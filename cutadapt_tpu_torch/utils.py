"""Small utilities: CPU counting and the live progress meter.

Reference parity: utils.py:18-133 of cutadapt:src/cutadapt
(cpuset-aware CPU count; stderr progress line with µs/read and
M reads/minute).
"""

import logging
import multiprocessing
import re
import sys
import time

logger = logging.getLogger(__name__)

MICRO = "µ"


def available_cpu_count() -> int:
    """
    Number of CPUs usable by this process. When a cpuset(7) restricts
    the process to a subset of the machine (common on clusters), count
    the bits of the Cpus_allowed mask instead of trusting cpu_count().
    """
    total = multiprocessing.cpu_count()
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("Cpus_allowed:"):
                    mask = int(line.split(":", 1)[1].replace(",", ""), 16)
                    allowed = bin(mask).count("1")
                    if allowed:
                        return min(allowed, total)
                    break
    except OSError:
        pass
    return total


def _format_duration(seconds: float) -> str:
    whole = int(seconds)
    return f"{whole // 3600:02d}:{whole % 3600 // 60:02d}:{whole % 60:02d}"


def _scissor_frames(width: int = 10):
    """Endless animation frames: scissors snipping across a dashed
    line, then back."""
    while True:
        for going_left in (False, True):
            for pos in range(width + 1):
                for blades in ("8<", "8="):
                    gap, dashes = " " * pos, "-" * (width - pos)
                    if going_left:
                        frame = dashes + blades[::-1].replace("<", ">") + gap
                    else:
                        frame = gap + blades + dashes
                    yield f"[{frame}]"


class Progress:
    """Animated progress line on stderr with reads/s statistics."""

    def __init__(self, every: float = 1):
        self._min_interval = every
        self._frames = self.scissors()
        self._n = 0
        self._t0 = time.time()
        self._mark_time = self._t0
        self._mark_n = 0

    def __repr__(self):
        elapsed = self._mark_time - self._t0
        return f"Progress(_n={self._n}, elapsed={elapsed:.3f})"

    @staticmethod
    def scissors(width: int = 10):
        return _scissor_frames(width)

    def update(self, increment: int, _final: bool = False) -> None:
        self._n += increment
        now = time.time()
        if _final:
            interval, counted = now - self._t0, self._n
        else:
            interval = now - self._mark_time
            counted = self._n - self._mark_n
        if counted < 1 or interval == 0:
            return
        if not _final and interval < self._min_interval:
            return

        frame = next(self._frames)
        if _final:
            frame = "Done".ljust(len(frame))
        us_per_read = interval / counted * 1e6
        mreads_per_min = counted / interval * 60 / 1e6
        sys.stderr.write(
            f"\r{frame} {_format_duration(now - self._t0)} "
            f"{self._n:13,d} reads @ {us_per_read:5.1F} {MICRO}s/read; "
            f"{mreads_per_min:6.2F} M reads/minute"
        )
        self._mark_time = now
        self._mark_n = self._n

    def close(self) -> None:
        self.update(0, _final=True)
        print(file=sys.stderr)


class DummyProgress(Progress):
    """Progress reporter that prints nothing."""

    def update(self, increment, _final=False) -> None:
        pass

    def close(self) -> None:
        pass
