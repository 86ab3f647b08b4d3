"""
Written-read length tallies, mergeable across workers.

Two entry points feed the same store: the per-read host path bumps one
length at a time, while the batch path lands a whole ``np.bincount``
histogram in a single call (`add_histogram`), so merging is a plain
elementwise add.

Reference parity: statistics.py:5-48 of cutadapt:src/cutadapt
(ReadLengthStatistics contract used by Statistics/report rendering).
"""

from collections import Counter
from typing import Dict, Tuple


class ReadLengthStatistics:
    """Length histograms of written reads, one per read side (R1/R2)."""

    __slots__ = ("_r1", "_r2")

    def __init__(self) -> None:
        self._r1: Dict[int, int] = {}
        self._r2: Dict[int, int] = {}

    def update(self, read) -> None:
        """Record a written single-end read."""
        n = len(read)
        self._r1[n] = self._r1.get(n, 0) + 1

    def update2(self, read1, read2) -> None:
        """Record a written read pair."""
        n1, n2 = len(read1), len(read2)
        self._r1[n1] = self._r1.get(n1, 0) + 1
        self._r2[n2] = self._r2.get(n2, 0) + 1

    def add_histogram(self, hist, side: int = 1) -> None:
        """Merge a dense histogram (index = length, value = count),
        e.g. an ``np.bincount`` over a batch, into one read side."""
        store = self._r1 if side == 1 else self._r2
        for length, count in enumerate(hist):
            if count:
                length = int(length)
                store[length] = store.get(length, 0) + int(count)

    def written_reads(self) -> int:
        return sum(self._r1.values())

    def written_bp(self) -> Tuple[int, int]:
        return (
            sum(n * c for n, c in self._r1.items()),
            sum(n * c for n, c in self._r2.items()),
        )

    def written_lengths(self) -> Tuple[Counter, Counter]:
        return Counter(self._r1), Counter(self._r2)

    def __iadd__(self, other: "ReadLengthStatistics"):
        theirs1, theirs2 = other.written_lengths()
        for n, c in theirs1.items():
            self._r1[n] = self._r1.get(n, 0) + c
        for n, c in theirs2.items():
            self._r2[n] = self._r2.get(n, 0) + c
        return self
