#!/usr/bin/env python
"""Host-to-device and device-to-host copy time and bandwidth for
cutadapt_tpu_torch's uploads and result fetches.

The port's counterpart of tools/profile_xfer.py: each size from 1 KiB
to 32 MiB (uint8) is copied host to device and device to host, from
page-locked (pinned, as the engine's encode buffers and results are)
and from pageable host memory, timed with CUDA events around ``reps``
copies on the current stream after a warm copy. Also the round trip of
the engine's smallest fetch: a (2, 4096) int32 packed result copied
into a pinned buffer and waited on through its event.

With --device cpu the same copies run between two CPU tensors (no pinned
memory) on the host clock: a check that the tool runs, not a device
measurement.

Usage: python tools/profile_xfer_torch.py [--max-bytes N] [--reps R]
       [--device cpu]
Prints one line per size and a last JSON line `profile_xfer_torch
{...}`: per size and memory kind the ms per copy and GB/s each way.
"""

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

from cutadapt_tpu_torch.ops.align_cuda import resolve_device  # noqa: E402

SIZES = [1 << 10, 1 << 16, 1 << 20, 8 << 20, 32 << 20]


def copy_ms(dst, src, reps: int, device) -> float:
    """Mean ms of dst.copy_(src) over reps copies (CUDA events on the
    card, the host clock on the CPU)."""
    dst.copy_(src, non_blocking=True)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            dst.copy_(src)
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fetch_round_trip_ms(device, reps: int) -> float:
    """Host ms from queueing a (2, 4096) int32 result's copy into a
    pinned buffer to its event's completion, as DeviceResult does."""
    dev = torch.zeros((2, 4096), dtype=torch.int32, device=device)
    pinned = device.type == "cuda"
    total = 0.0
    for i in range(reps + 1):
        t0 = time.perf_counter()
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=pinned)
        host.copy_(dev, non_blocking=pinned)
        if pinned:
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        if i:  # the first is a warm-up
            total += time.perf_counter() - t0
    return total / reps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-bytes", type=int, default=SIZES[-1])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = ap.parse_args(argv)
    device = resolve_device(opts.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    kinds = ("pinned", "pageable") if device.type == "cuda" else ("pageable",)
    rows = []
    for size in [s for s in SIZES if s <= opts.max_bytes]:
        dev = torch.empty(size, dtype=torch.uint8, device=device)
        for kind in kinds:
            host = torch.randint(0, 255, (size,), dtype=torch.uint8)
            if kind == "pinned":
                host = host.pin_memory()
            h2d = copy_ms(dev, host, opts.reps, device)
            d2h = copy_ms(host, dev, opts.reps, device)
            rows.append(dict(bytes=size, memory=kind, h2d_ms=h2d, d2h_ms=d2h,
                             h2d_gb_s=size / h2d / 1e6,
                             d2h_gb_s=size / d2h / 1e6))
            print(f"{size / 1e6:9.4f} MB {kind:8s}  H2D {h2d:9.4f} ms "
                  f"({size / h2d / 1e6:8.3f} GB/s)  D2H {d2h:9.4f} ms "
                  f"({size / d2h / 1e6:8.3f} GB/s)")
    fetch = fetch_round_trip_ms(device, opts.reps)
    print(f"(2, 4096) int32 result fetch through a pinned buffer and its "
          f"event: {fetch:.4f} ms per round trip")
    print("profile_xfer_torch " + json.dumps(dict(
        device=name, reps=opts.reps, copies=rows,
        result_fetch_round_trip_ms=fetch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
