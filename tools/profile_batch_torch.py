#!/usr/bin/env python
"""Stage profile of cutadapt_tpu_torch's engine on the flagship workload.

The port's counterpart of tools/profile_batch.py: one chunk of the
flagship reads (tests/torch_fixtures.py:make_dataset, 100 bp, a quarter
with the TruSeq adapter; ``-a ADAPTER -e 0.1 -O 3``) through parse,
submit, collect and assemble, each timed on the host clock, after a
warm pass. Submit is split further by wrapping what it calls:

- ``kmer_prefilter``, ``windows_clean``, ``pad_encode``: the C++ host
  scans (native/hostops.cpp);
- ``pinned allocations``: the encode buffers and length tensors put in
  page-locked memory (``BatchPipelineEngine._encode`` less its
  ``pad_encode``, and ``_host_tensor``);
- ``upload``: ``launch_batch`` less the kernel wrapper, the
  host-to-device copies it queues (once per dispatch batch, for every
  task of a shared-upload group);
- ``launch``: the kernel wrapper ``locate_packed`` (argument checks,
  ctypes call);
- ``copy back``: the result's pinned host buffer, its queued copy to
  the host and its event;
- ``rest``: submit's own Python (lane split, window bookkeeping).

Then the pipelined drive (process_chunks_pipelined) end to end over the
same reads in two chunks, and once more under torch.profiler: the device
time it records, by kernel and copy, and its share of the pass. Runs on
CUDA unless --device cpu (the plain aligner; no pinned memory, no
upload, no device activity).

Usage: python tools/profile_batch_torch.py [--reads N] [--device cpu]
Prints one line per stage and a last JSON line `profile_batch_torch
{...}` with ms per stage, ns per read and the submit split.
"""

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_REPO, os.path.join(_REPO, "tests")]

import torch  # noqa: E402

import cutadapt_tpu_torch.batch_pipeline as bp  # noqa: E402
import torch_fixtures as fx  # noqa: E402
from cutadapt_tpu_torch import native  # noqa: E402
from cutadapt_tpu_torch.io.chunks import (  # noqa: E402
    assemble_window,
    parse_fastq_chunk,
)

SUBMIT_PARTS = ("kmer_prefilter", "windows_clean", "pad_encode",
                "pinned allocations", "upload", "launch", "copy back")


class Split:
    """Host seconds spent inside wrapped callables, by part. Nested
    parts are subtracted from the part that encloses them."""

    def __init__(self):
        self.seconds = dict.fromkeys(SUBMIT_PARTS, 0.0)
        self._saved = []

    def _wrap(self, owner, name, part, inner=()):
        fn = getattr(owner, name)
        seconds = self.seconds

        def timed(*args, **kwargs):
            before = sum(seconds[p] for p in inner)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                seconds[part] += dt - (sum(seconds[p] for p in inner)
                                       - before)

        self._saved.append((owner, name, fn))
        setattr(owner, name, timed)

    def __enter__(self):
        engine = bp.BatchPipelineEngine
        for name in ("kmer_prefilter", "windows_clean", "pad_encode"):
            self._wrap(native, name, name)
        self._wrap(engine, "_encode", "pinned allocations", ("pad_encode",))
        self._wrap(engine, "_host_tensor", "pinned allocations")
        self._wrap(bp, "locate_packed", "launch")
        self._wrap(bp, "launch_batch", "upload", ("launch", "copy back"))
        self._wrap(bp.DeviceResult, "copy_to_host_async", "copy back")
        self._wrap(bp.ShardedResult, "copy_to_host_async", "copy back",
                   ("copy back",))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def profiled_pass(engine, chunks, device) -> dict:
    """One pipelined pass under torch.profiler (CPU and, on the card,
    CUDA activity): the device time it recorded, in all and by name (the
    8 largest), and the busy share of the pass's wall time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in bp.process_chunks_pipelined(engine, chunks):
            pass
        sync(device)
        seconds = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    return dict(seconds=seconds, device_ms=device_ms,
                busy_share=device_ms / 1e3 / seconds,
                by_name=[dict(name=e.key, count=e.count,
                              device_ms=e.self_device_time_total / 1e3)
                         for e in events[:8]])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=200000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = ap.parse_args(argv)
    device = bp.resolve_device(opts.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}; native: {native.AVAILABLE}")
    data = fx.make_dataset(opts.reads)
    engine = fx.make_engine(device=device)
    engine.warmup(fx.READ_LEN)
    list(bp.process_chunks_pipelined(engine, [data]))  # warm
    sync(device)

    spent = {}
    t0 = time.perf_counter()
    chunk = parse_fastq_chunk(data)
    spent["parse"] = time.perf_counter() - t0
    with Split() as split:
        t0 = time.perf_counter()
        pending = engine.submit(chunk)
        spent["submit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws, we, keep, _ = engine.collect(pending)
    spent["collect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assemble_window(chunk, ws, we, keep)
    spent["assemble"] = time.perf_counter() - t0

    n = chunk.n_records
    total = sum(spent.values())
    for k, v in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"{k:24s} {v * 1e3:9.2f} ms  {v / total * 100:5.1f}%  "
              f"{v / n * 1e9:8.1f} ns/read")
    print(f"{'TOTAL':24s} {total * 1e3:9.2f} ms  -> {n / total:,.0f} reads/s")
    submit_split = dict(split.seconds)
    submit_split["rest"] = spent["submit"] - sum(split.seconds.values())
    print("submit split: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms ({v / n * 1e9:.1f} ns/read)"
        for k, v in submit_split.items()))

    chunks, n2 = fx.split_records(data, (opts.reads + 1) // 2)
    list(bp.process_chunks_pipelined(engine, chunks))  # warm
    sync(device)
    t0 = time.perf_counter()
    for _ in bp.process_chunks_pipelined(engine, chunks):
        pass
    sync(device)
    dt = time.perf_counter() - t0
    print(f"pipelined end-to-end ({len(chunks)} chunks): {n2 / dt:,.0f} "
          f"reads/s")
    traced = profiled_pass(engine, chunks, device)
    print(f"torch.profiler over one more pipelined pass "
          f"({traced['seconds']:.3f} s): {traced['device_ms']:.3f} ms of "
          f"device time, busy share {traced['busy_share']:.6f}; by name "
          + "; ".join(f"{d['name'][:60]} x{d['count']} {d['device_ms']:.3f} ms"
                      for d in traced["by_name"]))
    print("profile_batch_torch " + json.dumps(dict(
        device=name, reads=n,
        stage_ms={k: v * 1e3 for k, v in spent.items()},
        stage_ns_per_read={k: v / n * 1e9 for k, v in spent.items()},
        submit_split_ms={k: v * 1e3 for k, v in submit_split.items()},
        submit_split_ns_per_read={k: v / n * 1e9
                                  for k, v in submit_split.items()},
        pipelined_reads_per_sec=n2 / dt, profiler=traced,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
