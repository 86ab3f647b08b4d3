#!/usr/bin/env python
"""Stage profile of cutadapt_tpu_torch's engine on the flagship workload.

The port's counterpart of tools/profile_batch.py: one chunk of the
flagship reads (tests/torch_fixtures.py:make_dataset, 100 bp, a quarter
with the TruSeq adapter; ``-a ADAPTER -e 0.1 -O 3``) through parse,
submit, collect and assemble, each timed on the host clock, after a
warm pass. Submit and collect are split further by the port's own
spans (cutadapt_tpu_torch/tracing.py), enabled around each:

- submit: ``host_stages`` (the host stages before the adapters),
  ``stage`` (the staged pass: the C++ k-mer scan, the lane split and
  every batch encoded into the engine's staging arena), ``launch`` (the
  upload, the kernel wrapper and the queued copy back of each dispatch
  batch), and ``rest``, submit's own Python (window bookkeeping);
- collect: ``result_wait`` (the host waiting on each result's event)
  and ``rest``.

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
sys.path.insert(0, _REPO)

import torch  # noqa: E402

import cutadapt_tpu_torch.batch_pipeline as bp  # noqa: E402
from cutadapt_tpu_torch import native, tracing  # noqa: E402
from cutadapt_tpu_torch.io.chunks import (  # noqa: E402
    assemble_window,
    parse_fastq_chunk,
)

SUBMIT_PARTS = ("host_stages", "stage", "launch")
COLLECT_PARTS = ("result_wait",)


def split_seconds(records, parts) -> dict:
    """Seconds by part of the outermost spans named in ``parts`` (a
    ``kernel_launch`` inside ``launch`` is in ``launch``)."""
    seconds = dict.fromkeys(parts, 0.0)
    for s in records:
        if s.parent is None and s.name in seconds:
            seconds[s.name] += (s.end - s.start) / 1e9
    return seconds


def spanned(fn, *args):
    """``fn(*args)`` with the tracer on: (its result, its seconds, its
    spans)."""
    tracing.enable()
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        seconds = time.perf_counter() - t0
        records = tracing.disable()
    return out, seconds, records


def profiled_pass(engine, chunks, device) -> dict:
    """One pipelined pass under torch.profiler (CPU and, on the card,
    CUDA activity): the device time it recorded, in all and by name (the
    8 largest), and the busy share of the pass's wall time. The sum over
    names counts a copy twice (the copy's own event and the aten::copy_
    that queued it); ``kernel_ms`` sums only the events that ran on the
    card as kernels (no copy), and ``kernel_busy_share`` is its share of
    the wall time."""
    from torch.autograd import DeviceType
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
    kernel_ms = sum(
        e.self_device_time_total for e in events
        if getattr(e, "device_type", None) == DeviceType.CUDA
        and not e.key.startswith(("Memcpy", "Memset"))) / 1e3
    return dict(seconds=seconds, device_ms=device_ms,
                busy_share=device_ms / 1e3 / seconds, kernel_ms=kernel_ms,
                kernel_busy_share=kernel_ms / 1e3 / seconds,
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
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import torch_fixtures as fx

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
    pending, spent["submit"], records = spanned(engine.submit, chunk)
    submit_split = split_seconds(records, SUBMIT_PARTS)
    (ws, we, keep, _), spent["collect"], records = spanned(engine.collect,
                                                          pending)
    collect_split = split_seconds(records, COLLECT_PARTS)
    t0 = time.perf_counter()
    assemble_window(chunk, ws, we, keep)
    spent["assemble"] = time.perf_counter() - t0

    n = chunk.n_records
    total = sum(spent.values())
    for k, v in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"{k:24s} {v * 1e3:9.2f} ms  {v / total * 100:5.1f}%  "
              f"{v / n * 1e9:8.1f} ns/read")
    print(f"{'TOTAL':24s} {total * 1e3:9.2f} ms  -> {n / total:,.0f} reads/s")
    for stage, split in (("submit", submit_split),
                         ("collect", collect_split)):
        split["rest"] = spent[stage] - sum(split.values())
        print(f"{stage} split: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms ({v / n * 1e9:.1f} ns/read)"
            for k, v in split.items()))

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
        collect_split_ms={k: v * 1e3 for k, v in collect_split.items()},
        pipelined_reads_per_sec=n2 / dt, profiler=traced,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
