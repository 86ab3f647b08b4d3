#!/usr/bin/env python
"""Kernel-only throughput of cutadapt_tpu_torch's aligner at the flagship
spec.

The port's counterpart of tools/kernel_bench.py: rows/s of the CUDA
aligner (csrc/align_locate.cu through ops/align_cuda.py:locate_packed)
on pre-staged device tensors, with no host work in the timed region.
The batch is what the engine dispatches for the flagship workload
(tests/torch_fixtures.py: ``-a ADAPTER -e 0.1 -O 3`` on 100 bp reads, a
quarter with the adapter): ``rows`` of its reads encoded by the engine's
own ``_encode`` in the lane and at the row width the engine picks for
them (the task's lane, the exact-wire width),
so neither is fixed here. ``iters`` launches are captured in a CUDA
graph and replayed, timed with CUDA events (chip_smoke.py:cuda_ms), once
per ``repeat``. With --device cpu the plain PyTorch version runs on the
host clock: a check that the tool runs, not a device measurement.

Usage: python tools/kernel_bench_torch.py [rows] [iters] [repeat]
       [--device cpu]
Prints one line per pass and a last JSON line `kernel_bench_torch
{...}`.
"""

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import cutadapt_tpu_torch.batch_pipeline as bp  # noqa: E402
from cutadapt_tpu_torch import staging  # noqa: E402
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk  # noqa: E402
from cutadapt_tpu_torch.ops import align_cuda  # noqa: E402


def encoded_batch(engine, data: bytes, read_len: int):
    """(enc, lengths, tables, pack2) of every read of the FASTQ bytes
    ``data`` as ``engine`` encodes them for its last task's kernel, at
    the lane and row width it picks for reads of ``read_len`` bp, on the
    engine's device."""
    task = engine.stages[-1].tasks[0]
    pack2 = None if task.byte else True
    width = engine._bucket_length(read_len)
    if bp._exact_wire_on(engine.device):
        width = bp._eff_width(read_len, width, pack2)
    chunk = parse_fastq_chunk(data)
    rows = chunk.n_records
    starts = chunk.seq_start.astype(np.int64)
    lens = chunk.seq_len.astype(np.int32)
    enc = torch.from_numpy(staging.encode_rows(
        chunk.buf, starts, lens, np.arange(rows, dtype=np.int64), rows, width,
        task.lut, task.reverse, pack2))
    lengths = torch.from_numpy(lens)
    return (enc.to(engine.device), lengths.to(engine.device), task.tables,
            pack2)


def flagship_batch(rows: int, device):
    """encoded_batch of ``rows`` reads of tests/torch_fixtures.py's
    flagship workload, on ``device``."""
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import torch_fixtures as fx

    return encoded_batch(fx.make_engine(device=device),
                         fx.make_dataset(rows), fx.READ_LEN)


def time_launches(enc, lengths, tables, pack2, iters: int) -> float:
    """Milliseconds per launch of the aligner on these inputs: on the
    card, ``iters`` launches captured in a CUDA graph and replayed, timed
    with CUDA events (chip_smoke.py:cuda_ms); on the CPU, the plain
    version on the host clock after one untimed call."""
    def launch():
        return align_cuda.locate_packed(enc, lengths, tables, pack2)

    if enc.device.type == "cuda":
        with torch.cuda.device(enc.device):
            return chip_smoke.cuda_ms(launch, iters, graph=True)
    launch()
    t0 = time.perf_counter()
    for _ in range(iters):
        launch()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", type=int, nargs="?", default=131072)
    ap.add_argument("iters", type=int, nargs="?", default=8)
    ap.add_argument("repeat", type=int, nargs="?", default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = ap.parse_args(argv)
    device = align_cuda.resolve_device(opts.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    enc, lengths, tables, pack2 = flagship_batch(opts.rows, device)
    lane = align_cuda.LANE_NAMES[pack2]
    print(f"device: {name}; lane {lane}, batch {tuple(enc.shape)} uint8, "
          f"adapter of {tables.m} bp")

    passes = []
    for r in range(opts.repeat):
        ms = time_launches(enc, lengths, tables, pack2, opts.iters)
        passes.append(dict(ms_per_launch=ms, rows_per_sec=opts.rows / ms * 1e3))
        print(f"pass {r}: {opts.rows / ms * 1e3:,.0f} rows/s ({ms:.4f} ms per "
              f"launch of {opts.rows} rows, {opts.iters} launches)")
    print("kernel_bench_torch " + json.dumps(dict(
        device=name, lane=lane, rows=opts.rows, row_bytes=enc.shape[1],
        iters=opts.iters, passes=passes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
