#!/usr/bin/env python
"""
Benchmark of cutadapt_tpu_torch: single-end 3' adapter trimming
(`-a ADAPTER -e 0.1`), the flagship configuration.

The port's counterpart of bench.py, section by section and in its order:
reads/s of the port's engine end to end (FASTQ parse -> host k-mer
prefilter -> the CUDA aligner -> trimmed FASTQ assembly) on bench.py's
synthetic dataset, byte parity against the per-read host path on a
subset (exit 1 on any difference), and ONE JSON line, printed last:

    {"metric": "reads_per_sec_se_3p_adapter_trim", "value": ...,
     "unit": "reads/s", "vs_baseline": ..., ...}

vs_baseline is the speedup over the per-read host path (the port's
BackAdapter on parsed records, one core) measured in the same process.

The sections: the host baseline and parity; the warm-up; the kernel
parity matrix (tools/verify_cuda_torch.py; CUTADAPT_TPU_TORCH_KERNEL_VERIFY=0
skips it); the kernel alone (tools/kernel_bench_torch.py's path: the
first chunk's reads encoded by the engine, the 2-bit lane staged on the
card before the clock starts, launches in a CUDA graph timed with CUDA
events, beside the bound of ops/align_cuda.py:bound_of); the link probe
(`link_pre`, `link_post`); sequential passes with per-stage minima and
the transfer counters; the steady-state pipelined passes (the headline:
passes until two agree within 20%, then the median of at least 3); one
counted pipelined pass (its launches, each launch shape timed against its
bound); one pipelined pass under torch.profiler (the idle share: 1 minus
the device time of the CUDA kernels it records over the pass's wall
time, tools/profile_batch_torch.py:profiled_pass); the CLI surface
(cutadapt_tpu_torch.cli.main under CUTADAPT_TPU_TORCH_BATCH=require, 4
runs, the median of the last 3, its output held to the pipelined pass's);
-j 2 and -j 3 through main (every -j runs the same pipelined drive).

It runs on CUDA and has no fallback: without a card it exits 2 and
prints no result. Only --device cpu runs the plain versions (a rehearsal
at a small BENCH_READS): every device field (device_kernel, link_pre,
link_post, idle_share, x_bound, the per-shape times, roofline) is then
null and device is "cpu".

Environment: BENCH_READS (default 1,000,000), BENCH_BASELINE_READS
(5000), BENCH_SEQ_PASSES (3), BENCH_PASSES (3), BENCH_MAX_PASSES (10),
BENCH_CLI and BENCH_POOLED (1; 0 skips), CUTADAPT_TPU_TORCH_KERNEL_VERIFY.

Usage: python bench_torch.py [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # TruSeq
READ_LEN = 100
N_READS = int(os.environ.get("BENCH_READS", "1000000"))
SUBSET = int(os.environ.get("BENCH_BASELINE_READS", "5000"))
CHUNK_RECORDS = 131072
ADAPTER_FRACTION = 0.25
# the kernel alone (bench.py:328-337): the first chunk's reads, this many
# launches
KERNEL_ITERS = 8


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_dataset(n_reads: int, read_len: int, seed: int = 12345) -> bytes:
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = bases[rng.randint(0, 4, size=(n_reads, read_len))]
    ad = np.frombuffer(ADAPTER.encode(), dtype=np.uint8)
    has_adapter = rng.rand(n_reads) < ADAPTER_FRACTION
    positions = rng.randint(10, read_len - 3, size=n_reads)
    for i in np.flatnonzero(has_adapter):
        pos = positions[i]
        take = min(len(ad), read_len - pos)
        seqs[i, pos : pos + take] = ad[:take]
    quals = rng.randint(33 + 2, 33 + 41, size=(n_reads, read_len)).astype(np.uint8)

    # assemble FASTQ: @r<i>\nseq\n+\nqual\n
    names = [f"@r{i}\n".encode() for i in range(n_reads)]
    name_lens = np.array([len(x) for x in names], dtype=np.int64)
    rec_lens = name_lens + read_len + 1 + 2 + read_len + 1
    total = int(rec_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    offs = np.cumsum(rec_lens) - rec_lens
    pos = offs
    for i, nm in enumerate(names):  # headers vary in length; per-record
        out[pos[i] : pos[i] + name_lens[i]] = np.frombuffer(nm, np.uint8)
    pos = pos + name_lens
    idx = pos[:, None] + np.arange(read_len)[None, :]
    out[idx] = seqs
    pos = pos + read_len
    out[pos] = ord("\n")
    out[pos + 1] = ord("+")
    out[pos + 2] = ord("\n")
    pos = pos + 3
    idx = pos[:, None] + np.arange(read_len)[None, :]
    out[idx] = quals
    out[pos + read_len] = ord("\n")
    return out.tobytes()


def host_baseline(data: bytes, n_records: int):
    """reads/s of the per-read host path (Python hot loop) on the first
    n_records reads, and its output."""
    import io

    from cutadapt_tpu_torch.adapters import BackAdapter
    from cutadapt_tpu_torch.io.fastq import parse_fastq

    adapter = BackAdapter(ADAPTER, max_errors=0.1, min_overlap=3)
    reads = []
    for rec in parse_fastq(io.BytesIO(data)):
        reads.append(rec)
        if len(reads) >= n_records:
            break
    outputs = []
    t0 = time.perf_counter()
    for rec in reads:
        match = adapter.match_to(rec.sequence)
        trimmed = match.trimmed(rec) if match is not None else rec
        outputs.append(trimmed.fastq_bytes())
    dt = time.perf_counter() - t0
    return len(reads) / dt, b"".join(outputs)


def split_records(data: bytes, records_per_chunk: int):
    """Split a FASTQ byte buffer at record boundaries."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(buf == 10)
    n_records = len(nl) // 4
    bounds = [0]
    for r in range(records_per_chunk, n_records, records_per_chunk):
        bounds.append(int(nl[r * 4 - 1]) + 1)
    bounds.append(len(data))
    return [data[a:b] for a, b in zip(bounds[:-1], bounds[1:])], n_records


def probe_link(device, reps: int = 5) -> dict:
    """The host-card link alone, independent of any pipeline code: the
    median H2D GB/s of a 4 MiB copy from pinned memory and the median
    round trip of an 8-byte copy to the card and back, in microseconds.
    Each timed value ends in torch.cuda.synchronize()."""
    import torch

    mib4 = torch.zeros(4 << 20, dtype=torch.uint8).pin_memory()
    tiny = torch.zeros(8, dtype=torch.uint8).pin_memory()
    # one untimed copy of each sets up the allocator and the context
    mib4.to(device)
    tiny.to(device).cpu()
    torch.cuda.synchronize()
    h2d = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mib4.to(device, non_blocking=True)
        torch.cuda.synchronize()
        h2d.append(mib4.numel() / (time.perf_counter() - t0) / 1e9)
    rtt = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tiny.to(device, non_blocking=True).cpu()
        torch.cuda.synchronize()
        rtt.append((time.perf_counter() - t0) * 1e6)
    return {"h2d_gbps": float(np.median(h2d)), "rtt_us": float(np.median(rtt))}


def device_kernel_bench(engine, data: bytes, sms: int, clock_hz: float,
                        iters: int = KERNEL_ITERS) -> dict:
    """The aligner alone, at the flagship task's lane and row width: the
    reads of ``data`` (one chunk) encoded by the engine and staged on the
    card before the clock starts, ``iters`` launches captured in a CUDA
    graph and replayed after a warm-up, timed with CUDA events
    (tools/kernel_bench_torch.py:time_launches); the single call's
    latency (launch to synchronize, median of 5); the bound of those
    inputs on this card (ops/align_cuda.py:bound_of). ``launches`` is the
    wrapper's count over the section."""
    import torch

    import kernel_bench_torch as kb
    from cutadapt_tpu_torch.ops import align_cuda

    enc, lengths, tables, pack2 = kb.encoded_batch(engine, data, READ_LEN)
    lane = align_cuda.LANE_NAMES[pack2]
    align_cuda.reset_launch_counters()
    calls = []
    for _ in range(5):
        t0 = time.perf_counter()
        align_cuda.locate_packed(enc, lengths, tables, pack2)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    ms = kb.time_launches(enc, lengths, tables, pack2, iters)
    launches = align_cuda.LAUNCHES[lane]
    bound_ms, bound_by, work = align_cuda.bound_of(
        enc.cpu().numpy(), lengths.cpu().numpy(), tables, pack2, clock_hz,
        sms)
    rows = enc.shape[0]
    return {
        "device_dp_rows_per_sec": rows / ms * 1e3,
        "device_call_ms": float(np.median(calls)),
        "ms": ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "x_bound": ms / bound_ms,
        "rows": rows,
        "row_bytes": enc.shape[1],
        "iters": iters,
        "lane": lane,
        "launches": launches,
        "dp_cells": work[1],
    }


def counted_pass(engine, chunks, on_card: bool, sms, clock_hz) -> tuple:
    """One pipelined pass with the launch counters set to 0 just before
    it and read just after, its launch shapes recorded
    (chip_smoke.py:Recorder); on the card each shape is then timed (20
    launches in a CUDA graph) against its bound. Returns the launches,
    the shapes and the pass's output."""
    import chip_smoke
    import cutadapt_tpu_torch.batch_pipeline as bp
    import kernel_bench_torch as kb
    from cutadapt_tpu_torch.ops import align_cuda

    rec = chip_smoke.Recorder(bp.locate_packed)
    bp.locate_packed = rec
    align_cuda.reset_launch_counters()
    try:
        out = b"".join(o for o, _ in bp.process_chunks_pipelined(engine,
                                                                  chunks))
    finally:
        bp.locate_packed = rec.fn
    launches = dict(align_cuda.LAUNCHES)
    pack2_of = {lane: p for p, lane in align_cuda.LANE_NAMES.items()}
    per_shape = []
    for key in sorted(rec.inputs, key=lambda k: (-k[1], -k[2])):
        enc, lengths, tables = rec.inputs[key]
        pack2, wide = pack2_of[key[0]], key[4]
        d = dict(lane=key[0], shape=[key[1], key[2]], wide=wide,
                 launches=rec.calls.count(key), ms=None, bound_ms=None,
                 bound_by=None, x_bound=None)
        if on_card and not wide:
            d["ms"] = kb.time_launches(enc, lengths, tables, pack2, 20)
            d["bound_ms"], d["bound_by"], _ = align_cuda.bound_of(
                enc.cpu().numpy(), lengths.cpu().numpy(), tables, pack2,
                clock_hz, sms)
            d["x_bound"] = d["ms"] / d["bound_ms"]
        per_shape.append(d)
    return dict(launches=launches, per_shape=per_shape), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain versions (no device figures)")
    opts = ap.parse_args(argv)
    import torch

    if opts.device == "cuda" and not torch.cuda.is_available():
        log("bench_torch: torch.cuda.is_available() is False: this "
            "benchmark needs an NVIDIA GPU (--device cpu runs the plain "
            "versions and reports no device figure)")
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tools")]
    import cutadapt_tpu_torch.batch_pipeline as bp
    from cutadapt_tpu_torch.adapters import BackAdapter
    from cutadapt_tpu_torch.batch_pipeline import (
        AdapterStage,
        AdapterTask,
        BatchPipelineEngine,
    )

    device = torch.device(opts.device)
    on_card = device.type == "cuda"
    if on_card:
        from chip_smoke import nvidia_smi

        name = torch.cuda.get_device_name(0)
        power_limit = nvidia_smi("power.limit")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock_hz = float(nvidia_smi("clocks.max.sm", units=False)) * 1e6
        log(f"device: {name}, {power_limit}, {sms} SMs, max SM clock "
            f"{clock_hz / 1e6:.0f} MHz; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        link0 = probe_link(device)
        log(f"link probe (pre): {link0}")
    else:
        name, power_limit, sms, clock_hz, link0 = "cpu", None, None, None, None
        log("device: cpu (the plain versions; no device figure)")
    log(f"generating {N_READS} synthetic reads ...")
    data = make_dataset(N_READS, READ_LEN)

    # the same engine the CLI builds for -a ADAPTER
    adapter_obj = BackAdapter(ADAPTER, max_errors=0.1, min_overlap=3)
    engine = BatchPipelineEngine(
        [AdapterStage([AdapterTask(adapter_obj, "back", 0)])], device=device
    )

    def process_chunk(data):
        from cutadapt_tpu_torch.io.chunks import (
            assemble_window,
            parse_fastq_chunk,
        )

        parsed = parse_fastq_chunk(data)
        ws, we, keep, stats = engine.process_parsed(parsed)
        return assemble_window(parsed, ws, we, keep), stats

    chunks, n_records = split_records(data, CHUNK_RECORDS)
    log(f"{n_records} reads in {len(chunks)} chunks")

    # correctness: the subset must match the per-read host path
    log("measuring host baseline + verifying parity ...")
    host_rps, host_out = host_baseline(data, SUBSET)
    sub_chunks, _ = split_records(data, SUBSET)
    sub_out, _ = process_chunk(sub_chunks[0])
    if sub_out[: len(host_out)] != host_out:
        log("FATAL: batched engine output differs from host engine")
        sys.exit(1)
    log(f"parity OK on {SUBSET} reads; host baseline {host_rps:,.0f} reads/s")

    # warm-up: the kernel library, every lane's launch, one chunk
    t0 = time.perf_counter()
    engine.warmup(READ_LEN)
    process_chunk(chunks[0])
    log(f"warmup/build: {time.perf_counter() - t0:.1f}s")

    # the on-card parity matrix of the kernel
    kernel_parity = "skipped"
    if on_card and os.environ.get("CUTADAPT_TPU_TORCH_KERNEL_VERIFY",
                                  "1") != "0":
        try:
            import verify_cuda_torch

            t0 = time.perf_counter()
            failures = verify_cuda_torch.run(verbose=False)
            log(f"kernel parity matrix: {time.perf_counter() - t0:.1f}s")
            kernel_parity = (
                "ok" if not failures else "FAIL: " + "; ".join(failures[:3])
            )
        except Exception as e:
            kernel_parity = f"error: {type(e).__name__}: {e}"
        log(f"kernel_parity: {kernel_parity}")

    # --- the kernel alone ----------------------------------------------
    kernel = None
    if on_card:
        kernel = device_kernel_bench(engine, chunks[0], sms, clock_hz)
        log(f"device kernel: {kernel['device_dp_rows_per_sec']:,.0f} DP "
            f"rows/s ({kernel['lane']} lane, {kernel['rows']} x "
            f"{kernel['row_bytes']} B, {kernel['iters']} launches in a "
            f"CUDA graph: {kernel['ms']:.4f} ms each, bound "
            f"{kernel['bound_ms']:.5f} ms ({kernel['bound_by']}), "
            f"{kernel['x_bound']:.2f}x; single call "
            f"{kernel['device_call_ms']:.3f} ms)")

    # --- sequential passes: per-stage minima and transfer counters -----
    from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk

    seq_passes = int(os.environ.get("BENCH_SEQ_PASSES", "3"))
    bp.reset_xfer_counters()
    stage_min = {"parse": [], "dispatch": [], "collect": [],
                 "assemble": []}
    seq_rates = []
    for _ in range(seq_passes):
        stage_s = dict.fromkeys(stage_min, 0.0)
        t_all0 = time.perf_counter()
        for chunk_data in chunks:
            t0 = time.perf_counter()
            parsed = parse_fastq_chunk(chunk_data)
            t1 = time.perf_counter()
            pending = engine.submit(parsed)
            t2 = time.perf_counter()
            ws, we, keep, _stats = engine.collect(pending)
            t3 = time.perf_counter()
            assemble_window(parsed, ws, we, keep)
            t4 = time.perf_counter()
            stage_s["parse"] += t1 - t0
            stage_s["dispatch"] += t2 - t1
            stage_s["collect"] += t3 - t2
            stage_s["assemble"] += t4 - t3
        seq_rates.append(n_records / (time.perf_counter() - t_all0))
        for k, v in stage_s.items():
            stage_min[k].append(v)
    xfer = bp.xfer_counters()
    per_read = {
        k: min(v) / n_records * 1e9 for k, v in stage_min.items()
    }  # ns/read, min over passes
    bytes_h2d = xfer["h2d_bytes"] / n_records / seq_passes
    bytes_d2h = xfer["d2h_bytes"] / n_records / seq_passes
    # the assembler alone on the last chunk, best of 3, beside the stage
    asm = []
    for _ in range(3):
        t0 = time.perf_counter()
        assemble_window(parsed, ws, we, keep)
        asm.append((time.perf_counter() - t0) / parsed.n_records * 1e9)
    assemble_micro = min(asm)
    log(
        f"sequential passes: best {max(seq_rates):,.0f} reads/s; "
        f"ns/read (min of {seq_passes}) "
        f"{ {k: round(v, 1) for k, v in per_read.items()} }; assemble "
        f"micro {assemble_micro:.1f} ns/read; "
        f"H2D {bytes_h2d:.1f} B/read, D2H {bytes_d2h:.1f} B/read, "
        f"{xfer['candidates'] // seq_passes} candidates, "
        f"{xfer['dp_rows'] // seq_passes} DP rows"
    )

    # --- headline: steady-state pipelined throughput --------------------
    # Passes until two consecutive agree within 20%, then the median of
    # at least 3 steady passes; the cold pass and the best are reported.
    min_steady = int(os.environ.get("BENCH_PASSES", "3"))
    max_passes = int(os.environ.get("BENCH_MAX_PASSES", "10"))
    rates = []
    steady_at = None
    while len(rates) < max_passes:
        t0 = time.perf_counter()
        total_out = 0
        with_adapters = 0
        for out, stats in bp.process_chunks_pipelined(engine, chunks):
            total_out += len(out)
            with_adapters += stats.get("with_adapters", 0)
        dt = time.perf_counter() - t0
        rates.append(n_records / dt)
        log(
            f"pass {len(rates)}: {rates[-1]:,.0f} reads/s ({dt:.2f}s "
            f"for {n_records} reads, {with_adapters} with adapters, "
            f"{total_out/1e6:.1f} MB out)"
        )
        if steady_at is None and len(rates) >= 2:
            a, b = rates[-2], rates[-1]
            if abs(a - b) / max(a, b) < 0.20:
                steady_at = len(rates) - 2  # index of first steady pass
        if steady_at is not None and len(rates) - steady_at >= min_steady:
            break
    if steady_at is None:
        steady = sorted(rates)[len(rates) // 2:]
        log("WARNING: passes never stabilized within 20%; using top half")
    else:
        steady = sorted(rates[steady_at:])
    rps = steady[len(steady) // 2]
    log(
        f"engine ({name}): steady-state median {rps:,.0f} reads/s "
        f"({len(steady)} steady of {len(rates)} passes; "
        f"cold {rates[0]:,.0f}, best {max(rates):,.0f})"
    )

    # --- one counted pipelined pass: launches and shapes ----------------
    pipelined_pass, pass_out = counted_pass(engine, chunks, on_card, sms,
                                            clock_hz)
    log(f"one pipelined pass: launches {pipelined_pass['launches']}; "
        + "; ".join(
            f"{d['lane']} {d['shape'][0]}x{d['shape'][1]} x{d['launches']}"
            + (f" {d['ms']:.4f} ms, bound {d['bound_ms']:.5f} ms, "
               f"{d['x_bound']:.2f}x" if d["ms"] is not None else "")
            for d in pipelined_pass["per_shape"]))

    # --- the idle share: one pipelined pass under torch.profiler ---------
    idle_share = profiler = None
    if on_card:
        import profile_batch_torch

        profiler = profile_batch_torch.profiled_pass(engine, chunks, device)
        idle_share = 1 - profiler["kernel_busy_share"]
        log(f"torch.profiler over one pipelined pass "
            f"({profiler['seconds']:.3f} s): {profiler['kernel_ms']:.4f} ms "
            f"of kernel time ({profiler['device_ms']:.4f} ms of device "
            f"time over all names); idle share {idle_share:.6f}")
        link1 = probe_link(device)
        log(f"link probe (post): {link1}")
    else:
        link1 = None

    # --- the CLI surface: main on a file, then -j 2 and -j 3 ------------
    cli_rps = cli_best = flight_max = None
    pooled = None
    if os.environ.get("BENCH_CLI", "1") != "0":
        import logging
        import tempfile

        from cutadapt_tpu_torch import tracing
        from cutadapt_tpu_torch.cli import main as cli_main

        saved = {k: os.environ.get(k) for k in (
            "CUTADAPT_TPU_TORCH_BATCH", "CUTADAPT_TPU_TORCH_DEVICE")}
        os.environ["CUTADAPT_TPU_TORCH_BATCH"] = "require"
        if on_card:
            os.environ.pop("CUTADAPT_TPU_TORCH_DEVICE", None)
        else:
            os.environ["CUTADAPT_TPU_TORCH_DEVICE"] = "cpu"
        try:
            with tempfile.TemporaryDirectory() as tmp:
                in_path = os.path.join(tmp, "bench_in.fastq")
                out_path = os.path.join(tmp, "bench_out.fastq")
                with open(in_path, "wb") as f:
                    f.write(data)

                def run_main(*extra):
                    t0 = time.perf_counter()
                    cli_main(["--quiet", *extra, "-a", ADAPTER, "-o",
                              out_path, in_path])
                    dt = time.perf_counter() - t0
                    logging.root.handlers.clear()
                    with open(out_path, "rb") as f:
                        if f.read() != pass_out:
                            log(f"FATAL: main {' '.join(extra)} wrote other "
                                f"bytes than the pipelined pass")
                            sys.exit(1)
                    return n_records / dt

                # the first run traced: the most chunks in flight at once
                tracing.enable()
                try:
                    cli_rates = [run_main()]
                finally:
                    flight_max = tracing.in_flight_max(tracing.disable())
                cli_rates += [run_main() for _ in range(3)]
                # the first run builds and warms; median of the rest
                warm = sorted(cli_rates[1:])
                cli_rps = warm[len(warm) // 2]
                cli_best = max(cli_rates)
                log(f"CLI surface: median {cli_rps:,.0f} reads/s (best "
                    f"{cli_best:,.0f}), max chunks in flight {flight_max}")
                if os.environ.get("BENCH_POOLED", "1") != "0":
                    pooled = {"drive": "pipelined"}
                    for w in (2, 3):
                        pooled[f"workers{w}"] = {
                            "reads_per_sec": run_main("-j", str(w))}
                        log(f"-j {w}: {pooled[f'workers{w}']}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    x_bound = kernel["x_bound"] if kernel else None
    roofline = None
    if on_card:
        roofline = (
            f"the card idle {idle_share:.2%} of a pipelined pass "
            f"(torch.profiler); the aligner at {x_bound:.2f}x its bound "
            f"({kernel['bound_by']}) at {kernel['rows']} x "
            f"{kernel['row_bytes']} B; {bytes_h2d:.1f} B/read H2D against "
            f"a {link0['h2d_gbps']:.1f} GB/s link: "
            + ("host-bound" if idle_share > 0.5 else "device-bound")
        )
    print(
        json.dumps(
            {
                "metric": "reads_per_sec_se_3p_adapter_trim",
                "value": rps,
                "unit": "reads/s",
                "vs_baseline": rps / host_rps,
                # the reference's production figure is about 8 cores; the
                # host baseline is one core
                "vs_8core_equiv": rps / (host_rps * 8),
                "kernel_parity": kernel_parity,
                "backend": device.type,
                "device": name,
                "power_limit_w": (float(power_limit.split()[0])
                                  if power_limit else None),
                "n_reads": n_records,
                "parity_reads": SUBSET,
                "host_baseline_reads_per_sec": host_rps,
                "cold_reads_per_sec": rates[0],
                "best_reads_per_sec": max(rates),
                "steady_passes": steady,
                "n_passes": len(rates),
                "link_pre": link0,
                "link_post": link1,
                "device_kernel": kernel,
                "x_bound": x_bound,
                "idle_share": idle_share,
                "profiler": profiler,
                "pipelined_pass": pipelined_pass,
                "assemble_micro_ns_per_read": assemble_micro,
                "cli_reads_per_sec": cli_rps,
                "cli_best_reads_per_sec": cli_best,
                "chunks_in_flight_max": flight_max,
                "pooled_drive": pooled,
                "bytes_per_read_h2d": bytes_h2d,
                "bytes_per_read_d2h": bytes_d2h,
                "candidates_per_read": (
                    xfer["candidates"] / n_records / seq_passes),
                "dp_rows_per_read": xfer["dp_rows"] / n_records / seq_passes,
                "stage_ns_per_read": per_read,
                "sequential_reads_per_sec": max(seq_rates),
                "roofline": roofline,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
