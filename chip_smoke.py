#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (cutadapt_tpu_torch) on one NVIDIA GPU.

Phases, each of which must pass:

1. build: compile the aligner kernel library from csrc/ with nvcc;
2. kernel parity: both lanes of the kernel (2-bit and 4-bit class ids)
   against the plain PyTorch version on the same CUDA tensors and against
   the C++ scalar aligner, on a 13-spec matrix of adapter kinds and flags
   and on 9 adapters whose DP rows end at the flagship layout's lane
   blocks (lanes x rows - 1, lanes x rows, lanes x rows + 1), at
   1024 reads x 128 bp and 1024 reads x 512 bp; on two adapters of
   lanes x rows - 1 bp for each register variant (lanes, rows) of the
   kernel, at 1024 reads of at least twice their length; on three 200 bp
   adapters and a 300 bp one (rows in shared memory) at 1024 reads x
   512 bp; and on a 4,000 bp one (rows in device scratch) at 64 reads x
   512 bp. Every instantiation of the kernel in the library must have run
   here. Then the wide result (the (7, B) store of windows of 2**14 bp
   or more and of adapter-side coordinates) in both lanes, on one spec of
   each layout mode (registers, shared memory, device scratch) and on
   256 reads of 16,400-20,000 bp with the flagship adapter, against the
   plain version on all 7 fields. Results are integers: `found` must
   agree everywhere, query start/stop, errors and score (and ref
   start/stop) wherever a match was found (tolerance: exact);
3. main path: flagship single-end 3' trimming of the TruSeq adapter,
   524,288 reads of 100 bp in 4 chunks of 131,072 through
   BatchPipelineEngine and process_chunks_pipelined on the card; output
   byte-identical to the per-read host path on every read; reads/s as the
   median of 3 passes after one warm pass;
4. dirty lane: 262,144 reads of which 5% carry N bases, so that the
   kernel's 4-bit lane and the host scalar tail run; output
   byte-identical to the per-read host path;
5. cli: phase 3's reads written to a FASTQ file and trimmed by
   ``cutadapt_tpu_torch.cli.main`` in-process on the card, under
   CUTADAPT_TPU_TORCH_BATCH=require: the output file equals phase 3's
   engine output byte for byte and the report's reads-with-adapters
   count equals the host path's, at -j 1 and -j 3; the CLI's wall time
   and reads/s (median of 3 runs after the first) and the first run's
   start-up time (call to first chunk submitted, kernel library already
   built); one counted run of the flagship file and one of phase 4's
   dirty file through main, each lane's launches there (the engine's
   warm-up apart) with its time, bound and parity against the plain
   version at every shape the CLI launched; then every golden case
   (tests/torch_fixtures.py: the engine refuses none), single-end and
   paired, through main on the card, byte-identical to tests/cut/;
6. host stages: the repo's configuration -q 20 -a ADAPTER --poly-a -m 10
   (bench_configs.py:132-135) on 262,144 reads of 40-100 bp (30% with
   the adapter, 30% with an A tail, phred 2-40) through main under
   require, held to the port's per-read host path
   (CUTADAPT_TPU_TORCH_BATCH=0): the output file byte for byte, and the
   --json report's read counts, base-pair counts (quality-trimmed and
   poly-A bases) and adapter statistics; reads/s through main (median
   of 3 runs after the first); one counted run, each kernel shape there
   timed, bounded and held to the plain version;
7. linked primers: the amplicon trimming of cutadapt's user guide,
   -a ^GTGYCAGCMGCCGCGGTAA...ATTAGAWACCCBNGTAGTCC --discard-untrimmed
   (the 16S V4 primers 515F and 806R), on 131,072 synthetic amplicon
   reads of 260-299 bp, held and measured as phase 6; the 5' phase
   launches the kernel from submit, the 3' phase from collect, and each
   must launch the 2-bit lane;
8. paired TruSeq: -a AGATCGGAAGAGCACACGTCTGAACTCCAGTCA -A
   AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT -q 20 -m 20 -o -p (the TruSeq R1/R2
   adapters of cutadapt's user guide, Trim Galore's default -q 20 -m 20)
   on 131,072 pairs of 2 x 150 bp (torch_fixtures.make_pairs), held to
   the host path on both output files and the report (read counts, base
   pairs, the adapter statistics of both reads) and measured as phase 6
   (reads/s with a pair counted as one read); R1 launches from the first
   engine, R2 from the second, and each side must launch both lanes;
9. revcomp amplicons: --revcomp -g ^GTGYCAGCMGCCGCGGTAA
   --discard-untrimmed on 131,072 make_amplicons reads, half of them
   reverse-complemented, held and measured as phase 6; both orientations
   launch from submit and each must launch the 2-bit lane, and about half
   the reads must come out reverse-complemented;
10. long reads: the flagship -a AGATCGGAAGAGCACACGTCTGAACTCCAGTCA -e 0.1
   -O 3 on 8,192 reads of 8,000-32,000 bp (PacBio HiFi and Oxford
   Nanopore lengths; a quarter with the adapter at a uniform position,
   3% with 1-3 N; torch_fixtures.make_long_reads), the file as one
   chunk, held and measured as phase 6 (reads/s and bp/s, the idle
   share); each lane must launch, every launch in the wide result;
11. the output side, held and measured as phase 6 on every file: (a)
   UMI to header, -u 8 --rename '{id}_{cut_prefix} {comment}' -a
   ADAPTER --info-file (the "--rename" section of cutadapt's user guide)
   on 262,144 reads of 108 bp, the 2-bit lane; (b) barcode
   demultiplexing of pairs, -e 0.15 --no-indels -g
   ^file:barcodes.fasta -o trimmed-{name}.1.fastq -p
   trimmed-{name}.2.fastq ("Demultiplexing paired-end reads") on
   262,144 pairs, 95% of them with one of 16 barcodes before R1: an
   indexed host task, which must launch no kernel.

Launch counters are set to 0 just before each counted window (the main
path's warm pass, the dirty lane, each counted CLI run, the golden
cases, the counted runs of phases 6 to 11) and read just after; each
lane the window carries must have been launched there. Prints the
card's name and power limit, one JSON line with every kernel's numbers
(time, plain time, bound, time / bound and error at every shape the
path launched, and the same for the CLI's shapes under "cli" and for
phases 6 to 11 under "host_stages", "linked", "paired" (by side),
"revcomp" (by orientation), "long_reads" and "output_side"; the wide
launches under "wide_launches"), and as the last line
{"ok": true, "device": {...}}.

The workload and the parity matrix come from tests/torch_fixtures.py.
Run from the repository root: python3 chip_smoke.py
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_READS = 524288
N_DIRTY_READS = 262144
# phase 6 (bench_configs.py:132-135) and phase 7 (linked 16S primers);
# halved since phases 10 and 11 came, so that the run keeps to its time
N_POLYA_READS = 262144
N_AMPLICON_READS = 131072
# phase 8 (paired TruSeq, pairs of 2 x 150 bp; halved likewise) and
# phase 9 (revcomp amplicons)
N_PAIRS = 131072
N_RC_AMPLICON_READS = 131072
PARITY_READS = 1024
PARITY_LENGTHS = (128, 512)
# reads for the adapters past the flagship's width (long_specs)
PARITY_LONG_LENGTH = 512
# reads of the 4,000 bp adapter (its scalar check is the slow part)
PARITY_VERY_LONG_READS = 64
# the wide store on reads of 2**14 bp or more (the plain version's loop
# over columns is the slow part)
PARITY_WIDE_LONG_READS = 256
PARITY_WIDE_LENGTHS = (16400, 20000)
# the wide launches of the parity phase, per lane
WIDE_PARITY = {}
# phase 10: long reads (8,000-32,000 bp) and phase 11's output side
N_LONG_READS = 8192
# the long reads' file (about 330 MB) as one chunk, so that the 4-bit lane
# gets a device batch and the path launches three wide shapes
LONG_CHUNK_BYTES = 1 << 30
N_UMI_READS = 262144
N_BARCODED_PAIRS = 262144
TIMED_PASSES = 3
# HBM3 rate of the H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# int32 lanes per SM (the issue rate of 32-bit integer instructions)
INT32_LANES_PER_SM = 64
# Integer ALU operations the aligner needs, counted from the inner loops
# of csrc/align_locate.cu. Loads and stores of the DP column are not
# counted: they run on the load/store pipe, and a column held in
# registers would need none. Per active column, row 0: its cost, score
# and origin adds and the band test (4). Per cell of rows 1..m: the
# class match bit (2: shift, and), the diagonal leaf (3: cost add, score
# select and add), the deletion candidate (4: select, add and
# saturating min on the cost, add on the score), its lexicographic
# key_min against the leaf (10: 5 compares, 5 selects) and the band and
# band-edge updates (5: 3 compares, 2 selects). A cell whose query class
# does not match the row also takes the insertion leaf (2 adds) and its
# key_min against the diagonal, whose classes are fixed (1 compare,
# 5 selects); a matching cell takes the diagonal outright.
OPS_PER_COLUMN = 4
OPS_PER_CELL = 24
OPS_PER_MISMATCH = 8


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi --query-gpu={query}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean time of fn() over reps launches, from CUDA events around the
    stream. With graph=True the reps calls are captured in a CUDA graph
    and replayed, so that the host's cost per call (the Python wrapper,
    ctypes) leaves no gaps between launches and the events see device
    time alone; fn must not synchronise then."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of fn(), without waiting for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


class Recorder:
    """Wraps the engine's kernel entry: notes the shape of every launch
    (lane, rows, row bytes, task, wide result) and keeps a copy of the
    first inputs of each shape. Launches made while warming() is true
    (the engine's warm-up on zeros) are only counted, per lane, in
    warmup. task(tables) labels the task a launch belongs to (the phase
    of a linked adapter), "" by default."""

    def __init__(self, fn, warming=lambda: False, task=lambda tables: ""):
        self.fn = fn
        self.warming = warming
        self.task = task
        self.calls = []  # (pack2, B, Wp, task, wide)
        # (pack2, B, Wp, task, wide) -> (enc, lengths, tables)
        self.inputs = {}
        self.warmup = {"pack2": 0, "pack4": 0}

    def launches(self, pack2: bool, task=None, wide=None) -> int:
        return sum(1 for k in self.calls if k[0] == pack2
                   and task in (None, k[3]) and wide in (None, k[4]))

    def __call__(self, enc, lengths, tables, pack2, wide=False):
        if self.warming():
            self.warmup["pack2" if pack2 else "pack4"] += 1
            return self.fn(enc, lengths, tables, pack2, wide=wide)
        key = (bool(pack2), enc.shape[0], enc.shape[1], self.task(tables),
               bool(wide))
        self.calls.append(key)
        if key not in self.inputs:
            self.inputs[key] = (enc.clone(), lengths.clone(), tables)
        return self.fn(enc, lengths, tables, pack2, wide=wide)


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two unpacked results under the
    comparison rule (found everywhere, other fields where found)."""
    f = want[0]
    err = int(np.abs(got[0].astype(np.int64) - want[0]).max(initial=0))
    for g, w in zip(got[1:], want[1:]):
        err = max(err, int(np.abs(g[f].astype(np.int64) - w[f]).max(initial=0)))
    return err


def ptxas_summary(log_text: str):
    """One line per compiled kernel variant from nvcc's -Xptxas -v log:
    (BITS, lanes, rows, mode) and its registers, stack and spills."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"locate_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            cur = dict(variant="<{}>".format(",".join(m.groups())))
            out.append(cur)
        elif cur is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                hit = re.search(pat, line)
                if hit:
                    cur[key] = int(hit.group(1))
    return out


def parity_cases():
    """(read length, reads, spec, where random_batch puts the adapter)
    of the parity matrix."""
    import torch_fixtures as fx

    cases = [(L, PARITY_READS, spec, {}) for L in PARITY_LENGTHS
             for spec in fx.parity_specs()]
    cases += [(L, PARITY_READS, spec, fx.placement(spec))
              for L in PARITY_LENGTHS for spec in fx.block_edge_specs()]
    cases += [(fx.variant_read_length(spec), PARITY_READS, spec,
               fx.placement(spec)) for spec in fx.variant_specs()]
    cases += [(PARITY_LONG_LENGTH, PARITY_READS, spec, {})
              for spec in fx.long_specs()]
    cases.append((PARITY_LONG_LENGTH, PARITY_VERY_LONG_READS,
                  fx.very_long_spec(), {}))
    return cases


def parity_phase():
    """Both lanes on every case against the plain version and the scalar
    aligner; every instantiation of the kernel must run. Returns the
    worst error per lane."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    rng = np.random.RandomState(20260816)
    worst = {True: 0, False: 0}
    runs = 0
    align_cuda.reset_launch_counters()
    t0 = time.perf_counter()
    for L, B, spec, place in parity_cases():
        tables = align_cuda.make_tables(spec)
        lay = align_cuda.kernel_layout(tables.m)
        for pack2 in (True, False):
            raw, enc, lens = fx.random_batch(spec, rng, B, L, pack2, **place)
            enc_d = torch.from_numpy(enc).cuda()
            len_d = torch.from_numpy(lens).cuda()
            got = align_cuda.locate_packed(enc_d, len_d, tables, pack2)
            plain = align_cuda.locate_reference(enc_d, len_d, tables, pack2)
            torch.cuda.synchronize()
            g = align_cuda.unpack_result(got.cpu().numpy())
            p = align_cuda.unpack_result(plain.cpu().numpy())
            s = fx.scalar_locate(spec, raw, lens)
            label = (f"{spec.reference[:12]}.. m={len(spec.reference)} "
                     f"flags={spec.flags} e={spec.max_error_rate} "
                     f"ic={spec.indel_cost} mo={spec.min_overlap} L={L} "
                     f"{'2-bit' if pack2 else '4-bit'} "
                     f"[{lay.lanes} lanes x {lay.rows} rows, {lay.mode}]")
            for other, name in ((p, "plain PyTorch"), (s, "scalar C++")):
                diff = fx.first_difference(g, other)
                if diff is not None:
                    fail(f"kernel parity {label}: {diff} differs from "
                         f"the {name} version")
            worst[pack2] = max(worst[pack2], max_abs_err(g, p))
            runs += 1
            log(f"  parity {label}: ok ({int(g[0].sum())} matches)")
    ran = set(align_cuda.VARIANT_LAUNCHES)
    missing = align_cuda.instantiations() - ran
    if missing or ran - align_cuda.instantiations():
        fail(f"the parity matrix did not run the instantiations "
             f"{sorted(missing)} (ran {sorted(ran)})")
    log(f"kernel parity: all {runs} runs agree, all {len(ran)} "
        f"instantiations ran ({time.perf_counter() - t0:.1f} s)")
    wide_parity(rng, worst)
    return worst


def wide_parity(rng, worst) -> None:
    """The wide (7, B) store against the plain version on all 7 fields
    (found everywhere, the others where found) and the first five
    against the scalar aligner: a spec of each layout mode (registers,
    shared memory, device scratch) at 512 bp, and the flagship adapter on
    reads of 2**14 bp or more, in both lanes. Updates ``worst``."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    t0 = time.perf_counter()
    flagship = fx.parity_specs()[0]
    cases = [(spec, PARITY_READS, PARITY_LONG_LENGTH)
             for spec in (flagship, fx.long_specs()[-1])]
    cases.append((fx.very_long_spec(), PARITY_VERY_LONG_READS,
                  PARITY_LONG_LENGTH))
    cases.append((flagship, PARITY_WIDE_LONG_READS, PARITY_WIDE_LENGTHS))
    before = dict(align_cuda.WIDE_LAUNCHES)
    modes = set()
    for spec, B, L in cases:
        tables = align_cuda.make_tables(spec)
        lay = align_cuda.kernel_layout(tables.m)
        for pack2 in (True, False):
            if isinstance(L, tuple):
                raw, enc, lens = fx.long_batch(spec, rng, B, L, pack2)
            else:
                raw, enc, lens = fx.random_batch(spec, rng, B, L, pack2)
            enc_d = torch.from_numpy(enc).cuda()
            len_d = torch.from_numpy(lens).cuda()
            got = align_cuda.locate_packed(enc_d, len_d, tables, pack2,
                                           wide=True)
            t1 = time.perf_counter()
            plain = align_cuda.locate_reference(enc_d, len_d, tables, pack2,
                                                wide=True)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
            g = align_cuda.unpack_wide(got.cpu().numpy())
            p = align_cuda.unpack_wide(plain.cpu().numpy())
            label = (f"{spec.reference[:12]}.. m={len(spec.reference)} "
                     f"{B} reads of {L} bp {'2-bit' if pack2 else '4-bit'} "
                     f"[{lay.lanes} lanes x {lay.rows} rows, {lay.mode}]")
            diff = fx.first_difference(g, p)
            if diff is None:
                diff = fx.first_difference(g[:5], fx.scalar_locate(
                    spec, raw, lens))
            if diff is not None:
                fail(f"wide parity {label}: {diff} differs")
            if not g[0].any():
                fail(f"wide parity {label}: no read matched")
            worst[pack2] = max(worst[pack2], max_abs_err(g, p))
            modes.add(lay.mode)
            log(f"  wide parity {label}: ok on all 7 fields "
                f"({int(g[0].sum())} matches, longest ref_stop "
                f"{int(g[6][g[0]].max())}, query_stop "
                f"{int(g[2][g[0]].max())}; plain {plain_s:.1f} s)")
    wide = {k: v - before[k] for k, v in align_cuda.WIDE_LAUNCHES.items()}
    if modes != set(align_cuda.MODES) or min(wide.values()) < len(cases):
        fail(f"wide parity: layout modes {sorted(modes)}, wide launches "
             f"{wide}")
    WIDE_PARITY.update(wide)
    log(f"wide parity: {2 * len(cases)} runs agree, every layout mode, wide "
        f"launches {wide} ({time.perf_counter() - t0:.1f} s)")


def run_pass(engine, chunks, keep_output: bool):
    from cutadapt_tpu_torch.batch_pipeline import process_chunks_pipelined

    outs, total, with_adapters, matched = [], 0, 0, []
    for out, stats in process_chunks_pipelined(engine, chunks):
        total += len(out)
        with_adapters += stats["with_adapters"]
        if keep_output:
            outs.append(out)
            matched.append(stats["matched_mask"])
    return b"".join(outs), total, with_adapters, matched


def stage_breakdown(engine, chunks, n_reads) -> dict:
    """Host ns/read of each stage in one sequential (not overlapped)
    pass: parse, submit (prefilter, encode, upload, launch), collect
    (wait for the results, window update, filters), assemble."""
    from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk

    spent = dict.fromkeys(("parse", "submit", "collect", "assemble"), 0.0)
    for data in chunks:
        t0 = time.perf_counter()
        parsed = parse_fastq_chunk(data)
        t1 = time.perf_counter()
        pending = engine.submit(parsed)
        t2 = time.perf_counter()
        ws, we, keep, _ = engine.collect(pending)
        t3 = time.perf_counter()
        assemble_window(parsed, ws, we, keep)
        t4 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            spent[key] += dt
    return {k: v / n_reads * 1e9 for k, v in spent.items()}


def drive(engine, data, chunk_records, label):
    """One counted pass of the engine over data, held byte for byte to
    the per-read host path. Returns the kernel-entry recorder, launch
    and transfer counters."""
    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    chunks, n = fx.split_records(data, chunk_records)
    t0 = time.perf_counter()
    host, host_matched = fx.host_trim(data, n)
    log(f"{label}: per-read host path over {n} reads: "
        f"{time.perf_counter() - t0:.1f} s, {host_matched} with adapters")
    rec = Recorder(bp.locate_packed)
    bp.locate_packed = rec
    align_cuda.reset_launch_counters()
    bp.reset_xfer_counters()
    try:
        out, _, with_adapters, matched = run_pass(engine, chunks, True)
    finally:
        bp.locate_packed = rec.fn
    launches = dict(align_cuda.LAUNCHES)
    xfer = bp.xfer_counters()
    if out != host:
        pos = next(i for i, (a, b) in enumerate(zip(out, host)) if a != b) \
            if len(out) == len(host) else min(len(out), len(host))
        fail(f"{label}: engine output differs from the per-read host path "
             f"at byte {pos} ({len(out)} vs {len(host)} bytes)")
    if with_adapters != host_matched or int(
        sum(m.sum() for m in matched)
    ) != host_matched:
        fail(f"{label}: with_adapters {with_adapters} != host path "
             f"{host_matched}")
    log(f"{label}: output byte-identical to the per-read host path "
        f"({len(out)} bytes, {with_adapters} with adapters, "
        f"{len(chunks)} chunks)")
    log(f"{label}: launches {launches}, per chunk "
        f"{ {k: v / len(chunks) for k, v in launches.items()} }; "
        f"candidates/read {xfer['candidates'] / n}, DP rows/read "
        f"{xfer['dp_rows'] / n}, H2D B/read {xfer['h2d_bytes'] / n}, "
        f"D2H B/read {xfer['d2h_bytes'] / n}")
    return chunks, rec, launches, host, host_matched


def cli_phase(files, engine_rps: float) -> dict:
    """Phase 5: the flagship file through cli.main on the card (a first
    run, timed runs, -j 3), one counted run of the flagship file and one
    of the dirty file, then the accepted golden cases. files maps "clean"
    and "dirty" to (FASTQ bytes, the per-read host path's output, its
    reads with adapters). Returns each counted window's recorder and
    launches."""
    import logging
    import tempfile

    import torch
    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx
    from cutadapt_tpu_torch import accel, cli
    from cutadapt_tpu_torch.ops import align_cuda

    # the CLI's report lines go nowhere; its errors reach stderr
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    os.environ["CUTADAPT_TPU_TORCH_BATCH"] = "require"
    for name in ("CUTADAPT_TPU_TORCH_DEVICE", "CUTADAPT_TPU_TORCH_CHUNK_BYTES"):
        os.environ.pop(name, None)
    fallbacks = accel.FALLBACK_COUNT
    windows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        paths = {}
        for which, (data, _, _) in files.items():
            paths[which] = os.path.join(tmp, f"{which}.fastq")
            with open(paths[which], "wb") as f:
                f.write(data)
            log(f"cli: {which} file written, {len(data)} bytes")

        def run(tag, which="clean", extra=()):
            _, want, want_matched = files[which]
            out = os.path.join(tmp, f"{tag}.fastq")
            rep = os.path.join(tmp, f"{tag}.json")
            t0 = time.perf_counter()
            cli.main(["-a", fx.ADAPTER, "-e", "0.1", "-O", "3", *extra,
                      "-o", out, "--json", rep, paths[which]])
            dt = time.perf_counter() - t0
            with open(out, "rb") as f:
                got = f.read()
            with open(rep) as f:
                matched = json.load(f)["read_counts"]["read1_with_adapter"]
            if got != want:
                fail(f"cli {tag}: output differs from the per-read host "
                     f"path ({len(got)} vs {len(want)} bytes)")
            if matched != want_matched:
                fail(f"cli {tag}: report counts {matched} reads with "
                     f"adapters, the host path {want_matched}")
            os.unlink(out)
            return t0, dt

        t_call, dt = run("first")
        times = accel.RUN_TIMES
        startup = times["first_submit"] - t_call
        log(f"cli: first main call {dt:.3f} s, {N_READS / dt:.1f} reads/s; "
            f"start-up (call to first chunk submitted, library built) "
            f"{startup * 1e3:.1f} ms, of which device setup and warm-up "
            f"{(times['device_ready'] - times['start']) * 1e3:.1f} ms")
        walls = []
        for i in range(TIMED_PASSES):
            accel.reset_flight_metrics()
            walls.append(run(f"timed{i}")[1])
            log(f"cli run: {walls[-1]:.3f} s, {N_READS / walls[-1]:.1f} "
                f"reads/s, at most {accel.flight_metrics()['max']} chunks "
                f"in flight")
        walls.sort()
        wall = walls[len(walls) // 2]
        _, dt_j3 = run("j3", extra=("-j", "3"))
        log(f"cli: -j 3 (the same pipelined drive): output identical, "
            f"{dt_j3:.3f} s, {N_READS / dt_j3:.1f} reads/s")
        log(f"cli: median wall {wall:.4f} s = {N_READS / wall:.1f} reads/s "
            f"through main (file read, parse, engine, write, report) vs "
            f"{engine_rps:.1f} reads/s engine-only in phase 3 "
            f"({torch.cuda.get_device_name(0)}, "
            f"{nvidia_smi('power.limit')})")
        log(f"cli_reads_per_sec {N_READS / wall}")
        log(f"cli_startup_ms {startup * 1e3}")

        # one counted run per file: counts set to 0 just before main,
        # read just after; the engine's warm-up launches (before the
        # device is ready) are told apart from the chunks' launches
        for which in files:
            rec = Recorder(bp.locate_packed,
                           warming=lambda: times["device_ready"] is None)
            bp.locate_packed = rec
            align_cuda.reset_launch_counters()
            try:
                run(f"counted_{which}", which)
            finally:
                bp.locate_packed = rec.fn
            launches = dict(align_cuda.LAUNCHES)
            windows[which] = (rec, launches)
            log(f"cli: one {which} file run through main: launches "
                f"{launches}, of which warm-up {rec.warmup}; chunk "
                f"launches per shape "
                f"{ {k: rec.calls.count(k) for k in sorted(rec.inputs)} }")
        if windows["clean"][0].launches(True) <= 0:
            fail("cli: the flagship file launched no 2-bit chunk batch")
        if windows["dirty"][0].launches(False) <= 0:
            fail("cli: the dirty file launched no 4-bit chunk batch")

        align_cuda.reset_launch_counters()
        ran = 0
        if fx.ENGINE_NOT_YET or fx.ENGINE_NOT_YET_PAIRED:
            fail(f"golden cases the engine refuses: {fx.ENGINE_NOT_YET} "
                 f"{fx.ENGINE_NOT_YET_PAIRED}")
        for case_id, params, expected, inpath in fx.golden_cases():
            out = os.path.join(tmp, "golden_" + expected)
            cli.main(fx.golden_args(params, out, inpath))
            with open(out, "rb") as f, open(fx.golden_path(expected), "rb") as g:
                if f.read() != g.read():
                    fail(f"cli golden case {case_id}: output differs from "
                         f"tests/cut/{expected}")
            ran += 1
        for case_id, params, in1, in2, exp1, exp2 in fx.paired_golden_cases():
            # the outputs' extensions name their format, as the golden
            # files' do
            outs = [os.path.join(tmp, f"golden_{i}_{expected}")
                    for i, expected in ((1, exp1), (2, exp2))]
            cli.main(fx.paired_golden_args(params, *outs, in1, in2))
            for out, expected in zip(outs, (exp1, exp2)):
                with open(out, "rb") as f, \
                        open(fx.golden_path(expected), "rb") as g:
                    if f.read() != g.read():
                        fail(f"cli paired golden case {case_id}: output "
                             f"differs from tests/cut/{expected}")
            ran += 1
        golden = dict(align_cuda.LAUNCHES)
        if min(golden.values()) <= 0:
            fail(f"cli golden cases: a kernel lane was never launched: "
                 f"{golden}")
        log(f"cli: all {ran} golden cases (single-end and paired) "
            f"byte-identical on the card; "
            f"their launches (warm-ups included) {golden}")
    if accel.FALLBACK_COUNT != fallbacks:
        fail(f"cli: {accel.FALLBACK_COUNT - fallbacks} fallbacks "
             f"({accel.LAST_FALLBACK})")
    return dict(windows=windows, golden=golden)


def report_parts(path: str) -> dict:
    """The parts of a --json report that the engine must reproduce."""
    with open(path) as f:
        rep = json.load(f)
    return {k: rep[k] for k in ("read_counts", "basepair_counts",
                                "adapters_read1", "adapters_read2")}


class OrientationTags:
    """Labels the kernel launches of a --revcomp run with the orientation
    of the dispatch they came from: "forward" for the chunk that submit
    got, "rc" for its reverse-complemented copy. While active, the
    engine's submit and _dispatch_stage note the chunk in a thread-local;
    an instance is a Recorder's task function."""

    def __init__(self):
        self.local = threading.local()

    def __enter__(self):
        import cutadapt_tpu_torch.batch_pipeline as bp

        engine = bp.BatchPipelineEngine
        self.saved = real_submit, real_dispatch = (engine.submit,
                                                   engine._dispatch_stage)
        local = self.local

        def submit(eng, parsed):
            local.parsed = parsed
            return real_submit(eng, parsed)

        def dispatch(eng, stage, chunk, *args):
            local.tag = ("forward" if chunk is getattr(local, "parsed", None)
                         else "rc")
            return real_dispatch(eng, stage, chunk, *args)

        engine.submit, engine._dispatch_stage = submit, dispatch
        return self

    def __exit__(self, *exc):
        import cutadapt_tpu_torch.batch_pipeline as bp

        bp.BatchPipelineEngine.submit, bp.BatchPipelineEngine._dispatch_stage \
            = self.saved

    def __call__(self, tables) -> str:
        return getattr(self.local, "tag", "")


def config_phase(label, args, inputs, task_of, tasks, lanes=(True,),
                 outputs=None, files=None, chunk_bytes=None):
    """Phases 6 to 11: one configuration through cli.main on the card
    under CUTADAPT_TPU_TORCH_BATCH=require at -j 1, held to the port's
    per-read host path (CUTADAPT_TPU_TORCH_BATCH=0): every file the run
    writes byte for byte (-o, and -p when ``inputs`` holds two files, R1
    and R2, or what ``outputs(directory)`` names; side files named in
    ``args`` as "{out}/name"), and the report's read counts, base-pair
    counts and adapter statistics. ``files`` are written beside the
    inputs, "{tmp}/name" in ``args``; ``chunk_bytes`` sets
    CUTADAPT_TPU_TORCH_CHUNK_BYTES for the phase. A first run,
    TIMED_PASSES timed runs (reads/s through main, the median; a pair
    counts as one read), then one counted run: launch counters at 0 just
    before it, read just after, each launch's shape recorded by task
    (task_of(tables) in `tasks`), every task must launch each lane of
    `lanes` (True: 2-bit, False: 4-bit); the engines that run built then
    take one sequential pass over their side's reads for the host time
    per stage. Returns (recorder, launches (with the wide ones under
    "wide"), reads/s, the median wall time in seconds, the counted run's
    report parts)."""
    import shutil
    import tempfile

    import cutadapt_tpu_torch.adapters as port_adapters
    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx
    from cutadapt_tpu_torch import accel, cli
    from cutadapt_tpu_torch.ops import align_cuda

    n_reads = inputs[0].count(b"\n") // 4
    fallbacks = accel.FALLBACK_COUNT
    saved_chunk = os.environ.pop("CUTADAPT_TPU_TORCH_CHUNK_BYTES", None)
    if chunk_bytes:
        os.environ["CUTADAPT_TPU_TORCH_CHUNK_BYTES"] = str(chunk_bytes)
    if outputs is None:
        def outputs(d):
            outs = ["-o", os.path.join(d, "out.1.fastq")]
            if len(inputs) > 1:
                outs += ["-p", os.path.join(d, "out.2.fastq")]
            return outs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cfg_") as tmp:
        paths = []
        for i, data in enumerate(inputs):
            paths.append(os.path.join(tmp, f"in.{i + 1}.fastq"))
            with open(paths[-1], "wb") as f:
                f.write(data)
        for name, data in (files or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)

        def run(tag, mode):
            os.environ["CUTADAPT_TPU_TORCH_BATCH"] = mode
            # adapters without a name are numbered per process
            port_adapters._adapter_counter = [0]
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            rep = os.path.join(tmp, f"{tag}.json")
            argv = [a.format(tmp=tmp, out=d) for a in args] + outputs(d)
            t0 = time.perf_counter()
            cli.main(argv + ["--json", rep, *paths])
            dt = time.perf_counter() - t0
            got = {}
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), "rb") as f:
                    got[name] = f.read()
            shutil.rmtree(d)
            return got, report_parts(rep), dt

        want, want_rep, dt = run("host", "0")
        log(f"{label}: {n_reads} reads ({sum(map(len, inputs))} bytes in "
            f"{len(inputs)} files) through the per-read host path: "
            f"{dt:.1f} s, {len(want)} files out "
            f"{ {k: len(v) for k, v in list(want.items())[:8]} }, read "
            f"counts {want_rep['read_counts']}, base pairs "
            f"{want_rep['basepair_counts']}")

        def engine_run(tag):
            got, rep, dt = run(tag, "require")
            if sorted(got) != sorted(want):
                fail(f"{label} {tag}: files {sorted(got)} differ from the "
                     f"host path's {sorted(want)}")
            for name, w in want.items():
                g = got[name]
                if g != w:
                    pos = next((i for i, (a, b) in enumerate(zip(g, w))
                                if a != b), min(len(g), len(w)))
                    fail(f"{label} {tag}: {name} differs from the host "
                         f"path at byte {pos} ({len(g)} vs {len(w)} bytes)")
            for key in want_rep:
                if rep[key] != want_rep[key]:
                    fail(f"{label} {tag}: report {key} {rep[key]} differs "
                         f"from the host path's {want_rep[key]}")
            return dt

        dt = engine_run("first")
        log(f"{label}: first main call {dt:.3f} s, {n_reads / dt:.1f} reads/s"
            f", output and report equal to the host path")
        walls = []
        for i in range(TIMED_PASSES):
            accel.reset_flight_metrics()
            walls.append(engine_run(f"timed{i}"))
            log(f"{label} run: {walls[-1]:.3f} s, "
                f"{n_reads / walls[-1]:.1f} reads/s, at most "
                f"{accel.flight_metrics()['max']} chunks in flight")
        walls.sort()
        wall = walls[len(walls) // 2]
        rps = n_reads / wall

        times = accel.RUN_TIMES
        rec = Recorder(bp.locate_packed,
                       warming=lambda: times["device_ready"] is None,
                       task=task_of)
        engines = []
        setup = accel._setup_device

        def kept_setup(*sides, **kw):
            engines.extend(setup(*sides, **kw))
            return engines

        accel._setup_device = kept_setup
        bp.locate_packed = rec
        align_cuda.reset_launch_counters()
        try:
            engine_run("counted")
        finally:
            bp.locate_packed = rec.fn
            accel._setup_device = setup
        launches = dict(align_cuda.LAUNCHES)
        launches["wide"] = dict(align_cuda.WIDE_LAUNCHES)
    os.environ.pop("CUTADAPT_TPU_TORCH_CHUNK_BYTES", None)
    if saved_chunk is not None:
        os.environ["CUTADAPT_TPU_TORCH_CHUNK_BYTES"] = saved_chunk
    if accel.FALLBACK_COUNT != fallbacks:
        fail(f"{label}: {accel.FALLBACK_COUNT - fallbacks} fallbacks "
             f"({accel.LAST_FALLBACK})")
    per_task = {(t, "2-bit" if p2 else "4-bit"): rec.launches(p2, t)
                for t in tasks for p2 in lanes}
    log(f"{label}: one run through main: launches {launches}, of which "
        f"warm-up {rec.warmup}; launches by task and lane {per_task}; per "
        f"shape { {k: rec.calls.count(k) for k in sorted(rec.inputs)} }")
    missing = [k for k, n in per_task.items() if n <= 0]
    if missing:
        fail(f"{label}: these tasks and lanes were never launched: {missing}")
    for side, (engine, data) in enumerate(zip(engines, inputs)):
        chunks, _ = fx.split_records(data, fx.CHUNK_RECORDS)
        stages = stage_breakdown(engine, chunks, n_reads)
        log(f"{label}: the run's engine {side + 1}, one sequential pass in "
            f"chunks of {fx.CHUNK_RECORDS} reads, host ns/read by stage "
            f"{ {k: round(v, 1) for k, v in stages.items()} }")
    log(f"{label}: median {rps:.1f} reads/s through main over "
        f"{TIMED_PASSES} runs")
    return rec, launches, rps, wall, want_rep


def dp_work(enc: np.ndarray, lengths: np.ndarray, tables, pack2: bool):
    """The DP work this batch's data needs: each read runs its active
    columns (min_n, min(max_n, width)] over rows 0..m. Returns (active
    columns, cells of rows 1..m, those of them whose query class matches
    the row, integer operations)."""
    spec = tables.spec
    m, k = tables.m, tables.k
    n = lengths.astype(np.int64)
    per_byte = 4 if pack2 else 2
    bits = 8 // per_byte
    cls = np.stack([(enc >> (t * bits)) & ((1 << bits) - 1)
                    for t in range(per_byte)], axis=2).reshape(len(enc), -1)
    max_n = n if spec.start_in_query else np.minimum(n, m + k)
    min_n = np.zeros_like(n) if spec.stop_in_query else np.maximum(0, n - m - k)
    j_end = np.minimum(max_n, cls.shape[1])
    q = np.arange(cls.shape[1])[None, :]
    active = (q >= min_n[:, None]) & (q < j_end[:, None])
    row_masks = tables.table[:m].astype(np.int64)
    n_eq = np.array([int(((row_masks >> c) & 1).sum()) for c in range(16)])
    cols = int(active.sum())
    cells = cols * m
    eq_cells = int(n_eq[cls[active]].sum())
    ops = (cols * OPS_PER_COLUMN + cells * OPS_PER_CELL
           + (cells - eq_cells) * OPS_PER_MISMATCH)
    return cols, cells, eq_cells, ops


def bound_of(enc, lens, tables, pack2, clock_hz, sms, wide=False):
    """The least time the card needs for one launch on these inputs: the
    larger of the integer operations the data needs (dp_work) at the
    card's int32 rate and the bytes moved (inputs read once, the result,
    2 or 7 int32 per read, written once) at its memory rate. Returns (ms,
    "operations" or "bytes", dp_work's tuple)."""
    work = dp_work(enc.cpu().numpy(), lens.cpu().numpy(), tables, pack2)
    ops_s = work[3] / (sms * INT32_LANES_PER_SM * clock_hz)
    nbytes = enc.numel() + 4 * enc.shape[0] + 4 * len(tables.table) \
        + 4 * (7 if wide else 2) * enc.shape[0]
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes", work)


def kernel_numbers(rec, pack2, clock_hz, sms):
    """Kernel time, bound, time / bound and the error against the plain
    version (on all 7 fields of a wide launch) at every dispatch shape of
    a lane the path launched, with the plain version's time there (one
    run, CUDA events); the device time of all the run's launches."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    shapes = sorted((k for k in rec.inputs if k[0] == pack2),
                    key=lambda s: (-s[1], -s[2]))
    if not shapes:
        fail(f"no {'2-bit' if pack2 else '4-bit'} launch was recorded")
    per_shape = []
    for key in shapes:
        enc, lens, tables = rec.inputs[key]
        wide = key[4]
        unpack = align_cuda.unpack_wide if wide else align_cuda.unpack_result

        def call():
            return align_cuda.locate_packed(enc, lens, tables, pack2,
                                            wide=wide)

        g = unpack(call().cpu().numpy())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = align_cuda.locate_reference(enc, lens, tables, pack2,
                                            wide=wide)
        end.record()
        end.synchronize()
        p = unpack(plain.cpu().numpy())
        diff = fx.first_difference(g, p)
        if diff is not None:
            fail(f"kernel vs plain at the path's shape {key}: {diff}")
        ms = cuda_ms(call, 20 if key[2] < 1024 else 5, graph=True)
        bound_ms, bound_by, work = bound_of(enc, lens, tables, pack2,
                                            clock_hz, sms, wide)
        per_shape.append(dict(
            task=key[3], shape=[key[1], key[2]], wide=wide,
            plain_ms=start.elapsed_time(end),
            launches=rec.calls.count(key), ms=ms,
            bound_ms=bound_ms, bound_by=bound_by, x_bound=ms / bound_ms,
            max_abs_err=max_abs_err(g, p),
            stream_ms=cuda_ms(call, 20 if key[2] < 1024 else 5),
            host_us_per_call=host_us(call, 20),
            dp_cells=work[1], dp_columns=work[0],
            match_share=work[2] / max(work[1], 1),
            ops_per_cell=work[3] / max(work[1], 1),
        ))
    top = per_shape[0]
    lay = align_cuda.kernel_layout(rec.inputs[shapes[0]][2].m)
    return dict(
        shape=top["shape"], ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"],
        max_abs_err=max(d["max_abs_err"] for d in per_shape),
        per_shape=per_shape,
        run_kernel_ms=sum(d["ms"] * d["launches"] for d in per_shape),
        lanes=lay.lanes, rows=lay.rows, mode=lay.mode,
    )


PER_SHAPE_KEYS = ("task", "shape", "wide", "launches", "ms", "plain_ms",
                  "bound_ms", "bound_by", "x_bound", "max_abs_err")


def shape_line(nums) -> str:
    return "; ".join(
        f"{d['task'] + ' ' if d['task'] else ''}"
        f"{'wide ' if d['wide'] else ''}"
        f"{d['shape'][0]}x{d['shape'][1]}: {d['ms']:.4f} ms, bound "
        f"{d['bound_ms']:.5f} ms ({d['bound_by']}), {d['x_bound']:.2f}x, "
        f"{d['launches']} launches, {d['stream_ms']:.4f} ms per launch "
        f"back to back on the stream ({d['host_us_per_call']:.1f} us of "
        f"host time per call), {d['dp_cells']} cells, "
        f"{d['ops_per_cell']:.3f} ops/cell, plain {d['plain_ms']:.1f} ms"
        for d in nums["per_shape"])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(HERE, "cutadapt_tpu_torch"))
            and os.path.exists(os.path.join(HERE, "tests", "torch_fixtures.py"))):
        print("chip_smoke: run it from a checkout of the repository (the "
              "cutadapt_tpu_torch package or tests/torch_fixtures.py is "
              "missing)", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

    import torch_fixtures as fx
    from cutadapt_tpu_torch import native
    from cutadapt_tpu_torch.ops import align_cuda

    log(nvidia_smi("name,power.limit"))
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{sms} SMs, max SM clock {clock_mhz:.0f} MHz")
    if not native.AVAILABLE:
        fail("the native host library (native/hostops.cpp) did not build")

    # 1. build
    align_cuda.build_library()
    info = align_cuda.BUILD_INFO
    log(f"kernel library built in {info['seconds']:.1f} s "
        f"({'cached' if info['cached'] else 'nvcc'}): {info['path']}")
    variants = ptxas_summary(info["log"])
    for v in variants:
        log(f"  ptxas: locate_kernel{v['variant']} (bits, lanes, rows, mode):"
            f" {v.get('registers')} registers, {v.get('stack')} bytes stack,"
            f" {v.get('spill_stores')}/{v.get('spill_loads')} bytes spill "
            f"stores/loads")
    compiled = {tuple(int(x) for x in v["variant"][1:-1].split(","))
                for v in variants}
    if info["log"] and compiled != align_cuda.instantiations():
        fail(f"nvcc compiled the instantiations {sorted(compiled)}, the "
             f"wrapper's kernel_layout picks "
             f"{sorted(align_cuda.instantiations())}")

    # 2. kernel parity
    worst = parity_phase()

    # 3. main path
    engine = fx.make_engine(device="cuda")
    engine.warmup(fx.READ_LEN)
    t0 = time.perf_counter()
    data = fx.make_dataset(N_READS)
    log(f"main path: {N_READS} reads, {len(data) / 1e6:.1f} MB of FASTQ "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    chunks, rec_main, launches_main, main_out, main_matched = drive(
        engine, data, fx.CHUNK_RECORDS, "main path"
    )
    if launches_main["pack2"] <= 0:
        fail("main path: the 2-bit kernel lane was never launched")
    rates = []
    for _ in range(TIMED_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, total, _, _ = run_pass(engine, chunks, False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(N_READS / dt)
        log(f"main path pass: {N_READS / dt:.1f} reads/s ({dt:.3f} s, "
            f"{total} bytes out)")
    rates.sort()
    rps = rates[len(rates) // 2]
    stages = stage_breakdown(engine, chunks, N_READS)
    log(f"main path: sequential pass, host ns/read by stage "
        f"{ {k: round(v, 1) for k, v in stages.items()} } "
        f"(sum {sum(stages.values()):.1f})")
    k2 = kernel_numbers(rec_main, True, clock_mhz * 1e6, sms)
    log(f"main path: median {rps:.1f} reads/s over {TIMED_PASSES} passes; "
        f"2-bit kernel ({k2['lanes']} lanes x {k2['rows']} rows per read) "
        f"{shape_line(k2)}; device kernel time per pass "
        f"{k2['run_kernel_ms']:.4f} ms = "
        f"{k2['run_kernel_ms'] / 1e3 * rps / N_READS * 100:.3f}% of the "
        f"pass wall time; plain {k2['plain_ms']:.3f} ms")

    # 4. dirty lane
    dirty = fx.add_ns(fx.make_dataset(N_DIRTY_READS, seed=777), 0.05)
    _, rec_dirty, launches_dirty, dirty_host, dirty_matched = drive(
        engine, dirty, fx.CHUNK_RECORDS, "dirty lane"
    )
    if launches_dirty["pack4"] <= 0:
        fail("dirty lane: the 4-bit kernel lane was never launched")
    k4 = kernel_numbers(rec_dirty, False, clock_mhz * 1e6, sms)
    log(f"dirty lane: 4-bit kernel {shape_line(k4)}; plain "
        f"{k4['plain_ms']:.3f} ms")

    # 5. cli
    cli_runs = cli_phase({
        "clean": (data, main_out, main_matched),
        "dirty": (dirty, dirty_host, dirty_matched),
    }, rps)
    # each lane at the shapes of the CLI run that carries it: the 2-bit
    # lane on the flagship file, the 4-bit lane on the dirty file
    cli_nums = {}
    for pack2, which in ((True, "clean"), (False, "dirty")):
        rec, launches = cli_runs["windows"][which]
        nums = kernel_numbers(rec, pack2, clock_mhz * 1e6, sms)
        lane = "pack2" if pack2 else "pack4"
        cli_nums[pack2] = dict(
            file=which, launches=launches[lane],
            warmup_launches=rec.warmup[lane],
            golden_launches=cli_runs["golden"][lane],
            max_abs_err=nums["max_abs_err"], plain_ms=nums["plain_ms"],
            per_shape=[{key: d[key] for key in PER_SHAPE_KEYS}
                       for d in nums["per_shape"]],
        )
        log(f"cli, {which} file: {'2-bit' if pack2 else '4-bit'} kernel "
            f"{shape_line(nums)}; plain {nums['plain_ms']:.3f} ms")

    # 6. host stages: the repo's -q 20 -a ADAPTER --poly-a -m 10
    os.environ.pop("CUTADAPT_TPU_TORCH_CHUNK_BYTES", None)
    t0 = time.perf_counter()
    polya = fx.make_reads(N_POLYA_READS, 1, [fx.ADAPTER], polya=True)
    log(f"host stages: {N_POLYA_READS} reads generated "
        f"({time.perf_counter() - t0:.1f} s)")
    rec6, launches6, rps6, _, _ = config_phase(
        "host stages", ["-q", "20", "-a", fx.ADAPTER, "--poly-a", "-m", "10"],
        [polya], lambda tables: "3'", ["3'"],
    )
    del polya
    # 7. linked primers: the 5' phase (PREFIX) launches from submit, the
    # 3' phase (BACK) from collect
    from cutadapt_tpu_torch.adapters import Where

    t0 = time.perf_counter()
    amplicons = fx.make_amplicons(N_AMPLICON_READS)
    log(f"linked primers: {N_AMPLICON_READS} reads generated "
        f"({time.perf_counter() - t0:.1f} s)")
    rec7, launches7, rps7, _, _ = config_phase(
        "linked primers", ["-a", fx.LINKED_PRIMERS, "--discard-untrimmed"],
        [amplicons],
        lambda tables: "5'" if tables.spec.flags == Where.PREFIX.value
        else "3'",
        ["5'", "3'"],
    )
    del amplicons
    # 8. paired TruSeq: R1's adapter launches from the first engine, R2's
    # from the second; the reads' N take each side to the 4-bit lane too
    t0 = time.perf_counter()
    pairs = fx.make_pairs(N_PAIRS)
    log(f"paired: {N_PAIRS} pairs of 2 x {fx.PAIR_READ_LEN} bp generated "
        f"({time.perf_counter() - t0:.1f} s)")
    rec8, launches8, rps8, wall8, _ = config_phase(
        "paired", ["-a", fx.TRUSEQ_R1, "-A", fx.TRUSEQ_R2, "-q", "20",
                   "-m", "20"],
        list(pairs),
        lambda tables: "R1" if tables.spec.reference == fx.TRUSEQ_R1
        else "R2",
        ["R1", "R2"], lanes=(True, False),
    )
    del pairs
    # 9. revcomp amplicons: the forward and the rc dispatch of each chunk
    # both launch from submit
    t0 = time.perf_counter()
    rc_amplicons = fx.make_amplicons(N_RC_AMPLICON_READS, rc_share=0.5)
    log(f"revcomp: {N_RC_AMPLICON_READS} reads, half reverse-complemented, "
        f"generated ({time.perf_counter() - t0:.1f} s)")
    with OrientationTags() as orientation:
        rec9, launches9, rps9, wall9, rep9 = config_phase(
            "revcomp", ["--revcomp", "-g", "^" + fx.PRIMER_515F,
                        "--discard-untrimmed"],
            [rc_amplicons], orientation, ["forward", "rc"],
        )
    del rc_amplicons
    rc_share = rep9["read_counts"]["reverse_complemented"] / N_RC_AMPLICON_READS
    log(f"revcomp: {rep9['read_counts']['reverse_complemented']} reads "
        f"reverse-complemented ({rc_share:.4f} of the reads), equal to the "
        f"host path's")
    if not 0.35 <= rc_share <= 0.65:
        fail(f"revcomp: {rc_share:.4f} of the reads were reverse-"
             f"complemented, not about half")
    # 10. long reads: the flagship adapter on 8,000-32,000 bp reads, the
    # kernel's wide result in both lanes
    t0 = time.perf_counter()
    long_reads = fx.make_long_reads(N_LONG_READS)
    from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk

    long_bases = int(parse_fastq_chunk(long_reads).seq_len.sum())
    log(f"long reads: {N_LONG_READS} reads of "
        f"{fx.LONG_READ_LENGTHS[0]}-{fx.LONG_READ_LENGTHS[1]} bp, "
        f"{long_bases} bases, generated ({time.perf_counter() - t0:.1f} s)")
    rec10, launches10, rps10, wall10, _ = config_phase(
        "long reads", ["-a", fx.ADAPTER, "-e", "0.1", "-O", "3"],
        [long_reads], lambda tables: "3'", ["3'"], lanes=(True, False),
        chunk_bytes=LONG_CHUNK_BYTES,
    )
    del long_reads
    for pack2 in (True, False):
        if rec10.launches(pack2, wide=True) <= 0 or rec10.launches(
                pack2, wide=False):
            fail(f"long reads: the {'2-bit' if pack2 else '4-bit'} lane's "
                 f"launches were not all wide: {rec10.calls}")
    log(f"long reads: median {rps10:.1f} reads/s = {long_bases / wall10:.1f} "
        f"bp/s through main; wide launches {launches10['wide']}")
    # 11. the output side: (a) UMI to header with an info file, (b) barcode
    # demultiplexing of pairs (an indexed host task: no kernel launch)
    t0 = time.perf_counter()
    umi_reads = fx.make_umi_reads(N_UMI_READS)
    log(f"output side: {N_UMI_READS} UMI reads of "
        f"{fx.UMI_LEN + fx.READ_LEN} bp generated "
        f"({time.perf_counter() - t0:.1f} s)")
    rec11, launches11, rps11, wall11, rep11 = config_phase(
        "output side (a)",
        ["-u", str(fx.UMI_LEN), "--rename",
         "{{id}}_{{cut_prefix}} {{comment}}", "-a", fx.ADAPTER,
         "--info-file", "{out}/info.tsv"],
        [umi_reads], lambda tables: "3'", ["3'"],
    )
    del umi_reads
    t0 = time.perf_counter()
    r1, r2, barcodes = fx.make_barcoded_pairs(N_BARCODED_PAIRS)
    log(f"output side: {N_BARCODED_PAIRS} pairs, {fx.N_BARCODES} barcodes, "
        f"generated ({time.perf_counter() - t0:.1f} s)")
    _, launches11b, rps11b, _, rep11b = config_phase(
        "output side (b)",
        ["-e", "0.15", "--no-indels", "-g", "^file:{tmp}/barcodes.fasta"],
        [r1, r2], lambda tables: "", [], lanes=(),
        outputs=lambda d: ["-o", os.path.join(d, "trimmed-{name}.1.fastq"),
                           "-p", os.path.join(d, "trimmed-{name}.2.fastq")],
        files={"barcodes.fasta": barcodes},
    )
    del r1, r2
    if launches11b["pack2"] or launches11b["pack4"]:
        fail(f"output side (b): the indexed barcodes launched the kernel "
             f"{launches11b}")
    routed = rep11b["read_counts"]["read1_with_adapter"]
    if not 0.9 * N_BARCODED_PAIRS <= routed <= N_BARCODED_PAIRS:
        fail(f"output side (b): {routed} pairs carried a barcode, not 95%")
    log(f"output side: (a) {rps11:.1f} reads/s, (b) {rps11b:.1f} pairs/s "
        f"through main, {routed} pairs routed by barcode")
    busy = {}
    path_lanes = {}
    for path, rec, launches, lanes, wall in (
        ("host_stages", rec6, launches6, (True,), None),
        ("linked", rec7, launches7, (True,), None),
        ("paired", rec8, launches8, (True, False), wall8),
        ("revcomp", rec9, launches9, (True,), wall9),
        ("long_reads", rec10, launches10, (True, False), wall10),
        ("output_side", rec11, launches11, (True,), wall11),
    ):
        device_ms = 0.0
        for pack2 in lanes:
            lane = "pack2" if pack2 else "pack4"
            nums = kernel_numbers(rec, pack2, clock_mhz * 1e6, sms)
            log(f"{path}: {'2-bit' if pack2 else '4-bit'} kernel "
                f"{shape_line(nums)}; plain {nums['plain_ms']:.3f} ms")
            if nums["max_abs_err"] != 0:
                fail(f"{path}: the kernel differs from the plain version")
            device_ms += nums["run_kernel_ms"]
            path_lanes.setdefault(pack2, {})[path] = dict(
                launches=launches[lane], warmup_launches=rec.warmup[lane],
                wide_launches=launches["wide"][lane],
                by_task={t: rec.launches(pack2, t)
                         for t in sorted({k[3] for k in rec.calls
                                          if k[0] == pack2})},
                max_abs_err=nums["max_abs_err"], plain_ms=nums["plain_ms"],
                run_kernel_ms=nums["run_kernel_ms"],
                per_shape=[{key: d[key] for key in PER_SHAPE_KEYS}
                           for d in nums["per_shape"]],
            )
        if wall is not None:
            busy[path] = device_ms / 1e3 / wall
            log(f"{path}: device time of the counted run's launches "
                f"{device_ms:.4f} ms against a median wall of {wall:.3f} s: "
                f"idle share {1 - busy[path]:.6f}")
    log(f"host_stages_reads_per_sec {rps6}")
    log(f"linked_reads_per_sec {rps7}")
    log(f"paired_reads_per_sec {rps8}")
    log(f"revcomp_reads_per_sec {rps9}")
    log(f"long_reads_reads_per_sec {rps10}")
    log(f"long_reads_bp_per_sec {long_bases / wall10}")
    log(f"long_reads_idle_share {1 - busy['long_reads']}")
    log(f"output_side_umi_reads_per_sec {rps11}")
    log(f"output_side_demux_pairs_per_sec {rps11b}")

    src = "cutadapt_tpu_torch/csrc/align_locate.cu"
    kernels = []
    for name, lane, launches, nums, pack2 in (
        ("align_locate_pack2", "2-bit", launches_main["pack2"], k2, True),
        ("align_locate_pack4", "4-bit", launches_dirty["pack4"], k4, False),
    ):
        kernels.append(dict(
            name=name, lane=lane, route="cuda", source=src,
            replaces="cutadapt_tpu/ops/align_pallas.py:73",
            launches=launches,
            cli_launches=cli_nums[pack2]["launches"],
            parity="ok",
            max_abs_err=max(worst[pack2], nums["max_abs_err"],
                            cli_nums[pack2]["max_abs_err"]),
            ms=nums["ms"], plain_ms=nums["plain_ms"],
            bound_ms=nums["bound_ms"], bound_by=nums["bound_by"],
            library_ms=None, shape=nums["shape"], lanes=nums["lanes"],
            rows=nums["rows"], per_shape=[
                {key: d[key] for key in PER_SHAPE_KEYS}
                for d in nums["per_shape"]],
            cli=cli_nums[pack2],
        ))
    # the paths of phases 6, 7 and 9 launch the 2-bit lane only (their
    # reads carry no N, or none of another class than the primer's); the
    # 4-bit lane's launches there are the warm-ups
    kernels[0].update(path_lanes[True])
    kernels[1].update(path_lanes[False])
    for path, rec, launches in (("host_stages", rec6, launches6),
                                ("linked", rec7, launches7),
                                ("revcomp", rec9, launches9),
                                ("output_side", rec11, launches11)):
        kernels[1][path] = dict(launches=launches["pack4"],
                                warmup_launches=rec.warmup["pack4"])
    for kernel, lane in zip(kernels, ("pack2", "pack4")):
        kernel["wide_launches"] = dict(
            parity=WIDE_PARITY[lane],
            long_reads=kernel["long_reads"]["wide_launches"],
        )
    log(f"reads_per_sec {rps}")
    # the card again, near the end of the output
    log(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
