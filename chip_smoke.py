#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (cutadapt_tpu_torch) on one NVIDIA GPU.

Phases, each of which must pass:

1. build: compile the aligner's and the scatter kernel's libraries from
   csrc/ with nvcc, one process per source, started together;
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
   512 bp; the byte lane (adapters of more than 16 query classes, one
   query code per byte) on one adapter of lanes x rows - 1 bp for each of
   its register variants (8 x 3 to 32 x 8), a 300 bp one (shared memory)
   and a 4,000 bp one (device scratch), each holding the 16 letters
   ACGTRYKMXSWBDHVN, in the packed and the wide store. Every
   instantiation of the kernel in the library must have run here. Then
   the wide result (the (7, B) store of windows of 2**14 bp
   or more and of adapter-side coordinates) in both lanes, on one spec of
   each layout mode (registers, shared memory, device scratch) and on
   256 reads of 16,400-20,000 bp with the flagship adapter, against the
   plain version on all 7 fields, and the byte lane on 32 reads of
   16,400-20,000 bp. Results are integers: `found` must
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
   launches the kernel from submit, the 3' phase from the engine's
   linked worker, and each must launch the 2-bit lane;
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
   indexed host task, which must launch no kernel;
12. the byte lane: -N -e 0.1 -a ACGTRYKMXSWBDHVNACGT (a 20 bp adapter of
   17 query classes) on 131,072 reads of 100 bp
   (torch_fixtures.make_byte_lane_reads: a quarter carry a prefix of the
   adapter with up to 2 substitutions, 3% carry 1-3 N), held and
   measured as phase 6 (with its start-up); only the byte lane launches;
13. the golden suites: tests/test_commandline.py and tests/test_paired.py
   unedited through the port on the card, in a pytest subprocess with
   the tests/torch_as_jax.py plugin under
   CUTADAPT_TPU_TORCH_BATCH=require; pytest must exit 0 with no fallback
   and no plain run, and kernel launches counted (the subprocess's own
   counted window, read from the plugin's line);
14. the statistics reducer and the device mesh: (a) the scatter
   kernel's batch entry point (csrc/stats_scatter.cu) against its plain
   version, error 0: at 33,000 removal events into a 128 x 64 buffer,
   131,072 written lengths and a 131,072-entry mask (one descriptor
   each), at the flush of one flagship chunk (four buffers, one launch),
   at a long-read removal histogram in direct mode, at more descriptors
   than one launch takes and at an empty batch, with its time, bound and
   the index_put_ calls' time; (b) the flagship file and phase 8's paired
   TruSeq files through main with CUTADAPT_TPU_TORCH_DEVICE_STATS=1,
   every file and the --json report equal to the run without it, one
   fold, one scatter launch per flush with events (one per chunk); (c) a
   mesh of 4 shards on the first min(4, cards) cards, repeated in order
   (set by replacing accel._setup_mesh, as the CPU tests set 8 shards of
   the CPU), on the flagship file and the four pipeline shapes of
   __graft_entry__.py:_dryrun_real_pipeline (torch_fixtures.
   write_mesh_pairs): files and report equal to the one-device run,
   each lane's launches 4 times the one-device run's (warm-ups apart),
   every shard launched, no dispatch left unsharded, one scatter launch
   per flush and shard on the flagship file, reads/s and the flagship's
   idle share; (d) where the machine has 2 or more cards, (c) again
   through CUTADAPT_TPU_TORCH_DEVICES=all; (e) make_sharded_trim_step on
   4 shards of the card(s) equal to the same step on 4 shards of the
   CPU, one scatter launch per shard.
15. the input sharded over processes (parallel/multihost.py): (a)
   --shard i/4 through main in this process on phase 5's flagship file,
   one shard after another, each shard's launches counted (every shard
   must launch the 2-bit lane), the outputs concatenated equal to phase
   5's output byte for byte, merge_statistics of the four pickles (each
   refused if it holds a torch object) equal to phase 5's --json report
   on read counts, base pairs and adapter statistics, each launch shape
   held to the plain version, and the plan pass timed alone; (b) the
   flagship file written 4 times over, run unsharded through python -m
   cutadapt_tpu_torch (output equal to phase 5's output 4 times) and
   through tools/multihost_run_torch.py with 1, 2 and 4 processes at
   once, each output byte-identical and each merged report equal to the
   unsharded run's; reads/s of each, each shard process's seconds, one
   process's start-up, the plan pass, os.cpu_count() and the card's idle
   share estimated from (a)'s kernel time; (c) phase 8's paired files
   through the coordinator on 2 processes with
   CUTADAPT_TPU_TORCH_DEVICE_STATS=1, R1, R2 and the merged report equal
   to phase 8's; (d) two --shard i/2 processes of the flagship file in
   one gloo group (CUTADAPT_TPU_TORCH_DIST_COORDINATOR), both exiting 0
   within 120 s, their outputs concatenated equal to phase 5's; (e)
   tools/kernel_bench_torch.py 32768 20 3, tools/profile_xfer_torch.py,
   tools/profile_batch_torch.py (its submit split on a line of its own)
   and tools/fuzz_parity_torch.py 20 15000 on the card (0 mismatches).
   Every process the phase starts must exit 0 within its time limit.
16. the shared upload: three Illumina 3' adapters (TruSeq, Nextera,
   small RNA; -e 0.1 -O 3) on 262,144 make_reads reads through main as
   phase 6 (its own launches, shapes, times and bounds, reads/s, idle
   share), held to the host path, with the transfer counters of its
   counted run per read and submit's host ns/read split as
   tools/profile_batch_torch.py splits it (the port's stage and launch
   spans); every upload must carry one launch per adapter and feed three
   DP rows per row. A kernel variant launched in the counted run and not
   in its warm-up fails the phase.
17. the port's benchmark programs, each a process at its default size
   (bench_torch.py, the counterpart of bench.py: 1,000,000 flagship
   reads; bench_configs_torch.py, of bench_configs.py: 200,000 reads
   per configuration), together within 300 s: each must exit 0 and
   name this card; bench_torch.py's kernel_parity (tools/
   verify_cuda_torch.py) must be "ok" and its 2-bit kernel must run at
   no less than its bound (x_bound >= 1 / 1.05); bench_configs_torch.py
   must report parity on all five configurations. Both JSON lines are
   logged; the 2-bit kernel's entry gets bench_torch.py's kernel
   section and the launches of its counted pipelined pass under "bench"
   (that process's own counters).

Launch counters are set to 0 just before each counted window (the main
path's warm pass, the dirty lane, each counted CLI run, the golden
cases, the counted runs of phases 6 to 12, the golden suites' process,
each run of phase 14, each shard run of phase 15 (a), the counted runs
of phase 16)
and read just after; each
lane the window carries must have been launched there. Prints the
card's name and power limit, one JSON line with every kernel's numbers
(time, plain time, bound, time / bound and error at every shape the
path launched, and the same for the CLI's shapes under "cli" and for
phases 6 to 11 under "host_stages", "linked", "paired" (by side),
"revcomp" (by orientation), "long_reads" and "output_side"; the wide
launches under "wide_launches"; the golden suites' launches under
"golden_suites_launches"; the byte lane's entry with phase 12's numbers
under "byte_lane"; the launches per shard of phase 14's mesh under
"shard_launches" and by configuration under "mesh"; the scatter kernel's
entry with phase 14's numbers; each kernel's launches per shard of
phase 15 (a) under "sharded"; phase 16's configuration under
"dispatch_modes"; phase 17's under "bench"), the seconds of each phase,
and as the last line {"ok": true, "device": {...}}.

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
# phase 12: the byte lane through main (an adapter of 17 query classes)
N_BYTE_LANE_READS = 131072
# reads of the byte lane's wide parity on 16,400-20,000 bp
PARITY_BYTE_WIDE_READS = 32
# phase 13: the JAX package's golden suites through the port, unedited
GOLDEN_SUITES = ("tests/test_commandline.py", "tests/test_paired.py")
GOLDEN_SUITES_TIMEOUT = 300
# seconds per phase, printed at the end
PHASE_SECONDS = {}
# each configuration phase's start-up: call of main to first chunk
# submitted, in its first engine run
STARTUP_MS = {}
# the host path's files of a configuration phase, by label, where a later
# phase holds its own runs to them (phase 15: phase 8's)
HOST_FILES = {}
HOST_REPORTS = {}


def lane_label(pack2) -> str:
    """The kernel lane of a wrapper's pack2 argument, for the log."""
    return {True: "2-bit", False: "4-bit", None: "byte"}[pack2]


def lane_name(pack2) -> str:
    """The lane's name in the wrapper's counters."""
    from cutadapt_tpu_torch.ops.align_cuda import LANE_NAMES

    return LANE_NAMES[pack2]


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
        self.calls = []  # (lane name, B, Wp, task, wide)
        # (lane name, B, Wp, task, wide) -> (enc, lengths, tables)
        self.inputs = {}
        self.warmup = {"pack2": 0, "pack4": 0, "byte": 0}
        # (lane name, wide, the kernel's instantiation) of the warm-up's
        # launches and of the others: what a launch may need compiled
        self.warm_variants = set()
        self.variants = set()

    @staticmethod
    def variant(tables, pack2, wide):
        from cutadapt_tpu_torch.ops import align_cuda

        return (lane_name(pack2), bool(wide), align_cuda.template_args(
            align_cuda.LANE_BITS[pack2], align_cuda.kernel_layout(tables.m)))

    def launches(self, pack2, task=None, wide=None) -> int:
        return sum(1 for k in self.calls if k[0] == lane_name(pack2)
                   and task in (None, k[3]) and wide in (None, k[4]))

    def __call__(self, enc, lengths, tables, pack2, wide=False):
        if self.warming():
            self.warmup[lane_name(pack2)] += 1
            self.warm_variants.add(self.variant(tables, pack2, wide))
            return self.fn(enc, lengths, tables, pack2, wide=wide)
        key = (lane_name(pack2), enc.shape[0], enc.shape[1],
               self.task(tables), bool(wide))
        self.calls.append(key)
        self.variants.add(self.variant(tables, pack2, wide))
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
    """Both packed lanes on every case, and the byte lane on an adapter of
    each of its instantiations, against the plain version and the scalar
    aligner; every instantiation of the kernel must run. Returns the
    worst error per lane."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    rng = np.random.RandomState(20260816)
    worst = {True: 0, False: 0, None: 0}
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
    runs += byte_parity(rng, worst)
    ran = set(align_cuda.VARIANT_LAUNCHES)
    missing = align_cuda.instantiations() - ran
    if missing or ran - align_cuda.instantiations():
        fail(f"the parity matrix did not run the instantiations "
             f"{sorted(missing)} (ran {sorted(ran)})")
    log(f"kernel parity: all {runs} runs agree, all {len(ran)} "
        f"instantiations ran ({time.perf_counter() - t0:.1f} s)")
    wide_parity(rng, worst)
    return worst


def byte_parity(rng, worst) -> int:
    """The byte lane (adapters of more than 16 query classes) on one
    adapter of lanes x rows - 1 bp for each of its register variants, of
    300 bp (shared memory) and of 4,000 bp (device scratch), each holding
    the 16 letters ACGTRYKMXSWBDHVN: the packed store against the plain
    version and the scalar aligner, the wide store against the plain
    version on all 7 fields. Updates ``worst``; returns the runs."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    t0 = time.perf_counter()
    runs = 0
    for spec in fx.byte_variant_specs():
        tables = align_cuda.make_tables(spec)
        if not tables.byte:
            fail(f"byte parity: {spec.reference[:16]}.. does not take the "
                 f"byte lane")
        lay = align_cuda.kernel_layout(tables.m)
        raw, enc, lens = fx.byte_variant_batch(spec, rng)
        enc_d = torch.from_numpy(enc).cuda()
        len_d = torch.from_numpy(lens).cuda()
        label = (f"{spec.reference[:12]}.. m={tables.m} flags={spec.flags} "
                 f"{len(lens)} reads x {enc.shape[1]} bp byte lane "
                 f"[{lay.lanes} lanes x {lay.rows} rows, {lay.mode}]")
        for wide in (False, True):
            unpack = align_cuda.unpack_wide if wide else \
                align_cuda.unpack_result
            got = align_cuda.locate_packed(enc_d, len_d, tables, None,
                                           wide=wide)
            plain = align_cuda.locate_reference(enc_d, len_d, tables, None,
                                                wide=wide)
            torch.cuda.synchronize()
            g = unpack(got.cpu().numpy())
            p = unpack(plain.cpu().numpy())
            diff = fx.first_difference(g, p)
            if diff is None:
                diff = fx.first_difference(g[:5], fx.scalar_locate(
                    spec, raw, lens))
            if diff is not None:
                fail(f"byte parity {label} {'wide' if wide else 'packed'}: "
                     f"{diff} differs")
            if not g[0].any():
                fail(f"byte parity {label}: no read matched")
            worst[None] = max(worst[None], max_abs_err(g, p))
            runs += 1
        log(f"  byte parity {label}: ok, packed and wide "
            f"({int(g[0].sum())} matches)")
    log(f"byte parity: {runs} runs agree, {len(fx.byte_variant_specs())} "
        f"instantiations ({time.perf_counter() - t0:.1f} s)")
    return runs


def wide_parity(rng, worst) -> None:
    """The wide (7, B) store against the plain version on all 7 fields
    (found everywhere, the others where found) and the first five
    against the scalar aligner: a spec of each layout mode (registers,
    shared memory, device scratch) at 512 bp, and the flagship adapter on
    reads of 2**14 bp or more, in both packed lanes; a byte-lane adapter
    on a few such reads. Updates ``worst``."""
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
    # the byte lane on a few reads of 2**14 bp or more
    byte_spec = fx.byte_lane_specs()[0]
    cases.append((byte_spec, PARITY_BYTE_WIDE_READS, PARITY_WIDE_LENGTHS))
    before = dict(align_cuda.WIDE_LAUNCHES)
    modes = set()
    for spec, B, L in cases:
        tables = align_cuda.make_tables(spec)
        lay = align_cuda.kernel_layout(tables.m)
        for pack2 in (None,) if tables.byte else (True, False):
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
                     f"{B} reads of {L} bp {lane_label(pack2)} "
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
    if modes != set(align_cuda.MODES) or min(
            wide["pack2"], wide["pack4"]) < len(cases) - 1 or wide["byte"] < 1:
        fail(f"wide parity: layout modes {sorted(modes)}, wide launches "
             f"{wide}")
    WIDE_PARITY.update(wide)
    log(f"wide parity: {sum(wide.values())} runs agree, every layout mode, "
        f"wide launches {wide} ({time.perf_counter() - t0:.1f} s)")


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

        reports = {}

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
            reports[tag] = report_parts(rep)
            matched = reports[tag]["read_counts"]["read1_with_adapter"]
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
            walls.append(run(f"timed{i}")[1])
            log(f"cli run: {walls[-1]:.3f} s, {N_READS / walls[-1]:.1f} "
                f"reads/s")
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
        if min(golden["pack2"], golden["pack4"]) <= 0:
            fail(f"cli golden cases: a packed kernel lane was never "
                 f"launched: {golden}")
        log(f"cli: all {ran} golden cases (single-end and paired) "
            f"byte-identical on the card; "
            f"their launches (warm-ups included) {golden}")
    if accel.FALLBACK_COUNT != fallbacks:
        fail(f"cli: {accel.FALLBACK_COUNT - fallbacks} fallbacks "
             f"({accel.LAST_FALLBACK})")
    return dict(windows=windows, golden=golden,
                report=reports["counted_clean"])


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
                 outputs=None, files=None, chunk_bytes=None, keep=False,
                 probe=None):
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
    report parts). With ``keep``, the host path's files and report parts
    stay in HOST_FILES[label] and HOST_REPORTS[label] for a later phase.
    ``probe`` (phase 16, a DispatchProbe) is entered around the counted
    run and around each engine's sequential pass."""
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
        # seconds from the call of main to its first chunk submitted
        started = {}

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
            if mode != "0":
                started[tag] = accel.RUN_TIMES["first_submit"] - t0
            return got, report_parts(rep), dt

        want, want_rep, dt = run("host", "0")
        log(f"{label}: {n_reads} reads ({sum(map(len, inputs))} bytes "
            f"in {len(inputs)} files) through the per-read host path: "
            f"{dt:.1f} s, {len(want)} files out "
            f"{ {k: len(v) for k, v in list(want.items())[:8]} }, read "
            f"counts {want_rep['read_counts']}, base pairs "
            f"{want_rep['basepair_counts']}")
        if keep:
            HOST_FILES[label], HOST_REPORTS[label] = want, want_rep

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
            f", output and report equal to the host path; start-up (call to "
            f"first chunk submitted) {started['first'] * 1e3:.1f} ms")
        walls = []
        for i in range(TIMED_PASSES):
            walls.append(engine_run(f"timed{i}"))
            log(f"{label} run: {walls[-1]:.3f} s, "
                f"{n_reads / walls[-1]:.1f} reads/s")
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
            if probe is None:
                engine_run("counted")
            else:
                with probe.counting(times):
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
    per_task = {(t, lane_label(p2)): rec.launches(p2, t)
                for t in tasks for p2 in lanes}
    log(f"{label}: one run through main: launches {launches}, of which "
        f"warm-up {rec.warmup}; launches by task and lane {per_task}; per "
        f"shape { {k: rec.calls.count(k) for k in sorted(rec.inputs)} }")
    missing = [k for k, n in per_task.items() if n <= 0]
    if missing:
        fail(f"{label}: these tasks and lanes were never launched: {missing}")
    for side, (engine, data) in enumerate(zip(engines, inputs)):
        chunks, _ = fx.split_records(data, fx.CHUNK_RECORDS)
        if probe is None:
            stages = stage_breakdown(engine, chunks, n_reads)
        else:
            with probe.splitting(n_reads):
                stages = stage_breakdown(engine, chunks, n_reads)
        log(f"{label}: the run's engine {side + 1}, one sequential pass in "
            f"chunks of {fx.CHUNK_RECORDS} reads, host ns/read by stage "
            f"{ {k: round(v, 1) for k, v in stages.items()} }")
    log(f"{label}: median {rps:.1f} reads/s through main over "
        f"{TIMED_PASSES} runs")
    STARTUP_MS[label] = started["first"] * 1e3
    return rec, launches, rps, wall, want_rep


def golden_suites_phase() -> dict:
    """Phase 13: the JAX package's golden suites (tests/test_commandline.py,
    tests/test_paired.py) unedited through the port on the card, in a
    pytest subprocess with the torch_as_jax plugin (their cutadapt_tpu
    imports resolve to cutadapt_tpu_torch) under
    CUTADAPT_TPU_TORCH_BATCH=require, the device left as CUDA. Fails
    unless pytest exits 0, no fallback was counted, kernel launches were
    counted and the plain version never ran. Returns the plugin's counts,
    the subprocess's own counted window."""
    tests = os.path.join(HERE, "tests")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUTADAPT_TPU_TORCH_DEVICE",
                        "CUTADAPT_TPU_TORCH_CHUNK_BYTES")}
    env["CUTADAPT_TPU_TORCH_BATCH"] = "require"
    env["PYTHONPATH"] = os.pathsep.join(
        [tests, HERE] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "torch_as_jax"]
            + [os.path.join(HERE, suite) for suite in GOLDEN_SUITES],
            cwd=HERE, env=env, capture_output=True, text=True,
            timeout=GOLDEN_SUITES_TIMEOUT,
        )
    except subprocess.TimeoutExpired:
        fail(f"golden suites: pytest did not end within "
             f"{GOLDEN_SUITES_TIMEOUT} s")
    dt = time.perf_counter() - t0
    summary = next((ln for ln in proc.stdout.splitlines()[::-1]
                    if " passed" in ln), "")
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("torch_as_jax {")), None)
    if proc.returncode != 0 or line is None or " failed" in summary:
        fail(f"golden suites: pytest exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    counts = json.loads(line.split(" ", 1)[1])
    counts["summary"] = summary.strip()
    if counts["fallbacks"] or sum(counts["plain_runs"].values()) or not sum(
            counts["launches"].values()):
        fail(f"golden suites: fallbacks, plain runs or no launches {counts}")
    log(f"golden suites: {' and '.join(GOLDEN_SUITES)} unedited through the "
        f"port on the card in {dt:.1f} s: {summary.strip()}; launches "
        f"{counts['launches']} (wide {counts['wide_launches']}), no "
        f"fallback, no plain run")
    counts["seconds"] = dt
    return counts


# phase 14: the statistics reducer and the device mesh
SCATTER_HIST2D = (128, 64)
N_SCATTER_REMOVALS = 33000
N_SCATTER_EVENTS = 131072
# a long-read removal histogram: past the cluster's shared memory, so the
# kernel bins it in direct mode
SCATTER_LONG_HIST2D = (32768, 64)
N_SCATTER_LONG_REMOVALS = 8192
MESH_SHARDS = 4
MESH_PAIRS = 700
# the sharded trim step's batch (4 shards of 1024 reads of 100 bp)
STEP_READS = 4096
STEP_READ_LEN = 100


def scatter_bytes(descs) -> int:
    """The bytes a batch must move: each event array read once, each
    buffer read and written once."""
    return sum(4 * sum(a.numel() for a in d[1:] if a is not None)
               + 2 * 4 * d[0].numel() for d in descs)


def scatter_phase():
    """14 (a): the batch kernel against its plain version on the same
    CUDA tensors (tolerance: exact), at three single-buffer shapes
    through the one-descriptor names (removal events into a 128 x 64
    buffer, written lengths into a 1-D one, a mask's popcount), at the
    flush of one flagship chunk (removals, adjacent bases, the weighted
    written-length bins and a mask in one launch), at a long-read removal
    histogram in direct mode beside a cluster-mode one, at more
    descriptors than one launch takes, and at an empty batch (no
    launch). Times from CUDA events (the kernel in a CUDA graph and on
    the stream; the plain version and the library call,
    index_put_(accumulate=True) per buffer or a sum, on the stream); the
    bound from the bytes the batch must move at the card's memory
    rate."""
    import torch

    from cutadapt_tpu_torch.ops import stats_cuda as sc
    from cutadapt_tpu_torch.ops.align_cuda import PEAK_BYTES_PER_S

    rng = np.random.RandomState(14)
    dev = torch.device("cuda", 0)
    R, C = SCATTER_HIST2D

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def buf(shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def removals(n, rows):
        return (t(np.minimum(rng.geometric(0.08, n), rows - 1)),
                t(np.minimum(rng.geometric(0.6, n) - 1, 3)))

    n2, n1 = N_SCATTER_REMOVALS, N_SCATTER_EVENTS
    written = rng.randint(0, 101, n1)
    hist = np.bincount(written)
    nz = np.flatnonzero(hist)
    mask = t(rng.rand(n1) < 0.25)
    LR, LC = SCATTER_LONG_HIST2D
    nl = N_SCATTER_LONG_REMOVALS
    # a 1-D buffer one bin past the cluster's shared memory: direct mode
    big = sc.CLUSTER * sc.MAX_BINS_PER_BLOCK + 1
    many_bufs = [(5,), (128,), (R, C), (big,)] * 6
    cases = [
        # one descriptor each, with their 0/1 weights, as a one-buffer
        # kernel would bin them
        ("hist2d", [(buf((R, C)), *removals(n2, R), t(np.ones(n2)))]),
        ("hist1d", [(buf((R,)), t(written), t(np.ones(n1)))]),
        ("count", [(buf(()), mask)]),
        # one flagship chunk's flush, as the reducer stages it
        ("flush", [(buf((R, C)), *removals(n2, R), None),
                   (buf((64,)), t(rng.randint(0, 5, n2)), None),
                   (buf((R,)), t(nz), t(hist[nz])),
                   (buf(()), mask)]),
        ("direct", [(buf((LR, LC)), *removals(nl, LR), None),
                    (buf((3 * 64, C)), *removals(n2, 3 * 64), None)]),
        ("many", [(buf(shape), *(removals(500, shape[0])
                                 if len(shape) == 2 else
                                 (t(rng.randint(0, shape[0], 500)),)),
                   t(rng.randint(0, 3, 500)))
                  for shape in many_bufs] + [(buf((R,)), t([]), None)]),
        ("hist2d", [(buf((R, C)), t([]), t([]), t([]))]),
    ]
    out = []
    for name, descs in cases:
        plan = sc.plan_batch([(d[0].numel(), (d[-1] if d[-1] is not None
                                              else d[1]).numel())
                              for d in descs])
        want = [(d[0].clone(),) + tuple(d[1:]) for d in descs]
        before = dict(sc.LAUNCHES)
        modes_before = dict(sc.DESCRIPTORS)
        sc.scatter_add_batch(descs)
        sc.scatter_add_batch_reference(want)
        torch.cuda.synchronize()
        if sc.LAUNCHES["batch"] - before["batch"] != len(plan):
            fail(f"scatter {name}: {sc.LAUNCHES['batch'] - before['batch']} "
                 f"launches where the plan has {len(plan)}")
        modes = {m: sc.DESCRIPTORS[m] - modes_before[m] for m in sc.MODES}
        err = max((int((d[0].long() - w[0].long()).abs().max())
                   for d, w in zip(descs, want)), default=0)
        if err or not all(torch.equal(d[0], w[0])
                          for d, w in zip(descs, want)):
            fail(f"scatter {name}: the kernel differs from the plain "
                 f"version by up to {err}")
        events = sum((d[-1] if d[-1] is not None else d[1]).numel()
                     for d in descs)
        nums = dict(entry=name, events=events, descriptors=len(descs),
                    buffers=[list(d[0].shape) for d in descs],
                    launches=len(plan), modes=modes, max_abs_err=err)
        if plan:
            bufs = [d[0] for d in descs]
            lib_args = [(d[0], tuple(a.long() for a in d[1:-1]),
                         d[-1] if d[-1] is not None else
                         torch.ones_like(d[1])) for d in descs]

            def kernel():
                sc.scatter_add_batch(descs)

            def plain():
                sc.scatter_add_batch_reference(descs)

            def library():
                # one PyTorch call per buffer, as a user would write it
                for b, idx, w in lib_args:
                    if idx:
                        b.index_put_(idx, w, accumulate=True)
                    else:
                        b.add_(w.sum())

            nbytes = scatter_bytes(descs)
            nums.update(
                ms=cuda_ms(kernel, 50, graph=True),
                stream_ms=cuda_ms(kernel, 50),
                plain_ms=cuda_ms(plain, 20),
                library_ms=cuda_ms(library, 20),
                bytes=nbytes,
                bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                host_us_per_call=host_us(kernel, 50),
            )
            nums["x_bound"] = nums["ms"] / nums["bound_ms"]
            for b in bufs:
                b.zero_()
        if name == "flush":
            nums["reducer_us_per_chunk"] = reducer_chunk_us(descs)
        out.append(nums)
        log(f"scatter {name}: {len(descs)} descriptor(s), {events} events "
            f"into {nums['buffers'][:4]}{' ...' if len(descs) > 4 else ''} "
            f"equal the plain version; {len(plan)} launch(es), modes "
            f"{modes}" + (
                f"; {nums['ms'] * 1e3:.2f} us per call (graph; "
                f"{nums['stream_ms'] * 1e3:.2f} us on the stream, "
                f"{nums['host_us_per_call']:.1f} us of host time per call), "
                f"bound {nums['bound_ms'] * 1e3:.3f} us ({nums['bytes']} "
                f"bytes), {nums['x_bound']:.1f}x; plain "
                f"{nums['plain_ms'] * 1e3:.1f} us, index_put_ per buffer "
                f"{nums['library_ms'] * 1e3:.1f} us"
                if plan else " (no launch)") + (
                f"; the reducer's adds and flush of these events "
                f"{nums['reducer_us_per_chunk']:.1f} us of host time per "
                f"chunk" if name == "flush" else ""))
    if not any(d["modes"]["direct"] for d in out):
        fail("scatter: no descriptor ran in direct mode")
    return out


def reducer_chunk_us(descs) -> float:
    """Host microseconds per chunk of a DeviceStatsReducer on the card
    that stages one chunk's events (the flush case's, from the host, as
    the engine hands them over) and flushes them: the adds, the packing
    into pinned memory, the upload and the launch."""
    from cutadapt_tpu_torch.parallel import DeviceStatsReducer

    hist2d, adj, written, count = (
        [None if a is None else a.cpu().numpy() for a in d[1:]]
        for d in descs)
    red = DeviceStatsReducer(device="cuda")

    def chunk():
        red.add_hist2d("rm", hist2d[0], hist2d[1], lambda h: None)
        red.add_hist1d("adj", adj[0], lambda h: None)
        red.add_hist1d("wl", written[0], lambda h: None, weights=written[1])
        red.add_count("flt", count[0], lambda n: None)
        red.flush()

    us = host_us(chunk, 50)
    red.fold()
    return us


def sharded_step_phase() -> dict:
    """14 (e): make_sharded_trim_step on MESH_SHARDS shards of the
    card(s) against the same step on MESH_SHARDS shards of the CPU (the
    plain versions): every field equal, and each shard's seven buffers
    binned in one scatter launch."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.adapters import Where
    from cutadapt_tpu_torch.ops import stats_cuda
    from cutadapt_tpu_torch.ops.align_batch import AlignerSpec
    from cutadapt_tpu_torch.parallel import make_mesh, make_sharded_trim_step

    rng = np.random.RandomState(15)
    reads = np.frombuffer(b"ACGT", np.uint8)[
        rng.randint(0, 4, (STEP_READS, STEP_READ_LEN))].copy()
    ad = np.frombuffer(fx.ADAPTER.encode(), np.uint8)
    for i in range(0, STEP_READS, 4):
        pos = rng.randint(0, STEP_READ_LEN - 4)
        take = min(len(ad), STEP_READ_LEN - pos)
        reads[i, pos:pos + take] = ad[:take]
    lengths = rng.randint(30, STEP_READ_LEN + 1, STEP_READS).astype(np.int32)
    spec = AlignerSpec(reference=fx.ADAPTER, max_error_rate=0.1,
                       flags=Where.BACK.value, min_overlap=3)
    cards = min(MESH_SHARDS, torch.cuda.device_count())
    card_mesh = make_mesh([torch.device("cuda", i % cards)
                           for i in range(MESH_SHARDS)])
    want = make_sharded_trim_step(spec, make_mesh(["cpu"] * MESH_SHARDS),
                                  STEP_READ_LEN, min_length=20)(reads, lengths)
    stats_cuda.reset_launch_counters()
    got = make_sharded_trim_step(spec, card_mesh, STEP_READ_LEN,
                                 min_length=20)(reads, lengths)
    launches = dict(stats_cuda.LAUNCHES)
    if launches != {"batch": MESH_SHARDS}:
        fail(f"sharded trim step: scatter launches {launches}, not one per "
             f"shard")
    same = (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and sorted(got[2]) == sorted(want[2])
            and all(np.array_equal(got[2][k], w) for k, w in want[2].items()))
    if not same:
        fail("sharded trim step: the card's result differs from the CPU's")
    log(f"sharded trim step on {MESH_SHARDS} shards of {cards} card(s): "
        f"every field equal to the CPU shards'; scatter launches {launches} "
        f"({stats_cuda.DESCRIPTORS['cluster']} cluster-mode descriptors)")
    return dict(scatter_launches=launches["batch"], shards=MESH_SHARDS)


class MainRuns:
    """Runs of cli.main for phase 14, each in a directory of its own with
    its own environment, counted: launch counters at 0 just before the
    call, the engine's warm-up launches (made inside _setup_device) kept
    apart, shard and scatter counters and the reducer's flushes (those
    that had events staged) read just after."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.n = 0

    def __call__(self, args_of, env, label, record=None):
        import cutadapt_tpu_torch.adapters as port_adapters
        import cutadapt_tpu_torch.batch_pipeline as bp
        import torch_fixtures as fx
        from cutadapt_tpu_torch import accel, cli
        from cutadapt_tpu_torch.ops import align_cuda, stats_cuda
        from cutadapt_tpu_torch.parallel import stats

        self.n += 1
        d = os.path.join(self.tmp, f"run{self.n}")
        os.makedirs(d)
        rep = os.path.join(d, "report.json")
        keys = ("CUTADAPT_TPU_TORCH_DEVICES", "CUTADAPT_TPU_TORCH_DEVICE_STATS",
                "CUTADAPT_TPU_TORCH_BATCH")
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update(CUTADAPT_TPU_TORCH_BATCH="require", **env)
        for k in keys:
            if k not in env and k != "CUTADAPT_TPU_TORCH_BATCH":
                os.environ.pop(k, None)
        warm = {}
        setup = accel._setup_device

        def counted_setup(*a, **kw):
            engines = setup(*a, **kw)
            warm.update(align_cuda.LAUNCHES)
            return engines

        flushes = {"calls": 0, "with_events": 0}
        flush = stats.DeviceStatsReducer.flush

        def counted_flush(red):
            flushes["calls"] += 1
            flushes["with_events"] += bool(red._staged)
            return flush(red)

        port_adapters._adapter_counter = [0]
        fallbacks = accel.FALLBACK_COUNT
        folds = stats.FOLDS
        accel._setup_device = counted_setup
        stats.DeviceStatsReducer.flush = counted_flush
        if record is not None:
            bp.locate_packed = record
        align_cuda.reset_launch_counters()
        stats_cuda.reset_launch_counters()
        bp.reset_shard_counters()
        try:
            t0 = time.perf_counter()
            cli.main(args_of(d) + ["--json", rep])
            dt = time.perf_counter() - t0
        finally:
            accel._setup_device = setup
            stats.DeviceStatsReducer.flush = flush
            if record is not None:
                bp.locate_packed = record.fn
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if accel.FALLBACK_COUNT != fallbacks:
            fail(f"{label}: fell back to the host path "
                 f"({accel.LAST_FALLBACK})")
        files = {}
        for name in sorted(os.listdir(d)):
            if name != "report.json":
                with open(os.path.join(d, name), "rb") as f:
                    files[name] = f.read()
        lanes = ("pack2", "pack4", "byte")
        return dict(
            files=files, report=fx.json_report(rep), seconds=dt,
            launches={k: align_cuda.LAUNCHES[k] - warm.get(k, 0)
                      for k in lanes},
            warmup_launches={k: warm.get(k, 0) for k in lanes},
            shard_launches=dict(bp.SHARD_LAUNCHES),
            unsharded=bp.UNSHARDED_DISPATCHES,
            scatter_launches=dict(stats_cuda.LAUNCHES),
            scatter_descriptors=dict(stats_cuda.DESCRIPTORS),
            scatter_plain_runs=sum(stats_cuda.PLAIN_RUNS.values()),
            folds=stats.FOLDS - folds, flushes=flushes["with_events"],
            flush_calls=flushes["calls"],
        )


def same_run(label, got, want) -> None:
    """Every file and the --json report of two runs equal."""
    if sorted(got["files"]) != sorted(want["files"]):
        fail(f"{label}: files {sorted(got['files'])} differ from "
             f"{sorted(want['files'])}")
    for name, w in want["files"].items():
        g = got["files"][name]
        if g != w:
            pos = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                       min(len(g), len(w)))
            fail(f"{label}: {name} differs at byte {pos} ({len(g)} vs "
                 f"{len(w)} bytes)")
    if got["report"] != want["report"]:
        diff = [k for k in want["report"]
                if got["report"].get(k) != want["report"][k]]
        fail(f"{label}: the --json report differs in {diff}")
    if got["scatter_plain_runs"]:
        fail(f"{label}: the scatter kernel's plain version ran on the card")


def reducer_mesh_phase(data, pairs, clock_hz, sms) -> dict:
    """Phase 14 (b)-(d): the reducer forced on one card, the mesh of
    MESH_SHARDS shards on the first min(MESH_SHARDS, cards) cards,
    repeated in order, and where the machine has 2 or more cards the
    mesh of CUTADAPT_TPU_TORCH_DEVICES=all, each held to the one-device
    run on every file and the report."""
    import shutil
    import tempfile

    import torch

    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx
    from cutadapt_tpu_torch import accel
    from cutadapt_tpu_torch.parallel import Mesh

    result = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        run = MainRuns(tmp)
        flag = os.path.join(tmp, "flagship.fastq")
        with open(flag, "wb") as f:
            f.write(data)
        p1, p2 = (os.path.join(tmp, f"truseq.{k}.fastq") for k in (1, 2))
        for path, side in zip((p1, p2), pairs):
            with open(path, "wb") as f:
                f.write(side)
        n_flag = data.count(b"\n") // 4
        n_pairs = pairs[0].count(b"\n") // 4

        def flagship(d):
            return ["--quiet", "-a", fx.ADAPTER, "-e", "0.1", "-O", "3",
                    "-o", os.path.join(d, "out.fastq"), flag]

        def truseq(d):
            return ["--quiet", "-a", fx.TRUSEQ_R1, "-A", fx.TRUSEQ_R2,
                    "-q", "20",
                    "-m", "20", "-o", os.path.join(d, "out.1.fastq"),
                    "-p", os.path.join(d, "out.2.fastq"), p1, p2]

        # (b) the reducer forced on one card
        env1 = {"CUTADAPT_TPU_TORCH_DEVICES": "1"}
        forced = {}
        for label, args_of, n in (("flagship", flagship, n_flag),
                                  ("paired TruSeq", truseq, n_pairs)):
            base = run(args_of, env1, f"reducer {label}")
            red = run(args_of, {**env1, "CUTADAPT_TPU_TORCH_DEVICE_STATS": "1"},
                      f"reducer {label}")
            same_run(f"reducer {label}", red, base)
            if base["folds"] or sum(base["scatter_launches"].values()):
                fail(f"reducer {label}: the reducer ran without a mesh or "
                     f"CUTADAPT_TPU_TORCH_DEVICE_STATS=1")
            # one launch per chunk: every emit flushes its chunk's events
            if (red["folds"] != 1 or red["flushes"] <= 0
                    or red["scatter_launches"]["batch"] != red["flushes"]):
                fail(f"reducer {label}: folds {red['folds']}, scatter "
                     f"launches {red['scatter_launches']}, flushes with "
                     f"events {red['flushes']}")
            if red["launches"] != base["launches"]:
                fail(f"reducer {label}: aligner launches {red['launches']} "
                     f"differ from {base['launches']}")
            forced[label] = dict(
                scatter_launches=red["scatter_launches"],
                scatter_descriptors=red["scatter_descriptors"],
                flushes=red["flushes"], flush_calls=red["flush_calls"],
                reads_per_sec=n / red["seconds"],
                reads_per_sec_without=n / base["seconds"],
            )
            log(f"reducer forced on one card, {label}: files and report "
                f"equal to the run without it; scatter launches "
                f"{red['scatter_launches']} (descriptors "
                f"{red['scatter_descriptors']}) for {red['flushes']} flushes "
                f"with events of {red['flush_calls']}, one fold; "
                f"{n / red['seconds']:.1f} reads/s against "
                f"{n / base['seconds']:.1f} without")
        result["forced"] = forced

        # (c) MESH_SHARDS shards on the first min(MESH_SHARDS, cards)
        # cards, repeated: the mesh set as the CPU tests set it
        cards = min(MESH_SHARDS, torch.cuda.device_count())
        mesh_devices = [torch.device("cuda", i % cards)
                        for i in range(MESH_SHARDS)]

        def patched_mesh(device):
            bp.set_shard_mesh(Mesh(mesh_devices))

        shapes_dir = os.path.join(tmp, "pairs")
        os.makedirs(shapes_dir)
        files = fx.write_mesh_pairs(shapes_dir, n_pairs=MESH_PAIRS)
        configs = [("flagship file", flagship, n_flag)] + [
            (shape, (lambda s: lambda d: fx.mesh_shape_args(s, files, d))(
                shape), MESH_PAIRS) for shape in fx.MESH_SHAPES]
        singles = {}
        shard_totals = {}
        per_config = {}
        setup_mesh = accel._setup_mesh
        for label, args_of, n in configs:
            singles[label] = base = run(args_of, env1, f"mesh {label}")
            rec = None
            if label == "flagship file":
                rec = Recorder(bp.locate_packed,
                               warming=lambda: accel.RUN_TIMES[
                                   "device_ready"] is None)
            accel._setup_mesh = patched_mesh
            try:
                got = run(args_of, {}, f"mesh {label}", record=rec)
            finally:
                accel._setup_mesh = setup_mesh
                bp.set_shard_mesh(None)
            same_run(f"mesh {label}", got, base)
            want = {k: MESH_SHARDS * v for k, v in base["launches"].items()}
            if got["launches"] != want:
                fail(f"mesh {label}: launches {got['launches']}, not "
                     f"{MESH_SHARDS} x the one-device run's "
                     f"{base['launches']}")
            if got["unsharded"]:
                fail(f"mesh {label}: {got['unsharded']} dispatches did not "
                     f"divide over the mesh")
            if got["folds"] != 1:
                fail(f"mesh {label}: the reducer folded {got['folds']} times")
            # one launch per flush and shard that holds events: every
            # shard on the flagship file's chunks
            sl = got["scatter_launches"]["batch"]
            if not (got["flushes"] <= sl <= MESH_SHARDS * got["flushes"]) or (
                    label == "flagship file"
                    and sl != MESH_SHARDS * got["flushes"]):
                fail(f"mesh {label}: {sl} scatter launches for "
                     f"{got['flushes']} flushes on {MESH_SHARDS} shards")
            for i, c in got["shard_launches"].items():
                shard_totals[i] = shard_totals.get(i, 0) + c
            per_config[label] = dict(
                launches=got["launches"], one_device_launches=base["launches"],
                warmup_launches=got["warmup_launches"],
                shard_launches=got["shard_launches"],
                scatter_launches=got["scatter_launches"],
                flushes=got["flushes"],
                reads_per_sec=n / got["seconds"],
                one_device_reads_per_sec=n / base["seconds"],
            )
            log(f"mesh of {MESH_SHARDS} shards on {cards} card(s), {label}: "
                f"files and report equal to the one-device run; launches "
                f"{got['launches']} = {MESH_SHARDS} x {base['launches']}, "
                f"warm-up {got['warmup_launches']}, per shard "
                f"{got['shard_launches']}, scatter {got['scatter_launches']}; "
                f"{n / got['seconds']:.1f} reads/s against "
                f"{n / base['seconds']:.1f} on one device")
            if rec is not None:
                nums = kernel_numbers(rec, True, clock_hz, sms)
                if nums["max_abs_err"]:
                    fail("mesh flagship: the kernel differs from the plain "
                         "version")
                busy = nums["run_kernel_ms"] / 1e3 / got["seconds"]
                per_config[label].update(
                    idle_share=1 - busy, device_ms=nums["run_kernel_ms"],
                    per_shape=[{k: d[k] for k in PER_SHAPE_KEYS}
                               for d in nums["per_shape"]])
                log(f"mesh flagship: 2-bit kernel {shape_line(nums)}; device "
                    f"time {nums['run_kernel_ms']:.4f} ms against "
                    f"{got['seconds']:.3f} s of wall: idle share "
                    f"{1 - busy:.6f}")
        if sorted(shard_totals) != list(range(MESH_SHARDS)) or min(
                shard_totals.values()) <= 0:
            fail(f"mesh: launches per shard {shard_totals}")
        result["mesh"] = dict(shards=MESH_SHARDS, cards=cards,
                              shard_launches=shard_totals,
                              configs=per_config)

        # (d) one shard per card, through the user's variable
        if torch.cuda.device_count() >= 2:
            all_totals = {}
            for label, args_of, n in configs:
                got = run(args_of, {"CUTADAPT_TPU_TORCH_DEVICES": "all"},
                          f"all cards {label}")
                same_run(f"all cards {label}", got, singles[label])
                for i, c in got["shard_launches"].items():
                    all_totals[i] = all_totals.get(i, 0) + c
            if len(all_totals) != torch.cuda.device_count() or min(
                    all_totals.values()) <= 0:
                fail(f"all cards: launches per shard {all_totals}")
            result["all_cards"] = all_totals
            log(f"mesh over all {torch.cuda.device_count()} cards "
                f"(CUTADAPT_TPU_TORCH_DEVICES=all): every run equal to the "
                f"one-device run; launches per card {all_totals}")
        else:
            result["all_cards"] = None
            log("mesh over all cards (CUTADAPT_TPU_TORCH_DEVICES=all): not "
                "run, this machine has one card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if bp.UNSHARDED_DISPATCHES:
        fail(f"{bp.UNSHARDED_DISPATCHES} dispatches did not divide over "
             f"the mesh")
    return result


# phase 15: input sharding over processes (parallel/multihost.py)
SHARDS = 4
# (b)'s file: the flagship file written this many times over
SHARD_COPIES = 4
SHARD_PROCESS_COUNTS = (1, 2, 4)
# every process phase 15 starts must end within this many seconds
SHARD_TIMEOUT = 120
# the measurement tools' own limit (fuzz_parity_torch.py runs 20
# iterations of two main calls each)
TOOL_TIMEOUT = 300
FUZZ_ITERATIONS = 20
FUZZ_SEED = 15000


def subprocess_env(**extra) -> dict:
    """The environment of a process phase 15 starts: none of the
    CUTADAPT_TPU_* variables this process has set, the checkout first on
    the path, ``extra`` on top."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CUTADAPT_TPU")}
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(extra)
    return env


def run_process(label, cmd, env, timeout=SHARD_TIMEOUT, cwd=None):
    """Run cmd to its end; fails the smoke run on a non-zero exit or when
    it outlives ``timeout`` (killed then). Returns (stdout, stderr,
    seconds)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout, cwd=cwd or HERE)
    except subprocess.TimeoutExpired:
        fail(f"{label}: did not end within {timeout} s")
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr, dt


def tagged_json(label, text, tag) -> dict:
    """The JSON object of the line ``<tag> {...}`` in a tool's output."""
    line = next((ln for ln in text.splitlines()[::-1]
                 if ln.startswith(tag + " {")), None)
    if line is None:
        fail(f"{label}: no '{tag} {{...}}' line in its output:\n"
             f"{text[-2000:]}")
    return json.loads(line.split(" ", 1)[1])


def same_file(label, path, want: bytes, copies: int = 1) -> None:
    """The file at ``path`` is ``want`` repeated ``copies`` times, read
    a copy at a time."""
    with open(path, "rb") as f:
        for i in range(copies):
            got = f.read(len(want))
            if got != want:
                pos = next((j for j, (a, b) in enumerate(zip(got, want))
                            if a != b), min(len(got), len(want)))
                fail(f"{label}: copy {i} differs at byte {pos} ({len(got)} "
                     f"vs {len(want)} bytes)")
        if f.read(1):
            fail(f"{label}: longer than {copies} x {len(want)} bytes")


def stats_parts(stats, paired) -> dict:
    """The report parts of a Statistics (as report_parts reads them from
    a --json file), its adapters' names aside: unnamed adapters are
    numbered per process."""
    from cutadapt_tpu_torch import cli

    rep = json.loads(cli.json_dumps(cli.json_report(
        stats, [], "in", "in2" if paired else None, 1, paired, 0.5)))
    return strip_names({k: rep[k] for k in ("read_counts", "basepair_counts",
                                            "adapters_read1",
                                            "adapters_read2")})


def strip_names(parts) -> dict:
    parts = json.loads(json.dumps(parts))
    for key in ("adapters_read1", "adapters_read2"):
        for adapter in parts.get(key) or []:
            adapter.pop("name", None)
    return parts


def merged_pickles(label, paths):
    """merge_statistics of the shard pickles, each first loaded by
    torch_fixtures.load_host_pickle, which refuses any torch object (a
    CUDA tensor must never reach a pickle)."""
    import torch_fixtures as fx
    from cutadapt_tpu_torch.parallel.multihost import merge_statistics

    for path in paths:
        try:
            fx.load_host_pickle(path)
        except Exception as e:
            fail(f"{label}: {path}: {e}")
    return merge_statistics(paths)


def shard_phase(data, want_out, want_report, pairs, want8_report, clock_hz,
                sms) -> dict:
    """Phase 15: the input sharded over processes. (a) --shard i/SHARDS
    through cli.main in this process, one shard after another, on the
    flagship file, each shard's launches counted; the outputs
    concatenated equal phase 5's output and the merged pickles its
    report; the plan pass alone timed. (b) the flagship file written
    SHARD_COPIES times over, unsharded through python -m
    cutadapt_tpu_torch and through tools/multihost_run_torch.py at each
    of SHARD_PROCESS_COUNTS processes, all shards at once, each held to
    phase 5's output repeated and the unsharded report; reads/s, each
    shard process's seconds, the plan pass, a process's start-up and the
    card's estimated idle share. (c) phase 8's paired files through the
    coordinator on 2 processes with CUTADAPT_TPU_TORCH_DEVICE_STATS=1,
    held to phase 8's files and report. (d) two --shard i/2 processes of
    the flagship file in one gloo group. (e) the measurement tools."""
    import shutil
    import tempfile

    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx
    from cutadapt_tpu_torch import accel, cli
    from cutadapt_tpu_torch.ops import align_cuda
    from cutadapt_tpu_torch.parallel.multihost import shard_byte_range_env
    from cutadapt_tpu_torch.report import full_report

    result = {}
    coordinator = os.path.join(HERE, "tools", "multihost_run_torch.py")
    flag_args = ["-a", fx.ADAPTER, "-e", "0.1", "-O", "3"]
    want_parts = strip_names(want_report)
    n_reads = data.count(b"\n") // 4
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        flag = os.path.join(tmp, "flagship.fastq")
        with open(flag, "wb") as f:
            f.write(data)

        # (a) in this process, one shard after another
        t0 = time.perf_counter()
        for i in range(SHARDS):
            shard_byte_range_env([flag], i, SHARDS)
        plan_s = (time.perf_counter() - t0) / SHARDS
        saved = {k: os.environ.pop(k, None) for k in (
            "CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_TORCH_DEVICES",
            "CUTADAPT_TPU_TORCH_DEVICE_STATS")}
        os.environ["CUTADAPT_TPU_TORCH_BATCH"] = "require"
        times = accel.RUN_TIMES
        rec = Recorder(bp.locate_packed,
                       warming=lambda: times["device_ready"] is None)
        fallbacks = accel.FALLBACK_COUNT
        per_shard, outs, pickles = [], [], []
        bp.locate_packed = rec
        try:
            for i in range(SHARDS):
                out = os.path.join(tmp, f"a{i}.fastq")
                chunk_launches = rec.launches(True)
                warm = dict(rec.warmup)
                align_cuda.reset_launch_counters()
                t0 = time.perf_counter()
                cli.main(["--quiet", *flag_args, "-o", out, "--shard",
                          f"{i}/{SHARDS}", flag])
                dt = time.perf_counter() - t0
                launches = dict(align_cuda.LAUNCHES)
                per_shard.append(dict(
                    launches=launches,
                    chunk_launches=rec.launches(True) - chunk_launches,
                    warmup_launches={k: rec.warmup[k] - warm[k]
                                     for k in warm},
                    seconds=dt))
                if per_shard[-1]["chunk_launches"] <= 0:
                    fail(f"sharding (a): shard {i}/{SHARDS} launched no "
                         f"2-bit chunk batch ({launches})")
                outs.append(out)
                pickles.append(out + ".shard-stats.pickle")
        finally:
            bp.locate_packed = rec.fn
            for k, v in saved.items():
                if v is not None:
                    os.environ[k] = v
        if accel.FALLBACK_COUNT != fallbacks:
            fail(f"sharding (a): fell back ({accel.LAST_FALLBACK})")
        got = b"".join(open(p, "rb").read() for p in outs)
        if got != want_out:
            fail(f"sharding (a): the {SHARDS} shards' outputs concatenated "
                 f"({len(got)} bytes) differ from phase 5's output "
                 f"({len(want_out)} bytes)")
        merged = merged_pickles("sharding (a)", pickles)
        if stats_parts(merged, False) != want_parts:
            fail("sharding (a): the merged statistics differ from phase 5's "
                 "--json report")
        nums = kernel_numbers(rec, True, clock_hz, sms)
        if nums["max_abs_err"]:
            fail("sharding (a): the kernel differs from the plain version")
        a_device_ms = nums["run_kernel_ms"]
        log(f"sharding (a): --shard i/{SHARDS} in this process on the "
            f"flagship file ({len(data)} bytes): outputs concatenated equal "
            f"to phase 5's output, merged pickles (no torch object) equal "
            f"to its report; per shard 2-bit chunk launches "
            f"{[d['chunk_launches'] for d in per_shard]}, warm-ups "
            f"{[d['warmup_launches'] for d in per_shard]}, seconds "
            f"{[round(d['seconds'], 3) for d in per_shard]}; plan pass "
            f"(shard_byte_range_env) {plan_s * 1e3:.1f} ms per shard; "
            f"2-bit kernel {shape_line(nums)}")
        result["in_process"] = dict(
            per_shard=per_shard, plan_ms=plan_s * 1e3,
            device_ms=a_device_ms, max_abs_err=nums["max_abs_err"],
            per_shape=[{k: d[k] for k in PER_SHAPE_KEYS}
                       for d in nums["per_shape"]])

        # (b) processes sharing the card
        big = os.path.join(tmp, "flagship_x4.fastq")
        with open(big, "wb") as f:
            for _ in range(SHARD_COPIES):
                f.write(data)
        n_big = SHARD_COPIES * n_reads
        t0 = time.perf_counter()
        shard_byte_range_env([big], 0, SHARDS)
        big_plan_s = time.perf_counter() - t0
        env = subprocess_env(CUTADAPT_TPU_TORCH_BATCH="require")
        # one process's start-up up to its first kernel launch, by part
        startup_code = (
            "import json, time\n"
            "t = [time.perf_counter()]\n"
            "import torch\n"
            "t.append(time.perf_counter())\n"
            "import cutadapt_tpu_torch.cli, cutadapt_tpu_torch.accel\n"
            "t.append(time.perf_counter())\n"
            "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
            "t.append(time.perf_counter())\n"
            "from cutadapt_tpu_torch.ops import align_cuda\n"
            "align_cuda._library()\n"
            "t.append(time.perf_counter())\n"
            "print('startup ' + json.dumps(dict(zip(('import_torch', "
            "'import_port', 'cuda_context', 'kernel_library'), "
            "(b - a for a, b in zip(t, t[1:]))))))\n")
        stdout, _, startup_s = run_process(
            "sharding (b) start-up", [sys.executable, "-c", startup_code], env)
        startup_parts = tagged_json("sharding (b) start-up", stdout,
                                    "startup")
        full = os.path.join(tmp, "b_full.fastq")
        full_pickle = full + ".pickle"
        _, _, full_s = run_process(
            "sharding (b) unsharded",
            [sys.executable, "-m", "cutadapt_tpu_torch", "--quiet",
             *flag_args, "-o", full, big],
            {**env, "CUTADAPT_TPU_TORCH_STATS_PICKLE": full_pickle})
        same_file("sharding (b) unsharded", full, want_out, SHARD_COPIES)
        os.unlink(full)
        unsharded = merged_pickles("sharding (b) unsharded", [full_pickle])
        want_text = full_report(unsharded, 0, 0.5).strip()
        log(f"sharding (b): {n_big} reads ({SHARD_COPIES} x the flagship "
            f"file, {os.path.getsize(big)} bytes) unsharded through "
            f"python -m cutadapt_tpu_torch: {full_s:.3f} s = "
            f"{n_big / full_s:.1f} reads/s, output equal to phase 5's "
            f"output x {SHARD_COPIES}; one process's start-up (interpreter, "
            f"import, CUDA context, kernel library) {startup_s * 1e3:.1f} "
            f"ms, seconds by part "
            f"{ {k: round(v, 3) for k, v in startup_parts.items()} }; plan "
            f"pass (shard_byte_range_env) {big_plan_s * 1e3:.1f} ms; "
            f"os.cpu_count() {os.cpu_count()}")
        runs = {}
        for n in SHARD_PROCESS_COUNTS:
            out = os.path.join(tmp, f"b{n}.fastq")
            stdout, stderr, dt = run_process(
                f"sharding (b) -n {n}",
                [sys.executable, coordinator, "-n", str(n), "--", *flag_args,
                 "-o", out, big], env, timeout=SHARD_TIMEOUT * 2)
            same_file(f"sharding (b) -n {n}", out, want_out, SHARD_COPIES)
            os.unlink(out)
            if stdout.strip() != want_text:
                fail(f"sharding (b) -n {n}: the merged report differs from "
                     f"the unsharded run's")
            timing = tagged_json(f"sharding (b) -n {n}", stderr,
                                 "multihost_run_torch")
            idle = 1 - SHARD_COPIES * a_device_ms / 1e3 / dt
            runs[n] = dict(seconds=dt, reads_per_sec=n_big / dt,
                           shard_seconds=timing["shard_seconds"],
                           concat_seconds=timing["concat_seconds"],
                           merge_seconds=timing["merge_seconds"],
                           idle_share_estimate=idle)
            log(f"sharding (b) -n {n}: {dt:.3f} s = {n_big / dt:.1f} reads/s "
                f"({n_big / dt / (n_big / full_s):.3f} x the unsharded run); "
                f"each shard process {n_big // n} reads in "
                f"{[round(x, 3) for x in timing['shard_seconds']]} s; "
                f"concatenation {timing['concat_seconds']:.3f} s, merge "
                f"{timing['merge_seconds']:.3f} s; output and merged report "
                f"equal to the unsharded run's; idle share estimated from "
                f"(a)'s kernel time x {SHARD_COPIES}: {idle:.6f}")
        result["processes"] = dict(
            reads=n_big, unsharded_seconds=full_s,
            unsharded_reads_per_sec=n_big / full_s,
            startup_ms=startup_s * 1e3, startup_seconds=startup_parts,
            plan_ms=big_plan_s * 1e3,
            cpu_count=os.cpu_count(), runs=runs)

        # (c) paired TruSeq on 2 processes with the reducer
        p1, p2 = (os.path.join(tmp, f"truseq.{k}.fastq") for k in (1, 2))
        for path, side in zip((p1, p2), pairs):
            with open(path, "wb") as f:
                f.write(side)
        o1, o2 = (os.path.join(tmp, f"c.{k}.fastq") for k in (1, 2))
        stdout, stderr, dt = run_process(
            "sharding (c)",
            [sys.executable, coordinator, "-n", "2", "--keep-shards", "--",
             "-a", fx.TRUSEQ_R1, "-A", fx.TRUSEQ_R2, "-q", "20", "-m", "20",
             "-o", o1, "-p", o2, p1, p2],
            subprocess_env(CUTADAPT_TPU_TORCH_BATCH="require",
                           CUTADAPT_TPU_TORCH_DEVICE_STATS="1"))
        want8 = HOST_FILES["paired"]
        for path, name in ((o1, "out.1.fastq"), (o2, "out.2.fastq")):
            same_file(f"sharding (c) {name}", path, want8[name])
        merged = merged_pickles("sharding (c)", [
            f"{o1}.shard{i}of2.stats.pickle" for i in range(2)])
        if stats_parts(merged, True) != strip_names(want8_report):
            fail("sharding (c): the merged statistics differ from phase 8's "
                 "--json report")
        if stdout.strip() != full_report(merged, 0, 0.5).strip():
            fail("sharding (c): the coordinator's report differs from the "
                 "merged pickles'")
        timing = tagged_json("sharding (c)", stderr, "multihost_run_torch")
        n_pairs = pairs[0].count(b"\n") // 4
        result["paired"] = dict(seconds=dt, pairs_per_sec=n_pairs / dt,
                                shard_seconds=timing["shard_seconds"])
        log(f"sharding (c): phase 8's {n_pairs} paired TruSeq pairs on 2 "
            f"processes with CUTADAPT_TPU_TORCH_DEVICE_STATS=1: R1 and R2 "
            f"equal to phase 8's files, merged pickles (no torch object) "
            f"equal to its report; {dt:.3f} s = {n_pairs / dt:.1f} pairs/s, "
            f"shard processes {[round(x, 3) for x in timing['shard_seconds']]}"
            f" s")

        # (d) two --shard i/2 processes in one gloo group
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist_env = subprocess_env(
            CUTADAPT_TPU_TORCH_BATCH="require",
            CUTADAPT_TPU_TORCH_DIST_COORDINATOR=f"127.0.0.1:{port}",
            CUTADAPT_TPU_TORCH_DIST_NPROCS="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "cutadapt_tpu_torch", "--debug",
             *flag_args, "--shard", f"{i}/2", "-o",
             os.path.join(tmp, f"d{i}.fastq"), flag],
            env={**dist_env, "CUTADAPT_TPU_TORCH_DIST_PID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=HERE) for i in range(2)]
        texts = []
        try:
            for i, proc in enumerate(procs):
                try:
                    out_text, err_text = proc.communicate(
                        timeout=max(1.0, SHARD_TIMEOUT
                                    - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    fail(f"sharding (d): shard {i}/2 did not end within "
                         f"{SHARD_TIMEOUT} s")
                texts.append(out_text + err_text)
                if proc.returncode != 0:
                    fail(f"sharding (d): shard {i}/2 exit {proc.returncode}:"
                         f"\n{texts[-1][-3000:]}")
                if f"process group: rank {i} of 2 (gloo" not in texts[-1]:
                    fail(f"sharding (d): shard {i}/2 did not join the group:"
                         f"\n{texts[-1][-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        dt = time.perf_counter() - t0
        got = b"".join(open(os.path.join(tmp, f"d{i}.fastq"), "rb").read()
                       for i in range(2))
        if got != want_out:
            fail("sharding (d): the two grouped shards' outputs concatenated "
                 "differ from phase 5's output")
        result["group"] = dict(seconds=dt)
        log(f"sharding (d): two --shard i/2 processes joined one gloo group "
            f"(CUTADAPT_TPU_TORCH_DIST_COORDINATOR=127.0.0.1:{port}), both "
            f"exit 0 in {dt:.3f} s, outputs concatenated equal to phase 5's "
            f"output")

        # (e) the measurement tools, each once
        tools = os.path.join(HERE, "tools")
        tool_env = subprocess_env()
        tool_out = {}
        for name, args in (
                ("kernel_bench_torch", ["32768", "20", "3"]),
                ("profile_xfer_torch", []),
                ("profile_batch_torch", []),
                ("fuzz_parity_torch", [str(FUZZ_ITERATIONS),
                                       str(FUZZ_SEED)])):
            stdout, stderr, dt = run_process(
                name, [sys.executable, os.path.join(tools, name + ".py"),
                       *args], tool_env, timeout=TOOL_TIMEOUT)
            tool_out[name] = tagged_json(name, stdout, name)
            tool_out[name]["seconds"] = dt
        fuzz = tool_out["fuzz_parity_torch"]
        if fuzz["mismatches"] or fuzz["iterations"] != FUZZ_ITERATIONS:
            fail(f"fuzz_parity_torch: {fuzz}")
        bench = tool_out["kernel_bench_torch"]
        log(f"kernel_bench_torch 32768 20 3: {bench['lane']} lane, "
            f"32768 x {bench['row_bytes']} B, rows/s per pass "
            f"{[round(p['rows_per_sec'], 1) for p in bench['passes']]}, ms "
            f"per launch "
            f"{[round(p['ms_per_launch'], 5) for p in bench['passes']]}")
        xfer = tool_out["profile_xfer_torch"]
        log("profile_xfer_torch: " + "; ".join(
            f"{c['bytes']} B {c['memory']} H2D {c['h2d_ms']:.4f} ms "
            f"({c['h2d_gb_s']:.2f} GB/s) D2H {c['d2h_ms']:.4f} ms "
            f"({c['d2h_gb_s']:.2f} GB/s)" for c in xfer["copies"])
            + f"; result fetch round trip "
            f"{xfer['result_fetch_round_trip_ms']:.4f} ms")
        prof = tool_out["profile_batch_torch"]
        stage_ns = {k: round(v, 1)
                    for k, v in prof["stage_ns_per_read"].items()}
        log(f"profile_batch_torch: {prof['reads']} reads, host ns/read "
            f"{stage_ns}, pipelined {prof['pipelined_reads_per_sec']:.1f} "
            f"reads/s")
        traced = prof["profiler"]
        log(f"profile_batch_torch under torch.profiler: "
            f"{traced['device_ms']:.4f} ms of device time in a "
            f"{traced['seconds']:.3f} s pipelined pass (busy share "
            f"{traced['busy_share']:.6f}); by name " + "; ".join(
                f"{d['name'][:48]} x{d['count']} {d['device_ms']:.4f} ms"
                for d in traced["by_name"]))
        if traced["device_ms"] <= 0:
            log("profile_batch_torch: torch.profiler recorded no device "
                "time on this card")
        log("submit split (ns/read): " + json.dumps(
            {k: round(v, 1)
             for k, v in prof["submit_split_ns_per_read"].items()}))
        log(f"fuzz_parity_torch {FUZZ_ITERATIONS} {FUZZ_SEED}: "
            f"{fuzz['mismatches']} mismatches on the card, engine launches "
            f"{fuzz['launches']}, {fuzz['engine_fallbacks']} runs the engine "
            f"declined")
        result["tools"] = tool_out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result


# phase 16: the shared upload of three adapters
THREE_ADAPTERS = {"TruSeq": "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
                  "Nextera": "CTGTCTCTTATACACATCT",
                  "small RNA": "TGGAATTCTCGGGTGCCAAGG"}
THREE_ADAPTER_ARGS = ["-e", "0.1", "-O", "3"] + [
    x for ad in THREE_ADAPTERS.values() for x in ("-a", ad)]
N_THREE_ADAPTER_READS = 262144
THREE_ADAPTER_SEED = 16
# submit's parts as tools/profile_batch_torch.py splits them (the port's
# spans)
SPLIT_PARTS = ("stage", "launch")


class DispatchProbe:
    """Phase 16's view of the counted run through main (``counting``) and
    of each engine's sequential pass (``splitting``). The counted run:
    the transfer counters (set to 0 just before it), the uploads
    (``upload_batch``) and the launches on each; the engine's warm-up
    apart. The pass: submit's host time split as
    tools/profile_batch_torch.py splits it."""

    def __init__(self):
        # per thread: ("upload", ptr, rows) / ("launch", ptr, task)
        self.events = {}
        self.xfer = None
        self.splits = []  # per engine: ns/read by part

    def counting(self, times):
        import contextlib

        import cutadapt_tpu_torch.batch_pipeline as bp

        probe = self

        def warming():
            return times["device_ready"] is None

        @contextlib.contextmanager
        def window():
            saved = (bp.upload_batch, bp.locate_packed)
            real_upload, real_locate = saved

            def upload(enc, lengths, device):
                out = real_upload(enc, lengths, device)
                if not warming():
                    probe.note("upload", out[0].data_ptr(), enc.shape[0])
                return out

            def locate(enc, lengths, tables, pack2, wide=False):
                if not warming():
                    probe.note("launch", enc.data_ptr(),
                               tables.spec.reference)
                return real_locate(enc, lengths, tables, pack2, wide=wide)

            bp.upload_batch, bp.locate_packed = upload, locate
            bp.reset_xfer_counters()
            try:
                yield
            finally:
                probe.xfer = bp.xfer_counters()
                bp.upload_batch, bp.locate_packed = saved

        return window()

    def splitting(self, n_reads):
        import contextlib

        from cutadapt_tpu_torch import tracing

        sys.path.insert(0, os.path.join(HERE, "tools"))
        try:
            from profile_batch_torch import SUBMIT_PARTS, split_seconds
        finally:
            sys.path.remove(os.path.join(HERE, "tools"))

        @contextlib.contextmanager
        def window():
            tracing.enable()
            try:
                yield
            finally:
                records = tracing.disable()
            self.splits.append({
                k: v / n_reads * 1e9
                for k, v in split_seconds(records, SUBMIT_PARTS).items()})

        return window()

    def note(self, *event):
        self.events.setdefault(threading.get_ident(), []).append(event)

    def uploads(self):
        """[(rows, [task of each launch on the upload])]: a thread's
        launches belong to its last upload."""
        out = []
        for events in self.events.values():
            ups = []
            for kind, ptr, what in events:
                if kind == "upload":
                    ups.append((ptr, what, []))
                elif not ups or ups[-1][0] != ptr:
                    fail(f"a launch on a tensor that is not the last "
                         f"upload's ({len(ups)} uploads so far)")
                else:
                    ups[-1][2].append(what)
            out += [(rows, tasks) for _, rows, tasks in ups]
        return out


def dispatch_modes_phase(clock_hz, sms) -> dict:
    """Phase 16: three Illumina adapters through the shared upload, held
    to the host path: reads/s, the counted run's transfer counters per
    read, launches by task and lane, ms per launch shape beside its
    bound, submit's host ns/read split, the idle share. Every upload must
    carry one launch per adapter, and the DP rows must be three per
    uploaded row. A kernel variant launched in the counted run that its
    warm-up did not launch fails the phase (a launch of another batch
    size or row width needs no compile)."""
    import torch_fixtures as fx

    label = "three adapters, shared upload"
    name_of = {seq: name for name, seq in THREE_ADAPTERS.items()}
    t0 = time.perf_counter()
    three = fx.make_reads(N_THREE_ADAPTER_READS, THREE_ADAPTER_SEED,
                          list(THREE_ADAPTERS.values()))
    log(f"shared upload: {N_THREE_ADAPTER_READS} reads of 40-100 bp, 30% "
        f"with one of {list(THREE_ADAPTERS)}, generated "
        f"({time.perf_counter() - t0:.1f} s)")
    probe = DispatchProbe()
    rec, launches, rps, wall, _ = config_phase(
        label, THREE_ADAPTER_ARGS, [three],
        lambda tables: name_of[tables.spec.reference], list(THREE_ADAPTERS),
        probe=probe)
    late = rec.variants - rec.warm_variants
    if late:
        fail(f"{label}: kernel variants first launched after the warm-up: "
             f"{sorted(late)}")
    device_ms, per_lane = 0.0, {}
    for pack2 in (True, False, None):
        if not rec.launches(pack2):
            continue
        nums = kernel_numbers(rec, pack2, clock_hz, sms)
        log(f"{label}: {lane_label(pack2)} kernel {shape_line(nums)}")
        if nums["max_abs_err"] != 0:
            fail(f"{label}: the kernel differs from the plain version")
        device_ms += nums["run_kernel_ms"]
        per_lane[lane_name(pack2)] = dict(
            launches=launches[lane_name(pack2)],
            warmup_launches=rec.warmup[lane_name(pack2)],
            by_task={t: rec.launches(pack2, t) for t in THREE_ADAPTERS},
            run_kernel_ms=nums["run_kernel_ms"],
            per_shape=[{key: d[key] for key in PER_SHAPE_KEYS}
                       for d in nums["per_shape"]])
    uploads = probe.uploads()
    split = [{part: sp[part] for part in SPLIT_PARTS} for sp in probe.splits]
    n = N_THREE_ADAPTER_READS
    cell = dict(
        reads_per_sec=rps, wall_s=wall,
        xfer_per_read={k: v / n for k, v in probe.xfer.items()},
        xfer=probe.xfer, uploads=len(uploads),
        upload_rows=sum(r for r, _ in uploads),
        launches_per_upload=sorted({len(t) for _, t in uploads}),
        lanes=per_lane, submit_split_ns_per_read=split,
        device_ms=device_ms, idle_share=1 - device_ms / 1e3 / wall,
        startup_ms=STARTUP_MS[label])
    log(f"{label}: {rps:.1f} reads/s through main; per read H2D "
        f"{cell['xfer_per_read']['h2d_bytes']:.4f} B, D2H "
        f"{cell['xfer_per_read']['d2h_bytes']:.4f} B, candidates "
        f"{cell['xfer_per_read']['candidates']:.6f}, DP rows "
        f"{cell['xfer_per_read']['dp_rows']:.6f}; {len(uploads)} uploads "
        f"of {cell['upload_rows']} rows, launches per upload "
        f"{cell['launches_per_upload']}; submit ns/read by part "
        + "; ".join(f"engine {i + 1} "
                    + ", ".join(f"{k} {v:.1f}" for k, v in sp.items())
                    for i, sp in enumerate(split))
        + f"; device {device_ms:.4f} ms against a median wall of "
        f"{wall:.3f} s: idle share {cell['idle_share']:.6f}")
    for rows, launched in uploads:
        if sorted(launched) != sorted(THREE_ADAPTERS.values()):
            fail(f"{label}: an upload of {rows} rows launched "
                 f"{len(launched)} kernels, not one per adapter")
    if cell["launches_per_upload"] != [3]:
        fail(f"{label}: launches per upload {cell['launches_per_upload']}")
    if 3 * cell["upload_rows"] != cell["xfer"]["dp_rows"]:
        fail(f"{label}: {cell['upload_rows']} uploaded rows for "
             f"{cell['xfer']['dp_rows']} DP rows")
    return dict(cells={"three_shared": cell})


# phase 17: the port's benchmark programs, each a process at its default
# size; together they have BENCH_SECONDS, bench_torch.py at most
# BENCH_TORCH_SECONDS of it
BENCH_SECONDS = 300
BENCH_TORCH_SECONDS = 180


def last_json(label, text) -> dict:
    """The JSON object on the last line of a program's output."""
    lines = text.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{label}: its last line is not a JSON object:\n{text[-2000:]}")


def bench_phase() -> dict:
    """17: bench_torch.py at its default 1,000,000 reads, then
    bench_configs_torch.py at its default 200,000, each a process of its
    own. Each must exit 0 within its time limit, name this card, and
    bench_torch.py report kernel_parity "ok" and its 2-bit kernel at no
    less than its bound (x_bound >= 1 / 1.05: a kernel faster than its
    bound means the count is wrong); bench_configs_torch.py must report
    parity on every configuration."""
    import torch

    name = torch.cuda.get_device_name(0)
    env = subprocess_env()
    out, err, dt = run_process(
        "bench_torch.py", [sys.executable, os.path.join(HERE, "bench_torch.py")],
        env, timeout=BENCH_TORCH_SECONDS)
    bench = last_json("bench_torch.py", out)
    log(f"bench_torch.py ({dt:.1f} s): " + json.dumps(bench))
    for line in err.splitlines():
        if line.startswith(("pass ", "sequential", "device kernel",
                            "one pipelined pass", "torch.profiler",
                            "CLI surface", "-j ")):
            log(f"  bench_torch: {line}")
    if bench.get("metric") != "reads_per_sec_se_3p_adapter_trim" or not (
            bench.get("value", 0) > 0):
        fail(f"bench_torch.py: no reads/s in its line: {bench}")
    if bench["kernel_parity"] != "ok":
        fail(f"bench_torch.py: kernel_parity {bench['kernel_parity']}")
    if bench["device"] != name:
        fail(f"bench_torch.py ran on {bench['device']!r}, not {name!r}")
    if not bench["x_bound"] >= 1 / 1.05:
        fail(f"bench_torch.py: the kernel ran at {bench['x_bound']} x its "
             f"bound: the bound's count is wrong")
    out, err, dt2 = run_process(
        "bench_configs_torch.py",
        [sys.executable, os.path.join(HERE, "bench_configs_torch.py")],
        env, timeout=max(1, BENCH_SECONDS - dt))
    configs = last_json("bench_configs_torch.py", out)
    for line in out.strip().splitlines()[:-1]:
        log(f"  bench_configs_torch: {line}")
    log(f"bench_configs_torch.py ({dt2:.1f} s): " + json.dumps(configs))
    if configs["device"] != name:
        fail(f"bench_configs_torch.py ran on {configs['device']!r}, not "
             f"{name!r}")
    if len(configs["configs"]) != 5 or not all(
            c["parity"] for c in configs["configs"]):
        fail(f"bench_configs_torch.py: parity failed: {configs['configs']}")
    return dict(bench=bench, configs=configs, seconds=[dt, dt2])


def kernel_numbers(rec, pack2, clock_hz, sms):
    """Kernel time, bound, time / bound and the error against the plain
    version (on all 7 fields of a wide launch) at every dispatch shape of
    a lane the path launched, with the plain version's time there (one
    run, CUDA events); the device time of all the run's launches."""
    import torch

    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda

    shapes = sorted((k for k in rec.inputs if k[0] == lane_name(pack2)),
                    key=lambda s: (-s[1], -s[2]))
    if not shapes:
        fail(f"no {lane_label(pack2)} launch was recorded")
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
        bound_ms, bound_by, work = align_cuda.bound_of(
            enc.cpu().numpy(), lens.cpu().numpy(), tables, pack2, clock_hz,
            sms, wide)
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
    mark = started = time.perf_counter()

    def phase_done(name):
        nonlocal mark
        now = time.perf_counter()
        PHASE_SECONDS[name] = now - mark
        mark = now

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

    # 1. build: one nvcc per source, started together
    from cutadapt_tpu_torch.ops import stats_cuda

    build_errors = []

    def build(lib):
        try:
            lib.build_library()
        except Exception as e:  # reported below, with the compiler's log
            build_errors.append(f"{lib.__name__}: {e}")

    threads = [threading.Thread(target=build, args=(lib,))
               for lib in (align_cuda, stats_cuda)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if build_errors:
        fail("the kernel build failed: " + "; ".join(build_errors))
    log(f"scatter kernel library built in "
        f"{stats_cuda.BUILD_INFO['seconds']:.1f} s: "
        f"{stats_cuda.BUILD_INFO['path']}")
    for line in stats_cuda.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas (stats_scatter): {line.strip()}")
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

    phase_done("1 build")

    # 2. kernel parity
    worst = parity_phase()
    phase_done("2 kernel parity")

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

    phase_done("3 main path")
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

    phase_done("4 dirty lane")
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

    phase_done("5 cli")
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
    phase_done("6 host stages")
    # 7. linked primers: the 5' phase (PREFIX) launches from submit, the
    # 3' phase (BACK) from the engine's linked worker
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
    phase_done("7 linked primers")
    # 8. paired TruSeq: R1's adapter launches from the first engine, R2's
    # from the second; the reads' N take each side to the 4-bit lane too
    t0 = time.perf_counter()
    pairs = fx.make_pairs(N_PAIRS)
    log(f"paired: {N_PAIRS} pairs of 2 x {fx.PAIR_READ_LEN} bp generated "
        f"({time.perf_counter() - t0:.1f} s)")
    rec8, launches8, rps8, wall8, rep8 = config_phase(
        "paired", ["-a", fx.TRUSEQ_R1, "-A", fx.TRUSEQ_R2, "-q", "20",
                   "-m", "20"],
        list(pairs),
        lambda tables: "R1" if tables.spec.reference == fx.TRUSEQ_R1
        else "R2",
        ["R1", "R2"], lanes=(True, False), keep=True,
    )
    phase_done("8 paired")
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
    phase_done("9 revcomp")
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
    phase_done("10 long reads")
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
    if any(launches11b[lane] for lane in ("pack2", "pack4", "byte")):
        fail(f"output side (b): the indexed barcodes launched the kernel "
             f"{launches11b}")
    routed = rep11b["read_counts"]["read1_with_adapter"]
    if not 0.9 * N_BARCODED_PAIRS <= routed <= N_BARCODED_PAIRS:
        fail(f"output side (b): {routed} pairs carried a barcode, not 95%")
    log(f"output side: (a) {rps11:.1f} reads/s, (b) {rps11b:.1f} pairs/s "
        f"through main, {routed} pairs routed by barcode")
    phase_done("11 output side")
    # 12. the byte lane: an adapter of 17 query classes compared as ASCII
    t0 = time.perf_counter()
    byte_reads = fx.make_byte_lane_reads(N_BYTE_LANE_READS)
    log(f"byte lane: {N_BYTE_LANE_READS} reads of {fx.READ_LEN} bp "
        f"generated ({time.perf_counter() - t0:.1f} s)")
    rec12, launches12, rps12, wall12, _ = config_phase(
        "byte lane", ["-N", "-e", "0.1", "-a", fx.BYTE_LANE_ADAPTER],
        [byte_reads], lambda tables: "3'", ["3'"], lanes=(None,),
    )
    del byte_reads
    if launches12["pack2"] or launches12["pack4"]:
        fail(f"byte lane: a packed lane launched {launches12}")
    phase_done("12 byte lane")
    # 13. the JAX package's golden suites through the port, unedited
    suites = golden_suites_phase()
    phase_done("13 golden suites")
    # 14. the statistics reducer and the device mesh
    scatter = scatter_phase()
    mesh14 = reducer_mesh_phase(data, pairs, clock_mhz * 1e6, sms)
    step14 = sharded_step_phase()
    phase_done("14 reducer and mesh")
    # 15. the input sharded over processes
    shard15 = shard_phase(data, main_out, cli_runs["report"], pairs, rep8,
                          clock_mhz * 1e6, sms)
    phase_done("15 sharding")
    del pairs
    # 16. the shared upload of three adapters
    modes16 = dispatch_modes_phase(clock_mhz * 1e6, sms)
    phase_done("16 shared upload")
    # 17. the port's benchmark programs at their default sizes
    bench17 = bench_phase()
    phase_done("17 bench")
    busy = {}
    path_lanes = {}
    for path, rec, launches, lanes, wall in (
        ("host_stages", rec6, launches6, (True,), None),
        ("linked", rec7, launches7, (True,), None),
        ("paired", rec8, launches8, (True, False), wall8),
        ("revcomp", rec9, launches9, (True,), wall9),
        ("long_reads", rec10, launches10, (True, False), wall10),
        ("output_side", rec11, launches11, (True,), wall11),
        ("byte_lane", rec12, launches12, (None,), wall12),
    ):
        device_ms = 0.0
        for pack2 in lanes:
            lane = lane_name(pack2)
            nums = kernel_numbers(rec, pack2, clock_mhz * 1e6, sms)
            log(f"{path}: {lane_label(pack2)} kernel "
                f"{shape_line(nums)}; plain {nums['plain_ms']:.3f} ms")
            if nums["max_abs_err"] != 0:
                fail(f"{path}: the kernel differs from the plain version")
            device_ms += nums["run_kernel_ms"]
            path_lanes.setdefault(pack2, {})[path] = dict(
                launches=launches[lane], warmup_launches=rec.warmup[lane],
                wide_launches=launches["wide"][lane],
                by_task={t: rec.launches(pack2, t)
                         for t in sorted({k[3] for k in rec.calls
                                          if k[0] == lane})},
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
    log(f"byte_lane_reads_per_sec {rps12}")
    log(f"byte_lane_startup_ms {STARTUP_MS['byte lane']}")
    log(f"byte_lane_idle_share {1 - busy['byte_lane']}")
    mesh_flag = mesh14["mesh"]["configs"]["flagship file"]
    log(f"reducer_forced_reads_per_sec "
        f"{mesh14['forced']['flagship']['reads_per_sec']}")
    log(f"mesh_reads_per_sec {mesh_flag['reads_per_sec']}")
    log(f"mesh_one_device_reads_per_sec "
        f"{mesh_flag['one_device_reads_per_sec']}")
    log(f"mesh_idle_share {mesh_flag['idle_share']}")
    procs15 = shard15["processes"]
    log(f"shard_unsharded_reads_per_sec {procs15['unsharded_reads_per_sec']}")
    for n, run15 in procs15["runs"].items():
        log(f"shard_reads_per_sec_n{n} {run15['reads_per_sec']}")
    log(f"shard_process_startup_ms {procs15['startup_ms']}")
    log(f"shard_plan_pass_ms {procs15['plan_ms']}")
    log(f"cpu_count {procs15['cpu_count']}")
    for key, c in modes16["cells"].items():
        log(f"dispatch_{key}_reads_per_sec {c['reads_per_sec']}")
        log(f"dispatch_{key}_idle_share {c['idle_share']}")
    bench = bench17["bench"]
    log(f"bench_reads_per_sec {bench['value']}")
    log(f"bench_cli_reads_per_sec {bench['cli_reads_per_sec']}")
    log(f"bench_idle_share {bench['idle_share']}")
    log(f"bench_x_bound {bench['x_bound']}")
    for c in bench17["configs"]["configs"]:
        log(f"bench_configs {c['name']}: host {c['host']} engine "
            f"{c['engine']} {c['unit']}")

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
    # the byte lane: its path is phase 12's, its parity the byte parity
    # matrix and the long reads of the wide parity
    byte = path_lanes[None]["byte_lane"]
    kernels.append(dict(
        name="align_locate_byte", lane="byte", route="cuda", source=src,
        replaces="cutadapt_tpu/ops/align_batch.py:271",
        launches=byte["launches"], parity="ok",
        max_abs_err=max(worst[None], byte["max_abs_err"]),
        ms=byte["per_shape"][0]["ms"], plain_ms=byte["plain_ms"],
        bound_ms=byte["per_shape"][0]["bound_ms"],
        bound_by=byte["per_shape"][0]["bound_by"], library_ms=None,
        shape=byte["per_shape"][0]["shape"],
        lanes=align_cuda.kernel_layout(len(fx.BYTE_LANE_ADAPTER)).lanes,
        rows=align_cuda.kernel_layout(len(fx.BYTE_LANE_ADAPTER)).rows,
        per_shape=byte["per_shape"], byte_lane=byte,
        startup_ms=STARTUP_MS["byte lane"],
    ))
    for kernel, lane in zip(kernels, ("pack2", "pack4", "byte")):
        kernel["wide_launches"] = dict(parity=WIDE_PARITY[lane])
        if lane != "byte":
            kernel["wide_launches"]["long_reads"] = \
                kernel["long_reads"]["wide_launches"]
        kernel["golden_suites_launches"] = suites["launches"][lane]
        kernel["mesh"] = {
            label: dict(launches=c["launches"][lane],
                        one_device_launches=c["one_device_launches"][lane])
            for label, c in mesh14["mesh"]["configs"].items()}
    # launches per shard of the mesh phase (all lanes of each dispatch)
    for kernel in kernels:
        kernel["shard_launches"] = mesh14["mesh"]["shard_launches"]
    # phase 15 (a): each --shard run in this process, counted apart
    in15 = shard15["in_process"]
    kernels[0]["sharded"] = dict(
        chunk_launches_per_shard=[d["chunk_launches"]
                                  for d in in15["per_shard"]],
        warmup_launches_per_shard=[d["warmup_launches"]["pack2"]
                                   for d in in15["per_shard"]],
        max_abs_err=in15["max_abs_err"], per_shape=in15["per_shape"])
    # phase 17: bench_torch.py's kernel section and its counted pipelined
    # pass (its own process's counters)
    dk = bench["device_kernel"]
    kernels[0]["bench"] = dict(
        shape=[dk["rows"], dk["row_bytes"]], ms=dk["ms"],
        bound_ms=dk["bound_ms"], bound_by=dk["bound_by"],
        x_bound=dk["x_bound"], launches=dk["launches"],
        pipelined_pass_launches=bench["pipelined_pass"]["launches"]["pack2"],
        per_shape=[d for d in bench["pipelined_pass"]["per_shape"]
                   if d["lane"] == "pack2"])
    kernels[1]["sharded"] = dict(
        chunk_launches_per_shard=[d["launches"]["pack4"]
                                  - d["warmup_launches"]["pack4"]
                                  for d in in15["per_shard"]],
        warmup_launches_per_shard=[d["warmup_launches"]["pack4"]
                                   for d in in15["per_shard"]])
    kernels[2]["sharded"] = dict(chunk_launches_per_shard=[
        d["launches"]["byte"] for d in in15["per_shard"]])
    # phase 16: each configuration's launches by task, time and bound per
    # shape, per lane
    for kernel, lane in zip(kernels, ("pack2", "pack4", "byte")):
        kernel["dispatch_modes"] = {
            key: c["lanes"][lane] for key, c in modes16["cells"].items()
            if lane in c["lanes"]}
    # the scatter kernel: its path is phase 14's; the reported time, bound
    # and library call are those of one flagship chunk's flush
    top = next(d for d in scatter if d["entry"] == "flush")
    forced_flag = mesh14["forced"]["flagship"]
    kernels.append(dict(
        name="stats_scatter", route="cuda",
        source="cutadapt_tpu_torch/csrc/stats_scatter.cu",
        replaces="cutadapt_tpu/parallel/stats.py:54",
        launches=forced_flag["scatter_launches"]["batch"], parity="ok",
        max_abs_err=max(d["max_abs_err"] for d in scatter),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=top["library_ms"],
        descriptors_by_mode=forced_flag["scatter_descriptors"],
        per_entry=scatter,
        reducer_forced=mesh14["forced"],
        mesh={label: dict(scatter_launches=c["scatter_launches"],
                          flushes=c["flushes"])
              for label, c in mesh14["mesh"]["configs"].items()},
        sharded_step=step14,
        # phase 15 (c) runs the reducer in the shard processes, whose
        # counters this process does not see
        sharded=dict(chunk_launches_per_shard=None),
    ))
    log(f"reads_per_sec {rps}")
    log("seconds per phase " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()})
        + f"; {time.perf_counter() - started:.1f} s in all")
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
