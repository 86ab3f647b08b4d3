#!/usr/bin/env python
"""
Measure the BASELINE.md configuration matrix on cutadapt_tpu_torch:
reads/s of the per-read host path against the port's engine, through the
real CLI (cutadapt_tpu_torch.cli.main), on synthetic datasets.

The port's counterpart of bench_configs.py: the same five
configurations, the same reads (make_reads, seeds 1, 2 and 9). For each,
the engine runs under CUTADAPT_TPU_TORCH_BATCH=require, so that a run
the engine declines fails instead of timing the host path under the
engine's name, once to warm and once timed; the host path runs under
CUTADAPT_TPU_TORCH_BATCH=0. Every output file of the two paths must be
byte-identical, the demultiplexed files included: any difference exits 1.
Prints one line per configuration, then one JSON line with each
configuration's reads/s (pairs/s for the paired one) on both paths, its
parity and the device. bench_torch.py stays the headline benchmark.

The engine runs on CUDA; with CUTADAPT_TPU_TORCH_DEVICE=cpu it runs the
plain aligner on the host (a rehearsal; its times are the host's).
Without a card and without that setting it exits 2 and prints no result.

Usage: python bench_configs_torch.py [n_reads] [--work-dir DIR]
(--work-dir keeps each configuration's inputs and outputs under DIR.)
"""

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

N_READS = 200_000
READ_LEN = 100
A3 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A5 = "CTGTCTCTTATACACATCT"
AW = "AGANCGGAAGANCACACGT"  # IUPAC wildcards
A3_R2 = "AGATCGGAAGAGCGTCGTGTAGGGA"
DEMUX_NAME = "demux 8 barcodes (-g ^file:, e=1, no-indels)"
# CUTADAPT_TPU_TORCH_BATCH of each path
PATHS = (("engine", "require"), ("host", "0"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_reads(n, seed, adapters, frac=0.3, polya=False):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        L = int(rng.randint(40, READ_LEN + 1))
        s = bytearray(bases[rng.randint(0, 4, L)].tobytes())
        if adapters and rng.rand() < frac:
            ad = adapters[rng.randint(len(adapters))].encode()
            p = int(rng.randint(10, max(11, L - 4)))
            take = min(len(ad), L - p)
            s[p : p + take] = ad[:take]
        if polya and rng.rand() < 0.3:
            tail = min(int(rng.randint(3, 20)), L - 1)
            s[L - tail :] = b"A" * tail
        q = rng.randint(35, 74, L).astype(np.uint8).tobytes()
        out.append(b"@r%d/1 c\n%s\n+\n%s\n" % (i, bytes(s), q))
    return b"".join(out)


def configs():
    """(name, args(d, label), paired) of the four configurations beside
    the demultiplexing one; label names a run's output files."""
    return [
        (
            "SE 3' adapter trim (-a, e=0.1)",
            lambda d, l: ["-a", A3, "-o", f"{d}/out-{l}.fastq"],
            False,
        ),
        (
            "5' + anywhere, IUPAC wildcards, --no-indels",
            lambda d, l: [
                "-g", A5, "-b", AW, "--no-indels",
                "-o", f"{d}/out-{l}.fastq",
            ],
            False,
        ),
        (
            "paired -a/-A + -q 15 + length filters",
            lambda d, l: [
                "-a", A3, "-A", A3_R2, "-q", "15", "-m", "20", "-M", "95",
                "-o", f"{d}/out-{l}.fastq", "-p", f"{d}/out2-{l}.fastq",
            ],
            True,
        ),
        (
            "-q 20 + -a + --poly-a + -m 10",
            lambda d, l: [
                "-q", "20", "-a", A3, "--poly-a", "-m", "10",
                "-o", f"{d}/out-{l}.fastq",
            ],
            False,
        ),
    ]


def demux_args(d, label):
    return ["-g", f"^file:{d}/bc.fasta", "-e", "1", "--no-indels",
            "-o", f"{d}/{label}/out-{{name}}.fastq"]


def run_cli(args, env_batch):
    """cli.main on ``args`` with CUTADAPT_TPU_TORCH_BATCH=env_batch;
    returns elapsed seconds."""
    import logging

    from cutadapt_tpu_torch.cli import main

    os.environ["CUTADAPT_TPU_TORCH_BATCH"] = env_batch
    t0 = time.perf_counter()
    main(args)
    dt = time.perf_counter() - t0
    logging.root.handlers.clear()
    return dt


def write_inputs(name, paired, d, n_reads):
    """The configuration's input files in d (bench_configs.py's reads)."""
    if paired:
        inputs = [f"{d}/r1.fastq", f"{d}/r2.fastq"]
        for path, seed, adapter in zip(inputs, (1, 2), (A3, A3_R2)):
            with open(path, "wb") as f:
                f.write(make_reads(n_reads, seed, [adapter]))
    else:
        inputs = [f"{d}/in.fastq"]
        with open(inputs[0], "wb") as f:
            f.write(make_reads(n_reads, 1, [A3], polya="poly" in name))
    return inputs


def same_files(pairs) -> bool:
    """Every (a, b) path pair holds the same bytes."""
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                log(f"differs: {a} against {b}")
                return False
    return True


def report(name, results, parity, unit="r/s"):
    print(
        f"{name:45s} host {results['host']:>10,.0f} {unit}   "
        f"engine {results['engine']:>10,.0f} {unit}   "
        f"speedup {results['engine']/results['host']:6.1f}x   "
        f"parity {'OK' if parity else 'FAIL'}", flush=True
    )


def bench_config(name, args_fn, paired, d, n_reads):
    inputs = write_inputs(name, paired, d, n_reads)
    results = {}
    for label, env in PATHS:
        if label == "engine":  # warm outside the timed run
            run_cli(["--quiet"] + args_fn(d, "warm") + inputs, env)
        dt = run_cli(["--quiet"] + args_fn(d, label) + inputs, env)
        results[label] = n_reads / dt
    outs = sorted(glob.glob(f"{d}/out*-host.fastq"))
    parity = bool(outs) and same_files(
        (f, f.replace("-host.fastq", "-engine.fastq")) for f in outs)
    report(name, results, parity, "p/s" if paired else "r/s")
    return results, parity


def bench_demux(d, n_reads):
    rng = np.random.RandomState(9)
    bases = list("ACGT")
    barcodes = ["".join(rng.choice(bases, 10)) for _ in range(8)]
    with open(f"{d}/bc.fasta", "w") as fh:
        fh.write("".join(f">bc{i}\n{b}\n" for i, b in enumerate(barcodes)))
    recs = []
    for i in range(n_reads):
        L = int(rng.randint(40, 90))
        s = "".join(rng.choice(bases, L))
        if rng.rand() < 0.8:
            s = barcodes[rng.randint(8)] + s
        recs.append(f"@d{i}\n{s}\n+\n{'I' * len(s)}\n")
    inp = f"{d}/in.fastq"
    with open(inp, "w") as f:
        f.write("".join(recs))
    results = {}
    for label, env in PATHS:
        os.makedirs(f"{d}/{label}")
        args = ["--quiet"] + demux_args(d, label) + [inp]
        if label == "engine":
            run_cli(args, env)  # warm
            for f in glob.glob(f"{d}/engine/*.fastq"):
                os.unlink(f)
        dt = run_cli(args, env)
        results[label] = n_reads / dt
    host = sorted(os.listdir(f"{d}/host"))
    parity = (bool(host) and host == sorted(os.listdir(f"{d}/engine"))
              and same_files((f"{d}/host/{f}", f"{d}/engine/{f}")
                             for f in host))
    report(DEMUX_NAME, results, parity)
    return results, parity


def restore_batch(saved) -> None:
    if saved is None:
        os.environ.pop("CUTADAPT_TPU_TORCH_BATCH", None)
    else:
        os.environ["CUTADAPT_TPU_TORCH_BATCH"] = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("n_reads", type=int, nargs="?", default=N_READS)
    ap.add_argument("--work-dir", help="keep inputs and outputs here")
    opts = ap.parse_args(argv)
    n_reads = opts.n_reads
    import torch

    on_cpu = os.environ.get("CUTADAPT_TPU_TORCH_DEVICE") == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        log("bench_configs_torch: torch.cuda.is_available() is False: the "
            "engine needs an NVIDIA GPU (CUTADAPT_TPU_TORCH_DEVICE=cpu runs "
            "the plain aligner on the host)")
        return 2
    device = "cpu" if on_cpu else torch.cuda.get_device_name(0)
    log(f"device: {device}  n_reads={n_reads}")
    saved = os.environ.get("CUTADAPT_TPU_TORCH_BATCH")
    rows = []
    with contextlib.ExitStack() as stack:
        work = opts.work_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="bench_configs_torch_"))
        stack.callback(restore_batch, saved)
        for i, (name, args_fn, paired) in enumerate(configs()):
            d = os.path.join(work, f"c{i}")
            os.makedirs(d)
            results, parity = bench_config(name, args_fn, paired, d,
                                           n_reads)
            rows.append((name, "pairs/s" if paired else "reads/s", results,
                         parity))
        d = os.path.join(work, "demux")
        os.makedirs(d)
        results, parity = bench_demux(d, n_reads)
        rows.append((DEMUX_NAME, "reads/s", results, parity))
    ok = all(parity for *_, parity in rows)
    print(json.dumps({
        "configs": [dict(name=name, unit=unit, host=r["host"],
                         engine=r["engine"], speedup=r["engine"] / r["host"],
                         parity=parity)
                    for name, unit, r, parity in rows],
        "n_reads": n_reads, "device": device, "parity": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
