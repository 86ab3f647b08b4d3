#!/usr/bin/env python
"""Randomized engine-vs-host CLI parity fuzz of cutadapt_tpu_torch.

The port's counterpart of tools/fuzz_parity.py, with the same input
generators, option draws, output comparison, JSON comparison and rule
for two input errors. Each iteration generates random (sometimes
degenerate) inputs, FASTQ or FASTA, two-file or interleaved paired, and
a random option set, runs them through ``cutadapt_tpu_torch.cli.main``
with the engine on (CUTADAPT_TPU_TORCH_BATCH=1) and off (0), and
requires identical outputs (every file written under the run's output
directory, demultiplexed and side files included), JSON reports and
failure modes. The engine run also draws the port's own knobs, all of
which must be invisible in the results: CUTADAPT_TPU_TORCH_EXACT_WIRE
(batch-max row widths), CUTADAPT_TPU_TORCH_DEVICE_STATS (the statistics
reducer), CUTADAPT_TPU_TORCH_CHUNK_BYTES (multi-chunk runs) and
CUTADAPT_TPU_TORCH_DEVICES (a mesh of N shards; on the CPU, N shards of
the CPU; on CUDA the first N cards). The JAX tool's WORKERS has no
counterpart in the port (its pooled drive was removed): that draw picks
the shard count. Its 2-bit-lane and device-prefilter draws are made
and dropped (the port has one lane rule and the host prefilter only), so
a seed gives both tools the same inputs and arguments. --shard is never
drawn: sharding has tests of its own.

On CUDA (the default) an engine run that reached the plain aligner
version, which only CPU tensors take, counts as a mismatch.

Usage: python tools/fuzz_parity_torch.py [iterations] [seed_base]
       [--device cpu]
Prints one MISMATCH line per failing iteration, "done: N iterations, M
mismatches" and a last JSON line `fuzz_parity_torch {...}`; exits 1 on
any mismatch.
"""

import argparse
import json
import logging
import os
import random
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from cutadapt_tpu_torch import accel  # noqa: E402
from cutadapt_tpu_torch.cli import main  # noqa: E402
from cutadapt_tpu_torch.ops import align_cuda  # noqa: E402

A3 = "AGATCGGAAGAGCACACGTC"
A5 = "CTGTCTCTTATACACATCT"
AW = "ANGATNACGGA"
# the engine run's knobs, unset for the host run
KNOBS = ("CUTADAPT_TPU_TORCH_DEVICE_STATS", "CUTADAPT_TPU_TORCH_EXACT_WIRE",
         "CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_TORCH_DEVICES")

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _records(rng, ad, n, fasta, qual_lo, casava, pair_tag=None):
    recs = []
    for i in range(n):
        L = rng.randint(1, 95)
        s = "".join(rng.choice("ACGTN") for _ in range(L))
        if rng.random() < 0.5 and L > 24:
            pos = rng.randint(0, L - 20)
            s = (s[:pos] + ad + s[pos:])[:L]
            if rng.random() < 0.25:
                # reverse-complement the whole read so --revcomp
                # genuinely picks the rc orientation for a share
                s = "".join(_COMP[c] for c in reversed(s))
        com = f"1:{'Y' if i % 2 else 'N'}:0:AT" if casava else f"c{i}"
        name = f"f{i}/{pair_tag}" if pair_tag else f"f{i}"
        if fasta:
            if rng.random() < 0.3 and L > 10:  # multi-line wrapping
                s = s[:10] + "\n" + s[10:]
            recs.append(f">{name} {com}\n{s}\n")
        else:
            q = "".join(chr(rng.randint(qual_lo, 74)) for _ in s)
            recs.append(f"@{name} {com}\n{s}\n+\n{q}\n")
    return recs


def make_input(tmp, rng, paired, fasta, interleaved):
    # occasionally emit quality bytes below '!' (negative phred):
    # they exercise the exact BWA-trim arithmetic and ZeroCapper
    qual_lo = 20 if rng.random() < 0.2 else 33
    casava = rng.random() < 0.25  # for --discard-casava
    ext = "fasta" if fasta else "fastq"
    n = rng.randint(50, 400)
    if interleaved:
        r1 = _records(rng, A3, n, fasta, qual_lo, casava, pair_tag=1)
        r2 = _records(rng, A5, n, fasta, qual_lo, casava, pair_tag=2)
        p = os.path.join(tmp, f"in.{ext}")
        with open(p, "w") as f:
            for a, b in zip(r1, r2):
                f.write(a + b)
        return [p]
    paths = []
    for side, ad in enumerate([A3, A5][: 2 if paired else 1]):
        p = os.path.join(tmp, f"in{side}.{ext}")
        with open(p, "w") as f:
            f.writelines(_records(rng, ad, n, fasta, qual_lo, casava))
        paths.append(p)
    return paths


def random_args(rng, paired):
    args = []
    if paired and rng.random() < 0.15:
        # --pair-adapters needs matching per-side adapter counts
        args += ["--pair-adapters", "-a", "pa1=" + A3, "-A", "pa2=" + A5]
        if rng.random() < 0.5:
            args += ["-a", "pb1=ACGTACGTAC", "-A", "pb2=TTGACCGGAA"]
        if rng.random() < 0.3:
            args += ["DEMUX"]  # route pairs by the winning pair's name
        return args + _common_args(rng, paired)
    if rng.random() < 0.1:
        # demultiplexing: a named anchored-prefix barcode set
        for k, bc in enumerate(("AACC", "GGTT", "ACGT")):
            args += ["-g", f"bc{k}=^{bc}"]
        return args + ["DEMUX"] + _common_args(rng, paired)
    adapters = rng.sample([
        ["-a", A3], ["-g", A5], ["-b", "ACGTACGTAC"], ["-g", "^" + A5[:8]],
        ["-a", A3[:10] + "$"], ["-a", AW], ["-g", A5[:8] + "..." + A3[:8]],
        ["-a", A3 + ";e=0.2"],
    ], k=rng.randint(1, 3))
    for k, a in enumerate(adapters):
        # explicit names: the auto-name counter is process state and
        # would differ between the two in-process runs
        args += [a[0], f"ad{k}={a[1]}"]
    return args + _common_args(rng, paired)


def _common_args(rng, paired):
    args = []
    if rng.random() < 0.4:
        args += ["-q", str(rng.choice(["10", "15,12"]))]
    if rng.random() < 0.3:
        args += ["-u", str(rng.choice([3, -4]))]
    if rng.random() < 0.3:
        args += ["--times", "2"]
    if rng.random() < 0.3:
        args += ["--no-indels"]
    if rng.random() < 0.25:
        args += ["--action=" + rng.choice(
            ["retain", "mask", "lowercase", "none", "crop"])]
    if rng.random() < 0.3:
        args += ["-m", "10"]
    if rng.random() < 0.2:
        args += ["-M", "80"]
    if rng.random() < 0.2:
        args += ["--max-n", "3"]
    if rng.random() < 0.2:
        args += ["--discard-untrimmed"]
    if rng.random() < 0.15:
        args += ["--trim-n"]
    if rng.random() < 0.15:
        args += ["--poly-a"]
    if rng.random() < 0.15:
        args += ["--length", "60"]
    if rng.random() < 0.2:
        args += ["--rename", "{id} a={adapter_name} m={match_sequence}"]
    elif rng.random() < 0.2:
        args += ["-y", "_{name}", "-z"]
    if rng.random() < 0.15:
        args += ["--revcomp"]
    if rng.random() < 0.2:
        which = rng.random()
        if which < 0.4:
            args += ["-r", "REST"]
        elif which < 0.8:
            args += ["--info-file", "INFO"]
            if paired and rng.random() < 0.5:
                args += ["--info-file-paired", "INFO2"]
        else:
            args += ["--wildcard-file", "WC"]
    if rng.random() < 0.15:
        args += ["FASTA_OUT"]  # marker: .fasta outputs
    if rng.random() < 0.1:
        args += ["--zero-cap"]
    if rng.random() < 0.1:
        args += ["--max-ee", "8"]
    if rng.random() < 0.1:
        args += ["--discard-casava"]
    return args


def collect_outputs(out_dir):
    """Every file under out_dir, keyed by relative name."""
    data = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name), "rb") as f:
            data[name] = f.read()
    return data


def run_once(tmp, env, knobs, args, inputs, paired, interleaved, fasta_in):
    """One main call with CUTADAPT_TPU_TORCH_BATCH=env and, for the
    engine run, ``knobs``: ("ok", files, JSON report), ("exit", code) or
    ("raise", exception type)."""
    os.environ["CUTADAPT_TPU_TORCH_BATCH"] = env
    for key in KNOBS:
        os.environ.pop(key, None)
    if env == "1":
        os.environ.update({k: v for k, v in knobs.items() if v})
    demux = "DEMUX" in args
    out_dir = os.path.join(tmp, f"out{env}")
    os.makedirs(out_dir)
    ext = ".fasta" if "FASTA_OUT" in args or fasta_in else ".fastq"
    o1 = os.path.join(out_dir, ("dm-{name}" if demux else "o1") + ext)
    o2 = os.path.join(out_dir, ("dm2-{name}" if demux else "o2") + ext)
    rep = os.path.join(out_dir, "r.json")
    argv = ["--quiet", "--json", rep]
    side_paths = {flag: os.path.join(out_dir, flag)
                  for flag in ("REST", "INFO", "INFO2", "WC") if flag in args}
    argv += [side_paths.get(a, a) for a in args
             if a not in ("FASTA_OUT", "DEMUX")] + ["-o", o1]
    if paired and not (interleaved and not demux):
        argv += ["-p", o2]
    if interleaved:
        argv += ["--interleaved"]
    try:
        main(argv + inputs)
    except SystemExit as e:
        return ("exit", e.code)
    except Exception as e:
        return ("raise", type(e).__name__)
    finally:
        logging.root.handlers.clear()
    with open(rep) as f:
        r = json.load(f)
    r["command_line_arguments"] = None
    return ("ok", collect_outputs(out_dir), json.dumps(r, sort_keys=True))


def draw(seed: int):
    """An iteration's draws in the JAX tool's order: (the generator, left
    where the inputs are drawn, paired, interleaved, FASTA input, the
    engine run's knobs)."""
    rng = random.Random(seed)
    paired = rng.random() < 0.45
    interleaved = paired and rng.random() < 0.3
    fasta_in = rng.random() < 0.2
    rng.choice(["0", "1"])  # the JAX tool's 2-bit-lane switch
    knobs = {"CUTADAPT_TPU_TORCH_DEVICE_STATS": rng.choice(["0", "1"])}
    # the JAX tool's WORKERS draw: the shard count here
    knobs["CUTADAPT_TPU_TORCH_DEVICES"] = rng.choice(["1", "2", "3"])
    knobs["CUTADAPT_TPU_TORCH_EXACT_WIRE"] = rng.choice(["0", "1"])
    rng.choice(["0", "0", "1"])  # the JAX tool's device prefilter
    # small chunk sizes force multi-chunk engine runs; chunking must be
    # invisible in the results
    knobs["CUTADAPT_TPU_TORCH_CHUNK_BYTES"] = rng.choice(["", "3000", "12000"])
    return rng, paired, interleaved, fasta_in, knobs


def main_fuzz(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iterations", type=int, nargs="?", default=60)
    ap.add_argument("seed_base", type=int, nargs="?", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the aligner's plain version (tests)")
    opts = ap.parse_args(argv)
    if opts.device == "cpu":
        os.environ["CUTADAPT_TPU_TORCH_DEVICE"] = "cpu"
    else:
        os.environ.pop("CUTADAPT_TPU_TORCH_DEVICE", None)
    failures = 0
    fallbacks = accel.FALLBACK_COUNT
    plain_on_card = 0
    for it in range(opts.iterations):
        seed = (opts.seed_base + it if opts.seed_base is not None
                else 1000 + it)
        rng, paired, interleaved, fasta_in, knobs = draw(seed)
        with tempfile.TemporaryDirectory() as tmp:
            inputs = make_input(tmp, rng, paired, fasta_in, interleaved)
            args = random_args(rng, paired)
            plain = sum(align_cuda.PLAIN_RUNS.values())
            outs = {env: run_once(tmp, env, knobs, args, inputs, paired,
                                  interleaved, fasta_in)
                    for env in ("1", "0")}
            plain = sum(align_cuda.PLAIN_RUNS.values()) - plain
        for key in KNOBS:
            os.environ.pop(key, None)
        os.environ.pop("CUTADAPT_TPU_TORCH_BATCH", None)
        # When an input carries MORE THAN ONE defect (e.g. improper
        # pairing AND invalid phred bytes), the per-read host path and
        # the per-chunk engine may report different defects first, as
        # cutadapt's own multicore runner may. Any two clean input-error
        # outcomes are equivalent; internal failure types (KeyError etc.)
        # still count as mismatches.
        input_errors = (("exit", 1), ("raise", "ValueError"))
        both_input_errors = all(
            tuple(outs[e][:2]) in input_errors for e in ("1", "0"))
        on_card_plain = opts.device == "cuda" and plain > 0
        plain_on_card += on_card_plain
        if (outs["1"] != outs["0"] and not both_input_errors) or on_card_plain:
            failures += 1
            print(f"MISMATCH iter {it} (seed {seed}): {' '.join(args)} "
                  f"paired={paired} interleaved={interleaved} "
                  f"fasta={fasta_in} knobs={knobs} "
                  f"engine={outs['1'][:2] if outs['1'][0] != 'ok' else 'ok'} "
                  f"host={outs['0'][:2] if outs['0'][0] != 'ok' else 'ok'} "
                  f"plain_runs={plain}", flush=True)
    print(f"done: {opts.iterations} iterations, {failures} mismatches")
    print("fuzz_parity_torch " + json.dumps(dict(
        iterations=opts.iterations, mismatches=failures,
        device=opts.device, engine_fallbacks=accel.FALLBACK_COUNT - fallbacks,
        plain_runs_on_card=plain_on_card,
        launches=dict(align_cuda.LAUNCHES))))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main_fuzz())
