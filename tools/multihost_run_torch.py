#!/usr/bin/env python
"""
Sharded run coordinator for cutadapt_tpu_torch: COUNT processes, one
input shard each.

Turns the byte-range shard contract (cutadapt_tpu_torch/parallel/
multihost.py) into one command: launch COUNT `--shard i/COUNT`
processes of `python -m cutadapt_tpu_torch` over the same argv,
concatenate their output shards in shard order (the multi-process form
of the ordered chunk writer's invariant), merge their statistics
pickles, and print the merged report. The result is byte-identical to
the same argv run unsharded.

    python tools/multihost_run_torch.py -n 4 -- \\
        -a ADAPTER -o out.fastq.gz in.fastq

Compressed outputs concatenate correctly: gzip, bz2 and xz all define
a multi-member stream as the concatenation of members. Compressed
inputs are refused by `--shard` (they are not byte-addressable).

Every shard process runs on CUDA unless the environment says otherwise
(CUTADAPT_TPU_TORCH_DEVICE=cpu); several processes share one card, each
with its own CUDA context. On several machines each runs its own
`python -m cutadapt_tpu_torch --shard i/N`, and any one concatenates
and merges afterwards; this tool is that contract on one machine and
the harness for byte-parity tests.

Prints the merged report on stdout and, on stderr, one line per shard
(its exit code and seconds from start to exit) and a last JSON line
`multihost_run_torch {...}` with the same numbers, the seconds of the
concatenation and of the merge, and the wall time.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMPRESSED = (".gz", ".bz2", ".xz", ".zst", ".lzma")


def _split_output_args(argv):
    """Indexes of the -o/-p value slots in argv (for per-shard rewrite)."""
    slots = {}
    for i, arg in enumerate(argv):
        if arg in ("-o", "--output"):
            slots["o"] = i + 1
        elif arg in ("-p", "--paired-output"):
            slots["p"] = i + 1
    return slots


def _shard_path(final: str, i: int, n: int) -> str:
    """Keep the compression extension last, so that the shard is
    compressed as the final file is (the writer picks the codec by the
    name's suffix)."""
    for ext in _COMPRESSED:
        if final.lower().endswith(ext):
            return f"{final}.shard{i}of{n}{ext}"
    return f"{final}.shard{i}of{n}"


def _wait_all(procs, started):
    """Wait for every shard process; the first that fails terminates
    the others. Returns (seconds from start to exit per shard, the exit
    code of the first failure or 0)."""
    seconds = {}
    pending = dict(procs)
    while pending:
        for i, p in list(pending.items()):
            if p.poll() is None:
                continue
            seconds[i] = time.perf_counter() - started[i]
            del pending[i]
            if p.returncode != 0:
                for q in pending.values():
                    q.terminate()
                for q in pending.values():
                    q.wait()
                print(f"shard {i} failed (exit {p.returncode})",
                      file=sys.stderr)
                return seconds, p.returncode
        time.sleep(0.005)
    return seconds, 0


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("-n", "--hosts", type=int, required=True,
                    help="number of shard processes")
    ap.add_argument("--sequential", action="store_true",
                    help="run shards one at a time (bounded memory)")
    ap.add_argument("--keep-shards", action="store_true",
                    help="keep per-shard outputs and statistics pickles "
                         "next to the final files")
    ap.add_argument("argv", nargs=argparse.REMAINDER,
                    help="cutadapt-tpu-torch arguments (prefix with --)")
    opts = ap.parse_args(args)
    argv = opts.argv
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        ap.error("no cutadapt-tpu-torch arguments given (put them after --)")
    n = opts.hosts
    if n < 1:
        ap.error("--hosts must be >= 1")
    slots = _split_output_args(argv)
    if "o" not in slots:
        ap.error("the sharded argv must write to a file (-o OUT)")
    for key in slots:
        if "{" in argv[slots[key]]:
            ap.error("demultiplexing templates cannot be sharded by "
                     "output concatenation; run demux per shard instead")

    t0 = time.perf_counter()
    keys = sorted(slots)
    # (final path, shard paths in order) per output slot
    shard_files = [(argv[slots[k]], []) for k in keys]
    stats_pickles = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs, started, seconds = {}, {}, {}
    for i in range(n):
        shard_argv = list(argv)
        for (final, paths), key in zip(shard_files, keys):
            sp = _shard_path(final, i, n)
            shard_argv[slots[key]] = sp
            paths.append(sp)
        shard_argv += ["--shard", f"{i}/{n}"]
        pickle_path = f"{shard_files[0][1][i]}.stats.pickle"
        stats_pickles.append(pickle_path)
        cmd = [sys.executable, "-m", "cutadapt_tpu_torch", "--quiet"]
        started[i] = time.perf_counter()
        p = subprocess.Popen(
            cmd + shard_argv,
            env={**env, "CUTADAPT_TPU_TORCH_STATS_PICKLE": pickle_path})
        if opts.sequential:
            done, rc = _wait_all({i: p}, started)
            seconds.update(done)
            if rc:
                return rc
        else:
            procs[i] = p
    done, rc = _wait_all(procs, started)
    seconds.update(done)
    if rc:
        return rc
    for i in range(n):
        print(f"shard {i}/{n}: exit 0 in {seconds[i]:.3f} s",
              file=sys.stderr)

    # shard-order concatenation reproduces the unsharded byte stream
    t_cat = time.perf_counter()
    for final, paths in shard_files:
        with open(final, "wb") as out:
            for sp in paths:
                with open(sp, "rb") as f:
                    shutil.copyfileobj(f, out, 16 * 1024 * 1024)
                if not opts.keep_shards:
                    os.unlink(sp)
    t_merge = time.perf_counter()

    sys.path.insert(0, _REPO)
    from cutadapt_tpu_torch.parallel.multihost import merge_statistics
    from cutadapt_tpu_torch.report import full_report

    stats = merge_statistics(stats_pickles)
    if not opts.keep_shards:
        for sp in stats_pickles:
            os.unlink(sp)
    t_end = time.perf_counter()
    print(full_report(stats, t_end - t0, 0.5))
    print("multihost_run_torch " + json.dumps(dict(
        shards=n, sequential=opts.sequential,
        shard_seconds=[seconds[i] for i in range(n)],
        concat_seconds=t_merge - t_cat, merge_seconds=t_end - t_merge,
        wall_seconds=t_end - t0,
    )), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
