#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken. Its outputs and report stand in for one call of
the program on each timed file and go through run.judge, the checks and
limits that decide ``correct`` in every run; it has to come out as not
correct. The broken guarantee: an N in a read is a mismatch (cutadapt's
default, no --match-read-wildcards); the control lets it match any
base, the shortcut that would keep reads with N in the aligner's 2-bit
lane instead of its 4-bit one.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed, on the card at the cell's own size: the
checks with their values and limits, how far the control is off (output
blocks and report fields that differ), and whether it is correct.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def broken(cfg: dict) -> dict:
    """The configuration with N in reads matching any base."""
    return dict(cfg, read_wildcards=True)


def readings(workload: str, seed: int, device: str = "cuda",
             reads=None) -> dict:
    """The control of ``workload`` on ``seed``, judged as run.py judges a
    run (``reads`` makes the files smaller)."""
    from benchmark import generate, run

    cell, cfg, _, _ = run.load_cell(workload,
                                    os.path.join(ROOT, "BENCHMARK.json"))
    traffic = generate.load_traffic(cell["traffic"])
    if reads is not None:
        traffic = dict(traffic, reads_per_file=reads)
    ref = run.load_reference(cfg)
    wants, calls = [], []
    for i in range(traffic.get("files", 1)):
        mates = generate.make(traffic, seed, generate.file_stream(i), device)
        wants.append(run.reference_output(ref, cfg, mates, device))
        got = run.reference_output(ref, broken(cfg), mates, device)
        # one launch: the reference stands in for the program's kernel
        calls.append(run.Call(i, got["digests"], got["summary"], launches=1))
    checks, notes = run.judge(calls, wants)
    return {"workload": workload, "seed": seed, "reads": len(mates[0]),
            "checks": checks,
            "output_blocks_differing": notes["output_blocks_differing"],
            "report_fields_differing": notes["report_fields_differing"],
            "correct": run.passes(checks)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
