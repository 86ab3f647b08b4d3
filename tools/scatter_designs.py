#!/usr/bin/env python3
"""
Same-call comparison of designs for the batched statistics scatter
kernel: the shipped kernel (cutadapt_tpu_torch/csrc/stats_scatter.cu)
against the variants of tools/scatter_designs.cu, each launched through
the shipped wrapper (cutadapt_tpu_torch/ops/stats_cuda.py).

    python3 tools/scatter_designs.py

On one NVIDIA GPU the script builds every variant with nvcc (one process
each, started together) into tools/build/, checks each against the plain
version on every case (tolerance: exact), times each case in a CUDA
graph (the mean of 50 calls, chip_smoke.py:cuda_ms) with the shipped
kernel first and again last, and prints the card's name and power limit
and one JSON line ``designs: {...}`` with each design's microseconds per
case. The cases are chip_smoke.py's phase 14 shapes: 33,000 removal
events into 128 x 64, 131,072 written lengths into 128 bins, a
131,072-entry count, one flagship chunk's flush (those three buffers'
kinds and 101 weighted written-length bins in one launch), 101 weighted
events alone, and a long-read removal histogram (direct mode) beside a
192 x 64 one.

Run from the repository root; it exits 2 without a card.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# name -> macros of tools/scatter_designs.cu
DESIGNS = {
    # bins split over the cluster (each bin in one block), remote atomics
    # into the owner, warp-combined adds, 1024 threads, one cluster per
    # descriptor
    "first": dict(DESIGN_PRIVATE=0, DESIGN_AGG=1, DESIGN_THREADS=1024),
    "first_uncombined": dict(DESIGN_PRIVATE=0, DESIGN_AGG=0,
                             DESIGN_THREADS=1024),
    "split_clusters": dict(DESIGN_PRIVATE=0, DESIGN_AGG=0,
                           DESIGN_THREADS=256, DESIGN_EPC=4096),
    "private_combined": dict(DESIGN_PRIVATE=1, DESIGN_AGG=1,
                             DESIGN_THREADS=256, DESIGN_EPC=4096),
    "private_popc": dict(DESIGN_PRIVATE=1, DESIGN_AGG=2, DESIGN_THREADS=256,
                         DESIGN_EPC=4096),
    "private_4_per_thread": dict(DESIGN_PRIVATE=1, DESIGN_AGG=0,
                                 DESIGN_THREADS=256, DESIGN_EPC=4096),
    "private_no_cluster": dict(DESIGN_PRIVATE=1, DESIGN_AGG=0,
                               DESIGN_THREADS=256, DESIGN_EPC=2048,
                               DESIGN_CLUSTER=1, DESIGN_MAX_CLUSTERS=128),
    "empty": dict(DESIGN_EMPTY=1, DESIGN_THREADS=256),
}


def build(name, macros, out):
    so = os.path.join(HERE, "build", f"scatter_{name}.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    from cutadapt_tpu_torch.ops.align_cuda import NVCC_FLAGS, _nvcc

    r = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in macros.items()),
         "-o", so, os.path.join(HERE, "scatter_designs.cu")],
        capture_output=True, text=True, timeout=600)
    out[name] = so if r.returncode == 0 else r.stderr


def cases(dev):
    import torch

    rng = np.random.RandomState(14)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def buf(shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def removals(n, rows):
        return (t(np.minimum(rng.geometric(0.08, n), rows - 1)),
                t(np.minimum(rng.geometric(0.6, n) - 1, 3)))

    written = rng.randint(0, 101, 131072)
    hist = np.bincount(written)
    nz = np.flatnonzero(hist)
    mask = t(rng.rand(131072) < 0.25)
    return [
        ("hist2d", [(buf((128, 64)), *removals(33000, 128),
                     t(np.ones(33000)))]),
        ("hist1d", [(buf((128,)), t(written), t(np.ones(131072)))]),
        ("count", [(buf(()), mask)]),
        ("flush", [(buf((128, 64)), *removals(33000, 128), None),
                   (buf((64,)), t(rng.randint(0, 5, 33000)), None),
                   (buf((128,)), t(nz), t(hist[nz])), (buf(()), mask)]),
        ("weighted_101", [(buf((128,)), t(nz), t(hist[nz]))]),
        ("direct", [(buf((32768, 64)), *removals(8192, 32768), None),
                    (buf((192, 64)), *removals(33000, 192), None)]),
    ]


def run_design(sc, lib, all_cases, cuda_ms, check):
    import torch

    sc._LIB = lib
    out = {}
    for cname, descs in all_cases:
        if check:
            copies = {}
            want = [(copies.setdefault(d[0].data_ptr(), d[0].clone()),)
                    + tuple(d[1:]) for d in descs]
            sc.scatter_add_batch(descs)
            sc.scatter_add_batch_reference(want)
            torch.cuda.synchronize()
            if not all(torch.equal(d[0], w[0]) for d, w in zip(descs, want)):
                out[cname] = None  # differs from the plain version
                continue
        out[cname] = cuda_ms(lambda: sc.scatter_add_batch(descs), 50,
                             graph=True) * 1e3
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scatter_designs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cutadapt_tpu_torch.ops import stats_cuda as sc

    built = {}
    threads = [threading.Thread(target=build, args=(n, m, built))
               for n, m in DESIGNS.items()]
    threads.append(threading.Thread(target=sc.build_library))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = {n: v for n, v in built.items() if not v.endswith(".so")}
    if failed:
        print(f"scatter_designs: nvcc failed: {failed}", file=sys.stderr)
        return 1
    shipped = sc._library()
    all_cases = cases(torch.device("cuda", 0))
    result = {"shipped": run_design(sc, shipped, all_cases, cs.cuda_ms, True)}
    for name in DESIGNS:
        lib = ctypes.CDLL(built[name])
        lib.stats_scatter_batch_launch.restype = ctypes.c_int
        lib.stats_scatter_batch_launch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        result[name] = run_design(sc, lib, all_cases, cs.cuda_ms,
                                  name != "empty")
    result["shipped_again"] = run_design(sc, shipped, all_cases, cs.cuda_ms,
                                         False)
    sc._LIB = shipped
    for name, res in result.items():
        print(f"{name}: " + ", ".join(
            f"{c} {'differs' if us is None else f'{us:.2f} us'}"
            for c, us in res.items()), flush=True)
    print(cs.nvidia_smi("name,power.limit"))
    print("designs: " + json.dumps(result), flush=True)
    wrong = [n for n, r in result.items() if None in r.values()]
    if wrong:
        print(f"scatter_designs: {wrong} differ from the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
