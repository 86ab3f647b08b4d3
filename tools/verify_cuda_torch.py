#!/usr/bin/env python
"""
On-hardware parity matrix of cutadapt_tpu_torch's CUDA aligner.

The port's counterpart of tools/verify_pallas_tpu.py: the kernel of
csrc/align_locate.cu (ops/align_cuda.py:locate_packed) in both packed
lanes (four 2-bit class ids per byte, two 4-bit ones), on the spread of
adapter kinds and flag sets of parity_cases(), on random batches at the
production block size, held on every field of unpack_result to its plain
PyTorch version (align_cuda.locate_reference) on the same CUDA tensors
and to the C++ scalar aligner (align_cuda.scalar_locate): found
everywhere, query start/stop, errors and score where found (tolerance:
exact). The batches are those of verify_pallas_tpu.py (same seed, same
draws); the 2-bit lane takes them with every byte whose class id does
not fit in 2 bits replaced by 'A', as the engine's clean-window split
sends it only such windows. bench_torch.py runs this
(CUTADAPT_TPU_TORCH_KERNEL_VERIFY=0 skips it) and reports the outcome in
its JSON line as ``kernel_parity``.

With --device cpu the wrapper runs the plain version, so the check is
the plain version against the scalar aligner: a rehearsal, not a check
of the kernel.

Usage: python tools/verify_cuda_torch.py [--device cpu] [--reads N]
       [--long]   (exit 0: every spec run agrees)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cutadapt_tpu_torch.ops import align_cuda  # noqa: E402
from cutadapt_tpu_torch.ops.align_batch import (  # noqa: E402
    AlignerSpec,
    query_class_info,
)


def parity_cases():
    from cutadapt_tpu_torch.adapters import Where

    # (reference, wildcard_ref, flags, rate, indel_cost, min_overlap)
    truseq = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    nextera = "CTGTCTCTTATACACATCT"
    return [
        (truseq, False, Where.BACK, 0.1, 1, 3),
        (truseq, False, Where.BACK, 0.2, 1, 3),
        (truseq, False, Where.BACK, 0.0, 1, 3),
        (nextera, False, Where.FRONT, 0.1, 1, 3),
        (nextera, False, Where.ANYWHERE, 0.15, 1, 3),
        ("ANGNTCGGANGCT", True, Where.BACK, 0.2, 1, 3),
        ("ACGTNNNACGT", True, Where.FRONT, 0.1, 1, 3),
        (nextera, False, Where.BACK_NOT_INTERNAL, 0.1, 1, 3),
        (nextera, False, Where.FRONT_NOT_INTERNAL, 0.1, 1, 3),
        ("TTAGACATAT", False, Where.PREFIX, 0.2, 1, 10),
        ("TTAGACATAT", False, Where.SUFFIX, 0.2, 1, 10),
        (truseq, False, Where.BACK, 0.1, 100000, 3),  # --no-indels
        (truseq, False, Where.BACK, 0.1, 1, 12),  # high min_overlap
    ]


def run(block_b: int = 1024, read_len: int = 128, verbose: bool = True,
        device=None):
    """Both packed lanes on every case of parity_cases() on ``device``
    (None: CUDA). Returns the list of failures, empty when every field
    agrees."""
    dev = align_cuda.resolve_device(device)
    failures = []
    rng = np.random.RandomState(20260816)
    cases = parity_cases()
    for case_no, (ref, wc, flags, rate, indel_cost, mo) in enumerate(cases):
        spec = AlignerSpec(
            reference=ref, max_error_rate=rate, flags=flags.value,
            wildcard_ref=wc, indel_cost=indel_cost, min_overlap=mo,
        )
        tables = align_cuda.make_tables(spec)
        cls_lut, _ = query_class_info(spec)
        B, L = block_b, read_len
        raw = rng.choice(
            np.frombuffer(b"ACGTNacgt", np.uint8), size=(B, L)
        )
        # splice (mutated) adapter copies into a third of the reads
        ad = np.frombuffer(ref.encode(), np.uint8)
        for i in range(0, B, 3):
            pos = rng.randint(0, L - 4)
            take = min(len(ad), L - pos)
            raw[i, pos : pos + take] = ad[:take]
            if rate > 0 and take > 4:
                raw[i, pos + rng.randint(take)] = ord("T")
        lens = rng.randint(0, L + 1, B).astype(np.int32)
        padding = np.arange(L)[None, :] >= lens[:, None]
        label = f"{ref[:12]}.. flags={flags.name} e={rate} ic={indel_cost}"
        for pack2 in (False, True):
            lane_raw = raw.copy()
            if pack2:
                lane_raw[cls_lut[lane_raw] > 3] = ord("A")
            lane_raw[padding] = 0
            enc = torch.from_numpy(
                align_cuda.encode_rows(spec, lane_raw, pack2)).to(dev)
            lengths = torch.from_numpy(lens).to(dev)
            got = align_cuda.unpack_result(align_cuda.locate_packed(
                enc, lengths, tables, pack2).cpu().numpy())
            wants = [("scalar aligner",
                      align_cuda.scalar_locate(spec, lane_raw, lens))]
            if dev.type == "cuda":  # on the CPU the wrapper ran the plain one
                wants.insert(0, ("plain version", align_cuda.unpack_result(
                    align_cuda.locate_reference(enc, lengths, tables, pack2)
                    .cpu().numpy())))
            lane = align_cuda.LANE_NAMES[pack2]
            bad = [f"{label} {lane}: {diff} differs from the {name}"
                   for name, want in wants
                   for diff in [align_cuda.first_difference(got, want)]
                   if diff is not None]
            failures += bad
            if verbose and not bad:
                print(f"  [{case_no + 1:2d}/{len(cases)}] {label} {lane}: "
                      f"ok ({int(got[0].sum())} matches)", file=sys.stderr)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reads", type=int, default=1024,
                    help="reads per batch (default 1024)")
    ap.add_argument("--long", action="store_true",
                    help="also one pass of 512 bp reads")
    opts = ap.parse_args(argv)
    failures = run(block_b=opts.reads, device=opts.device)
    n = 2 * len(parity_cases())
    if opts.long:
        failures += [f"long-read {f}" for f in run(
            block_b=opts.reads, read_len=512, verbose=False,
            device=opts.device)]
        n *= 2
    if failures:
        print("KERNEL PARITY FAILURES:", file=sys.stderr)
        for f in failures:
            print(" -", f, file=sys.stderr)
        return 1
    held = ("the plain version and the scalar aligner"
            if opts.device == "cuda" else
            "the scalar aligner (the plain version ran on the CPU)")
    print(f"kernel parity: all {n} spec runs agree with {held}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
