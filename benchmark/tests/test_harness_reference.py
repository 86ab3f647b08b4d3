"""The plain reference (reference/trim.py) against cutadapt's golden
outputs under tests/ of the cases its two configurations cover: 3'
adapters with the default -e 0.1 -O 3, -q, and -m on pairs."""

import os

import numpy as np
import pytest

from benchmark.generate import Reads
from benchmark.reference import trim

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests")


def parse(path):
    """(headers, Reads) of a FASTQ file of any read lengths."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 3, 4)]
    n = len(recs)
    W = max([len(r[1]) for r in recs] + [1])
    seqs = np.zeros((n, W), np.uint8)
    quals = np.zeros((n, W), np.uint8)
    for i, r in enumerate(recs):
        seqs[i, : len(r[1])] = np.frombuffer(r[1], np.uint8)
        quals[i, : len(r[3])] = np.frombuffer(r[3], np.uint8)
    lens = np.array([len(r[1]) for r in recs], np.int64)
    return [r[0] for r in recs], Reads(np.zeros((n, 1), np.uint8), seqs, quals,
                                       lens)


def records(headers, reads, keep):
    return [(h, reads.seqs[i, : reads.lens[i]].tobytes(),
             reads.quals[i, : reads.lens[i]].tobytes())
            for i, h in enumerate(headers) if keep[i]]


def expected(path):
    headers, reads = parse(path)
    return records(headers, reads, np.ones(len(headers), bool))


def config(adapters, q=None, m=None):
    return {"adapters": adapters, "max_error_rate": 0.1, "min_overlap": 3,
            "quality_cutoff": q, "minimum_length": m}


@pytest.mark.parametrize("adapter, q, infile, outfile", [
    ("TTAGACATATCTCCGTCG", None, "small.fastq", "small.fastq"),
    ("ttagacatatctccgtcg", None, "small.fastq", "lowercase.fastq"),
    ("XXXXXX", 10, "lowqual.fastq", "lowqual.fastq"),
])
def test_single_end_golden(adapter, q, infile, outfile):
    headers, reads = parse(os.path.join(TESTS, "data", infile))
    outputs, _ = trim.run(config([adapter], q), [reads])
    (out, keep), = outputs
    assert records(headers, out, keep) == expected(
        os.path.join(TESTS, "cut", outfile))


@pytest.mark.parametrize("a1, a2, q, m, ins, outs", [
    ("TTAGACATAT", "CAGTGGAGTA", None, 14, ("paired.1.fastq", "paired.2.fastq"),
     ("paired.1.fastq", "paired.2.fastq")),
    ("TTAGACATAT", None, 10, 14, ("paired.1.fastq", "paired.2.fastq"),
     ("paired.m14.1.fastq", "paired.m14.2.fastq")),
    ("CAGTGGAGTA", "TTAGACATAT", 20, 14, ("paired.2.fastq", "paired.1.fastq"),
     ("pairedq.2.fastq", "pairedq.1.fastq")),
])
def test_paired_golden(a1, a2, q, m, ins, outs):
    parsed = [parse(os.path.join(TESTS, "data", f)) for f in ins]
    outputs, _ = trim.run(config([a1, a2], q, m), [r for _, r in parsed])
    for (headers, _), (out, keep), want in zip(parsed, outputs, outs):
        assert records(headers, out, keep) == expected(
            os.path.join(TESTS, "cut", want))


def scalar_quality_trim(qual: bytes, cutoff: int, base: int = 33) -> int:
    """cutadapt's loop, read by read (3' end only)."""
    s = max_qual = 0
    stop = len(qual)
    for i in reversed(range(len(qual))):
        s += cutoff - (qual[i] - base)
        if s < 0:
            break
        if s > max_qual:
            max_qual, stop = s, i
    return stop


def test_quality_trim_matches_the_loop():
    import torch

    rng = np.random.default_rng(4)
    quals = rng.integers(33, 75, (3000, 60)).astype(np.uint8)
    lens = rng.integers(0, 61, 3000)
    got = trim.quality_trim_3p(torch.from_numpy(quals),
                               torch.from_numpy(lens), 20).numpy()
    want = [scalar_quality_trim(quals[i, : lens[i]].tobytes(), 20)
            for i in range(3000)]
    assert got.tolist() == want
