"""The linked-primer configuration (pe_its_linked) on the CPU: the port
under require against the plain reference (reference/linked.py) on both
output files byte for byte, the report's summary and the 5' ends'
statistics of both mates; and three broken copies of the reference's
outputs that run.judge refuses."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import compare, generate, run
from benchmark.reference import linked

CELL = "pe_its_linked.miseq"
PAIRS = 2400
SEED = 2**31 + 20


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration and one file of its traffic."""
    _, cfg, _, _ = run.load_cell(CELL, os.path.join(run.ROOT,
                                                     "BENCHMARK.json"))
    bench = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    traffic = generate.load_traffic(next(
        w["traffic"] for w in bench["workloads"] if w["name"] == CELL))
    mates = generate.make(dict(traffic, reads_per_file=PAIRS), SEED)
    return cfg, mates


@pytest.fixture(scope="module")
def hits(cell):
    cfg, mates = cell
    return [linked.match_mate(r, a, cfg, "cpu")
            for r, a in zip(mates, cfg["adapters"])]


def _five_prime(end: dict) -> dict:
    return {"matches": end["matches"],
            "adjacent_bases": end["adjacent_bases"],
            "trimmed_lengths": [[row["len"], row["counts"]]
                                for row in end["trimmed_lengths"]]}


def test_the_port_is_the_reference(cell, hits, tmp_path, monkeypatch):
    from cutadapt_tpu_torch import accel, cli

    cfg, mates = cell
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_DEVICES", raising=False)
    inputs = run.write_inputs({}, mates, str(tmp_path), "in")
    outs = [str(tmp_path / f"out{i}.fastq") for i in (1, 2)]
    fallbacks = accel.FALLBACK_COUNT
    cli.main(cfg["args"] + ["-o", outs[0], "-p", outs[1], "--json",
                            str(tmp_path / "r.json"), "--quiet"] + inputs)
    assert accel.FALLBACK_COUNT == fallbacks
    outputs, summary = linked.summarize(cfg, mates, hits)
    for path, (reads, keep) in zip(outs, outputs):
        with open(path, "rb") as f:
            assert f.read() == generate.fastq_bytes(reads, keep)
    with open(tmp_path / "r.json") as f:
        report = json.load(f)
    assert compare.report_summary(report) == summary
    # the 5' ends, which the summary leaves out
    got = [_five_prime(a["five_prime_end"])
           for side in ("adapters_read1", "adapters_read2")
           for a in report[side]]
    assert got == [linked.five_prime_end(h) for h in hits]
    # both phases matched, and some pairs went untrimmed
    assert 0 < summary["read_counts"]["output"] < PAIRS
    assert all(s["matches"] > 0 for s in summary["adapters"])


def _judged(cfg, mates, outputs, summary) -> dict:
    """run.judge's checks of one call whose outputs and report are
    ``outputs`` and ``summary``, against the reference's."""
    want = run.reference_output(linked, cfg, mates, "cpu")
    got = {"digests": [generate.block_digests(generate.fastq_bytes(r, k))
                       for r, k in outputs], "summary": summary}
    call = run.Call(0, got["digests"], got["summary"], launches=1)
    checks, _ = run.judge([call], [want])
    return checks


def _without_back(h):
    none = torch.zeros_like(h.back.found)
    back = linked.Matches(none, h.rest_lens, h.rest_lens,
                          torch.zeros_like(h.back.errors))
    return linked.LinkedMatches(h.matched, h.front, back, h.rest, h.rest_lens)


@pytest.mark.parametrize("fault", ["3' phase skipped", "5' part unanchored",
                                   "pair filter both"])
def test_a_broken_reference_is_refused(fault, cell, hits):
    cfg, mates = cell
    if fault == "3' phase skipped":
        outputs, summary = linked.summarize(cfg, mates,
                                            [_without_back(h) for h in hits])
    elif fault == "5' part unanchored":
        loose = dict(cfg, adapters=[a.lstrip("^") for a in cfg["adapters"]])
        outputs, summary = linked.run(loose, mates)
    else:
        outputs, summary = linked.summarize(
            dict(cfg, pair_filter="both"), mates, hits)
    checks = _judged(cfg, mates, outputs, summary)
    assert not run.passes(checks)
    assert checks["output_mismatch_calls"]["value"] == 1


def test_the_reference_matches_at_the_read_start_only():
    """An anchored 5' part: the whole primer from the read's first base
    with at most int(0.1 * 22) = 2 errors, an indel among them; a
    non-anchored 3' part of 3 bases or more in the remainder."""
    fwd, rc_rev = "CTTGGTCATTTAGAGGAAGTAA", "GCATCGATGAAGAACGCAGC"
    cfg = {"max_error_rate": 0.1, "min_overlap": 3}
    spec = f"^{fwd}...{rc_rev}"
    reads = [fwd + "ACGTACGTAC" + rc_rev + "TTT",  # both parts
             "AAAA" + fwd + "ACGTACGTAC",  # the primer four bases in
             fwd[:5] + fwd[6:] + "ACGTACGTAC" + rc_rev[:3],  # a deletion
             "GG" + fwd[2:] + "ACGTACGTACGC",  # two mismatches, 2 bp of 3'
             "GGA" + fwd[3:] + "ACGTACGTAC",  # three mismatches
             "A" + fwd + "ACGTACGTAC"]  # one base in: an insertion
    W = max(map(len, reads))
    seqs = np.zeros((len(reads), W), np.uint8)
    for i, r in enumerate(reads):
        seqs[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lens = np.array([len(r) for r in reads], np.int64)
    mate = generate.Reads(np.zeros((len(reads), 1), np.uint8), seqs,
                          seqs.copy(), lens)
    h = linked.match_mate(mate, spec, cfg, "cpu")
    assert h.matched.tolist() == [True, False, True, True, False, True]
    assert h.front.rstop[[0, 2, 3, 5]].tolist() == [22, 21, 22, 23]
    assert h.front.errors[[0, 2, 3, 5]].tolist() == [0, 1, 2, 1]
    assert h.back.found.tolist() == [True, False, True, False, False, False]
    assert h.back.rstart[[0, 2]].tolist() == [10, 10]


@pytest.mark.parametrize("flags", [linked.PREFIX, linked.FRONT, linked.BACK])
def test_the_reference_aligner_is_cutadapts(flags):
    """reference/linked.py's locate against cutadapt's aligner as the
    port carries it on the host (align.Aligner, held to cutadapt's golden
    outputs) on reads made to hold the adapter, a part of it or a copy
    with errors, N among them."""
    from cutadapt_tpu_torch.align import Aligner

    adapter = "CTTGGTCATTTAGAGGAAGTAA"
    rng = np.random.default_rng(flags)
    n, W = 3000, 60
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, W))]
    lens = rng.integers(0, W + 1, n)
    ad = np.frombuffer(adapter.encode(), np.uint8)
    for i in range(n):
        at = 0 if rng.random() < 0.3 else rng.integers(-8, W)
        cut = rng.integers(3, len(ad) + 1)
        part = ad[:cut] if rng.random() < 0.5 else ad[-cut:]
        lo, hi = max(at, 0), min(at + len(part), W)
        if lo < hi:
            seqs[i, lo:hi] = part[lo - at: hi - at]
        for _ in range(rng.integers(0, 4)):
            seqs[i, rng.integers(0, W)] = b"ACGTN"[rng.integers(0, 5)]
    overlap = len(adapter) if flags == linked.PREFIX else 3
    got = linked.locate(torch.from_numpy(seqs), torch.from_numpy(lens),
                        adapter, flags, 0.1, overlap)
    aligner = Aligner(adapter, 0.1, flags=flags, min_overlap=overlap)
    assert int(got.found.sum()) > 100
    for i in range(n):
        hit = aligner.locate(bytes(seqs[i, :lens[i]]).decode())
        row = (bool(got.found[i]), int(got.rstart[i]), int(got.rstop[i]),
               int(got.errors[i]))
        if hit is None:
            assert row == (False, lens[i], lens[i], 0), i
        else:
            assert row == (True, hit[2], hit[3], hit[5]), i
