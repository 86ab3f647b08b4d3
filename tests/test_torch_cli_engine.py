"""
Every golden case of the JAX package's single-end CLI through the
port's engine in require mode (``CUTADAPT_TPU_TORCH_BATCH=require``,
the aligner's plain PyTorch version on the CPU). For each case exactly
one of two things holds:

- it runs, its output is byte-identical to ``tests/cut/`` (tolerance:
  exact), the aligner ran (unless the case gives it nothing to do) and
  no fallback was counted;
- it is in ``torch_fixtures.ENGINE_NOT_YET`` and ``main`` exits 1 with
  the reason given there.

As later slices port a feature, its cases leave ENGINE_NOT_YET, and
this test fails until they do.
"""

import pytest

from cutadapt_tpu_torch import accel, cli
from cutadapt_tpu_torch.ops import align_cuda
from torch_fixtures import (
    ENGINE_NOT_YET,
    NO_ALIGNER_RUN,
    golden_args,
    golden_cases,
    golden_path,
    one_torch_thread,
)

CASES = golden_cases()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_not_yet_names_golden_cases():
    ids = {case[0] for case in CASES}
    assert set(ENGINE_NOT_YET) <= ids
    assert set(NO_ALIGNER_RUN) <= ids - set(ENGINE_NOT_YET)


@pytest.mark.parametrize(
    "case", CASES, ids=[case[0] for case in CASES],
)
def test_engine_golden(monkeypatch, tmp_path, caplog, case):
    case_id, params, expected, inpath = case
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    out = tmp_path / expected
    args = golden_args(params, str(out), inpath)
    fallbacks = accel.FALLBACK_COUNT
    runs = sum(align_cuda.PLAIN_RUNS.values())
    if case_id in ENGINE_NOT_YET:
        with pytest.raises(SystemExit) as e:
            cli.main(args)
        assert e.value.code == 1
        assert ENGINE_NOT_YET[case_id] in caplog.text
        assert accel.FALLBACK_COUNT == fallbacks + 1
        return
    cli.main(args)
    with open(out, "rb") as got, open(golden_path(expected), "rb") as want:
        assert got.read() == want.read()
    assert accel.FALLBACK_COUNT == fallbacks
    ran = sum(align_cuda.PLAIN_RUNS.values()) - runs
    if case_id in NO_ALIGNER_RUN:
        assert ran == 0
    else:
        assert ran > 0


# inputs of tests/test_commandline.py outside GOLDEN_CASES: BAM, and
# FASTA files without records: (params, expected, input)
OTHER_INPUTS = [
    ("-a TTAGACATATCTCCGTCG", "small_from_bam.fastq", "small.bam"),
    ([], "empty.fasta", "empty.fasta"),
    ([], "empty.fasta", "onlycomment.fasta"),
]


@pytest.mark.parametrize(
    "params, expected, inpath", OTHER_INPUTS,
    ids=[case[2] for case in OTHER_INPUTS],
)
def test_engine_other_inputs(monkeypatch, tmp_path, params, expected, inpath):
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    out = tmp_path / expected
    cli.main(golden_args(params, str(out), inpath))
    with open(out, "rb") as got, open(golden_path(expected), "rb") as want:
        assert got.read() == want.read()
