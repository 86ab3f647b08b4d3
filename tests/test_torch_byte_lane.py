"""
The byte lane of the port's aligner through its CLI: adapters that need
more than 16 query classes (16 or more distinct letters compared as
ASCII, ``-N``) run on the engine under ``CUTADAPT_TPU_TORCH_BATCH=require``
on the CPU (the aligner's plain PyTorch version), and every output file
and the ``--json`` report equal what ``cutadapt_tpu.cli.main`` writes on
the JAX package's engine (``CUTADAPT_TPU_BATCH=1``, its XLA aligner's
byte use).

Cases: single-end 3' and 5' adapters, an anchored 5' adapter,
``--revcomp``, paired ``-a/-A``, a linked adapter with a byte-lane part,
a read of 2**14 bp or more (the wide store) and ``-j 2``. Then the
device rule: a byte-lane run with no card, or whose kernel library does
not build, exits 1 and never takes the host path. Tolerance: exact.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.ops import align_cuda

import torch_fixtures as fx

ADAPTER = fx.BYTE_LANE_ADAPTER
# a 5' adapter of 17 query classes
FRONT = "GGTTRYKMXSWBDHVNCA"
# 3' parts of a linked adapter: a 2-bit one after the byte-lane 5' part
LINKED_BACK = "AGATCGGAAGAGC"


@pytest.fixture(autouse=True)
def one_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture
def both_engines(monkeypatch):
    """The port's CLI on its engine under require on the CPU, the JAX
    package's on its engine. The JAX engine dispatches batches of 8 rows:
    its XLA aligner computes every padding row of a launch, and results
    do not depend on the batch size."""
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_WORKERS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_BATCH", "1")
    monkeypatch.setattr(
        jbp.BatchPipelineEngine, "__init__", functools.partialmethod(
            jbp.BatchPipelineEngine.__init__, min_dp_batch=8,
            max_dp_batch=8))
    return monkeypatch


def _records(seqs) -> bytes:
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                    for i, s in enumerate(seqs))


def _reads(n, seed, where, length=100) -> bytes:
    """n reads of random ACGT (3% with an N): a third carry the byte-lane
    adapter of ``where`` with one substitution, at a random position of
    the 3' half ("back"; a prefix where it runs off the end), after a few
    bases ("front"), at the start ("start"), or both parts of the linked
    adapter around an insert ("linked")."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        s = bytearray(rng.choice(list(b"ACGT"), length).astype(np.uint8))
        if i % 3 == 0:
            ad = bytearray({"back": ADAPTER, "front": FRONT,
                            "start": FRONT, "linked": fx.BYTE_LANE_LETTERS
                            }[where].encode())
            ad[rng.randint(len(ad))] = ord("ACGT"[rng.randint(4)])
            if where == "back":
                pos = rng.randint(length // 2, length - 3)
            elif where == "front":
                pos = rng.randint(0, 8)
            else:
                pos = 0
            s[pos : pos + len(ad)] = ad[: length - pos]
            if where == "linked":
                tail = LINKED_BACK.encode()
                pos = rng.randint(40, length - 5)
                s[pos : pos + len(tail)] = tail[: length - pos]
        if rng.rand() < 0.03:
            s[rng.randint(length)] = ord("N")
        out.append(bytes(s[:length]))
    return _records(out)


def _same_as_jax_cli(monkeypatch, tmp_path, args, inputs, outputs):
    """Every output file and the --json report of the port's CLI (byte
    lane on the engine, no fallback) equal the JAX CLI's."""
    got = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        # adapters without a name are numbered per process
        for module in (tad, jad):
            monkeypatch.setattr(module, "_adapter_counter", [0])
        fallbacks = taccel.FALLBACK_COUNT
        byte_runs = align_cuda.PLAIN_RUNS["byte"]
        main(args + ["--json", str(d / "report.json")]
             + [a for flag, out in outputs for a in (flag, str(d / out))]
             + [str(p) for p in inputs])
        if name == "port":
            assert taccel.FALLBACK_COUNT == fallbacks
            assert align_cuda.PLAIN_RUNS["byte"] > byte_runs
        got[name] = {out: (d / out).read_bytes() for _, out in outputs}
        got[name]["report"] = fx.json_report(d / "report.json")
    assert got["port"] == got["jax"]
    return got["port"]


SINGLE_END = {
    "back": (["-a", ADAPTER], "back"),
    "front": (["-g", FRONT], "front"),
    "anchored": (["-g", "^" + FRONT], "start"),
    "revcomp": (["--revcomp", "-a", ADAPTER], "back"),
    "linked": (["-a", f"^{fx.BYTE_LANE_LETTERS}...{LINKED_BACK}"], "linked"),
    "cores": (["-j", "2", "-a", ADAPTER, "--buffer-size", "4096"], "back"),
}


@pytest.mark.parametrize("case", sorted(SINGLE_END))
def test_single_end_matches_jax_cli(both_engines, tmp_path, case):
    options, where = SINGLE_END[case]
    reads = tmp_path / "in.fastq"
    data = _reads(240, 11 + sorted(SINGLE_END).index(case), where)
    if case == "revcomp":
        data = _revcomp_some(data)
    reads.write_bytes(data)
    got = _same_as_jax_cli(both_engines, tmp_path,
                           ["-N", "-e", "0.1"] + options,
                           [reads], [("-o", "out.fastq")])
    counts = got["report"]["read_counts"]
    assert counts["read1_with_adapter"] > 40
    if case == "revcomp":
        assert counts["reverse_complemented"] > 0


def _revcomp_some(data: bytes) -> bytes:
    """Every second record reverse-complemented (qualities reversed)."""
    lines = data.split(b"\n")
    table = bytes.maketrans(b"ACGTN", b"TGCAN")
    for r in range(0, len(lines) // 4, 2):
        lines[4 * r + 1] = lines[4 * r + 1].translate(table)[::-1]
        lines[4 * r + 3] = lines[4 * r + 3][::-1]
    return b"\n".join(lines)


def test_paired_matches_jax_cli(both_engines, tmp_path):
    """-a and -A byte-lane adapters on two files, with -q 20 -m 20: both
    outputs and the report, each side's engine in the byte lane."""
    r1 = tmp_path / "in.1.fastq"
    r2 = tmp_path / "in.2.fastq"
    r1.write_bytes(_reads(200, 21, "back"))
    r2.write_bytes(_reads(200, 22, "back"))
    got = _same_as_jax_cli(
        both_engines, tmp_path,
        ["-N", "-a", ADAPTER, "-A", ADAPTER, "-q", "20", "-m", "20"],
        [r1, r2], [("-o", "out.1.fastq"), ("-p", "out.2.fastq")])
    counts = got["report"]["read_counts"]
    assert counts["read1_with_adapter"] > 30
    assert counts["read2_with_adapter"] > 30


def test_long_read_takes_the_wide_store(both_engines, tmp_path,
                                        monkeypatch):
    """A read of 16,500 bp with the adapter past 2**14: the byte lane's
    launches store the wide result, and the output equals the JAX CLI's."""
    import cutadapt_tpu_torch.batch_pipeline as tbp

    launches = []
    real = tbp.locate_packed

    def spy(enc, lens, tables, pack2, wide=False):
        launches.append((pack2, wide))
        return real(enc, lens, tables, pack2, wide=wide)

    monkeypatch.setattr(tbp, "locate_packed", spy)
    rng = np.random.RandomState(16500)
    long_read = bytearray(rng.choice(list(b"ACGT"), 16500).astype(np.uint8))
    long_read[16420 : 16420 + len(ADAPTER)] = ADAPTER.encode()
    reads = tmp_path / "in.fastq"
    reads.write_bytes(_records([bytes(long_read), b"ACGT" * 20 + b"ACGTRY"]))
    got = _same_as_jax_cli(both_engines, tmp_path, ["-N", "-a", ADAPTER],
                           [reads], [("-o", "out.fastq")])
    assert got["report"]["read_counts"]["read1_with_adapter"] == 2
    assert launches and all(p is None and w for p, w in launches)


def test_byte_lane_without_a_card_fails(monkeypatch, tmp_path, caplog):
    """No card: the byte-lane run exits 1 naming CUDA, writes nothing,
    counts no fallback and runs no plain version."""
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _fails_without_host_path(tmp_path, caplog, "CUDA")


def test_byte_lane_with_a_failed_build_fails(monkeypatch, tmp_path, caplog):
    """A card but no kernel library (nvcc missing): exit 1 with the
    build's error, never the host path."""
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "1")
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(align_cuda, "_BUILD_DIR", str(tmp_path / "build"))

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME")

    monkeypatch.setattr(align_cuda, "_nvcc", no_nvcc)
    _fails_without_host_path(tmp_path, caplog, "nvcc not found")


def _fails_without_host_path(tmp_path, caplog, reason):
    reads = tmp_path / "in.fastq"
    reads.write_bytes(_reads(30, 5, "back"))
    out = tmp_path / "out.fastq"
    fallbacks = taccel.FALLBACK_COUNT
    runs = sum(align_cuda.PLAIN_RUNS.values())
    with pytest.raises(SystemExit) as e:
        port_cli.main(["-N", "-a", ADAPTER, "-o", str(out), str(reads)])
    assert e.value.code == 1
    assert reason in caplog.text and "could not start" in caplog.text
    assert not out.exists() or out.stat().st_size == 0
    assert taccel.FALLBACK_COUNT == fallbacks
    assert sum(align_cuda.PLAIN_RUNS.values()) == runs
