"""
--revcomp in the port's engine (device="cpu", the aligner's plain PyTorch
version) against the JAX package:

- ``RevcompStage`` on the same parsed chunk through both engines:
  windows, keep-mask, ``is_rc``, the rc copy's bytes, statistics and the
  assembled FASTQ, for the trim, mask, lowercase and no-trim actions, on
  reads of both orientations of which a share carries N (so that each
  orientation of the 3' adapter's reads splits into the 2-bit and the
  4-bit lane), and on FASTA
  chunks (sequences complemented, no qualities);
- the single-end revcomp golden cases of ``tests/test_commandline.py``
  through the port's main in require mode;
- ``se_revcomp`` of ``tests/test_accel.py`` through the port's main and
  the JAX package's: the same file and ``--json`` report; FASTA output
  and the lowercase action against the port's host path.

Tolerance: exact.
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

import cutadapt_tpu.accel as jaccel
import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu.modifiers as jmod
import cutadapt_tpu.parser as jparser
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk
from cutadapt_tpu_torch.io.records import reverse_complement
from cutadapt_tpu_torch.ops import align_cuda

import torch_fixtures as fx

JAX = (jparser, jmod, jaccel, jbp)
PORT = fx.PORT_MODULES
SIZES = dict(min_dp_batch=256, max_dp_batch=1024)
DATA = os.path.join(fx.TESTS, "data")
IGNORED_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


@pytest.fixture(autouse=True)
def port_env(monkeypatch):
    with fx.one_torch_thread():
        for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_BATCH"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        for module in (tad, jad):
            monkeypatch.setattr(module, "_adapter_counter", [0])
        yield monkeypatch


def _flip_share(data: bytes, share: float, seed: int) -> bytes:
    """FASTQ with a seeded ``share`` of its reads reverse-complemented
    (qualities reversed)."""
    lines = data.split(b"\n")
    rng = np.random.RandomState(seed)
    for r in np.flatnonzero(rng.rand(len(lines) // 4) < share):
        i = 4 * r
        lines[i + 1] = reverse_complement(lines[i + 1].decode()).encode()
        lines[i + 3] = lines[i + 3][::-1]
    return b"\n".join(lines)


def _to_fasta(data: bytes) -> bytes:
    lines = data.split(b"\n")
    return b"".join(b">%s\n%s\n" % (lines[i][1:], lines[i + 1])
                    for i in range(0, len(lines) - 1, 4))


@pytest.fixture(scope="module")
def amplicons():
    """Amplicons of either orientation, a fifth of them with N."""
    return fx.add_ns(fx.make_amplicons(600, seed=36, rc_share=0.5), 0.2,
                     seed=37)


@pytest.fixture(scope="module")
def back_reads():
    """Flagship reads (a quarter with the 3' adapter), half of them
    reverse-complemented, two fifths with N."""
    return _flip_share(fx.add_ns(fx.make_dataset(1200, seed=38), 0.4), 0.5,
                       39)


PRIMER = [("front", "^" + fx.PRIMER_515F)]
BACK = [("back", fx.ADAPTER)]


def _rc_stage(pkg, specs, action, times):
    stage, tasks = fx.cutter_stage(pkg, specs, action, times)
    return pkg[3].RevcompStage(tasks, times=times, action=action,
                               modifier=stage.modifier)


def _run_both(specs, action, times, data, fasta=False):
    """The same chunk through both engines with a RevcompStage and the
    filters -m 20 and --max-n 0; asserts equal windows, keep-mask,
    statistics (is_rc, events with their rc flag, revcomped), rc copy
    and assembled bytes (FASTQ through the stage assembler, FASTA from
    each read's chosen orientation). Returns the port's statistics."""
    import cutadapt_tpu.io.chunks as jchunks
    import cutadapt_tpu_torch.io.chunks as tchunks

    filters = [("too_short", 20), ("too_many_n", 0)]
    got = {}
    for name, pkg, pkg_accel, bp, chunks, kw in (
        ("jax", JAX, jaccel, jbp, jchunks, {}),
        ("port", PORT, taccel, tbp, tchunks, dict(device="cpu")),
    ):
        stage = _rc_stage(pkg, specs, action, times)
        if fasta:
            stage.has_quals = False
        engine = bp.BatchPipelineEngine(
            [stage], [bp.FilterSpec(k, t) for k, t in filters], **SIZES, **kw
        )
        chunk = (chunks.parse_fasta_chunk if fasta
                 else chunks.parse_fastq_chunk)(data)
        ws, we, keep, stats = engine.process_parsed(chunk)
        if fasta:
            rc = stats["rc_chunk"]
            sel = jaccel._select_paired_chunk(
                chunk, 0, rc, len(chunk.buf),
                np.concatenate([chunk.buf, rc.buf]), stats["is_rc"], " rc",
            ) if name == "jax" else taccel._select_rc_chunk(chunk, stats,
                                                           " rc")
            assembled = chunks.assemble_fasta_window(sel, ws, we, keep)
        else:
            assembled = pkg_accel._stages_assembler([stage])(
                chunk, ws, we, keep, stats)
        rc_buf = bytes(stats.pop("rc_chunk").buf)
        got[name] = dict(ws=ws, we=we, keep=keep, stats=stats, rc=rc_buf,
                         assembled=assembled)
    fx.assert_same(got["port"], got["jax"])
    return got["port"]["stats"]


# (data fixture, adapter specs, times)
ENGINE_CASES = {
    "primer": ("amplicons", PRIMER, 1),
    "back_times2": ("back_reads", BACK, 2),
}


@pytest.mark.parametrize("action", ["trim", "mask", "lowercase", None],
                         ids=["trim", "mask", "lowercase", "none"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_revcomp_stage_matches_jax(request, case, action):
    data_name, specs, times = ENGINE_CASES[case]
    runs = dict(align_cuda.PLAIN_RUNS)
    stats = _run_both(specs, action, times, request.getfixturevalue(data_name))
    is_rc = stats["is_rc"]
    assert 0 < stats["revcomped"] and is_rc.any() and not is_rc.all()
    assert {ev["rc"] for ev in stats["adapter_events"]} == {False, True}
    # the 3' adapter's N reads go to the 4-bit lane (for the IUPAC primer
    # an N is a class of the 2-bit lane)
    lanes = ("pack2", "pack4") if case == "back_times2" else ("pack2",)
    assert all(align_cuda.PLAIN_RUNS[lane] > runs[lane] for lane in lanes)
    if action in ("mask", "lowercase"):
        assert stats["transform_action"] == action


def test_revcomp_stage_fasta_matches_jax(amplicons):
    stats = _run_both(PRIMER, "trim", 1, _to_fasta(amplicons), fasta=True)
    assert stats["revcomped"] > 100


def test_revcomp_dispatches_both_orientations_in_submit(amplicons,
                                                        monkeypatch):
    """submit launches the forward and the rc windows; collect launches
    nothing for a one-phase adapter."""
    launched = []
    real = tbp.locate_packed
    monkeypatch.setattr(
        tbp, "locate_packed",
        lambda enc, lens, tables, pack2, **kw: launched.append(pack2)
        or real(enc, lens, tables, pack2, **kw),
    )
    stage = _rc_stage(PORT, PRIMER, "trim", 1)
    engine = tbp.BatchPipelineEngine([stage], **SIZES, device="cpu")
    calls = []
    real_dispatch = engine._dispatch_stage
    engine._dispatch_stage = lambda *a: calls.append(a[1]) or real_dispatch(*a)
    pending = engine.submit(parse_fastq_chunk(amplicons))
    in_submit = len(launched)
    engine.collect(pending)
    assert len(calls) == 2 and calls[1] is pending.dp_futures[0]
    assert in_submit > 0 and len(launched) == in_submit


def _engine_main(args):
    fallbacks = taccel.FALLBACK_COUNT
    runs = sum(align_cuda.PLAIN_RUNS.values())
    stats = port_cli.main([str(a) for a in args])
    assert taccel.FALLBACK_COUNT == fallbacks
    return stats, sum(align_cuda.PLAIN_RUNS.values()) - runs


@pytest.mark.parametrize("cores", [1, 2])
def test_reverse_complement_normalized_engine(tmp_path, cores):
    """test_commandline.py's test_reverse_complement_normalized."""
    out = tmp_path / "revcomp-single-normalize.fastq"
    stats, ran = _engine_main(
        ["--revcomp", "--no-index", "-g", "^TTATTTGTCT", "-g",
         "^TCCGCACTGG", "--cores", cores, "-o", out,
         os.path.join(DATA, "revcomp.1.fastq")])
    assert ran > 0
    assert out.read_bytes() == open(
        fx.golden_path("revcomp-single-normalize.fastq"), "rb").read()
    assert stats.n == 6
    assert stats.reverse_complemented == 2


@pytest.mark.parametrize("cores", [1, 2])
def test_reverse_complement_no_rc_suffix_engine(tmp_path, cores):
    """test_commandline.py's test_reverse_complement_no_rc_suffix:
    --rename {header} keeps the names, without the ' rc' suffix."""
    from cutadapt_tpu_torch.io.fastq import open_sequence_file

    out = tmp_path / "out.fastq"
    _engine_main(["-o", out, "--revcomp", "--no-index", "--rename",
                  "{header}", "-g", "^TTATTTGTCT", "-g", "^TCCGCACTGG",
                  "--cores", cores, os.path.join(DATA, "revcomp.1.fastq")])
    with open(out, "rb") as f:
        reads = list(open_sequence_file(f))
    assert len(reads) == 6
    assert reads[1].name == "read2/1"
    assert reads[1].sequence == "ACCATCCGATATGTCTAATGTGGCCTGTTG"


def test_se_revcomp_matches_jax_cli(port_env, tmp_path):
    """tests/test_accel.py's se_revcomp through the port's engine and the
    JAX package's CLI: the same file and --json report."""
    args, paired = fx.accel_configs()["se_revcomp"]
    assert not paired
    inputs = fx.accel_reads(tmp_path / "in.fastq", n=400)
    got = {}
    for which, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        for module in (tad, jad):
            port_env.setattr(module, "_adapter_counter", [0])
        out, rep = tmp_path / f"{which}.fastq", tmp_path / f"{which}.json"
        argv = ["--quiet", "--json", rep] + list(args) + ["-o", out, *inputs]
        if which == "port":
            _, ran = _engine_main(argv)
            assert ran > 0
        else:
            main([str(a) for a in argv])
        report = json.loads(rep.read_text())
        for key in IGNORED_REPORT_KEYS:
            report.pop(key)
        got[which] = (out.read_bytes(), report)
    assert got["port"] == got["jax"]
    assert got["port"][1]["read_counts"]["reverse_complemented"] > 0


# CLI runs held to the port's host path: (options, FASTA input)
HOST_CASES = {
    "fasta_out": (["--fasta", "-m", "40", "--too-short-output",
                   "{d}/short.fasta"], False),
    "fasta_in": (["--discard-untrimmed"], True),
    "lowercase": (["--action=lowercase", "--max-n", "0", "-m", "270",
                   "--too-short-output", "{d}/short.fastq"], False),
    "mask_times2": (["--action=mask", "--times", "2"], False),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_revcomp_cli_matches_host_path(port_env, tmp_path, amplicons, case):
    options, fasta_in = HOST_CASES[case]
    data = _to_fasta(amplicons) if fasta_in else amplicons
    inp = tmp_path / ("in.fasta" if fasta_in else "in.fastq")
    inp.write_bytes(data)
    got = {}
    for mode in ("require", "0"):
        d = tmp_path / mode
        d.mkdir()
        port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", mode)
        for module in (tad, jad):
            port_env.setattr(module, "_adapter_counter", [0])
        out = d / ("out.fasta" if fasta_in or "--fasta" in options
                   else "out.fastq")
        argv = ["--revcomp", "-g", "^" + fx.PRIMER_515F, "--json",
                d / "r.json", "-o", out]
        argv += [o.format(d=d) for o in options] + [inp]
        if mode == "require":
            _engine_main(argv)
        else:
            port_cli.main([str(a) for a in argv])
        report = json.loads((d / "r.json").read_text())
        for key in IGNORED_REPORT_KEYS:
            report.pop(key)
        got[mode] = ({p.name: p.read_bytes() for p in d.iterdir()
                      if p.suffix != ".json"}, report)
    assert got["require"] == got["0"]
    assert got["0"][1]["read_counts"]["reverse_complemented"] > 100
