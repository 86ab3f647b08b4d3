"""
Paired-end runs through the port's engine (``CUTADAPT_TPU_TORCH_BATCH=
require``, the aligner's plain PyTorch version on the CPU):

- every golden case of ``tests/test_paired.py`` (PAIRED_GOLDEN_CASES at
  -j 1 and 2, the interleaved, revcomp, routed-output, anchored and R2
  quality cases) byte-identical to ``tests/cut/``, with no fallback;
- the cases of the output side (demultiplexing, --rename, name edits)
  write every file the JAX package's CLI writes, and what
  ``tests/cut/`` holds for them, with no fallback;
- the pairing errors give the host path's message and exit code;
- --pair-adapters and paired --revcomp launch the aligner from the
  drive's emit thread.

``tests/test_torch_pair_helpers.py`` holds the paired configurations and
the pair helpers to the JAX package.

Tolerance: exact.
"""

import os

import pytest

import cutadapt_tpu.adapters as jax_adapters
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as port_adapters
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.ops import align_cuda

import torch_fixtures as fx

DATA = os.path.join(fx.TESTS, "data")
PAIRED = fx.paired_golden_cases()
# accepted paired golden cases that give the aligner no work
NO_ALIGNER_RUN = {
    "no_legacy_minlength": "the k-mer prefilter passes no read for XXX",
    "cut": "host stages only",
    "length": "host stage only",
    "negative_length": "host stage only",
    "length_uppercase_l": "host stages only",
    "length_only_uppercase_l": "host stage only",
    "nextseq_paired": "host stage only",
    "poly_a_poly_t": "host stage only",
}


@pytest.fixture(autouse=True)
def port_env(monkeypatch):
    with fx.one_torch_thread():
        for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_BATCH"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        yield monkeypatch


def _engine_main(args):
    """The port's main in require mode: no fallback; returns (statistics,
    plain aligner runs)."""
    fallbacks = taccel.FALLBACK_COUNT
    runs = sum(align_cuda.PLAIN_RUNS.values())
    stats = port_cli.main([str(a) for a in args])
    assert taccel.FALLBACK_COUNT == fallbacks
    return stats, sum(align_cuda.PLAIN_RUNS.values()) - runs


def _same(path, expected):
    with open(path, "rb") as got, open(fx.golden_path(expected), "rb") as want:
        assert got.read() == want.read(), expected


def _run_paired(tmp_path, params, in1, in2, expected1, expected2, cores=1):
    """The run_paired fixture of tests/conftest.py through the port's
    engine: both outputs equal their golden files. Returns (statistics,
    plain aligner runs)."""
    (tmp_path / "r1").mkdir()
    (tmp_path / "r2").mkdir()
    out1, out2 = tmp_path / "r1" / expected1, tmp_path / "r2" / expected2
    result = _engine_main(
        ["--cores", cores, "--json", tmp_path / "stats.json"]
        + fx.paired_golden_args(params, out1, out2, in1, in2))
    _same(out1, expected1)
    _same(out2, expected2)
    return result


def test_no_aligner_run_names_golden_cases():
    assert set(NO_ALIGNER_RUN) <= {case[0] for case in PAIRED}
    assert len(PAIRED) == 19


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("case", PAIRED, ids=[c[0] for c in PAIRED])
def test_paired_golden_engine(tmp_path, case, cores):
    case_id, params, in1, in2, expected1, expected2 = case
    _, ran = _run_paired(tmp_path, params, in1, in2, expected1, expected2,
                         cores)
    assert (ran == 0) == (case_id in NO_ALIGNER_RUN)


# tests/test_paired.py's run_interleaved cases: (params, inputs, expected)
INTERLEAVED = {
    "in_and_out": (["interleaved.fastq"], ["interleaved.fastq"]),
    "in": (["interleaved.fastq"], ["pairedq.1.fastq", "pairedq.2.fastq"]),
    "out": (["paired.1.fastq", "paired.2.fastq"], ["interleaved.fastq"]),
}


@pytest.mark.parametrize("chunk_bytes", [None, 400], ids=["chunk", "small"])
@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("name", sorted(INTERLEAVED))
def test_interleaved_engine(port_env, tmp_path, name, cores, chunk_bytes):
    """Interleaved input, output or both; in chunks of 400 bytes an
    interleaved chunk ends inside a pair, whose first read is carried to
    the next chunk."""
    if chunk_bytes:
        port_env.setenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", str(chunk_bytes))
    inputs, expected = INTERLEAVED[name]
    outs = [tmp_path / f"out{i}-{e}" for i, e in enumerate(expected)]
    args = ("-q 20 -a TTAGACATAT -A CAGTGGAGTA -m 14 -M 90 --interleaved "
            f"--cores {cores} --buffer-size=512").split()
    args += ["-o", outs[0]] + (["-p", outs[1]] if len(outs) > 1 else [])
    _, ran = _engine_main(args + [os.path.join(DATA, p) for p in inputs])
    assert ran > 0
    for out, exp in zip(outs, expected):
        _same(out, exp)


REVCOMP = {
    "only_r1": (["--revcomp", "-g", "^TTATTTGTCT", "-g", "^TCCGCACTGGC"],
                "revcomp.1.fastq", "revcomp.2.fastq", "revcomp.1.fastq",
                "revcomp.2.fastq"),
    "only_r2": (["--revcomp", "-G", "^TTATTTGTCT", "-G", "^TCCGCACTGGC"],
                "revcomp.2.fastq", "revcomp.1.fastq", "revcomp.2.fastq",
                "revcomp.1.fastq"),
    "r1_and_r2": (["--revcomp", "-g", "^TTATTTGTCT", "-G", "^TCCGCACTGGC"],
                  "revcomp.1.fastq", "revcomp.2.fastq",
                  "revcomp-r1r2.1.fastq", "revcomp-r1r2.2.fastq"),
}


@pytest.mark.parametrize("name", sorted(REVCOMP))
def test_paired_revcomp_engine(tmp_path, name):
    """Two anchored 5' adapters of one read form an indexed (host) task;
    one on each read launches the aligner."""
    stats, ran = _run_paired(tmp_path, *REVCOMP[name])
    assert (ran > 0) == (name == "r1_and_r2")
    if name == "r1_and_r2":
        assert stats.reverse_complemented == 2


@pytest.mark.parametrize("pair_filter", [["--pair-filter=first"], []],
                         ids=["first", "automatic_pair_filter"])
def test_untrimmed_paired_output_engine(tmp_path, pair_filter):
    u1, u2 = tmp_path / "untrimmed.1.fastq", tmp_path / "untrimmed.2.fastq"
    _run_paired(tmp_path, ["-a", "TTAGACATAT", *pair_filter,
                           "--untrimmed-output", u1,
                           "--untrimmed-paired-output", u2],
                "paired.1.fastq", "paired.2.fastq",
                "paired-trimmed.1.fastq", "paired-trimmed.2.fastq")
    _same(u1, "paired-untrimmed.1.fastq")
    _same(u2, "paired-untrimmed.2.fastq")


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("which", ["short", "long"])
def test_routed_length_outputs_engine(tmp_path, which, cores):
    """test_too_short_paired_output and test_too_long_output."""
    p1, p2 = tmp_path / "routed.1.fastq", tmp_path / "routed.2.fastq"
    opt = "-m 14" if which == "short" else "-M 14"
    if which == "short":
        main_out, routed_out = "paired", "paired-too-short"
    else:
        main_out, routed_out = "paired-too-short", "paired"
    _run_paired(tmp_path, f"-a TTAGACATAT -A CAGTGGAGTA {opt}".split()
                + [f"--too-{which}-output", p1,
                   f"--too-{which}-paired-output", p2],
                "paired.1.fastq", "paired.2.fastq", f"{main_out}.1.fastq",
                f"{main_out}.2.fastq", cores)
    _same(p1, f"{routed_out}.1.fastq")
    _same(p2, f"{routed_out}.2.fastq")


def test_paired_anchored_back_no_indels_engine(tmp_path):
    _run_paired(tmp_path, "-a BACKADAPTER$ -A BACKADAPTER$ -N --no-indels",
                "anchored-back.fasta", "anchored-back.fasta",
                "anchored-back.fasta", "anchored-back.fasta")


@pytest.mark.parametrize("args, expected1, expected2", [
    ("", "lowqual.unchanged.fastq", "lowqual.unchanged.fastq"),
    ("-q 10", "lowqual.fastq", "lowqual.fastq"),
    ("-q 10 -Q 10", "lowqual.fastq", "lowqual.fastq"),
    ("-Q 10", "lowqual.unchanged.fastq", "lowqual.fastq"),
    ("-q 0 -Q 10", "lowqual.unchanged.fastq", "lowqual.fastq"),
    ("-q 10 -Q 0", "lowqual.fastq", "lowqual.unchanged.fastq"),
])
def test_qualtrim_r2_engine(tmp_path, args, expected1, expected2):
    _run_paired(tmp_path, args, "lowqual.fastq", "lowqual.fastq",
                expected1, expected2)


# the paired cases of the output side: command lines of
# tests/test_paired.py (and of test_accel.py's pe_name_edits)
OUTPUT_SIDE_PAIRED = (
    "combinatorial_demultiplexing", "pair_adapters_demultiplexing",
    "paired_demultiplex", "pe_name_edits", "rename", "strip_suffix_length_tag",
)
# those of them whose outputs tests/cut/ holds
GOLDEN_OUTPUT_SIDE = {"combinatorial_demultiplexing",
                      "pair_adapters_demultiplexing", "paired_demultiplex",
                      "rename"}


def _output_side_args(case_id, d):
    paired = [os.path.join(DATA, "paired.1.fastq"),
              os.path.join(DATA, "paired.2.fastq")]
    if case_id == "paired_demultiplex":
        return ["-a", "first=AACATTAGACA", "-a", "second=CATTAGACATATCGG",
                "-A", "ignored=CAGTGGAGTA", "-A", "alsoignored=AATAACAGTGGAGTA",
                "-o", f"{d}/demultiplexed.{{name}}.1.fastq",
                "-p", f"{d}/demultiplexed.{{name}}.2.fastq", *paired]
    if case_id == "pair_adapters_demultiplexing":
        return ("-g i1=AAAA -G i1=GGGG -g i2=CCCC -G i2=TTTT --pair-adapters "
                f"-o {d}/dual-{{name}}.1.fastq -p {d}/dual-{{name}}.2.fastq "
                f"{DATA}/dual-index.1.fastq {DATA}/dual-index.2.fastq").split()
    if case_id == "combinatorial_demultiplexing":
        return ("-g A=^AAAAAAAAAA -g C=^CCCCCCCCCC -G G=^GGGGGGGGGG "
                "-G T=^TTTTTTTTTT "
                f"-o {d}/combinatorial.{{name1}}_{{name2}}.1.fastq "
                f"-p {d}/combinatorial.{{name1}}_{{name2}}.2.fastq "
                f"{DATA}/combinatorial.1.fastq "
                f"{DATA}/combinatorial.2.fastq").split()
    outs = ["-o", f"{d}/out.1.fastq", "-p", f"{d}/out.2.fastq"]
    if case_id == "rename":
        outs = ["-o", f"{d}/rename.1.fastq", "-p", f"{d}/rename.2.fastq"]
        return ["--rename={id} {r1.cut_prefix} {cut_prefix} {comment} "
                "{adapter_name} {r2.adapter_name}", "--cut=4",
                "-a", "R1adapter=GTCTCCAGCT", "-A", "R2adapter=GACAAATAAC",
                *outs, *paired]
    if case_id == "pe_name_edits":
        return fx.accel_configs()["pe_name_edits"][0] + outs + paired
    assert case_id == "strip_suffix_length_tag"
    return ["-a", "TTAGACATAT", "-A", "CAGTGGAGTA", "--strip-suffix", "/1",
            "--length-tag", "length=", *outs, *paired]


def _golden_of(name):
    for path in (name, os.path.join("combinatorial", name)):
        if os.path.exists(fx.golden_path(path)):
            return fx.golden_path(path)
    return None


@pytest.mark.parametrize("case_id", OUTPUT_SIDE_PAIRED)
def test_output_side_paired_cases_ride_the_engine(port_env, tmp_path,
                                                  case_id):
    """Under require, with no fallback and the aligner launched, the
    port writes every file the JAX package's CLI writes (on its host
    path), and the --json report is the same; the files tests/cut/ holds
    equal it."""
    assert not fx.ENGINE_NOT_YET_PAIRED
    outputs = {}
    for which, main in (("port", _engine_main), ("jax", jax_cli.main)):
        d = tmp_path / which
        d.mkdir()
        for module in (port_adapters, jax_adapters):
            port_env.setattr(module, "_adapter_counter", [0])
        result = main(_output_side_args(case_id, d)
                      + ["--json", str(d / "report.json")])
        if which == "port":
            # two anchored 5' adapters per side are an indexed (host) task
            assert (result[1] == 0) == (
                case_id == "combinatorial_demultiplexing"
            )
        outputs[which] = {p.name: p.read_bytes() for p in d.iterdir()
                          if p.name != "report.json"}
        outputs[which]["report"] = fx.json_report(d / "report.json")
    assert outputs["port"] == outputs["jax"]
    golden = [n for n in outputs["port"] if _golden_of(n)]
    assert bool(golden) == (case_id in GOLDEN_OUTPUT_SIDE)
    for name in golden:
        with open(_golden_of(name), "rb") as want:
            assert outputs["port"][name] == want.read(), name


def _pairing_inputs(name, tmp_path):
    """Inputs of tests/test_paired.py's pairing-error tests (and two of
    the interleaved reader's errors): the input paths and the -o/-p or
    --interleaved options."""
    def lines(path):
        with open(os.path.join(DATA, path)) as f:
            return f.readlines()

    def write(fname, rows):
        path = tmp_path / fname
        path.write_text("".join(rows))
        return str(path)

    p1 = os.path.join(DATA, "paired.1.fastq")
    p2 = os.path.join(DATA, "paired.2.fastq")
    two = ["-o", str(tmp_path / "o1.fastq"), "-p", str(tmp_path / "o2.fastq")]
    if name == "first_too_short":
        return two + [write("t.1.fastq", lines("paired.1.fastq")[:-4]), p2]
    if name == "second_too_short":
        return two + [p1, write("t.2.fastq", lines("paired.2.fastq")[:-4])]
    if name == "unmatched_read_names":
        rows = lines("paired.1.fastq")
        rows = rows[0:4] + rows[8:12] + rows[4:8] + rows[12:]
        return two + [write("swapped.1.fastq", rows), p2]
    rows = lines("interleaved.fastq")
    if name == "interleaved_unmatched_read_names":
        rows = rows[0:4] + rows[8:12] + rows[4:8] + rows[12:]
    else:  # interleaved_no_partner
        rows = rows[:-4]
    return ["--interleaved", "-o", str(tmp_path / "o.fastq"),
            write("i.fastq", rows)]


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("name", [
    "first_too_short", "second_too_short", "unmatched_read_names",
    "interleaved_unmatched_read_names", "interleaved_no_partner",
])
def test_pairing_errors_match_host_path(port_env, tmp_path, caplog, name,
                                        cores):
    """The engine stops with the host path's message and exit code."""
    messages = {}
    for mode in ("require", "0"):
        port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", mode)
        d = tmp_path / mode
        d.mkdir()
        caplog.clear()
        with pytest.raises(SystemExit) as e:
            port_cli.main(_pairing_inputs(name, d)
                          + ["--cores", str(cores)])
        assert e.value.code == 1
        messages[mode] = [r.getMessage() for r in caplog.records
                          if r.levelname == "ERROR"]
    assert messages["require"] == messages["0"]
    assert any("improperly paired" in m or "has no partner" in m
               for m in messages["0"])


def test_pair_match_and_rc_dispatch_from_emit(tmp_path, monkeypatch):
    """--pair-adapters and paired --revcomp launch the aligner from the
    drive's emit thread (after both engines collected), on the engine
    device's tensors."""
    import threading

    threads = set()
    real = tbp.locate_packed

    def spy(enc, lens, tables, pack2, **kw):
        threads.add(threading.current_thread().name)
        return real(enc, lens, tables, pack2, **kw)

    monkeypatch.setattr(tbp, "locate_packed", spy)
    inputs = fx.accel_reads(tmp_path / "in.fastq", n=100, paired=True)
    for opts in (["--pair-adapters"], ["--revcomp"]):
        threads.clear()
        _engine_main(opts + ["-a", fx.ADAPTER[:20], "-A", fx.NEXTERA,
                             "-o", tmp_path / "o1.fastq",
                             "-p", tmp_path / "o2.fastq", *inputs])
        assert threads and threading.main_thread().name not in threads
