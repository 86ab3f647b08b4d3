"""
The port's CLI (``cutadapt_tpu_torch.cli.main``) against the JAX
package's golden files and its CLI:

- every golden case through the port's per-read host path
  (``CUTADAPT_TPU_TORCH_BATCH=0``), byte-identical to ``tests/cut/``;
- the JSON and text reports of the engine path equal those of
  ``cutadapt_tpu.cli.main`` on the same arguments (all keys but the
  version, command-line and Python fields);
- the drive at ``-j 1`` and ``-j 2`` (both the pipelined drive)
  byte-identical to the golden files, and routed filter outputs
  byte-identical to the JAX package's;
- the device rule: with no card and no ``CUTADAPT_TPU_TORCH_DEVICE=cpu``
  an engine run fails naming CUDA and writes nothing; a refused run is
  counted as a fallback and an accepted one is not;
- the port's environment names are its own.

The engine path of every golden case is in test_torch_cli_engine.py.
Tolerance everywhere: exact.
"""

import json
import os

import pytest

from cutadapt_tpu import adapters as jax_adapters
from cutadapt_tpu import cli as jax_cli
from cutadapt_tpu import report as jax_report
from cutadapt_tpu_torch import accel, batch_pipeline, cli, tracing
from cutadapt_tpu_torch import adapters as port_adapters
from cutadapt_tpu_torch import report as port_report
from cutadapt_tpu_torch.ops import align_cuda
from torch_fixtures import (
    ENGINE_NOT_YET,
    golden_args,
    golden_cases,
    golden_path,
    one_torch_thread,
)

CASES = golden_cases()
BY_ID = {case[0]: case for case in CASES}
ENV = (
    "CUTADAPT_TPU_TORCH_BATCH", "CUTADAPT_TPU_TORCH_DEVICE",
    "CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_BATCH",
)
# report keys that name the program, its caller or the interpreter
IGNORED_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture
def port_env(monkeypatch):
    """The port on the CPU (the plain aligner), default policy."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    return monkeypatch


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def plain_runs() -> int:
    return sum(align_cuda.PLAIN_RUNS.values())


def run_case(case_id, out_dir, extra=()):
    """Run one golden case through the port's main; returns (stats,
    output path)."""
    _, params, expected, inpath = BY_ID[case_id]
    out = os.path.join(out_dir, expected)
    stats = cli.main(list(extra) + golden_args(params, out, inpath))
    return stats, out


@pytest.mark.parametrize(
    "case", CASES, ids=[case[0] for case in CASES],
)
def test_host_path_golden(port_env, tmp_path, case):
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "0")
    fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
    _, out = run_case(case[0], tmp_path)
    assert read(out) == read(golden_path(case[2]))
    assert accel.FALLBACK_COUNT == fallbacks
    assert plain_runs() == runs


def test_golden_cases_equal_the_jax_list():
    import test_commandline

    assert golden_cases() == test_commandline.GOLDEN_CASES


def _restart_adapter_names(monkeypatch):
    """Adapters without a name are numbered per process; start both
    packages' counters at 0, so that the reports name them alike."""
    for module in (port_adapters, jax_adapters):
        monkeypatch.setattr(module, "_adapter_counter", [0])


def _json_report(path):
    with open(path) as f:
        d = json.load(f)
    for key in IGNORED_REPORT_KEYS:
        d.pop(key)
    return d


# six accepted cases (FASTQ and FASTA, gzip, two adapters, filters, the
# mask and retain actions, an anchored 5' adapter) and one refused case
REPORT_CASES = [
    "small", "twoadapters", "illumina_adapter_wildcard", "discard_untrimmed",
    "maximum_length", "action_mask", "action_retain", "anchored_front",
    "qualtrim",
]


@pytest.mark.parametrize("case_id", REPORT_CASES)
def test_reports_equal_the_jax_package(port_env, tmp_path, case_id):
    if case_id not in ENGINE_NOT_YET:
        port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    _, params, expected, inpath = BY_ID[case_id]
    results = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        _restart_adapter_names(port_env)
        args = golden_args(params, str(d / expected), inpath)
        stats = main(args + ["--json", str(d / "report.json")])
        results[name] = (stats, _json_report(d / "report.json"),
                         read(d / expected))
    port, ref = results["port"], results["jax"]
    assert port[2] == ref[2] == read(golden_path(expected))
    assert port[1] == ref[1]
    gc = 0.5
    assert port_report.full_report(port[0], 1.0, gc) == \
        jax_report.full_report(ref[0], 1.0, gc)
    assert port_report.minimal_report(port[0], 1.0, gc) == \
        jax_report.minimal_report(ref[0], 1.0, gc)


# inputs whose records fit 128-byte chunks, so that each run has several
DRIVE_CASES = ["small", "example", "twoadapters", "action_lowercase",
               "mask_adapter"]


@pytest.mark.parametrize("cores", ["1", "2"])
@pytest.mark.parametrize("case_id", DRIVE_CASES)
def test_drives_are_byte_identical(port_env, tmp_path, case_id, cores):
    """-j 1 (the serial runner) and -j 2 (the CLI's device-first branch)
    both run the pipelined drive over several chunks."""
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    # small chunks, so that several are in flight and emit in order
    port_env.setenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "128")
    drive = accel._pipelined_drive
    chunks = []

    def counted_drive(producer, submit, emit):
        def counted(item):
            chunks.append(item)
            return submit(item)

        drive(producer, counted, emit)

    port_env.setattr(accel, "_pipelined_drive", counted_drive)
    runs = plain_runs()
    tracing.enable()
    try:
        _, out = run_case(case_id, tmp_path, ("-j", cores))
    finally:
        records = tracing.disable()
    assert read(out) == read(golden_path(BY_ID[case_id][2]))
    assert plain_runs() > runs
    assert len(chunks) > 1
    assert tracing.in_flight_max(records) >= 1


# small.fastq holds three reads: trimmed to 24 and 22 bp, and one of
# 34 bp without the adapter
@pytest.mark.parametrize("limits, filled", [
    (("-m", "23", "-M", "30"), ("out", "short", "long")),
    (("-m", "23", "-M", "40"), ("out", "short", "untrimmed")),
])
def test_routed_filter_outputs_equal_the_jax_package(port_env, tmp_path,
                                                     limits, filled):
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    names = ("out", "short", "long", "untrimmed")
    files = {}
    for which, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / which
        d.mkdir()
        _restart_adapter_names(port_env)
        main([
            "-a", "TTAGACATATCTCCGTCG", *limits,
            "--too-short-output", str(d / "short"),
            "--too-long-output", str(d / "long"),
            "--untrimmed-output", str(d / "untrimmed"),
            "--json", str(d / "report.json"),
            "-o", str(d / "out"), golden_args([], "", "small.fastq")[-1],
        ])
        files[which] = {n: read(d / n) for n in names}
        files[which]["report"] = _json_report(d / "report.json")
    assert files["port"] == files["jax"]
    assert {n for n in names if files["port"][n]} == set(filled)


def test_no_card_fails_naming_cuda(port_env, tmp_path, caplog):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    port_env.delenv("CUTADAPT_TPU_TORCH_DEVICE")
    fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
    with pytest.raises(SystemExit) as e:
        run_case("small", tmp_path)
    assert e.value.code == 1
    assert "CUDA" in caplog.text
    out = tmp_path / BY_ID["small"][2]
    assert not out.exists() or out.stat().st_size == 0
    assert accel.FALLBACK_COUNT == fallbacks
    assert plain_runs() == runs


def test_unknown_device_fails(port_env, tmp_path, caplog):
    port_env.setenv("CUTADAPT_TPU_TORCH_DEVICE", "meta")
    with pytest.raises(SystemExit) as e:
        run_case("small", tmp_path)
    assert e.value.code == 1
    assert "could not start" in caplog.text


# an adapter with the 'anywhere' search parameter, which the engine, as
# the JAX package's, has no task for
ANYWHERE = ["-a", "ACGTACGT;anywhere"]
ANYWHERE_REASON = "'anywhere' search parameter"


def test_fallback_counted_on_refused_case_only(port_env, tmp_path):
    fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
    _, out = run_case("small", tmp_path)
    assert read(out) == read(golden_path("small.fastq"))
    assert accel.FALLBACK_COUNT == fallbacks
    assert plain_runs() > runs

    data = golden_args([], "", "small.fastq")[-1]
    for which, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(ANYWHERE + ["-o", str(tmp_path / which), data])
    assert read(tmp_path / "port") == read(tmp_path / "jax")
    assert accel.FALLBACK_COUNT == fallbacks + 1
    assert ANYWHERE_REASON in accel.LAST_FALLBACK


# options whose pipeline the engine refuses, with the reason it gives
REFUSED_OPTIONS = [
    (["--revcomp", "--poly-a"],
     "a host stage after the --revcomp stage has no engine form"),
    (ANYWHERE, ANYWHERE_REASON),
    (["--action=mask", "--poly-a"], "after a mask/lowercase adapter stage"),
    (["-a", "^TTAGACATAT...GGGGGG", "--action=crop"],
     "linked adapters with --action=crop"),
]


@pytest.mark.parametrize(
    "options, reason", REFUSED_OPTIONS,
    ids=[r.split()[-1].strip("'") for _, r in REFUSED_OPTIONS],
)
def test_refused_options_fail_in_require_mode_and_run_on_host(
        port_env, tmp_path, caplog, options, reason):
    """Under require, exit 1 with the reason; by default, the host path
    writes what the JAX package's CLI writes."""
    data = golden_args([], "", "small.fastq")[-1]
    outputs = {}
    for which, main in (("require", cli.main), ("port", cli.main),
                        ("jax", jax_cli.main)):
        d = tmp_path / which
        d.mkdir()
        port_env.setenv("CUTADAPT_TPU_TORCH_BATCH",
                        "require" if which == "require" else "1")
        _restart_adapter_names(port_env)
        args = ["-a", "TTAGACATATCTCCGTCG", "-o", str(d / "out.fastq")]
        args += [o.format(d=d) for o in options] + [data]
        if which == "require":
            with pytest.raises(SystemExit) as e:
                main(args)
            assert e.value.code == 1
            assert reason in caplog.text
            continue
        fallbacks = accel.FALLBACK_COUNT
        main(args)
        if which == "port":
            assert accel.FALLBACK_COUNT == fallbacks + 1
        outputs[which] = {p.name: read(p) for p in d.iterdir()}
    assert outputs["port"] == outputs["jax"]
    assert outputs["port"]


# options of the output side, which the engine runs; the ids are those
# of the refusals they were before
OUTPUT_SIDE_OPTIONS = [
    (["--rest-file", "{d}/rest.txt"], "RestFileWriter"),
    (["--info-file", "{d}/info.txt"], "InfoFileWriter"),
    (["--wildcard-file", "{d}/wildcard.txt"], "WildcardFileWriter"),
    (["-o", "{d}/{{name}}.fastq", "--untrimmed-output", "{d}/untrimmed"],
     "Demultiplexer"),
    (["--rename", "{{id}}_x {{adapter_name}} {{match_sequence}}"],
     "Renamer"),
    (["--zero-cap", "--max-ee", "1"], "ZeroCapper"),
    (["-x", "pre_{{name}}_", "-y", "_post"], "PrefixSuffixAdder"),
]


@pytest.mark.parametrize(
    "options", [o for o, _ in OUTPUT_SIDE_OPTIONS],
    ids=[i for _, i in OUTPUT_SIDE_OPTIONS],
)
def test_output_side_options_ride_the_engine(port_env, tmp_path, options):
    """Under require, every output file and the --json report equal what
    the JAX package's CLI writes, with no fallback."""
    data = golden_args([], "", "small.fastq")[-1]
    outputs = {}
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    for which, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / which
        d.mkdir()
        _restart_adapter_names(port_env)
        fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
        main(["-a", "first=TTAGACATATCTCCGTCG", "-o", str(d / "out.fastq"),
              "--json", str(d / "report.json")]
             + [o.format(d=d) for o in options] + [data])
        if which == "port":
            assert accel.FALLBACK_COUNT == fallbacks
            assert plain_runs() > runs
        outputs[which] = {p.name: read(p) for p in d.iterdir()
                          if p.name != "report.json"}
        outputs[which]["report"] = _json_report(d / "report.json")
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"]) > 1


def test_paired_end_is_refused(port_env, tmp_path):
    """A paired run of byte-lane adapters on both reads, once refused,
    rides the engine under require: both outputs and the --json report
    equal what the JAX package's engine writes (CUTADAPT_TPU_BATCH=1),
    with no fallback."""
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    port_env.setenv("CUTADAPT_TPU_BATCH", "1")
    data = golden_args([], "", "paired.1.fastq")[-1]
    outputs = {}
    for which, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / which
        d.mkdir()
        _restart_adapter_names(port_env)
        fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
        main(["-N", "-a", "TTAGACATATRYKMXSWBDHVN",
              "-A", "CAGTGGAGTARYKMXSWBDHVN",
              "-o", str(d / "1.fastq"), "-p", str(d / "2.fastq"),
              "--json", str(d / "report.json"), data,
              data.replace("paired.1", "paired.2")])
        if which == "port":
            assert accel.FALLBACK_COUNT == fallbacks
            assert align_cuda.PLAIN_RUNS["byte"] > 0 and plain_runs() > runs
        outputs[which] = {n: read(d / n) for n in ("1.fastq", "2.fastq")}
        outputs[which]["report"] = _json_report(d / "report.json")
    assert outputs["port"] == outputs["jax"]
    counts = outputs["port"]["report"]["read_counts"]
    assert counts["read1_with_adapter"] and counts["read2_with_adapter"]


def test_quality_trimming_of_fasta_is_refused(port_env, tmp_path, caplog):
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    with pytest.raises(SystemExit) as e:
        cli.main(["-q", "10", "-a", "TTAGACATAT", "-o",
                  str(tmp_path / "out.fasta"),
                  golden_args([], "", "multi.fasta")[-1]])
    assert e.value.code == 1
    assert "quality trimming or capping of FASTA input" in caplog.text


def test_engine_needs_the_native_library(port_env, tmp_path, caplog):
    """Without the native host library the engine does not run: a run
    takes the host path through one fallback, which names the library
    (an error under require), and the engine refuses to be built."""
    from cutadapt_tpu_torch import native

    port_env.setattr(native, "AVAILABLE", False)
    fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
    _, out = run_case("twoadapters", tmp_path)
    assert read(out) == read(golden_path("twoadapters.fasta"))
    assert accel.FALLBACK_COUNT == fallbacks + 1
    assert "native host library" in accel.LAST_FALLBACK
    assert plain_runs() == runs
    with pytest.raises(RuntimeError, match="native host library"):
        batch_pipeline.BatchPipelineEngine([], device="cpu")
    port_env.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    with pytest.raises(SystemExit) as e:
        run_case("twoadapters", tmp_path)
    assert e.value.code == 1
    assert "native host library" in caplog.text


def test_jax_package_environment_leaves_the_port_alone(port_env, tmp_path):
    """The JAX package's variables do not steer the port: its engine
    stays on under CUTADAPT_TPU_BATCH=0, its exact-wire switch reads only
    its CUTADAPT_TPU_TORCH_ name, and its scalar tail is a constant that
    the JAX package's CUTADAPT_TPU_SCALAR_TAIL does not reach."""
    port_env.setenv("CUTADAPT_TPU_BATCH", "0")
    port_env.setenv("CUTADAPT_TPU_PACK2", "0")
    port_env.setenv("CUTADAPT_TPU_EXACT_WIRE", "1")
    port_env.setenv("CUTADAPT_TPU_SCALAR_TAIL", "7")
    fallbacks, runs = accel.FALLBACK_COUNT, plain_runs()
    _, out = run_case("twoadapters", tmp_path)
    assert read(out) == read(golden_path("twoadapters.fasta"))
    assert plain_runs() > runs
    assert accel.FALLBACK_COUNT == fallbacks
    assert not batch_pipeline._exact_wire_on(batch_pipeline.torch.device("cpu"))
    assert batch_pipeline._SCALAR_TAIL == 512

    port_env.setenv("CUTADAPT_TPU_TORCH_EXACT_WIRE", "1")
    assert batch_pipeline._exact_wire_on(batch_pipeline.torch.device("cpu"))
