"""
The output side of the port's engine (name edits, --rename, --zero-cap,
side files, demultiplexing) against the JAX package, on the CPU.

The JAX package's own parity tests (``tests/test_accel.py``) run each
configuration twice, with ``CUTADAPT_TPU_BATCH=1`` and ``=0``, and
compare every output file they name and, where they read one, the
``--json`` report. Here their ``main`` is swapped: the first run is the
port's CLI under ``CUTADAPT_TPU_TORCH_BATCH=require`` (the engine, no
fallback, the aligner's plain PyTorch version), the second the JAX
package's CLI on its host path. Their assertions then hold the port's
engine to the JAX CLI byte for byte. The per-side --revcomp cases of
``tests/test_accel_perside_rc.py`` are built through the port's API
and held to the same cases built through the JAX package's.

Tolerance: exact.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

import cutadapt_tpu.adapters as jax_adapters
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as port_adapters
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.ops import align_cuda

import test_accel
import test_accel_perside_rc as perside
import torch_fixtures as fx


def _restart_adapter_names(monkeypatch):
    """Adapters without a name are numbered per process: start both
    packages' counters at 0, so that the reports name them alike."""
    for module in (port_adapters, jax_adapters):
        monkeypatch.setattr(module, "_adapter_counter", [0])


@pytest.fixture
def port_first(monkeypatch):
    """test_accel's ``main`` and engagement spy, swapped: under
    CUTADAPT_TPU_BATCH=1 the port's CLI in require mode (its state
    records that the engine ran with no fallback and launched the plain
    aligner), under 0 the JAX CLI on its host path."""
    state = {}
    with fx.one_torch_thread():
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        monkeypatch.delenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", raising=False)

        def main(argv):
            _restart_adapter_names(monkeypatch)
            if os.environ.get("CUTADAPT_TPU_BATCH") != "1":
                return jax_cli.main(argv)
            fallbacks = taccel.FALLBACK_COUNT
            runs = sum(align_cuda.PLAIN_RUNS.values())
            result = port_cli.main(argv)
            state["engaged"] = taccel.FALLBACK_COUNT == fallbacks
            state["aligner_runs"] = sum(align_cuda.PLAIN_RUNS.values()) - runs
            return result

        monkeypatch.setattr(test_accel, "main", main)
        monkeypatch.setattr(test_accel, "_spy_engagement", lambda mp: state)
        yield state


OUTPUT_SIDE_CONFIGS = ["se_rename", "se_name_edits", "pe_name_edits",
                       "se_mask_edits", "se_lowercase_rename"]
CONFIG_BY_NAME = {c[0]: c for c in test_accel.CONFIGS}


@pytest.mark.parametrize("name", OUTPUT_SIDE_CONFIGS)
def test_accel_configs_match_jax(tmp_path, monkeypatch, port_first, name):
    test_accel.test_fastpath_matches_host(
        tmp_path, monkeypatch, *CONFIG_BY_NAME[name]
    )
    assert port_first["engaged"] and port_first["aligner_runs"] > 0


@pytest.mark.parametrize("name,args", test_accel.RC_EDIT_CONFIGS,
                         ids=[c[0] for c in test_accel.RC_EDIT_CONFIGS])
def test_revcomp_with_name_edits_match_jax(tmp_path, monkeypatch,
                                           port_first, name, args):
    test_accel.test_fastpath_revcomp_with_name_edits(
        tmp_path, monkeypatch, name, args
    )
    assert port_first["engaged"]


def _params(test):
    """Per parametrize mark of a test of test_accel (innermost first),
    its cases as (id, {argname: value})."""
    out = []
    for mark in test.pytestmark:
        names = [n.strip() for n in mark.args[0].split(",")]
        ids = mark.kwargs.get("ids")
        cases = []
        for k, values in enumerate(mark.args[1]):
            values = values if len(names) > 1 else (values,)
            if callable(ids) or ids is None:
                label = "-".join(str(v) for v in values if isinstance(v, str))
            else:
                label = ids[k]
            cases.append((label, dict(zip(names, values))))
        out.append(cases)
    return out


PAIRED_RC_COMBOS = _params(test_accel.test_fastpath_paired_revcomp_combos)[0]


@pytest.mark.parametrize("kw", [kw for _, kw in PAIRED_RC_COMBOS],
                         ids=[label for label, _ in PAIRED_RC_COMBOS])
def test_paired_revcomp_combos_match_jax(tmp_path, monkeypatch, port_first,
                                         kw):
    test_accel.test_fastpath_paired_revcomp_combos(tmp_path, monkeypatch,
                                                   **kw)
    assert port_first["engaged"]


def test_paired_side_files_match_jax(tmp_path, monkeypatch, port_first):
    test_accel.test_fastpath_paired_side_files(tmp_path, monkeypatch)
    assert port_first["engaged"]


@pytest.mark.parametrize("extra", [[], ["-y", " s{name}", "--zero-cap"]],
                         ids=["plain", "edits"])
def test_paired_revcomp_side_files_match_jax(tmp_path, monkeypatch,
                                             port_first, extra):
    test_accel.test_fastpath_paired_revcomp_side_files(tmp_path, monkeypatch,
                                                       extra)
    assert port_first["engaged"]


@pytest.mark.parametrize("action", ["mask", "lowercase"])
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_transform_side_files_match_jax(tmp_path, monkeypatch, port_first,
                                        action, paired):
    test_accel.test_fastpath_transform_side_files(tmp_path, monkeypatch,
                                                  action, paired)
    assert port_first["engaged"]


def test_pair_adapters_wildcard_file_matches_jax(tmp_path, monkeypatch,
                                                 port_first):
    test_accel.test_fastpath_pair_adapters_wildcard_file(tmp_path,
                                                         monkeypatch)
    assert port_first["engaged"]


@pytest.mark.parametrize("extra", [
    [], ["--zero-cap"], ["--strip-suffix", "/1", "-y", " k{name}"],
], ids=["plain", "zerocap", "edits"])
def test_revcomp_side_files_match_jax(tmp_path, monkeypatch, port_first,
                                      extra):
    test_accel.test_fastpath_revcomp_side_files(tmp_path, monkeypatch, extra)
    assert port_first["engaged"]


def test_wildcard_file_matches_jax(tmp_path, monkeypatch, port_first):
    test_accel.test_fastpath_wildcard_file(tmp_path, monkeypatch)
    assert port_first["engaged"] and port_first["aligner_runs"] > 0


def test_info_file_with_zero_cap_matches_jax(tmp_path, monkeypatch,
                                             port_first):
    test_accel.test_fastpath_info_file_with_zero_cap(tmp_path, monkeypatch)
    assert port_first["engaged"]


def test_paired_rename_matches_jax(tmp_path, monkeypatch, port_first):
    test_accel.test_fastpath_paired_rename(tmp_path, monkeypatch)
    assert port_first["engaged"]


# --- per-side --revcomp, built through each package's API --------------------


def _build_and_run_with(package):
    """perside.build_and_run with its imports taken from ``package``: for
    the port, a copy of the function whose ``__import__`` maps the JAX
    package's modules to the port's."""
    if package == "cutadapt_tpu":
        return perside.build_and_run
    import builtins
    import types

    real_import = builtins.__import__

    def redirected(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "cutadapt_tpu" or name.startswith("cutadapt_tpu."):
            name = "cutadapt_tpu_torch" + name[len("cutadapt_tpu"):]
        return real_import(name, globals, locals, fromlist, level)

    env = dict(perside.build_and_run.__globals__)
    env["__builtins__"] = dict(vars(builtins), __import__=redirected)
    return types.FunctionType(perside.build_and_run.__code__, env,
                              "build_and_run")


@pytest.mark.parametrize("rc_side", [0, 1], ids=["rc_r1", "rc_r2"])
@pytest.mark.parametrize("name,config", perside.CONFIGS,
                         ids=[c[0] for c in perside.CONFIGS])
def test_perside_rc_matches_jax(tmp_path, monkeypatch, name, config,
                                rc_side):
    """A ReverseComplementer on one side of a paired pipeline, with the
    case's side files, filters, edits, --rename, demultiplexing or
    interleaved IO: the port's engine writes what the JAX package's
    host path writes, and reports the same."""
    results, reports = {}, {}
    with fx.one_torch_thread():
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        monkeypatch.setenv("CUTADAPT_TPU_BATCH", "0")
        for package in ("cutadapt_tpu_torch", "cutadapt_tpu"):
            fallbacks = taccel.FALLBACK_COUNT
            runs = sum(align_cuda.PLAIN_RUNS.values())
            results[package], reports[package] = _build_and_run_with(
                package
            )(tmp_path, f"{name}-{rc_side}-{package}", config, rc_side)
            assert taccel.FALLBACK_COUNT == fallbacks
            if package == "cutadapt_tpu_torch":
                # the port's engine ran the case
                assert sum(align_cuda.PLAIN_RUNS.values()) > runs
    got, want = results["cutadapt_tpu_torch"], results["cutadapt_tpu"]
    assert len(got) == len(want)
    for k1, k0 in zip(sorted(got), sorted(want)):
        assert got[k1] == want[k0], f"{k1} differs from {k0}"
    for rep in reports.values():
        perside._strip_volatile(rep)
    assert reports["cutadapt_tpu_torch"] == reports["cutadapt_tpu"]


# the configurations of chip_smoke.py's phases 10 and 11, at small scale:
# (arguments with "{d}" for the run's directory, the inputs' maker, the
# outputs)
CHIP_CONFIGS = {
    "long_reads": (
        ["-a", fx.ADAPTER, "-e", "0.1", "-O", "3", "-o", "{d}/out.fastq"],
        lambda: [fx.make_long_reads(40, lengths=(1500, 3000))],
    ),
    "umi_rename_info": (
        ["-u", str(fx.UMI_LEN), "--rename", "{{id}}_{{cut_prefix}} {{comment}}",
         "-a", fx.ADAPTER, "--info-file", "{d}/info.tsv",
         "-o", "{d}/out.fastq"],
        lambda: [fx.make_umi_reads(1500)],
    ),
    "barcode_demultiplexing": (
        ["-e", "0.15", "--no-indels", "-g", "^file:{d}/../barcodes.fasta",
         "-o", "{d}/trimmed-{{name}}.1.fastq",
         "-p", "{d}/trimmed-{{name}}.2.fastq"],
        lambda: list(fx.make_barcoded_pairs(1500)),
    ),
}


@pytest.mark.parametrize("config", sorted(CHIP_CONFIGS))
def test_chip_smoke_configs_match_jax(monkeypatch, tmp_path, config):
    """Through the port's main in require mode and the JAX package's
    main: every file the run writes and the --json report are the
    same."""
    args, make = CHIP_CONFIGS[config]
    inputs = make()
    if config == "barcode_demultiplexing":
        (tmp_path / "barcodes.fasta").write_bytes(inputs.pop())
    paths = []
    for i, data in enumerate(inputs):
        paths.append(tmp_path / f"in.{i + 1}.fastq")
        paths[-1].write_bytes(data)
    got = {}
    with fx.one_torch_thread():
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        fallbacks = taccel.FALLBACK_COUNT
        for which, main in (("port", port_cli.main), ("jax", jax_cli.main)):
            d = tmp_path / which
            d.mkdir()
            _restart_adapter_names(monkeypatch)
            main([a.format(d=d) for a in args]
                 + ["--quiet", "--json", str(tmp_path / f"{which}.json")]
                 + [str(p) for p in paths])
            got[which] = {p.name: p.read_bytes() for p in d.iterdir()}
            got[which]["report"] = fx.json_report(tmp_path / f"{which}.json")
        assert taccel.FALLBACK_COUNT == fallbacks
    assert got["port"] == got["jax"]
    assert len(got["port"]) == {"long_reads": 2, "umi_rename_info": 3,
                                "barcode_demultiplexing": 35}[config]
