"""
The PyTorch port's aligner tables equal the JAX package's, table for
table, and importing the port pulls in neither jax nor any module of
the JAX package.
"""

import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from cutadapt_tpu.adapters import Where
from cutadapt_tpu.ops import align_batch as jab
from cutadapt_tpu_torch.ops import align_batch as tab
from torch_fixtures import parity_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CASES of tests/test_align_pallas.py
CASES = [
    tab.AlignerSpec(reference=ref, max_error_rate=rate, flags=flags,
                    wildcard_ref=wc, indel_cost=1, min_overlap=3)
    for ref, wc, flags, rate in [
        ("AGATCGGAAGAGC", False, Where.BACK.value, 0.1),
        ("ANGNTCGGANG", True, Where.BACK.value, 0.2),
        ("CTGATCGGACT", False, Where.FRONT.value, 0.2),
        ("ACGTACGTAA", False, Where.ANYWHERE.value, 0.2),
        ("AGATCGGAAGAGC", False, Where.BACK.value, 0.0),
    ]
]
SPECS = parity_specs() + CASES + [
    # read wildcards: IUPAC query encoding
    tab.AlignerSpec(reference="ACGTTGCA", max_error_rate=0.2,
                    wildcard_query=True, min_overlap=2),
]

PORT_MODULES = [
    "cutadapt_tpu_torch",
    "cutadapt_tpu_torch.accel",
    "cutadapt_tpu_torch.adapters",
    "cutadapt_tpu_torch.align",
    "cutadapt_tpu_torch.batch_pipeline",
    "cutadapt_tpu_torch.cli",
    "cutadapt_tpu_torch.info",
    "cutadapt_tpu_torch.io",
    "cutadapt_tpu_torch.io.chunks",
    "cutadapt_tpu_torch.io.compressed",
    "cutadapt_tpu_torch.io.fastq",
    "cutadapt_tpu_torch.io.files",
    "cutadapt_tpu_torch.io.records",
    "cutadapt_tpu_torch.json_utils",
    "cutadapt_tpu_torch.kmer_finder",
    "cutadapt_tpu_torch.kmer_heuristic",
    "cutadapt_tpu_torch.log",
    "cutadapt_tpu_torch.modifiers",
    "cutadapt_tpu_torch.native",
    "cutadapt_tpu_torch.ops",
    "cutadapt_tpu_torch.ops.align_batch",
    "cutadapt_tpu_torch.ops.align_cuda",
    "cutadapt_tpu_torch.ops.stats_cuda",
    "cutadapt_tpu_torch.ops.tables",
    "cutadapt_tpu_torch.parallel",
    "cutadapt_tpu_torch.parallel.mesh",
    "cutadapt_tpu_torch.parallel.multihost",
    "cutadapt_tpu_torch.parallel.stats",
    "cutadapt_tpu_torch.parser",
    "cutadapt_tpu_torch.pipeline",
    "cutadapt_tpu_torch.predicates",
    "cutadapt_tpu_torch.qualtrim",
    "cutadapt_tpu_torch.report",
    "cutadapt_tpu_torch.runners",
    "cutadapt_tpu_torch.statistics",
    "cutadapt_tpu_torch.steps",
    "cutadapt_tpu_torch.tokenizer",
    "cutadapt_tpu_torch.tracing",
    "cutadapt_tpu_torch.utils",
    "chip_smoke",
    "torch_fixtures",
    # tools/: the port's coordinator and measurement tools
    "multihost_run_torch",
    "fuzz_parity_torch",
    "profile_batch_torch",
    "profile_xfer_torch",
    "kernel_bench_torch",
    "trace_cell_torch",
    # the port's counterparts of bench.py, bench_configs.py,
    # tools/verify_pallas_tpu.py and tools/gen_cli_reference.py
    "bench_torch",
    "bench_configs_torch",
    "verify_cuda_torch",
    "gen_cli_reference_torch",
]
# the measurement programs and what they import at run time, which must
# load nothing from tests/ either
MEASUREMENT_MODULES = [
    "bench_torch",
    "bench_configs_torch",
    "verify_cuda_torch",
    "gen_cli_reference_torch",
    "kernel_bench_torch",
    "profile_batch_torch",
    "trace_cell_torch",
    "cutadapt_tpu_torch.cli",
]
LEAK_CHECK = (
    "bad = sorted(m for m in sys.modules if m == 'jax'\n"
    "             or m.startswith('jax.') or m == 'cutadapt_tpu'\n"
    "             or m.startswith('cutadapt_tpu.'))\n"
    "print('LEAKED', bad)\n"
    "sys.exit(1 if bad else 0)\n"
)


def test_constants_match():
    for name in ("MATCH_SCORE", "MISMATCH_SCORE", "INSERTION_SCORE",
                 "DELETION_SCORE", "INF_COST", "BIG_NEG"):
        assert getattr(tab, name) == getattr(jab, name), name


def test_parity_specs_match_the_jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import verify_pallas_tpu
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    want = [
        (ref, wc, flags.value, rate, ic, mo)
        for ref, wc, flags, rate, ic, mo in verify_pallas_tpu.parity_cases()
    ]
    got = [
        (s.reference, s.wildcard_ref, s.flags, s.max_error_rate,
         s.indel_cost, s.min_overlap)
        for s in parity_specs()
    ]
    assert got == want


@pytest.mark.parametrize(
    "spec", SPECS, ids=[f"{i}-{s.reference[:8]}-{s.flags}"
                        for i, s in enumerate(SPECS)],
)
def test_tables_match_jax(spec):
    jspec = jab.AlignerSpec(**spec._asdict())
    assert tuple(spec) == tuple(jspec)
    for flag in ("start_in_reference", "start_in_query",
                 "stop_in_reference", "stop_in_query"):
        assert getattr(spec, flag) == getattr(jspec, flag)
    for fn in ("encode_reference", "query_lut", "n_counts",
               "acceptance_table", "min_length_table"):
        got = getattr(tab, fn)(spec)
        want = getattr(jab, fn)(jspec)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    assert tab.effective_length(spec) == jab.effective_length(jspec)
    got = tab.query_class_info(spec)
    want = jab.query_class_info(jspec)
    assert (got is None) == (want is None)
    if got is not None:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_port_imports_nothing_of_jax():
    """A fresh interpreter that imports every module of the port (and
    chip_smoke) has neither jax nor any cutadapt_tpu module loaded."""
    code = (
        "import importlib, sys\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
    ) + LEAK_CHECK
    r = _fresh_python("-c", code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_measurement_programs_import_nothing_of_jax_or_tests():
    """A fresh interpreter without tests/ on its path imports the four
    measurement programs and what they load at run time: neither jax, nor
    any cutadapt_tpu module, nor any module of tests/ is loaded."""
    code = (
        "import importlib, os, sys\n"
        f"for name in {MEASUREMENT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"tests = {os.path.join(REPO, 'tests')!r}\n"
        "from_tests = sorted(n for n, m in list(sys.modules.items())\n"
        "    if (getattr(m, '__file__', None) or '').startswith(tests))\n"
        "print('FROM_TESTS', from_tests)\n"
        "if from_tests:\n"
        "    sys.exit(1)\n"
    ) + LEAK_CHECK
    r = _fresh_python("-c", code, tests_on_path=False)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FROM_TESTS []" in r.stdout


def _fresh_python(*args, tests_on_path=True):
    path = [REPO] + ([os.path.join(REPO, "tests")] if tests_on_path else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        path + [os.path.join(REPO, "tools")]))
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_cli_help_imports_nothing_of_jax():
    """``python -m cutadapt_tpu_torch --help`` runs, and a fresh
    interpreter that runs the same module as __main__ has neither jax
    nor any cutadapt_tpu module loaded."""
    r = _fresh_python("-m", "cutadapt_tpu_torch", "--help")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cutadapt-tpu-torch" in r.stdout
    code = (
        "import runpy, sys\n"
        "sys.argv = ['cutadapt-tpu-torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('cutadapt_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
    ) + LEAK_CHECK
    r = _fresh_python("-c", code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_paired_revcomp_run_imports_nothing_of_jax(tmp_path):
    """A paired --revcomp run and a single-end --revcomp run through the
    engine (require mode, the plain aligner on the CPU) in a fresh
    interpreter load neither jax nor any cutadapt_tpu module."""
    data = os.path.join(REPO, "tests", "data")
    runs = [
        ["--revcomp", "-g", "^TTATTTGTCT", "-G", "^TCCGCACTGGC",
         "-o", str(tmp_path / "1.fastq"), "-p", str(tmp_path / "2.fastq"),
         os.path.join(data, "revcomp.1.fastq"),
         os.path.join(data, "revcomp.2.fastq")],
        ["--revcomp", "-g", "^TTATTTGTCT", "-o", str(tmp_path / "s.fastq"),
         os.path.join(data, "revcomp.1.fastq")],
    ]
    # one torch thread: the plain aligner's many small ops wait at a
    # thread pool's barriers where test processes share the cores
    code = (
        "import os, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "os.environ.update(CUTADAPT_TPU_TORCH_DEVICE='cpu',\n"
        "                  CUTADAPT_TPU_TORCH_BATCH='require')\n"
        "from cutadapt_tpu_torch import accel, cli\n"
        f"for args in {runs!r}:\n"
        "    cli.main(args)\n"
        "assert accel.FALLBACK_COUNT == 0\n"
    ) + LEAK_CHECK
    r = _fresh_python("-c", code)
    assert r.returncode == 0, r.stdout + r.stderr
