"""
The round check: the JAX package's end-to-end golden suites,
``tests/test_commandline.py`` and ``tests/test_paired.py``, run unedited
against the PyTorch port under ``CUTADAPT_TPU_TORCH_BATCH=require`` on
the CPU (the aligner's plain PyTorch version).

Each suite runs in a pytest subprocess with the ``torch_as_jax`` plugin
(tests/torch_as_jax.py), which resolves every ``cutadapt_tpu`` import to
``cutadapt_tpu_torch`` and fails the session unless the engine carried
it: no fallback to the host path, and the aligner ran. Tolerance: every
test of the suite passes (the suites compare byte for byte).
"""

import json
import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("suite", ["test_commandline.py", "test_paired.py"])
def test_golden_suite_runs_through_the_port(suite):
    env = {
        **os.environ,
        "CUTADAPT_TPU_TORCH_BATCH": "require",
        "CUTADAPT_TPU_TORCH_DEVICE": "cpu",
        "PYTHONPATH": os.pathsep.join(
            [TESTS, ROOT] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]),
    }
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "torch_as_jax", os.path.join(TESTS, suite)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=270,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-6000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("torch_as_jax {"))
    counts = json.loads(line.split(" ", 1)[1])
    assert counts["fallbacks"] == 0
    assert sum(counts["plain_runs"].values()) > 0
    assert " passed" in proc.stdout and " failed" not in proc.stdout
