"""
The round check: the JAX package's end-to-end golden suites,
``tests/test_commandline.py`` and ``tests/test_paired.py``, run unedited
against the PyTorch port under ``CUTADAPT_TPU_TORCH_BATCH=require`` on
the CPU (the aligner's plain PyTorch version).

Each suite runs in a pytest subprocess with the ``torch_as_jax`` plugin
(tests/torch_as_jax.py), which resolves every ``cutadapt_tpu`` import to
``cutadapt_tpu_torch`` and fails the session unless the engine carried
it: no fallback to the host path, and the aligner ran. A second case runs
them with ``CUTADAPT_TPU_TORCH_DEVICES=8``: every DP dispatch sharded over
8 shards of the CPU and the statistics through the reducer, as the JAX
package's suites run on their 8 virtual devices. Tolerance: every test of
the suite passes (the suites compare byte for byte).
"""

import json
import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def _run_suite(suite, **env_vars) -> dict:
    """One suite through the port in a pytest subprocess; the plugin's
    counts."""
    env = {
        **{k: v for k, v in os.environ.items()
           if k not in ("CUTADAPT_TPU_TORCH_DEVICES",
                        "CUTADAPT_TPU_TORCH_DEVICE_STATS")},
        "CUTADAPT_TPU_TORCH_BATCH": "require",
        "CUTADAPT_TPU_TORCH_DEVICE": "cpu",
        "PYTHONPATH": os.pathsep.join(
            [TESTS, ROOT] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]),
        **env_vars,
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
    return counts


@pytest.mark.timeout(300)
@pytest.mark.parametrize("suite", ["test_commandline.py", "test_paired.py"])
def test_golden_suite_runs_through_the_port(suite):
    counts = _run_suite(suite)
    assert not counts["shard_launches"] and counts["reducer_folds"] == 0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("suite", ["test_commandline.py", "test_paired.py"])
def test_golden_suite_runs_through_the_port_on_8_shards(suite):
    """As the JAX package's own suite runs them: every DP dispatch
    sharded over 8 shards (of the CPU here), the statistics binned per
    shard by the reducer and summed once per run."""
    counts = _run_suite(suite, CUTADAPT_TPU_TORCH_DEVICES="8")
    assert sorted(counts["shard_launches"]) == [str(i) for i in range(8)]
    assert min(counts["shard_launches"].values()) > 0
    assert counts["unsharded_dispatches"] == 0
    assert counts["reducer_folds"] > 0
    assert min(counts["scatter_plain_runs"].values()) > 0
