"""
A pytest plugin that runs the JAX package's own test suites against the
PyTorch port: every import of ``cutadapt_tpu`` or ``cutadapt_tpu.X``
resolves to ``cutadapt_tpu_torch`` or ``cutadapt_tpu_torch.X``, the same
module objects. Nothing of the JAX package is imported.

At the end of the session it fails the run unless the port's engine
carried it: no fallback to the host path was counted
(``accel.FALLBACK_COUNT`` is 0) and the aligner ran (kernel launches
plus plain-version runs above 0), so that a broken alias cannot pass on
the host path alone. It prints one line, ``torch_as_jax {...}``, with
those counts and, for runs on a shard mesh (``CUTADAPT_TPU_TORCH_DEVICES``),
the launches per shard, the statistics reducer's folds and the scatter
kernel's launches and plain runs.

Load it before the suites' conftest, with ``tests/`` and the repository
on ``PYTHONPATH``::

    CUTADAPT_TPU_TORCH_BATCH=require CUTADAPT_TPU_TORCH_DEVICE=cpu \\
    PYTHONPATH=tests:. python -m pytest -q -p no:cacheprovider \\
        -p torch_as_jax tests/test_commandline.py tests/test_paired.py

(leave ``CUTADAPT_TPU_TORCH_DEVICE`` unset on a machine with a card).
"""

import importlib
import importlib.abc
import importlib.util
import json
import sys

import pytest

ALIAS = "cutadapt_tpu"
PORT = "cutadapt_tpu_torch"


class _PortLoader(importlib.abc.Loader):
    """Hands back the port's module, already imported, under the alias."""

    def __init__(self, module):
        self.module = module

    def create_module(self, spec):
        return self.module

    def exec_module(self, module):
        pass


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname != ALIAS and not fullname.startswith(ALIAS + "."):
            return None
        module = importlib.import_module(PORT + fullname[len(ALIAS):])
        return importlib.util.spec_from_loader(
            fullname, _PortLoader(module),
            is_package=hasattr(module, "__path__"),
        )


if any(n == ALIAS or n.startswith(ALIAS + ".") for n in sys.modules):
    raise RuntimeError(
        f"{ALIAS} was imported before the torch_as_jax plugin: load the "
        "plugin first (-p torch_as_jax)"
    )
sys.meta_path.insert(0, _AliasFinder())


def counts() -> dict:
    """The port's fallback, launch and plain-run counters, the aligner's
    launches per shard of a mesh, the statistics reducer's folds and the
    scatter kernel's launches and plain runs."""
    from cutadapt_tpu_torch import accel, batch_pipeline
    from cutadapt_tpu_torch.ops import align_cuda, stats_cuda
    from cutadapt_tpu_torch.parallel import stats

    return dict(
        fallbacks=accel.FALLBACK_COUNT,
        last_fallback=accel.LAST_FALLBACK,
        launches=dict(align_cuda.LAUNCHES),
        wide_launches=dict(align_cuda.WIDE_LAUNCHES),
        plain_runs=dict(align_cuda.PLAIN_RUNS),
        shard_launches={str(k): v for k, v in
                        sorted(batch_pipeline.SHARD_LAUNCHES.items())},
        unsharded_dispatches=batch_pipeline.UNSHARDED_DISPATCHES,
        reducer_folds=stats.FOLDS,
        scatter_launches=dict(stats_cuda.LAUNCHES),
        scatter_plain_runs=dict(stats_cuda.PLAIN_RUNS),
    )


@pytest.hookimpl(trylast=True)
def pytest_sessionfinish(session, exitstatus):
    c = counts()
    ran = sum(c["launches"].values()) + sum(c["plain_runs"].values())
    print(f"\ntorch_as_jax {json.dumps(c)}", flush=True)
    problem = None
    if sys.modules.get(ALIAS + ".cli") is not sys.modules.get(PORT + ".cli"):
        problem = f"{ALIAS}.cli is not the port's module"
    elif c["fallbacks"]:
        problem = (f"{c['fallbacks']} runs fell back to the host path "
                   f"({c['last_fallback']})")
    elif not ran:
        problem = "the port's aligner never ran"
    if problem is not None and session.testscollected:
        print(f"torch_as_jax: FAILED: {problem}", flush=True)
        session.exitstatus = pytest.ExitCode.TESTS_FAILED
