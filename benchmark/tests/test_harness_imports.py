"""Nothing under benchmark/ imports JAX or the JAX package, nor any of
the repository's files from before the port; nothing under
benchmark/reference/ imports the port. Names are compared by their
top-level part, whole: cutadapt_tpu_torch begins with cutadapt_tpu."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cutadapt_tpu", "bench", "bench_torch",
             "bench_configs", "bench_configs_torch", "chip_smoke",
             "kernel_ab", "tests", "tools"}
PORT = "cutadapt_tpu_torch"


def sources():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_forbidden_imports(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN
    if os.path.relpath(path, HERE).startswith("reference" + os.sep):
        assert PORT not in names


def test_whole_names_are_compared():
    assert "cutadapt_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "cutadapt_tpu.x".split(".")[0] in FORBIDDEN
