"""BENCHMARK.json against the benchmark's static rules, and every name in
it found as a file: a configuration, a traffic mix, a metric reader."""

import json
import os
import re

import pytest

from benchmark import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in BENCH["command"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert c["reduced"] == [] and TEXT.match(c["why"])
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert TEXT.match(w["why"])
        assert os.path.exists(os.path.join(run.HERE, "traffic",
                                           f"{w['traffic']}.json"))
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py"))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_states_what_the_program_runs(cfg):
    """The reference's parameters are the arguments the program gets."""
    with open(os.path.join(run.ROOT, cfg["file"])) as f:
        c = json.load(f)
    args = c["args"]

    def value(flag):
        return args[args.index(flag) + 1] if flag in args else None

    assert [value("-a"), value("-A")][: len(c["adapters"])] == c["adapters"]
    assert float(value("-e") or 0.1) == c["max_error_rate"]
    assert int(value("-O") or 3) == c["min_overlap"]
    assert (int(value("-q")) if value("-q") else None) == c["quality_cutoff"]
    assert (int(value("-m")) if value("-m") else None) == c["minimum_length"]
    assert value("-j") == "1" and "-N" not in args and not c["read_wildcards"]
