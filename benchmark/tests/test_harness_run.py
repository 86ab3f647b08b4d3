"""The harness end to end on the CPU (the port's plain aligner, small
files): each cell comes out correct, a broken timed path does not, and
the result line has the contract's keys."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import control, run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
READS = 1200


def cpu_run(workload, trace=False, seed=2**32 + 11):
    return run.run(workload, seed, 0.05, trace, device="cpu", reads=READS)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct(workload, port_env):
    r = cpu_run(workload)
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r) == KEYS
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())
    json.dumps(r)


def test_traced_run_reads_the_host_layers(port_env):
    r = cpu_run("pe_truseq_q20.bulk", trace=True)
    assert r["correct"] is True
    # the device's metrics need a card's trace; the rest is read here
    assert set(r["metrics"]) == {
        "call_startup_ms", "parse_ns_per_read", "submit_ns_per_read",
        "candidates_per_read", "h2d_bytes_per_read", "collect_ns_per_read"}
    assert 0 < r["metrics"]["candidates_per_read"]["value"] <= 2


def _patch_collect(monkeypatch, change):
    from cutadapt_tpu_torch.batch_pipeline import BatchPipelineEngine

    orig = BatchPipelineEngine.collect

    def collect(self, pending):
        return change(pending, *orig(self, pending))

    monkeypatch.setattr(BatchPipelineEngine, "collect", collect)


def state_unchanged(pending, ws, we, keep, stats):
    return np.zeros_like(ws), pending.parsed.seq_len.astype(we.dtype), keep, stats


def one_answer_altered(pending, ws, we, keep, stats):
    we = we.copy()
    we[0] = max(int(we[0]) - 1, int(ws[0]))
    return ws, we, keep, stats


def _patch_half_left_out(monkeypatch):
    """The drive hands on every other record of each chunk (both mates
    of a pair): half of each batch left out."""
    from cutadapt_tpu_torch import accel

    drive = accel._pipelined_drive
    half = slice(0, None, 2)

    def halve(item):
        if isinstance(item, tuple):
            return tuple(accel._slice_parsed(p, half) if p is not None else p
                         for p in item)
        return accel._slice_parsed(item, half)

    def halved(producer, *args, **kwargs):
        return drive((halve(item) for item in producer), *args, **kwargs)

    monkeypatch.setattr(accel, "_pipelined_drive", halved)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "one_answer_altered"])
@pytest.mark.parametrize("workload", ["se_truseq.bulk", "pe_truseq_q20.bulk"])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch,
                                            port_env):
    if fault == "half_left_out":
        _patch_half_left_out(monkeypatch)
    else:
        _patch_collect(monkeypatch, globals()[fault])
    r = cpu_run(workload)
    assert r["correct"] is False
    assert r["checks"]["output_mismatch_calls"]["value"] == r["attempted"]


def test_a_fallback_is_a_failed_call(monkeypatch, port_env):
    from cutadapt_tpu_torch import accel

    monkeypatch.setattr(accel, "_run_single", lambda *a: accel._fallback("test"))
    r = cpu_run("se_truseq.bulk")
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1


def test_a_call_without_a_launch_is_failed(monkeypatch, port_env):
    monkeypatch.setattr(run, "launch_count", lambda device: 0)
    r = cpu_run("se_truseq.bulk")
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1


def _plant_jax():
    sys.modules.setdefault("jax", types.ModuleType("jax"))


@pytest.fixture
def no_jax_after():
    had = "jax" in sys.modules
    yield
    if not had:
        sys.modules.pop("jax", None)


def _planting(monkeypatch, folder, attr):
    """Load the modules of ``folder`` (reference, metrics) so that their
    ``attr`` (run, read) loads a module named jax first."""
    load = run.load_file_module

    def loading(path):
        mod = load(path)
        if os.path.basename(os.path.dirname(path)) == folder:
            fn = getattr(mod, attr)

            def planted(*args, **kwargs):
                _plant_jax()
                return fn(*args, **kwargs)

            setattr(mod, attr, planted)
        return mod

    monkeypatch.setattr(run, "load_file_module", loading)


@pytest.mark.parametrize("where", ["before the run", "in the reference",
                                   "in a metric reader"])
def test_jax_loaded_ends_the_run(where, monkeypatch, port_env, no_jax_after,
                                 capsys):
    """JAX loaded at any time before the result is printed: exit code 1,
    no result, and what was found named on standard error."""
    if where == "before the run":
        _plant_jax()
    elif where == "in the reference":
        _planting(monkeypatch, "reference", "run")
    else:
        _planting(monkeypatch, "metrics", "read")
    r = cpu_run("se_truseq.bulk", trace=where == "in a metric reader")
    capsys.readouterr()
    assert "jax" in sys.modules
    assert run.finish(r) == 1
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_a_result_is_printed_last(port_env, capsys):
    r = cpu_run("se_truseq.bulk")
    capsys.readouterr()
    assert run.finish(r) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1]) == r
    assert err.splitlines()[-1].startswith("check report_mismatch_calls: 0")


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"),
                        "--workload", "se_truseq.bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The control goes through run.judge and fails its checks."""
    for seed in (1, 2, 3):
        r = control.readings(workload, seed, "cpu", reads=4 * READS)
        assert r["correct"] is False
        assert (r["output_blocks_differing"] + r["report_fields_differing"]
                >= 1)


def test_judge_holds_each_call_to_its_own_file():
    want = [{"digests": [["a"]], "summary": {"n": 1}},
            {"digests": [["b"]], "summary": {"n": 2}}]
    calls = [run.Call(0, [["a"]], {"n": 1}, launches=1),
             run.Call(1, [["b"]], {"n": 2}, launches=1),
             run.Call(1, [["a"]], {"n": 1}, launches=1),
             run.Call(0, [["a", "c"]], {"n": 1}, launches=1)]
    checks, notes = run.judge(calls, want)
    assert checks["failed_calls"]["value"] == 0
    assert checks["output_mismatch_calls"]["value"] == 2
    assert checks["report_mismatch_calls"]["value"] == 1
    assert not run.passes(checks) and run.passes(run.judge(calls[:2], want)[0])


def _variable_length_generator(tmp_path):
    """A generator file of its own: the model's reads, each cut to a
    length of 40 to the read length (the mates of a pair alike)."""
    (tmp_path / "cut_reads.py").write_text(
        "import numpy as np\n"
        "from benchmark import generate\n"
        "def make(traffic, seed, stream, device):\n"
        "    mates = generate.make_reads(traffic, seed, stream, device)\n"
        "    n, L = len(mates[0]), traffic['read_length']\n"
        "    lens = 40 + np.arange(n) * 7919 % (L - 39)\n"
        "    for m in mates:\n"
        "        m.lens = lens\n"
        "    return mates\n")
    return str(tmp_path)


@pytest.mark.parametrize("shape", ["three files", "gzip", "own generator"])
@pytest.mark.parametrize("workload", ["se_truseq.bulk", "pe_truseq_q20.bulk"])
def test_traffic_of_other_shapes_runs_from_its_file(workload, shape,
                                                    monkeypatch, port_env,
                                                    tmp_path):
    """What a traffic file may ask for besides the model: several files
    called in turn, gzip in and out, a generator of its own."""
    from benchmark import generate

    load = generate.load_traffic
    extra = {"three files": {"files": 3}, "gzip": {"compression": "gzip"},
             "own generator": {"generator": "cut_reads"}}[shape]
    monkeypatch.setattr(generate, "load_traffic",
                        lambda name: dict(load(name), **extra))
    if shape == "own generator":
        monkeypatch.setattr(generate, "GENERATORS",
                            _variable_length_generator(tmp_path))
    seconds, files = 0.05, []
    if shape == "three files":
        # the window closes after the fourth call: run.py's clock jumps
        seconds, skip = 1000.0, [0.0]
        real = time.perf_counter
        monkeypatch.setattr(run, "time", types.SimpleNamespace(
            perf_counter=lambda: real() + skip[0], time_ns=time.time_ns))
        call_main = run.call_main

        def counted(*args, **kwargs):
            files.append(kwargs.get("file", 0))
            skip[0] = seconds if len(files) == 5 else 0.0
            return call_main(*args, **kwargs)

        monkeypatch.setattr(run, "call_main", counted)
    r = run.run(workload, 2**31 + 5, seconds, False, device="cpu",
                reads=READS)
    assert r["correct"] is True and r["failed"] == 0
    if shape == "three files":  # the warm-up, then files 0, 1, 2, 0
        assert r["attempted"] == 4 and files == [0, 0, 1, 2, 0]


@pytest.mark.parametrize("shape", ["three files", "gzip"])
def test_traffic_of_other_shapes_still_fails_a_fault(shape, monkeypatch,
                                                     port_env):
    from benchmark import generate

    load = generate.load_traffic
    extra = {"three files": {"files": 3}, "gzip": {"compression": "gzip"}}
    monkeypatch.setattr(generate, "load_traffic",
                        lambda name: dict(load(name), **extra[shape]))
    _patch_collect(monkeypatch, one_answer_altered)
    r = cpu_run("se_truseq.bulk")
    assert r["correct"] is False
    assert r["checks"]["output_mismatch_calls"]["value"] == r["attempted"]


@pytest.mark.cuda
def test_only_the_benchmark_is_not_enough(cuda, tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "se_truseq.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode != 0 and p.stdout == ""
