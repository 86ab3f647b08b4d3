"""
The port's measurement tools (tools/*_torch.py) run to the end on the
CPU at a tiny size (``--device cpu``: the plain aligner, the host
clock), exit 0 and print their numbers as a parseable JSON line. Their
device numbers come only from runs on the card (chip_smoke.py phase 15).
"""

import json
import os
import random
import subprocess
import sys

import pytest

import torch_fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, *args):
    """Run tools/<name>.py with ``args`` in a fresh interpreter on one
    torch thread; returns the JSON object of its ``<name> {...}`` line."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CUTADAPT_TPU")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{name}.py"), *args],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines()[::-1]
                if ln.startswith(name + " {"))
    return json.loads(line.split(" ", 1)[1]), r


def test_fuzz_parity_runs_without_mismatch():
    out, r = _tool("fuzz_parity_torch", "3", "2000", "--device", "cpu")
    assert out["iterations"] == 3 and out["mismatches"] == 0
    assert "done: 3 iterations, 0 mismatches" in r.stdout


def test_profile_batch_splits_submit():
    out, _ = _tool("profile_batch_torch", "--reads", "1000",
                   "--device", "cpu")
    assert out["reads"] == 1000 and out["device"] == "cpu"
    assert set(out["stage_ms"]) == {"parse", "submit", "collect", "assemble"}
    # submit split by the port's spans
    split = out["submit_split_ms"]
    assert set(split) == {"host_stages", "stage", "launch", "rest"}
    assert split["launch"] > 0 and split["stage"] > 0
    assert split["host_stages"] == 0
    # the parts sum to submit's time
    assert sum(split.values()) == pytest.approx(out["stage_ms"]["submit"])
    # collect's wait on the card: none on the CPU
    collect = out["collect_split_ms"]
    assert collect["result_wait"] == 0
    assert sum(collect.values()) == pytest.approx(out["stage_ms"]["collect"])
    assert out["pipelined_reads_per_sec"] > 0
    # the profiled pass: on the CPU it records no device time
    assert out["profiler"]["seconds"] > 0
    assert out["profiler"]["device_ms"] == 0
    assert out["profiler"]["kernel_ms"] == 0
    assert out["profiler"]["by_name"] == []


def test_profile_xfer_times_every_size():
    out, _ = _tool("profile_xfer_torch", "--max-bytes", str(1 << 16),
                   "--reps", "2", "--device", "cpu")
    assert [c["bytes"] for c in out["copies"]] == [1 << 10, 1 << 16]
    assert all(c["h2d_ms"] > 0 and c["d2h_ms"] > 0 for c in out["copies"])
    assert out["result_fetch_round_trip_ms"] > 0


def test_kernel_bench_takes_the_engines_lane_and_width():
    out, _ = _tool("kernel_bench_torch", "256", "2", "2", "--device", "cpu")
    # the flagship task's 2-bit lane at the engine's CPU width (128
    # columns, 4 per byte), not fixed in the tool
    assert out["lane"] == "pack2" and out["row_bytes"] == 32
    assert len(out["passes"]) == 2
    assert all(p["rows_per_sec"] > 0 for p in out["passes"])


def test_fuzz_parity_draws_the_dispatch_modes(monkeypatch):
    """A seed that draws the JAX tool's DEVICE_PREFILTER=1 runs the
    port's device-side prefilter on the engine run (and never on the
    host run), with the SHARED_UPLOAD of the tool's second generator."""
    import importlib.util

    import cutadapt_tpu_torch.batch_pipeline as bp

    spec = importlib.util.spec_from_file_location(
        "fuzz_parity_torch", os.path.join(REPO, "tools",
                                          "fuzz_parity_torch.py"))
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    seed = next(s for s in range(2000, 2100)
                if fuzz.draw(s)[4]["CUTADAPT_TPU_TORCH_DEVICE_PREFILTER"]
                == "1")
    knobs = fuzz.draw(seed)[4]
    # the JAX tool's draws, in its order (tools/fuzz_parity.py:158-167),
    # leave its generator where this tool's is left
    rng = random.Random(seed)
    if rng.random() < 0.45:
        rng.random()
    rng.random()
    for choices in (["0", "1"], ["0", "1"], ["1", "2", "3"], ["0", "1"],
                    ["0", "0", "1"], ["", "3000", "12000"]):
        rng.choice(choices)
    assert fuzz.draw(seed)[0].getstate() == rng.getstate()
    seen = []
    real = bp._device_prefilter_on

    def spy():
        seen.append((os.environ.get("CUTADAPT_TPU_TORCH_BATCH"),
                     os.environ.get("CUTADAPT_TPU_TORCH_SHARED_UPLOAD")))
        return real()

    monkeypatch.setattr(bp, "_device_prefilter_on", spy)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    for key in fuzz.KNOBS + ("CUTADAPT_TPU_TORCH_BATCH",):
        monkeypatch.delenv(key, raising=False)
    with fx.one_torch_thread():
        assert fuzz.main_fuzz(["1", str(seed), "--device", "cpu"]) == 0
    assert seen and set(seen) == {
        ("1", knobs["CUTADAPT_TPU_TORCH_SHARED_UPLOAD"])}


def _trace_cell():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import trace_cell_torch
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return trace_cell_torch


def _span(i, name, stage, start, end, parent=None, chunk=None, cpu=None,
          call=1):
    from cutadapt_tpu_torch.tracing import Span

    s = Span()
    s.id, s.name, s.stage, s.call, s.chunk = i, name, stage, call, chunk
    s.parent, s.start, s.end, s.cpu = parent, start, end, cpu
    return s


def _made_up_call():
    """One call of two chunks on a made-up clock (ns): the reader reads
    and parses, submit waits and submits, emit waits, emits and writes."""
    return [
        _span(0, "call", "caller", 0, 1000),
        _span(1, "engine_setup", "caller", 100, 200, parent=0),
        _span(2, "drive", "caller", 210, 950, parent=0),
        _span(3, "read", "reader", 215, 250, chunk=0),
        _span(4, "parse", "reader", 250, 300, chunk=0),
        _span(5, "queue.parsed", "reader", 300, 320, chunk=0),
        _span(6, "read", "reader", 320, 350, chunk=1),
        _span(7, "parse", "reader", 350, 400, chunk=1),
        _span(8, "queue.parsed", "reader", 400, 600, chunk=1),
        _span(9, "wait.parsed", "submit", 215, 320, parent=2, chunk=0),
        _span(10, "submit", "submit", 320, 600, parent=2, chunk=0, cpu=100),
        _span(11, "stage", "submit", 330, 400, parent=10, chunk=0, cpu=50),
        _span(12, "launch", "submit", 400, 500, parent=10, chunk=0),
        _span(13, "kernel_launch", "submit", 450, 460, parent=12, chunk=0),
        _span(14, "queue.emit", "submit", 600, 610, chunk=0),
        _span(15, "submit", "submit", 610, 800, parent=2, chunk=1, cpu=150),
        _span(16, "queue.emit", "submit", 800, 820, chunk=1),
        _span(17, "wait.emit", "emit", 215, 610, chunk=0),
        _span(18, "emit", "emit", 610, 800, chunk=0, cpu=60),
        _span(19, "result_wait", "emit", 620, 700, parent=18, chunk=0),
        _span(20, "write", "emit", 780, 790, parent=18, chunk=0),
        _span(21, "wait.emit", "emit", 800, 820, chunk=1),
        _span(22, "emit", "emit", 820, 940, chunk=1, cpu=40),
        _span(23, "library", "caller", 110, 150, parent=1),
        _span(24, "stage.alloc", "submit", 340, 350, parent=11, chunk=0),
    ]


def test_trace_cell_readers_on_made_up_spans():
    tc = _trace_cell()
    spans = _made_up_call()
    # the kernel_launch span 450-460 holds its launch record at 455, and
    # the kernel starts at 470
    m = tc.metrics({"port_spans": spans, "reads": 10,
                    "aligner_launches": [(455, 470)],
                    "xfer": {"candidates": 8, "staged_rows": 8}})
    assert m["call_prologue_ms"] == 100 / 1e6
    assert m["engine_setup_ms"] == 100 / 1e6
    assert m["call_epilogue_ms"] == 50 / 1e6
    assert m["read_ns_per_read"] == 6.5
    assert m["submit_queue_ns_per_read"] == 22
    assert m["submit_starved_ns_per_read"] == 10.5
    assert m["submit_cpu_ns_per_read"] == 25
    assert m["stage_ns_per_read"] == 7
    assert m["stage_cpu_ns_per_read"] == 5
    assert m["staged_share"] == 1.0
    assert m["launch_ns_per_read"] == 10
    assert m["emit_queue_ns_per_read"] == 3
    assert m["emit_cpu_ns_per_read"] == 10
    assert m["result_wait_ns_per_read"] == 8
    assert m["write_ns_per_read"] == 1
    assert m["launch_to_kernel_us"] == 0.02
    # nothing recorded, nothing read
    for absent in ("host_stages_ns_per_read", "assemble_ns_per_read"):
        assert absent not in m
    # the arena allocated in the call's first chunk only; a counter-less
    # program reads no share
    assert tc.arena_allocs(spans, {"pinned_allocs": 2}, calls=1) == {
        "after_first_chunk": 0, "per_call": 2}
    late = spans + [_span(30, "stage.alloc", "submit", 620, 630, parent=15,
                          chunk=1)]
    assert tc.arena_allocs(late, {}, calls=1) == {"after_first_chunk": 1}
    assert tc.staged_share({"xfer": {"candidates": 8}}) is None
    assert m["wall_ns_per_read"]["submit"] == 47
    assert m["cpu_ns_per_read"] == {"read": 0, "parse": 0, "submit": 25,
                                    "emit": 10}
    empty = {"wall_ns_per_read": dict.fromkeys(tc.WALL, 0),
             "cpu_ns_per_read": dict.fromkeys(tc.CPU, 0)}
    assert tc.metrics({"port_spans": [], "reads": 10}) == empty
    # a program without the tracer: no spans in the context, no metric
    assert tc.metrics({"reads": 10}) == empty
    for name, read in tc.READERS.items():
        assert read({"reads": 10}) is None, name


LINKED_READERS = {"linked_front_ns_per_read", "linked_back_ns_per_read",
                  "linked_back_cpu_ns_per_read",
                  "linked_back_wait_ns_per_read", "linked_ready_share"}


def test_trace_cell_linked_readers_on_made_up_spans():
    """The linked phases of a made-up call on the engine's worker: the 5'
    fetch and the 3' phase of each of its two chunks, the 3' phase
    holding a staged pass, a launch and a result wait; emit's wait for
    each chunk's 3' results."""
    tc = _trace_cell()
    spans = _made_up_call() + [
        _span(40, "linked_front", "linked", 505, 515, chunk=0),
        _span(41, "linked_back", "linked", 520, 640, chunk=0, cpu=70),
        _span(42, "stage", "linked", 525, 545, parent=41, chunk=0, cpu=20),
        _span(43, "launch", "linked", 545, 580, parent=41, chunk=0),
        _span(44, "result_wait", "linked", 580, 630, parent=41, chunk=0),
        _span(45, "linked_front", "linked", 805, 810, chunk=1),
        _span(46, "linked_back", "linked", 810, 850, chunk=1, cpu=30),
        _span(47, "linked_wait", "emit", 615, 640, parent=18, chunk=0),
        _span(48, "linked_wait", "emit", 825, 850, parent=22, chunk=1),
    ]
    m = tc.metrics({"port_spans": spans, "reads": 10,
                    "xfer": {"linked_back_ready": 1}})
    assert m["linked_front_ns_per_read"] == 1.5
    assert m["linked_back_ns_per_read"] == 16
    assert m["linked_back_cpu_ns_per_read"] == 10
    assert m["linked_back_wait_ns_per_read"] == 5
    # one of the two 3' phases was done when collect asked
    assert m["linked_ready_share"] == 0.5
    assert tc.linked_ready_share({"port_spans": spans, "xfer": {}}) is None
    # the 3' phase's stage and launch count in their own readers too
    assert m["stage_ns_per_read"] == 9 and m["launch_ns_per_read"] == 13.5
    # the worker is a thread of its own: its cover (idle between jobs),
    # the stretch between its jobs, its span in an idle gap of the card
    cover = tc.thread_cover(spans)
    assert cover["linked"] == 175 / 345 and cover["emit"] == 1.0
    assert tc.cover_gaps(spans)["linked: linked_back -> linked_front"] == [
        165]
    c = tc.checks(spans, [(0, 1000)], busy=[(455, 700)], kernel_starts=[470],
                  aligner_launches=[(455, 470)])
    assert c["thread_cover_min"]["linked"] == 175 / 345
    # the card idle while the worker runs chunk 0's 3' phase
    gaps = tc.idle_gaps_by_thread(spans, busy=[(0, 520), (640, 1000)],
                                  lo=0, hi=1000, top=1)
    assert gaps == [{"s": 120 / 1e9, "reader": "queue.parsed",
                     "main": "submit", "emit": "wait.emit",
                     "linked": "linked_back"}]
    # a call without a linked task reads none of them
    plain = tc.metrics({"port_spans": _made_up_call(), "reads": 10})
    assert not LINKED_READERS & set(plain)
    for name in LINKED_READERS:
        assert tc.READERS[name]({"reads": 10}) is None


def test_trace_cell_clock_and_cover_checks():
    tc = _trace_cell()
    spans = _made_up_call()
    assert tc.launch_pairs(spans, [(455, 470)]) == [(450, 455, 470)]
    # launch records outside every span are not paired
    assert tc.launch_pairs(spans, [(300, 310), (455, 470), (900, 905)]) == [
        (450, 455, 470)]
    # a span with no record, or two, pairs nothing
    assert tc.launch_pairs(spans, [(470, 480)]) is None
    assert tc.launch_pairs(spans, [(452, 470), (458, 475)]) is None
    assert tc.launch_to_kernel_us({"port_spans": spans,
                                   "aligner_launches": []}) is None
    # a long result_wait meets the card, and ends soon after it went idle
    wait = _span(30, "result_wait", "emit", 1000, 301_000)

    def faults(busy):
        return {k: len(v) for k, v in tc.wait_faults([wait], busy).items()}

    assert faults([(150_000, 160_000)]) == {"no_device": 0, "late": 1}
    assert faults([(250_000, 260_000)]) == {"no_device": 0, "late": 0}
    assert faults([(0, 2000), (250_000, 300_000)]) == {"no_device": 0,
                                                       "late": 0}
    assert faults([(0, 400_000)]) == {"no_device": 0, "late": 0}
    assert faults([(0, 100), (301_500, 301_600)]) == {"no_device": 1,
                                                      "late": 0}
    assert faults([]) == {"no_device": 1, "late": 0}
    short = _span(31, "result_wait", "emit", 0, 100_000)
    assert tc.wait_faults([short], []) == {"no_device": [], "late": []}
    cover = tc.thread_cover(spans)
    assert cover == {"reader": 1.0, "submit": 1.0, "emit": 1.0}
    parts = tc.call_parts(spans)
    assert parts["untraced"] == 10 / 1e6 and parts["epilogue"] == 50 / 1e6
    # engine set-up by its parts
    assert parts["engine_setup.library"] == 40 / 1e6
    assert parts["engine_setup.warmup"] == 0
    c = tc.checks(spans, [(0, 1000)], busy=[(455, 700)], kernel_starts=[470],
                  aligner_launches=[(455, 470)])
    assert c["kernel_launch_spans"] == c["locate_kernels"] == 1
    assert c["launch_lags_us"]["span_to_kernel"] == {
        "min": 0.02, "median": 0.02, "negative": 0}
    assert c["call_parts_ms_mean"]["engine_setup.library"] == 40 / 1e6
    assert c["call_over_harness"] == [1.0, 1.0]
    assert c["untraced_share_max"] == 0.01


def test_trace_cell_names_each_threads_span_in_idle_gaps():
    tc = _trace_cell()
    spans = _made_up_call()
    gaps = tc.idle_gaps_by_thread(spans, busy=[(455, 700)], lo=0, hi=1000,
                                  top=2)
    # the longest: 0-455, then 700-1000
    assert gaps[0] == {"s": 455 / 1e9, "reader": "none", "main": "drive",
                       "emit": "wait.emit", "linked": "none"}
    assert gaps[1] == {"s": 300 / 1e9, "reader": "none",
                       "main": "drive", "emit": "none", "linked": "none"}
    # over 320-600 the submit thread is in submit, the reader blocked on
    # a full queue, the emit thread waiting
    assert tc.innermost(spans, ("caller", "submit"), 320, 600) == "submit"
    assert tc.innermost(spans, ("reader",), 420, 600) == "queue.parsed"
    assert tc.innermost(spans, ("emit",), 320, 600) == "wait.emit"


@pytest.mark.parametrize("cell", ["se_truseq.bulk", "pe_truseq_q20.bulk"])
def test_trace_cell_runs_the_harness_with_the_tracer(cell):
    out, _ = _tool("trace_cell_torch", "--workload", cell, "--seed",
                   "2147483659", "--seconds", "0.5", "--reads", "600",
                   "--cost", "1", "--device", "cpu")
    assert out["device"] == "cpu" and out["result"]["correct"]
    m = out["metrics"]
    # no trace on the CPU: no launch_to_kernel_us
    want = set(_trace_cell().READERS) - {"result_wait_ns_per_read",
                                         "launch_to_kernel_us"}
    if cell.startswith("se_"):
        want.discard("host_stages_ns_per_read")
    # the TruSeq cells have no linked adapter, so no linked spans
    want -= LINKED_READERS
    assert want <= set(m)
    c = out["checks"]
    # every plain run of the aligner is a kernel_launch; no trace on the CPU
    assert c["kernel_launch_spans"] > 0 and c["locate_kernels"] == 0
    assert min(c["thread_cover_min"].values()) >= 0.95
    assert c["untraced_share_max"] < 0.05
    assert c["uncovered"] and abs(c["clock_offset_drift_us"]) < 1e5
    lo, hi = c["call_over_harness"]
    assert 0.9 < lo <= hi <= 1.0
    # every candidate through the staged pass; the arena allocated in
    # each call's first chunk only
    assert m["staged_share"] == 1.0
    assert c["arena_allocs"]["after_first_chunk"] == 0
    assert c["arena_allocs"]["per_call"] >= 1
    cost = out["cost"]
    assert cost["pairs"] == 1 and len(cost["call_s"]["on"]) == 1


def test_trace_cell_holds_spans_to_the_profilers_launch_records():
    tc = _trace_cell()
    spans = _made_up_call()  # one kernel_launch, at 450
    # the launch record 5 ns into the span, its kernel 30 ns later
    pairs = tc.launch_pairs(spans, [(455, 485)])
    assert tc.launch_lags(pairs) == {
        "span_to_record": {"min": 0.005, "median": 0.005, "negative": 0},
        "record_to_kernel": {"min": 0.03, "median": 0.03, "negative": 0},
        "span_to_kernel": {"min": 0.035, "median": 0.035, "negative": 0}}
    # a kernel stamped before its own launch record, and before the span
    lags = tc.launch_lags(tc.launch_pairs(spans, [(455, 440)]))
    assert lags["record_to_kernel"]["negative"] == 1
    assert lags["span_to_kernel"] == {"min": -0.01, "median": -0.01,
                                      "negative": 1}
    c = tc.checks(spans, [(0, 1000)], busy=[], kernel_starts=[470],
                  aligner_launches=[(470, 480)])
    assert c["launch_lags_us"] is None
    # the stretches no top-level span covers, by the spans either side
    gappy = spans + [_span(40, "emit", "emit", 960, 980, chunk=2),
                     _span(41, "emit", "emit", 990, 995, chunk=3)]
    assert tc.cover_gaps(gappy) == {"emit: emit -> emit": [20, 10]}
    stats = tc.gap_stats(tc.cover_gaps(gappy), calls=2)
    assert stats["emit: emit -> emit"] == {
        "n": 2, "median_ms": 15 / 1e6, "p95_ms": 19.5 / 1e6,
        "max_ms": 20 / 1e6, "ms_per_call": 15 / 1e6}
