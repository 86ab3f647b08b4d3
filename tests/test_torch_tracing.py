"""
The port's tracer (``cutadapt_tpu_torch.tracing``) through ``cli.main``
on the CPU (the plain aligner):

- off, a call records nothing, reads no clock, and a span site
  allocates nothing;
- on, single-end and paired calls give per-thread trees that nest, each
  chunk's spans on all three drive threads under one chunk number,
  queue and wait spans of 0 ns or more, one ``kernel_launch`` per plain
  run of the aligner, and one ``call`` per call that encloses its
  ``engine_setup`` and ``drive``;
- the times are on the wall clock and the stage spans carry CPU time.
"""

import time
import tracemalloc

import pytest

from cutadapt_tpu_torch import cli, tracing
from cutadapt_tpu_torch.ops import align_cuda
from torch_fixtures import ADAPTER, make_dataset, make_pairs, one_torch_thread

ADAPTER2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
# small chunks: several in flight on every thread
CHUNK_BYTES = "20000"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture
def port(monkeypatch, tmp_path):
    """Engine runs on the CPU in small chunks; the tracer left off."""
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", CHUNK_BYTES)
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_DEVICES", raising=False)
    yield tmp_path
    tracing.disable()


def single_args(d) -> list:
    (d / "in.fastq").write_bytes(make_dataset(600))
    return ["--quiet", "-a", ADAPTER, "-o", str(d / "out.fastq"),
            str(d / "in.fastq")]


def paired_args(d) -> list:
    r1, r2 = make_pairs(400)
    (d / "in.1.fastq").write_bytes(r1)
    (d / "in.2.fastq").write_bytes(r2)
    return ["--quiet", "-a", ADAPTER, "-A", ADAPTER2, "-q", "20", "-m", "20",
            "-o", str(d / "out.1.fastq"), "-p", str(d / "out.2.fastq"),
            str(d / "in.1.fastq"), str(d / "in.2.fastq")]


ARGS = {"single": single_args, "paired": paired_args}


def plain_runs() -> int:
    return sum(align_cuda.PLAIN_RUNS.values())


class NoClock:
    """Stands in for the time module: any clock read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"the tracer read time.{name} while off")


def test_off_records_nothing_and_reads_no_clock(port, monkeypatch):
    monkeypatch.setattr(tracing, "time", NoClock())
    cli.main(single_args(port))
    assert not tracing.enabled()
    assert tracing.disable() == []


def _peak_bytes(loop) -> int:
    """The most memory traced while ``loop`` ran, beyond what was
    traced before it."""
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop()
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_off_span_site_allocates_nothing():
    assert not tracing.enabled()

    def bare():
        for _ in range(10000):
            span = None
        assert span is None

    def sites():
        for _ in range(10000):
            span = tracing.begin("prefilter")
            tracing.end(span)
            tracing.set_chunk(3)
        assert span is None

    # the loop's own allocation, and not one more byte
    assert _peak_bytes(sites) <= _peak_bytes(bare)


@pytest.fixture(params=sorted(ARGS))
def traced(request, port):
    """Two calls of one layout with the tracer on: (records, plain runs
    of the aligner in those calls, the wall clock around them)."""
    args = ARGS[request.param](port)
    runs = plain_runs()
    lo = time.time_ns()
    tracing.enable()
    cli.main(args)
    cli.main(args)
    records = tracing.disable()
    hi = time.time_ns()
    return request.param, records, plain_runs() - runs, lo, hi


def test_spans_nest_per_thread(traced):
    _, records, _, lo, hi = traced
    by_id = {s.id: s for s in records}
    assert all(s.end is not None and lo <= s.start <= s.end <= hi
               for s in records)
    for s in records:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        # on the same thread: the main thread is the caller's and submit's
        assert (s.stage == parent.stage
                or {s.stage, parent.stage} <= {"caller", "submit"})
        assert parent.start <= s.start and s.end <= parent.end
        assert s.call == parent.call
    crossing = [s for s in records if s.name.startswith("queue.")]
    assert crossing and all(s.parent is None for s in crossing)
    assert not any(s.parent in {q.id for q in crossing} for s in records)


def test_every_chunk_on_every_thread(traced):
    layout, records, _, _, _ = traced
    for call in (1, 2):
        chunks = {name: {s.chunk for s in records
                         if s.call == call and s.name == name}
                  for name in ("read", "parse", "submit", "emit",
                               "queue.parsed", "queue.emit")}
        n = len(chunks["parse"])
        assert n > 2  # several chunks
        assert chunks["parse"] == set(range(n))
        for name in ("submit", "emit", "queue.parsed", "queue.emit"):
            assert chunks[name] == chunks["parse"], name
        # the last read finds the end of the file
        assert chunks["read"] >= chunks["parse"]
        stages = {name: {s.stage for s in records
                         if s.call == call and s.name == name}
                  for name in ("read", "parse", "submit", "emit", "drive",
                               "engine_setup", "wait.parsed", "wait.emit")}
        assert stages == {"read": {"reader"}, "parse": {"reader"},
                          "submit": {"submit"}, "emit": {"emit"},
                          "drive": {"caller"}, "engine_setup": {"caller"},
                          "wait.parsed": {"submit"}, "wait.emit": {"emit"}}
    if layout == "paired":  # -q 20: the host stages before the adapters
        assert any(s.name == "host_stages" for s in records)
    else:
        assert not any(s.name == "host_stages" for s in records)


def test_queue_and_wait_spans(traced):
    _, records, _, _, _ = traced
    for name in ("queue.parsed", "queue.emit", "wait.parsed", "wait.emit"):
        spans = [s for s in records if s.name == name]
        assert spans and all(s.end - s.start >= 0 for s in spans), name


def test_one_kernel_launch_per_plain_run(traced):
    _, records, runs, _, _ = traced
    launches = [s for s in records if s.name == "kernel_launch"]
    assert runs > 0 and len(launches) == runs
    by_id = {s.id: s for s in records}
    assert all(by_id[s.parent].name == "launch" for s in launches)
    assert any(s.name == "stage" for s in records)
    for s in records:
        if s.name in ("stage", "launch", "host_stages"):
            assert by_id[s.parent].name == "submit"
        if s.name == "stage.alloc":
            assert by_id[s.parent].name == "stage"
        if s.name in ("assemble", "write"):
            assert by_id[s.parent].name == "emit"


def test_call_encloses_setup_and_drive(traced):
    _, records, _, _, _ = traced
    calls = [s for s in records if s.name == "call"]
    assert [s.call for s in calls] == [1, 2]
    by_id = {s.id: s for s in records}
    for call in calls:
        own = [s for s in records if s.call == call.call]
        assert all(call.start <= s.start and s.end <= call.end for s in own)
        for name in ("engine_setup", "drive"):
            (span,) = [s for s in own if s.name == name]
            assert by_id[span.parent] is call
        (setup,) = [s for s in own if s.name == "engine_setup"]
        children = {s.name for s in own if s.parent == setup.id}
        # no warm-up on the CPU: the plain aligner compiles nothing
        assert children == {"library", "engines", "reducer"}


def test_stage_spans_carry_cpu_time(traced):
    _, records, _, _, _ = traced
    for s in records:
        if s.name in ("read", "parse", "submit", "emit", "stage"):
            assert s.cpu is not None and s.cpu >= 0
        elif s.name in ("launch", "queue.parsed", "call", "write"):
            assert s.cpu is None


def test_enable_starts_afresh():
    tracing.enable()
    span = tracing.begin("x")
    first = tracing.disable()
    tracing.end(span)  # after disable: stays open in what was handed out
    assert [s.name for s in first] == ["x"] and first[0].end is None
    tracing.enable()
    inner = tracing.begin("y")
    tracing.end(inner)
    again = tracing.disable()
    assert [(s.name, s.parent) for s in again] == [("y", None)]
