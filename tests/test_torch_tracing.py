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
- the times are on the wall clock and the stage spans carry CPU time;
- a linked run records the fetch of its 5' results and its 3' phase on
  the engine's worker (the stage ``linked``), once per chunk, and emit's
  wait for them; a later round's 3' phase runs in emit; the linked XFER
  counters count, and stay 0 on a run without a linked adapter, which
  starts no thread beyond the drive's.
"""

import concurrent.futures
import threading
import time
import tracemalloc

import pytest

from cutadapt_tpu_torch import cli, tracing
from cutadapt_tpu_torch.batch_pipeline import (
    BatchPipelineEngine, xfer_counters,
)
from cutadapt_tpu_torch.ops import align_cuda
from torch_fixtures import (
    ADAPTER, LINKED_PRIMERS, make_amplicons, make_dataset, make_pairs,
    one_torch_thread,
)

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


def linked_args(d, *extra) -> list:
    (d / "amp.fastq").write_bytes(make_amplicons(300))
    return ["--quiet", "-a", LINKED_PRIMERS, "--discard-untrimmed", *extra,
            "-o", str(d / "out.fastq"), str(d / "amp.fastq")]


ARGS = {"single": single_args, "paired": paired_args}
LINKED = ("linked_front_rows", "linked_back_windows", "linked_back_rows",
          "linked_back_ns", "linked_back_wait_ns", "linked_back_ready")


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


def _counted(args) -> tuple:
    """One call with the tracer on: (records, the linked XFER counters'
    growth over it)."""
    before = xfer_counters()
    tracing.enable()
    cli.main(args)
    records = tracing.disable()
    after = xfer_counters()
    return records, {k: after[k] - before[k] for k in LINKED}


@pytest.fixture
def worker_ahead(monkeypatch):
    """collect waits until the linked worker has finished the chunk's 3'
    phases before it asks for them, so that each is ready."""
    collect = BatchPipelineEngine.collect

    def waiting(self, pending):
        concurrent.futures.wait([d[4] for d in pending.dp_futures or ()
                                 if d[0] == "linked" and d[4] is not None])
        return collect(self, pending)

    monkeypatch.setattr(BatchPipelineEngine, "collect", waiting)


def _linked_threads(before) -> list:
    """The live linked workers that were not alive at ``before`` (a set
    of threads): those an engine of the test left running."""
    return [t for t in threading.enumerate()
            if t.name.startswith("linked") and t not in before]


def test_linked_phases_on_the_emit_thread(port, worker_ahead):
    """Each chunk of a linked run: the 5' results fetched and the 3' phase
    run on the engine's worker (the stage ``linked``), once per chunk and
    under its number, the 3' phase's staged pass and launch inside it;
    emit waits for each in ``linked_wait``. A second round (``-n 2``),
    dispatched in collect, runs its 3' phase on the emit thread. The
    counters count the rows, the time and the phases that were ready."""
    before = set(threading.enumerate())
    records, grown = _counted(linked_args(port))
    by_id = {s.id: s for s in records}
    emits = [s for s in records if s.name == "emit"]
    for name in ("linked_front", "linked_back"):
        spans = [s for s in records if s.name == name]
        assert len(spans) == len(emits) > 2, name
        assert all(s.stage == "linked" and s.parent is None for s in spans)
        assert sorted(s.chunk for s in spans) == sorted(
            s.chunk for s in emits)
    waits = [s for s in records if s.name == "linked_wait"]
    assert len(waits) == len(emits)
    assert all(s.stage == "emit" and by_id[s.parent].name == "emit"
               for s in waits)
    backs = {s.id for s in records if s.name == "linked_back"}
    inside = {s.name for s in records if s.parent in backs}
    assert {"stage", "launch"} <= inside
    assert all(s.cpu is not None and s.cpu >= 0 for s in records
               if s.name == "linked_back")
    # the 5' phase still stages and launches from submit
    assert any(s.name == "launch" and by_id[s.parent].name == "submit"
               for s in records)
    # about 95% of the reads carry the 5' primer, and all of them the 3'
    assert 0 < grown["linked_back_rows"] <= grown["linked_back_windows"]
    assert grown["linked_back_windows"] <= grown["linked_front_rows"] <= 300
    assert grown["linked_back_windows"] >= 250
    # the counters' two clock reads enclose the spans'
    span_ns = sum(s.end - s.start for s in records if s.name == "linked_back")
    assert grown["linked_back_ns"] >= span_ns > 0
    assert grown["linked_back_wait_ns"] >= sum(s.end - s.start for s in waits)
    assert grown["linked_back_ready"] == len(emits)
    assert not _linked_threads(before)

    records, grown = _counted(linked_args(port, "-n", "2"))
    by_id = {s.id: s for s in records}
    emits = [s for s in records if s.name == "emit"]
    phases = [s for s in records if s.name == "linked_back"]
    inline = [s for s in phases if s.stage == "emit"]
    # each chunk's second round, inside its emit
    assert len(inline) == len(emits)
    assert all(by_id[s.parent].name == "emit" for s in inline)
    assert grown["linked_back_ready"] + len(inline) == len(phases)
    assert not _linked_threads(before)


def test_linked_counters_stay_zero_without_a_linked_task(port, monkeypatch):
    started = []
    start = threading.Thread.start

    def counted(thread):
        started.append(thread.name)
        return start(thread)

    monkeypatch.setattr(threading.Thread, "start", counted)
    records, grown = _counted(single_args(port))
    assert grown == dict.fromkeys(LINKED, 0)
    assert not any(s.name.startswith("linked") for s in records)
    # the drive's reader and writer, and no worker
    assert len(started) == 2, started
    assert not any(name.startswith("linked") for name in started)
