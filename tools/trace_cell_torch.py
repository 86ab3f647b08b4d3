#!/usr/bin/env python3
"""The port's own spans (cutadapt_tpu_torch/tracing.py) on one cell of
BENCHMARK.json: per-layer metrics, checks of what the spans account for,
and the cost of the tracer.

    python3 tools/trace_cell_torch.py --workload <cell> --seed <n> \\
        --seconds <s> [--cost PAIRS] [--device cpu --reads N]

Runs the benchmark's traced run (``benchmark/run.py:run`` with
``trace=True``: its set-up, its window under torch.profiler and its
judge of ``correct``) with the tracer enabled for the window, from its
first call to its last, and reduces the spans of the window's calls:

- ``metrics``: the per-layer metrics of :data:`READERS`, each a
  ``read(ctx)`` of the harness's reader context with the port's spans
  added under ``ctx["port_spans"]`` and each aligner launch of the
  trace under ``ctx["aligner_launches"]`` (per read over the window's
  good calls' reads, a pair one read, as the harness's own readers
  count), and the harness's own result line (``result``);
- ``checks``: the count of ``kernel_launch`` spans against the aligner's
  kernels in the window; each span paired with the profiler's own
  ``cudaLaunchKernel`` record inside it on the host clock, and that
  record with its kernel by correlation id (:func:`launch_pairs`), with
  the lags of each leg (``launch_lags_us``); the drift of the offset
  from ``perf_counter_ns`` to ``time_ns`` over the window; the
  ``result_wait`` spans over 100 us that overlap no device activity or
  end over 100 us after it (:func:`wait_faults`); each stage thread's
  cover by its top-level, ``wait.*`` and ``queue.*`` spans, and the
  stretches between them by the spans either side (count, median, 95th
  percentile, longest, per call); each ``call`` against the harness's
  time of the call; a call by part, engine set-up by its parts; the
  stretch of a call that no part covers; and the staging arena's
  allocations (:func:`arena_allocs`);
- ``idle_gaps_by_thread``: the ten longest stretches with nothing on
  the card, each with the innermost span open over most of it on the
  reader, main (caller and submit) and emit threads.

``--cost PAIRS`` then calls main on the cell's file PAIRS times with the
tracer on and off in turns (alternating which goes first), outside the
profiler, each engine submit timed on the host clock both ways: the
tracer's cost as a share of reads/s and in ns per read of submit; and
the host time of one span opened and closed with the tracer on, times
the spans of a call, over the call's time.

Prints a last line ``trace_cell_torch {...}``. On CUDA unless ``--device cpu``
(the plain aligner, a small file; no trace, so no device numbers).
"""

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the stage threads of the drive, and the stages their spans carry
THREADS = {"reader": ("reader",), "main": ("caller", "submit"),
           "emit": ("emit",)}
# a result_wait this long must meet device activity
RESULT_WAIT_NS = 100_000
# the parts of engine_setup
SETUP_PARTS = ("library", "engines", "warmup", "reducer")


def _sum_ns(spans, name, field="dur"):
    if field == "cpu":
        return sum(s.cpu or 0 for s in spans if s.name == name)
    return sum(s.end - s.start for s in spans if s.name == name)


def _per_read(name, field="dur"):
    def read(ctx):
        spans, reads = ctx.get("port_spans"), ctx["reads"]
        if not spans or not reads or not any(s.name == name for s in spans):
            return None
        return _sum_ns(spans, name, field) / reads
    return read


def _mean_ms(between):
    def read(ctx):
        ms = [between(parts) for parts in
              by_call(ctx.get("port_spans") or ()).values()]
        ms = [m / 1e6 for m in ms if m is not None]
        return sum(ms) / len(ms) if ms else None
    return read


def _first(parts, name):
    return next((s for s in parts if s.name == name), None)


def _prologue(parts):
    call, setup = _first(parts, "call"), _first(parts, "engine_setup")
    return setup.start - call.start if call and setup else None


def _setup(parts):
    setup = _first(parts, "engine_setup")
    return setup.end - setup.start if setup else None


def _epilogue(parts):
    call, drive = _first(parts, "call"), _first(parts, "drive")
    return call.end - drive.end if call and drive else None


def launch_pairs(spans, aligner_launches):
    """Each ``kernel_launch`` span, in order, with the one aligner launch
    record of the profiler whose host start lies inside it, as (span
    start, record start, kernel start) in ns; ``aligner_launches`` holds
    (record start, kernel start) per aligner kernel, the two matched by
    correlation id. None where a span holds no such record or several."""
    launches = sorted(aligner_launches)
    starts = [r for r, _ in launches]
    out = []
    for s in sorted((s for s in spans if s.name == "kernel_launch"),
                    key=lambda s: s.start):
        i = bisect.bisect_left(starts, s.start)
        if bisect.bisect_right(starts, s.end) != i + 1:
            return None
        out.append((s.start, *launches[i]))
    return out


def launch_to_kernel_us(ctx):
    """The median over the window's aligner launches of the kernel's start
    in the trace less its ``kernel_launch`` span's start, in us."""
    pairs = launch_pairs(ctx.get("port_spans") or (),
                         ctx.get("aligner_launches") or ())
    if not pairs:
        return None
    return statistics.median(k - s for s, _, k in pairs) / 1e3


def staged_share(ctx):
    """The share of the window's candidates (``XFER["candidates"]``) that
    went through submit's staged pass (``XFER["staged_rows"]``); None
    where the program has no such counter."""
    xfer = ctx.get("xfer") or {}
    if "staged_rows" not in xfer or not xfer.get("candidates"):
        return None
    return xfer["staged_rows"] / xfer["candidates"]


def arena_allocs(spans, xfer, calls) -> dict:
    """The staging arena's allocations: per call (``XFER["pinned_allocs"]``
    over the window's calls), and the ``stage.alloc`` spans of a chunk
    after a call's first (chunk numbers start at 0 on each of its
    threads)."""
    out = {"after_first_chunk": sum(s.name == "stage.alloc" and bool(s.chunk)
                                    for s in spans)}
    if "pinned_allocs" in xfer and calls:
        out["per_call"] = xfer["pinned_allocs"] / calls
    return out


# metric name -> read(ctx), as a benchmark/metrics/<name>.py would hold it
READERS = {
    "call_prologue_ms": _mean_ms(_prologue),
    "engine_setup_ms": _mean_ms(_setup),
    "call_epilogue_ms": _mean_ms(_epilogue),
    "read_ns_per_read": _per_read("read"),
    "submit_queue_ns_per_read": _per_read("queue.parsed"),
    "submit_starved_ns_per_read": _per_read("wait.parsed"),
    "submit_cpu_ns_per_read": _per_read("submit", "cpu"),
    "host_stages_ns_per_read": _per_read("host_stages"),
    "stage_ns_per_read": _per_read("stage"),
    "stage_cpu_ns_per_read": _per_read("stage", "cpu"),
    "staged_share": staged_share,
    "launch_ns_per_read": _per_read("launch"),
    "launch_to_kernel_us": launch_to_kernel_us,
    "emit_queue_ns_per_read": _per_read("queue.emit"),
    "emit_cpu_ns_per_read": _per_read("emit", "cpu"),
    "result_wait_ns_per_read": _per_read("result_wait"),
    "assemble_ns_per_read": _per_read("assemble"),
    "write_ns_per_read": _per_read("write"),
}
# beside them, the wall and CPU time of the stage spans
WALL = ("read", "parse", "submit", "emit", "wait.emit")
CPU = ("read", "parse", "submit", "emit")


def by_call(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.call, []).append(s)
    return out


def metrics(ctx) -> dict:
    """The per-layer metrics of ``ctx``, and the stage spans' wall and CPU
    time per read (``wall_ns_per_read``, ``cpu_ns_per_read``)."""
    out = {}
    for name, read in READERS.items():
        value = read(ctx)
        if value is not None:
            out[name] = value
    spans, reads = ctx.get("port_spans") or (), ctx["reads"]
    if reads:
        out["wall_ns_per_read"] = {n: _sum_ns(spans, n) / reads
                                   for n in WALL}
        out["cpu_ns_per_read"] = {n: _sum_ns(spans, n, "cpu") / reads
                                  for n in CPU}
    return out


def _lag_stats(lags) -> dict:
    return {"min": min(lags) / 1e3, "median": statistics.median(lags) / 1e3,
            "negative": sum(lag < 0 for lag in lags)}


def launch_lags(pairs) -> dict:
    """Min, median and count below 0, in us, of each leg of the launch
    pairs: the span to the profiler's launch record (both on the host
    clock), the record to its kernel (the profiler's host and device
    sides), and the span to the kernel."""
    return {"span_to_record": _lag_stats([r - s for s, r, _ in pairs]),
            "record_to_kernel": _lag_stats([k - r for _, r, k in pairs]),
            "span_to_kernel": _lag_stats([k - s for s, _, k in pairs])}


def wait_faults(spans, busy, slack=RESULT_WAIT_NS) -> dict:
    """The ``result_wait`` spans longer than ``slack`` that overlap no
    busy interval of the card (``no_device``), and those that end more
    than ``slack`` after the last busy interval they overlap (``late``:
    the card went idle and the host still waited)."""
    ends = [e for _, e in busy]
    out = {"no_device": [], "late": []}
    for s in spans:
        if s.name != "result_wait" or s.end - s.start <= slack:
            continue
        last = None
        for b0, b1 in busy[bisect.bisect_right(ends, s.start):]:
            if b0 >= s.end:
                break
            last = b1
        if last is None:
            out["no_device"].append(s)
        elif s.end - last > slack:
            out["late"].append(s)
    return out


def _union_ns(intervals, lo, hi) -> int:
    total, t = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, t), min(e, hi)
        if e > s:
            total += e - s
            t = e
    return total


def _top_level(parts, stage):
    by_id = {s.id: s for s in parts}
    return sorted((s for s in parts if s.stage == stage and (
        s.parent is None or by_id[s.parent].stage != stage)),
        key=lambda s: s.start)


def thread_cover(parts) -> dict:
    """Per stage thread of one call's drive: the share of the thread's
    life in the drive (its first span's start to its last's end) that
    its top-level spans (those whose parent is not on the same thread),
    its ``wait.*`` and its ``queue.*`` spans cover."""
    out = {}
    for stage in ("reader", "submit", "emit"):
        own = [s for s in parts if s.stage == stage]
        if not own:
            continue
        top = [(s.start, s.end) for s in _top_level(parts, stage)]
        lo = min(s.start for s in own)
        hi = max(s.end for s in own)
        out[stage] = _union_ns(top, lo, hi) / (hi - lo) if hi > lo else 1.0
    return out


def cover_gaps(parts) -> dict:
    """The stretches of each stage thread that no top-level span covers,
    each in ns, by the spans before and after them (``stage: before ->
    after``)."""
    out = {}
    for stage in ("reader", "submit", "emit"):
        top = _top_level(parts, stage)
        if not top:
            continue
        t, before = top[0].start, None
        for s in top:
            if s.start > t and before is not None:
                out.setdefault(f"{stage}: {before} -> {s.name}",
                               []).append(s.start - t)
            if s.end > t:
                t, before = s.end, s.name
    return out


def gap_stats(gaps, calls, top=4) -> dict:
    """The ``top`` kinds of stretch of :func:`cover_gaps` over ``calls``
    calls, by their total: count, median, 95th percentile, longest and
    total per call, in ms."""
    out = {}
    for key, ns in sorted(gaps.items(), key=lambda kv: -sum(kv[1]))[:top]:
        p95 = (statistics.quantiles(ns, n=20, method="inclusive")[-1]
               if len(ns) > 1 else ns[0])
        out[key] = {"n": len(ns), "median_ms": statistics.median(ns) / 1e6,
                    "p95_ms": p95 / 1e6, "max_ms": max(ns) / 1e6,
                    "ms_per_call": sum(ns) / 1e6 / calls}
    return out


def call_parts(parts) -> dict:
    """One call's span split by part, in ms: the untraced stretch between
    ``engine_setup`` and ``drive``, and engine set-up by its parts."""
    call = _first(parts, "call")
    setup = _first(parts, "engine_setup")
    drive = _first(parts, "drive")
    out = {"call": (call.end - call.start) / 1e6,
           "prologue": (setup.start - call.start) / 1e6,
           "engine_setup": (setup.end - setup.start) / 1e6,
           "untraced": (drive.start - setup.end) / 1e6,
           "drive": (drive.end - drive.start) / 1e6,
           "epilogue": (call.end - drive.end) / 1e6}
    for name in SETUP_PARTS:
        out["engine_setup." + name] = sum(
            s.end - s.start for s in parts
            if s.name == name and s.parent == setup.id) / 1e6
    return out


def checks(spans, harness_calls, busy, kernel_starts,
           aligner_launches=()) -> dict:
    """What the spans account for (see the module's docstring)."""
    out = {}
    out["kernel_launch_spans"] = sum(s.name == "kernel_launch"
                                     for s in spans)
    out["locate_kernels"] = len(kernel_starts)
    if aligner_launches:
        pairs = launch_pairs(spans, aligner_launches)
        out["launch_lags_us"] = launch_lags(pairs) if pairs else None
    waits = [s for s in spans if s.name == "result_wait"]
    out["result_waits_over_100us"] = sum(
        s.end - s.start > RESULT_WAIT_NS for s in waits)
    out["result_waits_faults"] = {k: len(v) for k, v in
                                  wait_faults(spans, busy).items()}
    calls = [p for _, p in sorted(by_call(spans).items())]
    covers = [thread_cover(p) for p in calls]
    stages = [st for st in ("reader", "submit", "emit")
              if any(st in c for c in covers)]
    out["thread_cover_min"] = {
        st: min(c[st] for c in covers if st in c) for st in stages}
    out["thread_cover_mean"] = {
        st: statistics.fmean(c[st] for c in covers if st in c)
        for st in stages}
    gaps = {}
    for p in calls:
        for key, ns in cover_gaps(p).items():
            gaps.setdefault(key, []).extend(ns)
    out["uncovered"] = gap_stats(gaps, len(calls)) if calls else {}
    split = [call_parts(p) for p in calls]
    out["untraced_share_max"] = max(
        (p["untraced"] / p["call"] for p in split), default=None)
    out["parts_over_call_min"] = min(
        ((p["call"] - p["untraced"]) / p["call"] for p in split),
        default=None)
    if harness_calls and len(harness_calls) == len(split):
        out["call_over_harness"] = [
            min(p["call"] * 1e6 / d for p, (_, d) in zip(split, harness_calls)),
            max(p["call"] * 1e6 / d for p, (_, d) in zip(split, harness_calls))]
    out["call_parts_ms_mean"] = {
        k: statistics.fmean(p[k] for p in split) for k in split[0]
    } if split else {}
    return out


def innermost(spans, stages, g0, g1):
    """The innermost span of ``stages`` open over most of [g0, g1): of
    those covering more than half of it, the one that began last."""
    best = None
    for s in spans:
        if s.stage in stages and 2 * (min(g1, s.end) - max(g0, s.start)) > g1 - g0:
            if best is None or s.start > best.start:
                best = s
    return best.name if best is not None else "none"


def idle_gaps_by_thread(spans, busy, lo, hi, top=10) -> list:
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return [{"s": (g1 - g0) / 1e9,
             **{th: innermost(spans, st, g0, g1)
                for th, st in THREADS.items()}}
            for g0, g1 in gaps[:top]]


def _clock_offset_ns() -> int:
    return time.time_ns() - time.perf_counter_ns()


def traced_run(workload, seed, seconds, device="cuda", reads=None) -> dict:
    """The harness's traced run of the cell with the tracer on over its
    window: the result line, and what the readers read."""
    from benchmark import run as bench
    from benchmark import trace as tr
    from cutadapt_tpu_torch import tracing

    got = {}
    instrumented, reader_context = tr.instrumented, bench._reader_context

    @contextlib.contextmanager
    def traced_window(spans, launches):
        with instrumented(spans, launches):
            got["offset"] = _clock_offset_ns()
            tracing.enable()
            try:
                yield
            finally:
                got["records"] = [s for s in tracing.disable()
                                  if s.end is not None]
                got["offset_drift_ns"] = _clock_offset_ns() - got["offset"]

    def context(good, n_reads, spans, launches, xfer, prof, lo, hi, window):
        ctx = reader_context(good, n_reads, spans, launches, xfer, prof,
                             lo, hi, window)
        ctx["port_spans"] = got["records"]
        got.update(ctx=ctx, harness_calls=list(spans.calls), lo=lo, hi=hi,
                   events=tr.device_events(prof) if prof is not None else [])
        if prof is not None:
            from torch.autograd import DeviceType

            events = prof.profiler.kineto_results.events()
            records = {e.correlation_id(): e.start_ns() for e in events
                       if e.device_type() == DeviceType.CPU
                       and e.name() == "cudaLaunchKernel"}
            ctx["aligner_launches"] = [
                (records[e.correlation_id()], e.start_ns())
                for e in events if e.device_type() == DeviceType.CUDA
                and tr.ALIGN_KERNEL in e.name()
                and e.correlation_id() in records]
        return ctx

    tr.instrumented, bench._reader_context = traced_window, context
    try:
        result = bench.run(workload, seed, seconds, True, device=device,
                           reads=reads)
    finally:
        tr.instrumented, bench._reader_context = instrumented, reader_context
    ctx, records = got["ctx"], got["records"]
    lo, hi = got["lo"], got["hi"]
    kernels = [s for name, s, _ in got["events"]
               if tr.ALIGN_KERNEL in name and lo <= s < hi]
    busy = tr.busy_intervals(got["events"], lo, hi)
    out = {"result": result,
           "metrics": metrics(ctx),
           "checks": checks(records, got["harness_calls"], busy, kernels,
                            ctx.get("aligner_launches", ())),
           "spans_per_call": len(records) / max(len(by_call(records)), 1)}
    out["checks"]["clock_offset_drift_us"] = got["offset_drift_ns"] / 1e3
    out["checks"]["arena_allocs"] = arena_allocs(
        records, ctx.get("xfer") or {}, len(by_call(records)))
    if got["events"]:
        out["idle_gaps_by_thread"] = idle_gaps_by_thread(records, busy, lo,
                                                         hi)
    return out


def tracer_cost(workload, seed, pairs, device="cuda", reads=None) -> dict:
    """Calls of main on the cell's (first) file, the tracer on and off in
    turns: reads/s and the host time of each engine submit, both ways."""
    import tempfile

    import torch

    from benchmark import generate, run as bench
    from benchmark import trace as tr
    from cutadapt_tpu_torch import batch_pipeline, tracing

    cell, cfg, _, _ = bench.load_cell(workload,
                                      os.path.join(ROOT, "BENCHMARK.json"))
    bench.set_environment(device, cell["chips"])
    traffic = generate.load_traffic(cell["traffic"])
    if reads is not None:
        traffic = dict(traffic, reads_per_file=reads)
    gen_device = "cpu" if device == "cpu" else "cuda"
    with tempfile.TemporaryDirectory(prefix="trace-cost-") as tmp:
        mates = generate.make(traffic, seed, generate.TIMED,
                              device=gen_device)
        inputs = bench.write_inputs(traffic, mates, tmp, "in")
        n_reads = len(mates[0])
        args = (cfg["args"], inputs, len(mates), tmp, device)
        bench.call_main(*args, suffix=generate.suffix(traffic))  # warm
        engine = batch_pipeline.BatchPipelineEngine
        submit = engine.submit
        spans = tr.Spans()
        engine.submit = spans.wrap("submit", submit)
        seconds = {True: [], False: []}
        submit_ns = {True: [], False: []}
        try:
            for i in range(2 * pairs):
                on = (i % 2 == 0) == (i // 2 % 2 == 0)
                spans.records.clear()
                if on:
                    tracing.enable()
                call = bench.call_main(*args, suffix=generate.suffix(traffic))
                if on:
                    tracing.disable()
                if device != "cpu":
                    torch.cuda.synchronize()
                if call.failed:
                    raise RuntimeError(f"call {i} failed: {call.error}")
                seconds[on].append(call.seconds)
                submit_ns[on].append(spans.total_ns("submit") / n_reads)
        finally:
            engine.submit = submit
    rate = {on: n_reads / statistics.median(s) for on, s in seconds.items()}
    sub = {on: statistics.median(v) for on, v in submit_ns.items()}
    return {"pairs": pairs, "reads": n_reads, "span_ns": span_cost_ns(),
            "reads_per_s": {"on": rate[True], "off": rate[False]},
            "cost_share_of_reads_per_s": 1 - rate[True] / rate[False],
            "submit_ns_per_read": {"on": sub[True], "off": sub[False]},
            "cost_submit_ns_per_read": sub[True] - sub[False],
            "call_s": {"on": seconds[True], "off": seconds[False]}}


def span_cost_ns(n=200_000) -> float:
    """Host ns to open and close one span with the tracer on."""
    from cutadapt_tpu_torch import tracing

    tracing.enable()
    try:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            tracing.end(tracing.begin("cost"))
        return (time.perf_counter_ns() - t0) / n
    finally:
        tracing.disable()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reads", type=int, default=None,
                    help="reads of a smaller file (for the CPU)")
    a = ap.parse_args(argv)
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = traced_run(a.workload, a.seed, a.seconds, a.device, a.reads)
    out["traced_run_s"] = time.perf_counter() - t0
    if a.cost:
        cost = out["cost"] = tracer_cost(a.workload, a.seed, a.cost,
                                         a.device, a.reads)
        call_s = statistics.median(cost["call_s"]["off"])
        cost["span_share_of_call"] = (cost["span_ns"] * out["spans_per_call"]
                                      / 1e9 / call_s)
    out["device"] = (torch.cuda.get_device_name(0) if a.device == "cuda"
                     else "cpu")
    print("trace_cell_torch " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
