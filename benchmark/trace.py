"""The traced run's instruments: harness spans around the calls into the
port's layers, the aligner launches' inputs, and the reduction of a
torch.profiler trace (CUDA activity only) to device busy time, kernel
times and idle gaps named by the span open on the host.

Spans are kept in memory and reduced once the window has closed. Their
start is the wall clock in ns, the clock of the profiler's events."""

import threading
import time
from contextlib import contextmanager

import numpy as np

# the aligner's kernel (csrc/align_locate.cu)
ALIGN_KERNEL = "locate_kernel"


class Spans:
    """Named host spans (wall-clock start ns, duration ns)."""

    def __init__(self):
        self.records = []  # (name, start_ns, dur_ns)
        self.calls = []  # (start_ns, dur_ns) of each call of main
        self._lock = threading.Lock()

    def add(self, name, start_ns, dur_ns):
        with self._lock:
            self.records.append((name, start_ns, dur_ns))

    def wrap(self, name, fn):
        def spanned(*args, **kwargs):
            t0, p0 = time.time_ns(), time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter_ns() - p0)
        return spanned

    def total_ns(self, name) -> int:
        return sum(d for n, _, d in self.records if n == name)

    def of(self, name) -> list:
        return [(s, d) for n, s, d in self.records if n == name]


@contextmanager
def instrumented(spans: Spans, launches: list):
    """Patch the port for the window: spans ``parse`` (each FASTQ chunk
    parsed), ``submit`` (each engine's) and ``emit`` (the drive's emit:
    each engine's collect, the assembly and the writes), and a copy of
    each aligner launch's host inputs in ``launches``."""
    from cutadapt_tpu_torch import accel, batch_pipeline
    from cutadapt_tpu_torch.io import chunks

    Engine = batch_pipeline.BatchPipelineEngine
    saved = [(chunks, "parse_fastq_chunk", chunks.parse_fastq_chunk),
             (Engine, "submit", Engine.submit),
             (accel, "_pipelined_drive", accel._pipelined_drive),
             (batch_pipeline, "launch_batch", batch_pipeline.launch_batch)]
    drive, launch_batch = accel._pipelined_drive, batch_pipeline.launch_batch

    def spanned_drive(producer, submit, emit, *args, **kwargs):
        return drive(producer, submit, spans.wrap("emit", emit), *args,
                     **kwargs)

    def captured_launch(tasks, enc, lengths, device, pack2, wide=False):
        launches.append({
            "enc": enc.numpy().copy(),
            "lengths": lengths.numpy().astype(np.int64),
            "tables": [t.tables for t in tasks], "pack2": pack2,
            "wide": wide,
        })
        return launch_batch(tasks, enc, lengths, device, pack2, wide)

    chunks.parse_fastq_chunk = spans.wrap("parse", chunks.parse_fastq_chunk)
    Engine.submit = spans.wrap("submit", Engine.submit)
    accel._pipelined_drive = spanned_drive
    batch_pipeline.launch_batch = captured_launch
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every kernel, copy and set on the
    device in a finished torch.profiler run."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def busy_intervals(events, lo, hi) -> list:
    """The union of the events' intervals, clipped to [lo, hi)."""
    ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in events
                 if e > lo and s < hi)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(busy, lo, hi, spans: Spans, top=10) -> list:
    """The ``top`` longest stretches of [lo, hi) in which the device ran
    nothing, each named by the host span that covers most of it."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for g0, g1 in gaps[:top]:
        best, best_overlap = "other", 0
        for name, s, d in spans.records:
            overlap = min(g1, s + d) - max(g0, s)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        named.append([f"host: {best}", (g1 - g0) / 1e9])
    return named


def top_device_ops(events, lo, hi, top=10) -> list:
    """The device operations with the most time in [lo, hi), by name."""
    by = {}
    for name, s, e in events:
        if e > lo and s < hi:
            by[name] = by.get(name, 0) + (min(e, hi) - max(s, lo))
    ranked = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name, ns / 1e9] for name, ns in ranked]
