"""The port's tracer: named spans at its layer boundaries, kept in memory
while a caller has turned it on.

    from cutadapt_tpu_torch import tracing

    tracing.enable()
    cli.main([...])
    records = tracing.disable()  # a list of Span

It is off unless a caller enables it; nothing in the port does. Off, a
span site costs one read of a module global: :func:`begin` returns
None, reading no clock and allocating nothing, and :func:`end` of None
returns. A site opens its span where the work starts and closes it in a
``finally``::

    span = tracing.begin("prefilter")
    try:
        ...
    finally:
        tracing.end(span)

Each :class:`Span` holds its name; the stage of the thread it ran on
(``caller``, or in the drive ``reader``, ``submit`` (the caller's own
thread) or ``emit``); the id of the ``cli.main`` call it belongs to;
the sequence number of the chunk it worked on, shared by one chunk's
spans on all three threads (None outside the drive); its parent, the
innermost span open on the same thread when it began; its start and
end in ns; and, for the stage spans opened with ``cpu=True``, the
thread's CPU ns over the span (``time.thread_time_ns``).

Times are ``time.perf_counter_ns()``, shifted once by :func:`disable`
onto the clock of ``time.time_ns()`` by the offset measured in
:func:`enable`: the wall clock in ns, the clock torch.profiler stamps
its CUDA events with.

Spans that cross threads are opened with ``nest=False``: a ``queue.*``
span from a chunk's ``put`` on one thread to its ``get`` on the next.
They have no parent and are no one's parent; their stage is the
putting thread's.
"""

import itertools
import threading
import time

# the records while enabled, else None: the one global a span site reads
_records = None
_offset_ns = 0
_ids = itertools.count()
_calls = itertools.count(1)
_call = None
_local = threading.local()


class Span:
    """One span; ``end`` is None while it is open."""

    __slots__ = ("id", "name", "stage", "call", "chunk", "parent", "start",
                 "end", "cpu", "_cpu0", "_stack", "_records")

    def __repr__(self):
        return (f"Span({self.name!r}, stage={self.stage}, call={self.call}, "
                f"chunk={self.chunk}, start={self.start}, end={self.end})")


def enable() -> None:
    """Start recording (again, with no records) on the calling thread as
    a ``caller``, and measure the offset from ``perf_counter_ns`` to
    ``time_ns``."""
    global _records, _offset_ns, _ids, _calls
    _local.stage, _local.chunk, _local.stack = "caller", None, []
    _ids = itertools.count()
    _calls = itertools.count(1)
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _records = []


def disable() -> list:
    """Stop recording; the spans recorded since :func:`enable`, their
    times on the wall clock (an empty list if it was not enabled)."""
    global _records
    records, _records = _records, None
    if records is None:
        return []
    for s in records:
        s.start += _offset_ns
        if s.end is not None:
            s.end += _offset_ns
    return records


def enabled() -> bool:
    return _records is not None


def begin(name: str, cpu: bool = False, nest: bool = True):
    """Open a span on this thread; None when the tracer is off."""
    records = _records
    if records is None:
        return None
    local = _local
    stack = getattr(local, "stack", None)
    if stack is None:
        stack = local.stack = []
    elif stack and stack[-1]._records is not records:
        stack.clear()  # spans left open by an earlier recording
    span = Span()
    span.id = next(_ids)
    span.name = name
    span.stage = getattr(local, "stage", "caller")
    span.call = _call
    span.chunk = getattr(local, "chunk", None)
    span.parent = stack[-1].id if nest and stack else None
    span.end = None
    span.cpu = None
    span._cpu0 = time.thread_time_ns() if cpu else None
    span._stack = stack if nest else None
    span._records = records
    if nest:
        stack.append(span)
    records.append(span)
    span.start = time.perf_counter_ns()
    return span


def end(span) -> None:
    """Close ``span`` (nothing for None, nor for a span whose records
    :func:`disable` has handed out: it stays open there)."""
    if span is None or span._records is not _records:
        return
    span.end = time.perf_counter_ns()
    if span._cpu0 is not None:
        span.cpu = time.thread_time_ns() - span._cpu0
    stack = span._stack
    if stack:
        if stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
    span._stack = None


def begin_call():
    """Open the ``call`` span of one ``cli.main`` call, under a new call
    id that every span until the next call carries."""
    global _call
    if _records is None:
        return None
    _call = next(_calls)
    return begin("call")


def set_stage(stage: str, chunk=None) -> None:
    """This thread's stage and chunk from now on (the drive's)."""
    if _records is None:
        return
    _local.stage = stage
    _local.chunk = chunk


def set_chunk(chunk) -> None:
    """The chunk this thread works on from now on."""
    if _records is None:
        return
    _local.chunk = chunk


def in_flight_max(records) -> int:
    """The most chunks in flight at once in ``records``: a chunk is in
    flight from the start of its ``submit`` span to the end of its
    ``emit`` span."""
    submitted, emitted = {}, {}
    for s in records:
        if s.name == "submit":
            submitted[s.call, s.chunk] = s.start
        elif s.name == "emit" and s.end is not None:
            emitted[s.call, s.chunk] = s.end
    # at one instant an emit's end counts before a submit's start
    moves = sorted([(t, 1) for k, t in submitted.items() if k in emitted]
                   + [(t, -1) for k, t in emitted.items() if k in submitted])
    now = most = 0
    for _, step in moves:
        now += step
        most = max(most, now)
    return most
