"""
The GPU path of the CLI: route a single-end pipeline that the port's
engine expresses through :class:`batch_pipeline.BatchPipelineEngine`
and the CUDA aligner, with output byte-identical to, and statistics
identical to, the per-read host pipeline.

The port of ``cutadapt_tpu/accel.py`` for single-end runs. Expressed
today: FASTQ, FASTA or BAM in (plain or compressed), FASTQ or FASTA
out; the host stages -u, -q, --nextseq-trim, --poly-a, --trim-n and
-l, in any order around one AdapterCutter whose adapters are of the
kernel kinds (regular, front, anywhere, non-internal, anchored with
indels, rightmost), linked, anchored without indels (the comparers) or
anchored sets (the indexed kinds), with --times and every action (trim,
retain, crop, mask, lowercase, --no-trim); the filters -m/-M with
routed outputs, --discard-trimmed/untrimmed with --untrimmed-output,
--max-n, --max-ee, --max-aer and --discard-casava.

Everything else is refused in the translation, before an engine is
built, with a reason: --revcomp, adapters needing more than 16 query
classes, name edits (--rename, --strip-suffix, -x/-y, --length-tag) and
--zero-cap, side files (--rest-file, --info-file, --wildcard-file),
demultiplexing and paired-end pipelines. A refused run is counted
(:data:`FALLBACK_COUNT`) and takes the per-read host path, or, under
``CUTADAPT_TPU_TORCH_BATCH=require``, fails with
:class:`BatchRequiredError`.

Environment (all read per run):

- ``CUTADAPT_TPU_TORCH_BATCH``: ``0`` is the host path, ``1`` or unset
  the engine, ``require`` the engine with refusals as errors;
- ``CUTADAPT_TPU_TORCH_DEVICE``: unset means CUDA; ``cpu`` runs the
  aligner's plain PyTorch version (the tests);
- ``CUTADAPT_TPU_TORCH_CHUNK_BYTES``: the size of the input chunks.

Once the engine path is chosen it runs on the device or fails: there
is no card, the kernel does not build or a launch fails, the run ends
with an error, never on the host path.

At every -j the drive is a 3-stage thread pipeline (reader / dispatch
/ in-order emit, _pipelined_drive).
"""

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

from .report import Statistics


class BatchRequiredError(Exception):
    """CUTADAPT_TPU_TORCH_BATCH=require was set but the run cannot ride
    the batch engine. Raised instead of silently taking the
    (byte-identical) host path, so a test lane can enforce the
    zero-fallback property."""


class DeviceError(Exception):
    """The engine path was chosen but its device could not be set up:
    no CUDA device, an unknown CUTADAPT_TPU_TORCH_DEVICE, or a kernel
    library that did not build or launch."""


# Fallback accounting: bumped whenever try_run_accelerated declines a
# run that the activation policy admitted (the caller then takes the
# host path). Reset-free by design: read a before/after delta.
FALLBACK_COUNT = 0
LAST_FALLBACK: Optional[str] = None


def _fallback(reason: str) -> None:
    """Record a batch-engine fallback and return None (the host path
    runs instead). Under CUTADAPT_TPU_TORCH_BATCH=require, escalate to
    BatchRequiredError instead."""
    global FALLBACK_COUNT, LAST_FALLBACK
    FALLBACK_COUNT += 1
    LAST_FALLBACK = reason
    logger.debug("batch engine fallback: %s", reason)
    if os.environ.get("CUTADAPT_TPU_TORCH_BATCH") == "require":
        raise BatchRequiredError(
            "CUTADAPT_TPU_TORCH_BATCH=require, but this run cannot ride the "
            "batch engine: " + reason
        )
    return None


# Start-up timing of the last engine run (perf_counter seconds): when
# _run_single began, when the device was set up and warm, and when the
# first chunk was submitted.
RUN_TIMES = {"start": None, "device_ready": None, "first_submit": None}


# Streaming chunk size: small enough that several chunks are in flight
# (the 3-stage thread pipeline needs >= 3 chunks to overlap), large
# enough that per-dispatch device round-trip latency amortizes.
def _chunk_bytes() -> int:
    """Chunk size for the engine's record-aligned input chunks; read
    per run so CUTADAPT_TPU_TORCH_CHUNK_BYTES works regardless of when this
    module was first imported."""
    return int(os.environ.get("CUTADAPT_TPU_TORCH_CHUNK_BYTES", 16 * 1024 * 1024))

_STAGE_END = object()

# Chunks-in-flight gauge: a chunk counts as in flight from device
# dispatch (submit) until its results are emitted. `max` is the
# high-water mark per run (wire/latency overlap needs >= 3 chunks
# concurrently dispatched-or-emitting).
_FLIGHT_LOCK = threading.Lock()
_FLIGHT = {"now": 0, "max": 0}


def _flight_delta(d: int) -> None:
    with _FLIGHT_LOCK:
        _FLIGHT["now"] += d
        if _FLIGHT["now"] > _FLIGHT["max"]:
            _FLIGHT["max"] = _FLIGHT["now"]


def reset_flight_metrics() -> None:
    with _FLIGHT_LOCK:
        _FLIGHT["now"] = 0
        _FLIGHT["max"] = 0


def flight_metrics() -> dict:
    with _FLIGHT_LOCK:
        return dict(_FLIGHT)


# Chunks allowed in each hand-off queue of the drive
PIPELINE_DEPTH = 3


def _pipelined_drive(producer, submit, emit, depth: int = PIPELINE_DEPTH
                     ) -> None:
    """Run the three pipeline stages on separate threads:

      reader thread:  iterate `producer` (file I/O + chunk parsing)
      main thread:    `submit` each item (prefilter/encode/device dispatch)
      writer thread:  `emit` each submitted item, in order (device
                      result fetch, FASTQ assembly, file writes, stats)

    The hot host work on all three stages is C++/IO that releases the
    GIL, so the stages genuinely overlap; bounded queues keep at most
    `depth` chunks in flight per hand-off (so up to depth+1 chunks are
    dispatched-but-unemitted: the emit queue plus the one being
    emitted — enough to hide round-trip latency on high-latency
    links). Only the writer thread folds statistics. Exceptions from
    any stage propagate to the caller with cross-thread shutdown
    handled here.
    """
    parsed_q: queue.Queue = queue.Queue(maxsize=depth)
    emit_q: queue.Queue = queue.Queue(maxsize=depth)
    failures = []

    def read_stage():
        try:
            for item in producer:
                parsed_q.put(item)
                if failures:
                    break
        except BaseException as e:  # noqa: BLE001 - forwarded to caller
            failures.append(e)
        finally:
            parsed_q.put(_STAGE_END)

    def write_stage():
        while True:
            item = emit_q.get()
            if item is _STAGE_END:
                return
            if failures:
                _flight_delta(-1)
                continue  # drain without emitting
            try:
                emit(item)
            except BaseException as e:  # noqa: BLE001
                failures.append(e)
            finally:
                _flight_delta(-1)

    reader = threading.Thread(target=read_stage, daemon=True)
    writer = threading.Thread(target=write_stage, daemon=True)
    reader.start()
    writer.start()
    try:
        while True:
            item = parsed_q.get()
            if item is _STAGE_END:
                break
            if failures:
                continue  # keep draining so the reader can finish
            _flight_delta(+1)  # in flight: dispatch start -> emitted
            try:
                emit_q.put(submit(item))
            except BaseException as e:  # noqa: BLE001
                _flight_delta(-1)
                failures.append(e)
    finally:
        emit_q.put(_STAGE_END)
        writer.join()
        # the reader stops after at most one more item (bounded queue)
        while reader.is_alive():
            try:
                parsed_q.get(timeout=0.05)
            except queue.Empty:
                pass
        reader.join()
    if failures:
        raise failures[0]



@dataclass
class SingleTranslation:
    """An eligible single-end pipeline, translated for the engine."""

    stages: list
    filters: list
    cutter: object
    sink: object  # SingleEndSink


class _Refused(Exception):
    """The translation met a pipeline part the engine does not run;
    the message is the fallback reason."""


def _task_kind(adapter) -> str:
    """The engine's task kind for a host adapter
    (batch_pipeline.adapter_kind); raises _Refused where the engine, as
    the reference's, has no task for it."""
    from .batch_pipeline import adapter_kind

    kind = adapter_kind(adapter)
    if kind is not None:
        return kind
    if getattr(adapter, "_force_anywhere", False):
        raise _Refused(
            "adapters with the 'anywhere' search parameter have no engine "
            "form"
        )
    raise _Refused(
        f"{getattr(adapter, 'kind', None) or type(adapter).__name__} "
        "adapters have no engine form"
    )


def _translate_tasks(cutter):
    """AdapterTask list for an AdapterCutter."""
    from .batch_pipeline import AdapterTask

    tasks = []
    for i, adapter in enumerate(cutter.adapters):
        kind = _task_kind(adapter)
        if kind == "linked" and cutter.action == "crop":
            raise _Refused("linked adapters with --action=crop have no "
                           "engine form")
        try:
            tasks.append(AdapterTask(adapter, kind, i))
        except (NotImplementedError, ValueError) as e:
            # more than 16 query classes; a linked adapter whose parts
            # have no task of their own
            raise _Refused(str(e)) from None
    return tasks


def _translate_modifier(mod, has_cutter):
    """Return (stage, cutter or None) for an eligible single-end
    modifier: a host stage, or the one adapter stage."""
    from . import native
    from .batch_pipeline import (
        AdapterStage, CutStage, NEndStage, NextseqStage, PolyAStage,
        QualityStage, ShortenStage,
    )
    from .modifiers import (
        AdapterCutter, NEndTrimmer, NextseqQualityTrimmer, PolyATrimmer,
        QualityTrimmer, Shortener, UnconditionalCutter,
    )

    if isinstance(mod, UnconditionalCutter):
        return CutStage(mod.length, mod), None
    if isinstance(mod, Shortener):
        return ShortenStage(mod.length, mod), None
    if isinstance(mod, (NEndTrimmer, QualityTrimmer, NextseqQualityTrimmer,
                        PolyATrimmer)) and not native.AVAILABLE:
        # the engine's byte scans are native-only
        raise _Refused(
            f"modifier {type(mod).__name__} needs the native host library, "
            "which did not build"
        )
    if isinstance(mod, NEndTrimmer):
        return NEndStage(mod), None
    if isinstance(mod, QualityTrimmer):
        return QualityStage(
            mod.cutoff_front, mod.cutoff_back, mod.base, mod
        ), None
    if isinstance(mod, NextseqQualityTrimmer):
        return NextseqStage(mod.cutoff, mod.base, mod), None
    if isinstance(mod, PolyATrimmer):
        return PolyAStage(mod, revcomp=mod.revcomp), None
    if type(mod) is not AdapterCutter:
        raise _Refused(
            f"modifier {type(mod).__name__} is not ported to the GPU engine "
            "yet"
        )
    if has_cutter:
        raise _Refused("a second adapter-cutting stage is not ported yet")
    supported = ("trim", None, "retain", "crop")
    if native.AVAILABLE:  # transform assembly is native-only
        supported += ("mask", "lowercase")
    if mod.action not in supported:
        raise _Refused(
            f"the adapter action {mod.action!r} needs the native host "
            "library, which did not build"
        )
    stage = AdapterStage(
        _translate_tasks(mod), times=mod.times, modifier=mod,
        action=mod.action,
    )
    return stage, mod


def _translate_predicate(pred):
    from . import native
    from .predicates import Predicate

    if not isinstance(pred, Predicate) or not pred.kind:
        raise _Refused(
            f"filter {type(pred).__name__} has no engine form"
        )
    if pred.needs_native_scan and not native.AVAILABLE:
        raise _Refused(
            f"filter {pred.kind} needs the native host library, which did "
            "not build"
        )
    return (pred.kind, pred.threshold)


def _translate_single(pipeline, fasta: bool = False) -> SingleTranslation:
    """Map an eligible single-end host pipeline to the engine's stages,
    filters, cutter and sink, or raise _Refused. The final step must be
    a plain sink; every writer must be a Fastq- or FastaWriter (FASTA
    input requires FASTA output: a FASTQ writer would raise on the host
    path, which must stay in charge of that error)."""
    from .batch_pipeline import FilterSpec
    from .io.fastq import FastaWriter, FastqWriter
    from .steps import SingleEndFilter, SingleEndSink

    writer_classes = (FastaWriter,) if fasta else (FastqWriter, FastaWriter)

    def check_writer(w, what):
        if not isinstance(w, writer_classes):
            raise _Refused(
                f"{what} writes {type(w).__name__}, which the engine does "
                f"not assemble{' from FASTA input' if fasta else ''}"
            )

    from .batch_pipeline import AdapterStage, NextseqStage, QualityStage

    stages = []
    cutter = None
    for mod in pipeline._modifiers:
        stage, stage_cutter = _translate_modifier(mod, cutter is not None)
        cutter = stage_cutter or cutter
        stages.append(stage)
    if _transform_action(stages) is not None and not isinstance(
        stages[-1], AdapterStage
    ):
        # the assembler rewrites the bytes outside the adapter stage's
        # remainder; a later stage would see untransformed bytes
        raise _Refused(
            "a host stage after a mask/lowercase adapter stage has no "
            "engine form"
        )
    if fasta and any(
        isinstance(s, (QualityStage, NextseqStage)) for s in stages
    ):
        # FASTA carries no qualities: the host path owns that error
        raise _Refused("quality trimming of FASTA input has no engine form")

    filters = []
    sink = None
    for step in pipeline._steps:
        if sink is not None:
            raise _Refused(f"step {type(step).__name__} after the sink")
        if isinstance(step, SingleEndSink):
            check_writer(step.writer, "the output")
            sink = step
            continue
        if not isinstance(step, SingleEndFilter):
            raise _Refused(
                f"step {type(step).__name__} is not ported to the GPU "
                "engine yet"
            )
        if step._writer is not None:
            check_writer(step._writer, "a routed filter output")
        kind, threshold = _translate_predicate(step._predicate)
        if fasta and kind in (
            "too_many_expected_errors", "too_high_average_error_rate",
        ):
            raise _Refused(f"filter {kind} needs qualities (FASTA input)")
        filters.append(FilterSpec(kind, threshold, step))
    if sink is None:
        raise _Refused("the pipeline ends without a sink")
    return SingleTranslation(stages, filters, cutter, sink)


def _transform_action(stages):
    """The mask/lowercase action of the stage list's adapter stage, if
    any (these need the transform assembler)."""
    for s in stages:
        if getattr(s, "action", None) in _TRANSFORM_MODES:
            return s.action
    return None


def _stages_assembler(stages):
    """Per-chunk FASTQ assembler honoring a mask/lowercase adapter
    action."""
    from .io.chunks import assemble_window

    action = _transform_action(stages)
    if action is None:
        def plain(chunk, ws, we, mask, stats):
            return assemble_window(chunk, ws, we, mask)

        return plain
    from . import native

    mode = _TRANSFORM_MODES[action]

    def fn(chunk, ws, we, mask, stats):
        rs, re_ = stats["remainder"]
        return native.assemble_fastq_transform(
            chunk.buf, chunk.head_start, chunk.head_end, chunk.seq_start,
            chunk.qual_start, ws, we, rs, re_, mask, mode,
        )

    return fn


_TRANSFORM_MODES = {"mask": 1, "lowercase": 2}


_ADJ_KEYS = ("A", "C", "G", "T", "")
_ADJ_CODE = np.full(256, 4, np.int8)
for _b_i, _b in enumerate(b"ACGT"):
    _ADJ_CODE[_b] = _b_i


def _record_removals(end, removed, errors):
    """Fold a removal event batch into EndStatistics, per unique
    (length, errors)."""
    base = int(errors.max(initial=0)) + 1
    enc = removed.astype(np.int64) * base + errors
    uniq, counts = np.unique(enc, return_counts=True)
    for p, c in zip(uniq, counts):
        end.record_removal(int(p // base), int(p % base), int(c))


def _record_adjacent(end, adj_bytes):
    """Adjacent-base tallies (byte 0 and non-ACGT count as '')."""
    codes = _ADJ_CODE[np.asarray(adj_bytes, np.uint8)]
    cnt = np.bincount(codes, minlength=5)
    for i, c in enumerate(cnt[:5]):
        if c:
            end.adjacent_bases[_ADJ_KEYS[i]] += int(c)


def _record_written(wl, side, hist):
    """Written-length histogram for one side (the host bincount)."""
    wl.add_histogram(hist, side=side)


def _apply_side_stats(stats, stages, cutter, written_lengths):
    """Fold one chunk's engine stats for one side into the host
    pipeline objects. Returns total_bp of the side."""
    for si, n in stats.get("quality_trimmed", {}).items():
        stages[si].modifier.trimmed_bases += n
    for si, removed in stats.get("poly_a_removed", {}).items():
        mod = stages[si].modifier
        for length, count in enumerate(np.bincount(removed)):
            if count:
                mod.trimmed_bases[int(length)] += int(count)
    if cutter is not None:
        cutter.with_adapters += stats.get("with_adapters", 0)
        stage = next(s for s in stages if hasattr(s, "tasks"))
        for ev in stats.get("adapter_events", ()):
            task = stage.tasks[ev["task"]]
            sub = np.asarray(ev["sub"])
            asf = np.asarray(ev["as_front"], bool)
            rem = np.asarray(ev["removed"])
            err = np.asarray(ev["errors"])
            adj = np.asarray(ev["adjacent"])
            # an indexed task credits the adapter each read matched
            for s in (np.unique(sub) if len(sub) else ()):
                m = sub == s
                astats = cutter.adapter_statistics[task.adapters[int(s)]]
                fm = m & asf
                bm = m & ~asf
                if fm.any():
                    _record_removals(astats.front, rem[fm], err[fm])
                if bm.any():
                    _record_removals(astats.back, rem[bm], err[bm])
                    _record_adjacent(astats.back, adj[bm])
    if written_lengths is not None:
        _record_written(written_lengths, 1, stats["written_lengths"])
    return stats["total_bp"]


def _input_format(infile) -> Optional[str]:
    """'fastq' / 'fasta' / 'bam' when the batch path can parse this
    input."""
    from .io.files import FileFormat, detect_file_format

    try:
        detected = detect_file_format(infile)
    except Exception:
        return None
    if detected == FileFormat.FASTQ:
        return "fastq"
    if detected == FileFormat.FASTA:
        return "fasta"
    if detected == FileFormat.BAM:
        return "bam"
    return None


def _setup_device(translated):
    """Build the engine on its device: CUTADAPT_TPU_TORCH_DEVICE, unset
    meaning CUDA. On CUDA, pin the device index, then warm the engine,
    which builds the kernel library once, before any drive thread
    starts, and launches each lane once. Failures raise DeviceError;
    there is no fallback to the host path from here."""
    import torch

    from .batch_pipeline import BatchPipelineEngine
    from .ops.align_cuda import resolve_device

    name = os.environ.get("CUTADAPT_TPU_TORCH_DEVICE") or "cuda"
    try:
        device = resolve_device(name)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        engine = BatchPipelineEngine(
            translated.stages, translated.filters, device=device
        )
        if device.type == "cuda":
            with torch.cuda.device(device):
                engine.warmup(engine.length_bucket)
    except (RuntimeError, ValueError) as e:
        raise DeviceError(
            f"the GPU engine could not start: {e} (set "
            "CUTADAPT_TPU_TORCH_BATCH=0 for the host path)"
        ) from e
    return engine


def _on_device(fn, device):
    """fn run with ``device`` as the calling thread's current CUDA
    device (the drive calls submit and emit from several threads, and
    the current device is per host thread; emit's collect launches the
    3' phase of a linked adapter)."""
    if device.type != "cuda":
        return fn
    import torch

    def call(item):
        with torch.cuda.device(device):
            return fn(item)

    return call


def try_run_accelerated(pipeline, infiles, progress) -> Optional[Statistics]:
    """
    Run the pipeline through the batched engine if eligible; return the
    collected Statistics, or None if the run takes the host path
    (CUTADAPT_TPU_TORCH_BATCH=0, or a configuration the engine does not
    express). Every -j drives the engine with _pipelined_drive.
    """
    from .pipeline import SingleEndPipeline

    if os.environ.get("CUTADAPT_TPU_TORCH_BATCH") == "0":
        return None  # the host path by request, not a fallback
    if isinstance(pipeline, SingleEndPipeline):
        return _run_single(pipeline, infiles, progress)
    return _fallback(
        f"{type(pipeline).__name__}: paired-end pipelines are not ported "
        "to the GPU engine yet"
    )


def _run_single(pipeline, infiles, progress) -> Optional[Statistics]:
    if infiles.interleaved or len(infiles._files) != 1:
        return _fallback("single-end pipeline over interleaved/multi-file input")
    infile = infiles._files[0]
    fmt = _input_format(infile)
    if fmt is None:
        return _fallback("input is not a parseable FASTQ/FASTA/BAM file")
    fasta_in = fmt == "fasta"
    try:
        translated = _translate_single(pipeline, fasta=fasta_in)
    except _Refused as e:
        return _fallback(str(e))
    stages, filters = translated.stages, translated.filters
    cutter, sink = translated.cutter, translated.sink
    RUN_TIMES.update(start=time.perf_counter(), device_ready=None,
                     first_submit=None)
    engine = _setup_device(translated)
    RUN_TIMES["device_ready"] = time.perf_counter()

    from .io.chunks import (
        assemble_fasta_transform,
        assemble_fasta_window,
        parse_bam_chunk,
        parse_fasta_chunk,
        parse_fastq_chunk,
    )
    from .io.fastq import FastaWriter, read_chunks

    def out_of(writer):
        """(file, writes_fasta) for one record writer."""
        return (writer._file, isinstance(writer, FastaWriter))

    out_file, out_fasta = out_of(sink.writer)
    filter_files = [
        out_of(f.step._writer) if f.step._writer is not None else None
        for f in filters
    ]
    n = 0
    total_bp = 0
    assemble = _stages_assembler(stages)
    transform_mode = _TRANSFORM_MODES.get(_transform_action(stages))

    def render(chunk, ws, we, mask, stats, writes_fasta):
        if writes_fasta:
            if transform_mode is not None:
                rs, re_ = stats["remainder"]
                return assemble_fasta_transform(
                    chunk, ws, we, rs, re_, mask, transform_mode
                )
            return assemble_fasta_window(chunk, ws, we, mask)
        return assemble(chunk, ws, we, mask, stats)

    def submit(chunk):
        if RUN_TIMES["first_submit"] is None:
            RUN_TIMES["first_submit"] = time.perf_counter()
        return engine.submit(chunk)

    def emit(pending):
        nonlocal n, total_bp
        ws, we, keep, stats = engine.collect(pending)
        chunk = pending.parsed
        out_file.write(render(chunk, ws, we, keep, stats, out_fasta))
        # routed filter outputs (--too-short-output etc.): records a
        # filter dropped, in input order, with their state at drop time
        for out, newly in zip(filter_files, stats["filter_dropped_masks"]):
            if out is not None and newly.any():
                out[0].write(render(chunk, ws, we, newly, stats, out[1]))
        for f, count in zip(filters, stats["filter_counts"]):
            f.step._filtered += count
        total_bp += _apply_side_stats(stats, stages, cutter, sink._statistics)
        n += stats["n"]
        if progress is not None:
            progress.update(stats["n"])

    if fasta_in:
        def producer():
            line = 0
            for data in read_chunks(infile, _chunk_bytes()):
                yield parse_fasta_chunk(data, first_line=line)
                line += int(
                    (np.frombuffer(data, np.uint8) == 10).sum()
                )
        chunks_iter = producer()
    elif fmt == "bam":
        # qualities may be absent per record (0xFF); that is an error
        # exactly when some output actually needs them
        fasta_outputs = [f[1] for f in filter_files if f is not None]
        fasta_outputs.append(out_fasta)
        chunks_iter = (
            parse_bam_chunk(data, not all(fasta_outputs))
            for data in read_chunks(infile, _chunk_bytes())
        )
    else:
        chunks_iter = (
            parse_fastq_chunk(data)
            for data in read_chunks(infile, _chunk_bytes())
        )
    try:
        _pipelined_drive(
            chunks_iter, _on_device(submit, engine.device),
            _on_device(emit, engine.device),
        )
    except NotImplementedError as e:
        # data-dependent limits of the engine (reads of 2**14 bp or
        # more): the output is partly written, so the run cannot move
        # to the host path now
        raise DeviceError(
            f"the GPU engine cannot finish this input: {e}; run with "
            "CUTADAPT_TPU_TORCH_BATCH=0 to take the host path"
        ) from e
    infiles.close()
    if progress is not None:
        progress.close()
    return Statistics().collect(
        n, total_bp, None, pipeline._modifiers, pipeline._steps
    )
