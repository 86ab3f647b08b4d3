"""
The GPU path of the CLI: route a pipeline that the port's engine
expresses through :class:`batch_pipeline.BatchPipelineEngine` and the
CUDA aligner, with output byte-identical to, and statistics identical
to, the per-read host pipeline.

The port of ``cutadapt_tpu/accel.py``. Expressed today, single-end:
FASTQ, FASTA or BAM in (plain or compressed), FASTQ or FASTA out; the
host stages -u, -q, --nextseq-trim, --poly-a, --trim-n and -l, in any
order around one AdapterCutter whose adapters are of the kernel kinds
(regular, front, anywhere, non-internal, anchored with indels,
rightmost), linked, anchored without indels (the comparers) or anchored
sets (the indexed kinds), with --times and every action (trim, retain,
crop, mask, lowercase, --no-trim), or around --revcomp (its adapter
stage last; trim, mask, lowercase, --no-trim); the filters -m/-M with
routed outputs, --discard-trimmed/untrimmed with --untrimmed-output,
--max-n, --max-ee, --max-aer and --discard-casava.

Paired-end (_run_paired): two files or one interleaved file of FASTQ or
FASTA, written as two files or interleaved; per side the same stages
(-a/-g/-b with -A/-G/-B, -q/-Q, -u/-U, -l/-L, --poly-a, per-side
revcomp stages built through the API), --pair-adapters, paired
--revcomp with the host stages after its swap, and the pair filters
(-m/-M per side, --max-n, --max-ee, --discard-(un)trimmed,
--pair-filter=any|both|first) with their routed paired outputs. Two
engines, one per side, share one device; the pair filters, the pair
match of --pair-adapters and the four matching runs of the paired
--revcomp run in emit.

Everything else is refused in the translation, before an engine is
built, with a reason: adapters needing more than 16 query classes, name
edits (--rename, --strip-suffix, -x/-y, --length-tag) and --zero-cap,
side files (--rest-file, --info-file, --wildcard-file) and
demultiplexing. A refused run is counted (:data:`FALLBACK_COUNT`) and
takes the per-read host path, or, under
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
        QualityStage, RevcompStage, ShortenStage,
    )
    from .modifiers import (
        AdapterCutter, NEndTrimmer, NextseqQualityTrimmer, PolyATrimmer,
        QualityTrimmer, ReverseComplementer, Shortener, UnconditionalCutter,
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
    if isinstance(mod, ReverseComplementer):
        inner = mod.adapter_cutter
        if has_cutter:
            raise _Refused("a second adapter-cutting stage is not ported yet")
        if inner.action not in _RC_ACTIONS:
            raise _Refused(
                f"--revcomp with the adapter action {inner.action!r} has "
                "no engine form"
            )
        if not native.AVAILABLE:
            raise _Refused(
                "--revcomp needs the native host library, which did not "
                "build"
            )
        stage = RevcompStage(
            _translate_tasks(inner), times=inner.times, modifier=mod,
            suffix=mod._suffix, action=inner.action,
        )
        return stage, inner
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


# filter kinds that read the qualities
_QUALITY_FILTERS = ("too_many_expected_errors", "too_high_average_error_rate")

# the adapter actions of a cutter under --revcomp (the reference's
# ReverseComplementer has no retain or crop)
_RC_ACTIONS = ("trim", None, "mask", "lowercase")


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

    from .batch_pipeline import NextseqStage, QualityStage

    stages = []
    cutter = None
    for mod in pipeline._modifiers:
        stage, stage_cutter = _translate_modifier(mod, cutter is not None)
        cutter = stage_cutter or cutter
        stages.append(stage)
    _check_last_stage(stages)
    rc_stage = _revcomp_stage(stages)
    if fasta and rc_stage is not None:
        # FASTA chunks alias quality offsets to the sequence: the rc
        # copy must complement sequences only
        rc_stage.has_quals = False
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
        if fasta and kind in _QUALITY_FILTERS:
            raise _Refused(f"filter {kind} needs qualities (FASTA input)")
        filters.append(FilterSpec(kind, threshold, step))
    if sink is None:
        raise _Refused("the pipeline ends without a sink")
    return SingleTranslation(stages, filters, cutter, sink)


def _check_last_stage(stages):
    """Refuse a host stage after a mask/lowercase or --revcomp adapter
    stage: the assembler rewrites the bytes outside the adapter stage's
    remainder, or picks each read's orientation, so a later stage would
    see untransformed or forward bytes."""
    from .batch_pipeline import AdapterStage

    if stages and not isinstance(stages[-1], AdapterStage):
        if _revcomp_stage(stages) is not None:
            raise _Refused(
                "a host stage after the --revcomp stage has no engine form"
            )
        if _transform_action(stages) is not None:
            raise _Refused(
                "a host stage after a mask/lowercase adapter stage has no "
                "engine form"
            )


def _revcomp_stage(stages):
    """The --revcomp stage of a stage list, if any."""
    from .batch_pipeline import RevcompStage

    return next((s for s in stages if isinstance(s, RevcompStage)), None)


def _transform_action(stages):
    """The mask/lowercase action of the stage list's adapter stage, if
    any (these need the transform assembler)."""
    for s in stages:
        if getattr(s, "action", None) in _TRANSFORM_MODES:
            return s.action
    return None


def _assemble_transform(chunk, ws, we, mask, stats, mode):
    """FASTQ of the kept records with the bytes outside each read's
    remainder (``stats["remainder"]``) masked or lowercased."""
    from . import native

    rs, re_ = stats["remainder"]
    return native.assemble_fastq_transform(
        chunk.buf, chunk.head_start, chunk.head_end, chunk.seq_start,
        chunk.qual_start, ws, we, rs, re_, mask, mode,
    )


def _stages_assembler(stages):
    """Per-chunk FASTQ assembler honoring a mask/lowercase adapter
    action or a --revcomp stage."""
    from .io.chunks import assemble_window

    rc_stage = _revcomp_stage(stages)
    if rc_stage is not None:
        from . import native

        suffix = (rc_stage.suffix or "").encode("ascii")

        def rc_fn(chunk, ws, we, mask, stats):
            if stats.get("rc_selected"):
                # the drive selected each read's orientation into the
                # chunk already; a mask/lowercase action reads the
                # remainder from the stats
                tm = _TRANSFORM_MODES.get(stats.get("transform_action"))
                if tm is not None:
                    return _assemble_transform(chunk, ws, we, mask, stats, tm)
                return assemble_window(chunk, ws, we, mask)
            return native.assemble_fastq_window_rc(
                chunk.buf, stats["rc_chunk"].buf, chunk.head_start,
                chunk.head_end, chunk.seq_start, chunk.qual_start,
                ws, we, mask, stats["is_rc"], suffix,
            )

        return rc_fn
    action = _transform_action(stages)
    if action is None:
        # no static transform stage; the paired --revcomp stage lives
        # outside the per-side stage lists and publishes its
        # mask/lowercase action through the stats
        def plain(chunk, ws, we, mask, stats):
            tm = _TRANSFORM_MODES.get(stats.get("transform_action"))
            if tm is not None:
                return _assemble_transform(chunk, ws, we, mask, stats, tm)
            return assemble_window(chunk, ws, we, mask)

        return plain
    mode = _TRANSFORM_MODES[action]

    def fn(chunk, ws, we, mask, stats):
        return _assemble_transform(chunk, ws, we, mask, stats, mode)

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


def _record_written(wl, side, values=None, hist=None):
    """Written-length histogram for one side: from the kept reads'
    lengths (``values``) or their bincount (``hist``)."""
    if hist is None:
        hist = np.bincount(values)
    wl.add_histogram(hist, side=side)


def _record_filtered(step, mask):
    """Filter counter for one step: the reads it newly dropped."""
    step._filtered += int(mask.sum())


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
    rc_stage = _revcomp_stage(stages)
    if rc_stage is not None and "revcomped" in stats:
        rc_stage.modifier.reverse_complemented += stats["revcomped"]
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
            # a linked adapter's two events per round credit
            # reverse_complemented once, by the primary (per-read) row
            prim = (
                np.asarray(ev["primary"], bool) if "primary" in ev else None
            )
            # an indexed task credits the adapter each read matched
            for s in (np.unique(sub) if len(sub) else ()):
                m = sub == s
                astats = cutter.adapter_statistics[task.adapters[int(s)]]
                if ev.get("rc"):
                    astats.reverse_complemented += int(
                        m.sum() if prim is None else (m & prim).sum()
                    )
                fm = m & asf
                bm = m & ~asf
                if fm.any():
                    _record_removals(astats.front, rem[fm], err[fm])
                if bm.any():
                    _record_removals(astats.back, rem[bm], err[bm])
                    _record_adjacent(astats.back, adj[bm])
    if written_lengths is not None:
        _record_written(written_lengths, 1, hist=stats["written_lengths"])
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


def _setup_device(*sides, extra_tasks=()):
    """Build one engine for each (stages, filters) of ``sides``, all on
    one device: CUTADAPT_TPU_TORCH_DEVICE, unset meaning CUDA. On CUDA,
    pin the device index, then warm every engine, which builds the
    kernel library once, before any drive thread starts, and launches
    each lane of each kernel task once; ``extra_tasks`` are tasks that
    run outside the engines' stages (--pair-adapters, paired --revcomp).
    Failures raise DeviceError; there is no fallback to the host path
    from here."""
    import torch

    from .batch_pipeline import BatchPipelineEngine
    from .ops.align_cuda import resolve_device

    name = os.environ.get("CUTADAPT_TPU_TORCH_DEVICE") or "cuda"
    try:
        device = resolve_device(name)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        engines = [
            BatchPipelineEngine(stages, filters, device=device)
            for stages, filters in sides
        ]
        if device.type == "cuda":
            with torch.cuda.device(device):
                for engine in engines:
                    engine.warmup(engine.length_bucket)
                if extra_tasks:
                    engines[0].warmup(engines[0].length_bucket,
                                      tasks=extra_tasks)
    except (RuntimeError, ValueError) as e:
        raise DeviceError(
            f"the GPU engine could not start: {e} (set "
            "CUTADAPT_TPU_TORCH_BATCH=0 for the host path)"
        ) from e
    return engines


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
    from .pipeline import PairedEndPipeline, SingleEndPipeline

    if os.environ.get("CUTADAPT_TPU_TORCH_BATCH") == "0":
        return None  # the host path by request, not a fallback
    if isinstance(pipeline, SingleEndPipeline):
        return _run_single(pipeline, infiles, progress)
    if isinstance(pipeline, PairedEndPipeline):
        return _run_paired(pipeline, infiles, progress)
    return _fallback(f"unsupported pipeline type {type(pipeline).__name__}")


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
    engine, = _setup_device((stages, filters))
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
    rc_stage = _revcomp_stage(stages)

    def render(chunk, ws, we, mask, stats, writes_fasta):
        if writes_fasta:
            if transform_mode is not None:
                rs, re_ = stats["remainder"]
                return assemble_fasta_transform(
                    chunk, ws, we, rs, re_, mask, transform_mode
                )
            if rc_stage is not None and not stats.get("rc_selected"):
                # each read's chosen orientation with the rc name
                # suffix, built once per chunk (filter outputs render
                # the same chunk)
                sel = stats.get("rc_fasta_selected")
                if sel is None:
                    sel = _select_rc_chunk(chunk, stats, rc_stage.suffix)
                    stats["rc_fasta_selected"] = sel
                return assemble_fasta_window(sel, ws, we, mask)
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
        if (rc_stage is not None and transform_mode is not None
                and "is_rc" in stats):
            # mask/lowercase under --revcomp: select each read's
            # orientation first; the remainder's read-relative
            # coordinates hold against the selected chunk
            chunk = _select_rc_chunk(chunk, stats, rc_stage.suffix)
            stats["rc_selected"] = True
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


# --- paired-end --------------------------------------------------------------


@dataclass
class PairedTranslation:
    """An eligible paired-end pipeline, translated for the engine."""

    stages1: list
    stages2: list
    cutters: list
    pair_filters: list  # (step, (kind, threshold) or None per side, mode)
    sink: object  # PairedEndSink
    pair_stage: object  # --pair-adapters: (tasks1, tasks2, modifier)
    rc_pair: object  # paired --revcomp: (stage1, stage2, modifier)
    post_stages: list  # host stages after the revcomp swap, per slot


def _translate_paired(pipeline, interleaved=False, fasta=False):
    """Map an eligible paired-end pipeline to per-side stage lists, pair
    filters and the paired adapter constructs, or raise _Refused. With
    FASTA input, outputs must be FASTA too and quality-reading stages
    and filters keep the run on the host path, which owns those errors.
    Demultiplexing, side files, --rename and the name edits are not
    ported yet."""
    from . import native
    from .batch_pipeline import (
        AdapterStage, AdapterTask, NEndStage, NextseqStage, PolyAStage,
        QualityStage,
    )
    from .io.fastq import (
        FastaWriter, FastqWriter, InterleavedSequenceWriter,
        PairedSequenceWriter,
    )
    from .modifiers import (
        PairedAdapterCutter, PairedEndModifierWrapper,
        PairedReverseComplementer,
    )
    from .steps import (
        CombinatorialDemultiplexer, InfoFileWriter, PairedDemultiplexer,
        PairedEndFilter, PairedEndSink, PairedInfoFileWriter,
        PairedSingleEndStep, RestFileWriter, WildcardFileWriter,
    )

    sub_classes = (FastaWriter,) if fasta else (FastqWriter, FastaWriter)

    def check_writer(w, what):
        if isinstance(w, PairedSequenceWriter):
            subs = (w._writer1, w._writer2)
        elif isinstance(w, InterleavedSequenceWriter):
            # either input arity: the drive interleaves the per-side
            # chunks when the input came as two files
            subs = (w._writer,)
        else:
            subs = (w,)
        for x in subs:
            if not isinstance(x, sub_classes):
                raise _Refused(
                    f"{what} writes {type(x).__name__}, which the engine "
                    f"does not assemble{' from FASTA input' if fasta else ''}"
                )

    stages1, stages2 = [], []
    cutters = [None, None]
    pair_stage = None
    rc_pair = None
    post_stages = [[], []]
    for mod in pipeline._modifiers:
        if pair_stage is not None:
            raise _Refused(
                f"modifier {type(mod).__name__} after --pair-adapters has "
                "no engine form"
            )
        if isinstance(mod, PairedReverseComplementer):
            if rc_pair is not None or cutters != [None, None]:
                raise _Refused("a second adapter-cutting stage is not "
                               "ported yet")
            rc_stages = []
            for c in (mod.adapter_cutter1, mod.adapter_cutter2):
                if c is None:
                    rc_stages.append(None)
                    continue
                if c.action not in _RC_ACTIONS:
                    raise _Refused(
                        f"--revcomp with the adapter action {c.action!r} "
                        "has no engine form"
                    )
                if c.action in _TRANSFORM_MODES and not native.AVAILABLE:
                    raise _Refused(
                        f"the adapter action {c.action!r} needs the native "
                        "host library, which did not build"
                    )
                rc_stages.append(AdapterStage(
                    _translate_tasks(c), times=c.times, modifier=c,
                    action=c.action,
                ))
            rc_pair = (rc_stages[0], rc_stages[1], mod)
            continue
        if isinstance(mod, PairedAdapterCutter):
            if cutters != [None, None] or rc_pair is not None:
                raise _Refused("a second adapter-cutting stage is not "
                               "ported yet")
            if mod.action not in ("trim", None, "retain"):
                raise _Refused(
                    f"--pair-adapters with the adapter action "
                    f"{mod.action!r} has no engine form"
                )
            tasks = [[], []]
            for side, adapters in enumerate(zip(*mod._adapter_pairs)):
                for i, a in enumerate(adapters):
                    kind = _task_kind(a)
                    if kind in ("linked", "indexed_prefix", "indexed_suffix"):
                        raise _Refused(
                            f"--pair-adapters with {kind} adapters has no "
                            "engine form"
                        )
                    tasks[side].append(AdapterTask(a, kind, i))
            pair_stage = (tasks[0], tasks[1], mod)
            continue
        if not isinstance(mod, PairedEndModifierWrapper):
            raise _Refused(
                f"modifier {type(mod).__name__} is not ported to the GPU "
                "engine yet"
            )
        for side, m in enumerate((mod._modifier1, mod._modifier2)):
            if m is None:
                continue
            stage, stage_cutter = _translate_modifier(
                m, cutters[side] is not None or rc_pair is not None
            )
            if rc_pair is not None:
                # stages after the swap apply to the mixed output slots;
                # under a mask/lowercase rc action --trim-n and --poly-a
                # would have to read the transformed bytes, which the
                # engine's window stages do not
                if (rc_pair[side] is not None
                        and rc_pair[side].action in _TRANSFORM_MODES
                        and isinstance(stage, (NEndStage, PolyAStage))):
                    raise _Refused(
                        f"{type(m).__name__} after a mask/lowercase "
                        "--revcomp has no engine form"
                    )
                post_stages[side].append(stage)
                continue
            if stage_cutter is not None:
                cutters[side] = stage_cutter
            (stages1 if side == 0 else stages2).append(stage)
    for st in (stages1, stages2):
        _check_last_stage(st)
    if fasta:
        if any(isinstance(s, (QualityStage, NextseqStage))
               for st in (stages1, stages2, *post_stages) for s in st):
            raise _Refused("quality trimming of FASTA input has no engine "
                           "form")
        for st in (stages1, stages2):
            rc_st = _revcomp_stage(st)
            if rc_st is not None:
                # FASTA chunks alias quality offsets to the sequence
                rc_st.has_quals = False

    pair_filters = []
    sink = None
    for step in pipeline._steps:
        inner = step._step if isinstance(step, PairedSingleEndStep) else None
        if isinstance(step, PairedInfoFileWriter) or isinstance(
            inner, (RestFileWriter, InfoFileWriter, WildcardFileWriter)
        ):
            name = type(step if inner is None else inner).__name__
            raise _Refused(f"side files ({name}) are not ported to the GPU "
                           "engine yet")
        if isinstance(step, (PairedDemultiplexer, CombinatorialDemultiplexer)):
            raise _Refused(f"demultiplexing ({type(step).__name__}) is not "
                           "ported to the GPU engine yet")
        if sink is not None:
            raise _Refused(f"step {type(step).__name__} after the sink")
        if isinstance(step, PairedEndSink):
            check_writer(step.writer, "the output")
            sink = step
            continue
        if not isinstance(step, PairedEndFilter):
            raise _Refused(
                f"step {type(step).__name__} is not ported to the GPU "
                "engine yet"
            )
        if step.writer is not None:
            check_writer(step.writer, "a routed filter output")
        t1, t2 = (
            _translate_predicate(p) if p is not None else None
            for p in (step.predicate1, step.predicate2)
        )
        if t1 is None and t2 is None:
            raise _Refused("a pair filter without a predicate has no engine "
                           "form")
        if fasta and any(t is not None and t[0] in _QUALITY_FILTERS
                         for t in (t1, t2)):
            raise _Refused(f"filter {(t1 or t2)[0]} needs qualities (FASTA "
                           "input)")
        pair_filters.append((step, t1, t2, step._pair_filter_mode))
    if sink is None:
        raise _Refused("the pipeline ends without a sink")
    return PairedTranslation(
        stages1, stages2, cutters, pair_filters, sink, pair_stage, rc_pair,
        post_stages,
    )


def _apply_match_windows(task, action, ws, we, hit, qs, qe):
    """Window update for one task's matches (the math of the engine's
    _adapter_round). Returns per-hit (as_front, removed, adjacent
    position relative to the read)."""
    cur_len = (we[hit] - ws[hit]).astype(np.int32)
    if task.trim == "before":
        as_front = np.ones(len(hit), bool)
    elif task.trim == "after":
        as_front = np.zeros(len(hit), bool)
    else:  # anywhere
        as_front = qs == 0
    removed = np.where(as_front, qe, cur_len - qs)
    adj_rel = ws[hit] + qs - 1
    if action == "retain":
        fr = hit[as_front]
        ws[fr] = ws[fr] + qs[as_front]
        bk = hit[~as_front]
        we[bk] = ws[bk] + qe[~as_front]
    elif action == "trim":
        fr = hit[as_front]
        ws[fr] = ws[fr] + qe[as_front]
        bk = hit[~as_front]
        we[bk] = ws[bk] + qs[~as_front]
    # action None: windows untouched
    return as_front, removed, adj_rel


def _pair_match(engines, chunks, windows, pair_stage, stats_pair=None):
    """--pair-adapters: adapter pair i matches iff it matches both
    reads; the pair with the highest total score wins (ties: fewer total
    errors, then the earlier pair), PairedAdapterCutter semantics
    (reference modifiers.py:412-503). Every pair's tasks dispatch on
    both sides before any result is read. Mutates both sides' windows,
    credits the statistics and returns the matched mask; with
    ``stats_pair``, each side's stats get the winning pair index per
    read (-1 where none) as last_adapter_gid."""
    tasks_by_side, mod = pair_stage[:2], pair_stage[2]
    n = chunks[0].n_records
    n_pairs = len(tasks_by_side[0])
    disp = [[None] * n_pairs, [None] * n_pairs]
    for side in (0, 1):
        eng, chunk = engines[side], chunks[side]
        ws, we = windows[side]
        lens = (we - ws).astype(np.int32)
        width = eng._bucket_length(int(lens.max()) if n else 0)
        starts = (chunk.seq_start + ws).astype(np.int64)
        for t in range(n_pairs):
            disp[side][t] = (
                eng._dispatch_windows(
                    tasks_by_side[side][t], chunk, starts, lens, width
                ),
                lens,
            )
    results = [[None] * n_pairs, [None] * n_pairs]
    for side in (0, 1):
        for t in range(n_pairs):
            (sel, futures), lens = disp[side][t]
            out = [np.zeros(n, bool)] + [np.zeros(n, np.int32)
                                         for _ in range(4)]
            if len(sel):
                got = engines[side]._fetch_windows(
                    tasks_by_side[side][t], sel, futures, lens
                )
                for arr, g in zip(out, got):
                    arr[sel] = g
            results[side][t] = out  # found, qstart, qstop, errors, score

    best = np.full(n, -1, np.int32)
    best_sc = np.zeros(n, np.int32)
    best_er = np.zeros(n, np.int32)
    for t in range(n_pairs):
        f1, _, _, er1, sc1 = results[0][t]
        f2, _, _, er2, sc2 = results[1][t]
        sc = sc1 + sc2
        er = er1 + er2
        better = (f1 & f2) & (
            (best == -1) | (sc > best_sc) | ((sc == best_sc) & (er < best_er))
        )
        best[better] = t
        best_sc[better] = sc[better]
        best_er[better] = er[better]

    matched = best >= 0
    if stats_pair is not None:
        for stats in stats_pair:
            stats["last_adapter_gid"] = best
    mod.with_adapters += int(matched.sum())
    for side in (0, 1):
        chunk = chunks[side]
        ws, we = windows[side]
        for t in range(n_pairs):
            hit = np.flatnonzero(best == t)
            if len(hit) == 0:
                continue
            task = tasks_by_side[side][t]
            _, qs, qe, er, _ = results[side][t]
            as_front, removed, adj_rel = _apply_match_windows(
                task, mod.action, ws, we, hit, qs[hit], qe[hit]
            )
            astats = mod.adapter_statistics[side][task.adapter]
            adjacent = np.where(
                ~as_front & (qs[hit] > 0),
                chunk.buf[np.clip(chunk.seq_start[hit] + adj_rel, 0, None)],
                0,
            )
            e_hit = er[hit]
            if as_front.any():
                _record_removals(
                    astats.front, removed[as_front], e_hit[as_front]
                )
            bk = ~as_front
            if bk.any():
                _record_removals(astats.back, removed[bk], e_hit[bk])
                _record_adjacent(astats.back, adjacent[bk])
    return matched


def _interleave_chunks(c1, c2):
    """A ParsedChunk alternating the records of two chunks of the same
    length (R1 in even, R2 in odd slots), for the interleaved writer
    when the per-side chunks were replaced or came from two files."""
    from .io.chunks import ParsedChunk

    off = len(c1.buf)
    buf = np.concatenate([c1.buf, c2.buf])
    n = c1.n_records

    def ilv(a1, a2, shift=0):
        out = np.empty(2 * n, a1.dtype)
        out[0::2] = a1
        out[1::2] = a2 + shift
        return out

    return ParsedChunk(
        buf,
        ilv(c1.head_start, c2.head_start, off),
        ilv(c1.head_end, c2.head_end, off),
        ilv(c1.seq_start, c2.seq_start, off),
        ilv(c1.seq_len, c2.seq_len),
        ilv(c1.qual_start, c2.qual_start, off),
        has_cr=c1.has_cr or c2.has_cr,
    )


def _select_paired_chunk(
    chunk_a, off_a, chunk_b, off_b, combined, swap, suffix
):
    """A ParsedChunk over the concatenated buffers ``combined`` that
    takes record i from chunk_b where swap[i] (the R1/R2 exchange of the
    paired --revcomp, or a read's rc copy), appending ``suffix`` to the
    headers of swapped records. off_a/off_b locate each source buffer
    inside ``combined``."""
    from .io.chunks import ParsedChunk, _scatter_ranges

    hs = np.where(swap, chunk_b.head_start + off_b, chunk_a.head_start + off_a)
    he = np.where(swap, chunk_b.head_end + off_b, chunk_a.head_end + off_a)
    ss = np.where(swap, chunk_b.seq_start + off_b, chunk_a.seq_start + off_a)
    sl = np.where(swap, chunk_b.seq_len, chunk_a.seq_len).astype(np.int32)
    qs = np.where(swap, chunk_b.qual_start + off_b, chunk_a.qual_start + off_a)
    buf = combined
    if suffix and swap.any():
        sfx = np.frombuffer(suffix.encode("latin-1"), np.uint8)
        base_len = he - hs
        new_len = base_len + np.where(swap, len(sfx), 0)
        ends = np.cumsum(new_len)
        new_hs = ends - new_len
        heads = np.empty(int(ends[-1]) if len(ends) else 0, np.uint8)
        _scatter_ranges(heads, new_hs, hs, base_len, combined)
        tail = new_hs + base_len
        for k, byte in enumerate(sfx):
            heads[(tail + k)[swap]] = byte
        base = len(combined)
        buf = np.concatenate([combined, heads])
        hs, he = base + new_hs, base + ends
    return ParsedChunk(buf, hs, he, ss, sl, qs)


def _select_rc_chunk(chunk, stats, suffix):
    """Each read of a --revcomp chunk in its chosen orientation
    (``stats["is_rc"]``), the rc ones with ``suffix`` on their name."""
    rc = stats["rc_chunk"]
    return _select_paired_chunk(
        chunk, 0, rc, len(chunk.buf), np.concatenate([chunk.buf, rc.buf]),
        stats["is_rc"], suffix or "",
    )


def _run_rc_pair(engines, rc_pair, chunks, windows):
    """--revcomp on paired data: match (R1 -> cutter1, R2 -> cutter2)
    and the swapped orientation (R2 -> cutter1, R1 -> cutter2), keep
    whichever scores strictly higher (PairedReverseComplementer,
    reference modifiers.py:311-405). The first slot's runs dispatch on
    engines[0], the second slot's on engines[1], from the drive's emit
    thread. Credits the modifiers' statistics for the winning
    orientation and returns (slot chunks, slot windows ws1, we1, ws2,
    we2, matched masks, last-match adapter ids per slot, and the action
    with each slot's remainder for the mask/lowercase actions)."""
    stage1, stage2, mod = rc_pair
    c1, c2 = chunks
    (ws1, we1), (ws2, we2) = windows
    B = c1.n_records

    def run(engine, stage, chunk, ws, we):
        ws, we = ws.copy(), we.copy()
        gid = np.full(B, -1, np.int32)
        score = np.zeros(B, np.int32)
        if stage is None:
            return np.zeros(B, bool), [], ws, we, score, gid
        width = engine._bucket_length(int((we - ws).max()) if B else 0)
        matched, events = engine._run_rounds(
            stage, chunk, ws, we, width, None, gid, score
        )
        return matched, events, ws, we, score, gid

    # orientation A: slots follow the physical sides; B: sides swapped
    a1 = run(engines[0], stage1, c1, ws1, we1)
    a2 = run(engines[1], stage2, c2, ws2, we2)
    b1 = run(engines[0], stage1, c2, ws2, we2)
    b2 = run(engines[1], stage2, c1, ws1, we1)
    use_rc = (b1[4] + b2[4]) > (a1[4] + a2[4])

    mod.reverse_complemented += int(use_rc.sum())
    for stage, straight, swapped in ((stage1, a1, b1), (stage2, a2, b2)):
        if stage is None:
            continue
        cutter = stage.modifier
        cutter.with_adapters += int(
            np.where(use_rc, swapped[0], straight[0]).sum()
        )
        for result, mask in ((straight, ~use_rc), (swapped, use_rc)):
            for ev in result[1]:
                sel = mask[ev["reads"]]
                if not sel.any():
                    continue
                task = stage.tasks[ev["task"]]
                reads = ev["reads"][sel]
                rem = ev["removed"][sel]
                err = ev["errors"][sel]
                asf = np.asarray(ev["as_front"][sel], bool)
                adj = ev["adjacent"][sel]
                sub = ev["sub"][sel]
                prim = (
                    np.asarray(ev["primary"], bool)[sel]
                    if "primary" in ev else None
                )
                for s in np.unique(sub):
                    m = sub == s
                    astats = cutter.adapter_statistics[task.adapters[int(s)]]
                    astats.reverse_complemented += int(
                        use_rc[reads[m if prim is None else (m & prim)]].sum()
                    )
                    fm = m & asf
                    bm = m & ~asf
                    if fm.any():
                        _record_removals(astats.front, rem[fm], err[fm])
                    if bm.any():
                        _record_removals(astats.back, rem[bm], err[bm])
                        _record_adjacent(astats.back, adj[bm])

    combined = np.concatenate([c1.buf, c2.buf])
    off2 = len(c1.buf)
    suffix = mod._suffix or ""
    slot1 = _select_paired_chunk(c1, 0, c2, off2, combined, use_rc, suffix)
    slot2 = _select_paired_chunk(c2, off2, c1, 0, combined, use_rc, suffix)
    action = next(
        (s.action for s in (stage1, stage2) if s is not None), "trim"
    )
    keep_windows = action in (None, "mask", "lowercase")

    def slot_windows(straight, swapped, entry_straight, entry_swapped):
        """Output windows and transform remainder of one slot: trim
        emits the trimmed windows; the window-keeping actions emit the
        chosen orientation's input extent, with the trimmed windows as
        the remainder."""
        t_ws = np.where(use_rc, swapped[2], straight[2])
        t_we = np.where(use_rc, swapped[3], straight[3])
        if not keep_windows:
            return t_ws, t_we, None
        ws = np.where(use_rc, entry_swapped[0], entry_straight[0])
        we = np.where(use_rc, entry_swapped[1], entry_straight[1])
        return ws, we, (t_ws, t_we)

    o_ws1, o_we1, rem1 = slot_windows(a1, b1, (ws1, we1), (ws2, we2))
    o_ws2, o_we2, rem2 = slot_windows(a2, b2, (ws2, we2), (ws1, we1))
    return (
        slot1, slot2, o_ws1, o_we1, o_ws2, o_we2,
        np.where(use_rc, b1[0], a1[0]), np.where(use_rc, b2[0], a2[0]),
        np.where(use_rc, b1[5], a1[5]), np.where(use_rc, b2[5], a2[5]),
        (action, rem1, rem2),
    )


def _apply_post_stages(engine, post_stages, chunk, ws, we):
    """Host stages that run after the paired --revcomp swap, on a slot
    whose reads may come from either side; folds their counters into
    the modifiers directly."""
    stats = {}
    for si, stage in enumerate(post_stages):
        ws, we = engine._apply_host_stage(si, stage, chunk, ws, we, stats)
    for si, trimmed in stats.get("quality_trimmed", {}).items():
        post_stages[si].modifier.trimmed_bases += trimmed
    for si, removed in stats.get("poly_a_removed", {}).items():
        mod = post_stages[si].modifier
        for length, count in enumerate(np.bincount(removed)):
            if count:
                mod.trimmed_bases[int(length)] += int(count)
    return ws, we


def _make_side_render(stages_s, assemble_s, writes_fasta):
    """Per-side record renderer of one paired output: FASTQ through the
    side's stage assembler; FASTA plain or with the mask/lowercase
    transform (of the side's stage, or published in the stats by the
    paired --revcomp)."""
    if not writes_fasta:
        return assemble_s
    from .io.chunks import assemble_fasta_transform, assemble_fasta_window

    tm_static = _TRANSFORM_MODES.get(_transform_action(stages_s))

    def render(c, ws, we, m, st):
        tm = tm_static or _TRANSFORM_MODES.get(st.get("transform_action"))
        if tm is not None:
            rs, re_ = st["remainder"]
            return assemble_fasta_transform(c, ws, we, rs, re_, m, tm)
        return assemble_fasta_window(c, ws, we, m)

    return render


def _pair_condition(t, chunk, ws, we, lengths, matched, stats):
    """One side's predicate of a pair filter; under a mask action the
    host predicate sees the masked read (filter_condition adjusts the N
    count by the remainder)."""
    from .batch_pipeline import filter_condition

    kind, thr = t
    mask_rem = (
        stats["remainder"] if stats.get("transform_action") == "mask"
        else None
    )
    return filter_condition(kind, thr, chunk, ws, we, lengths, matched,
                            mask_remainder=mask_rem)


def _slice_parsed(parsed, sl):
    """A ParsedChunk over a subset of records (shared buffer); the
    offset arrays are copied contiguous for the native ops' pointers."""
    from .io.chunks import ParsedChunk

    return ParsedChunk(
        parsed.buf,
        np.ascontiguousarray(parsed.head_start[sl]),
        np.ascontiguousarray(parsed.head_end[sl]),
        np.ascontiguousarray(parsed.seq_start[sl]),
        np.ascontiguousarray(parsed.seq_len[sl]),
        np.ascontiguousarray(parsed.qual_start[sl]),
        has_cr=parsed.has_cr,
    )


def _interleaved_parsed_chunks(file, size, fasta=False):
    """Yield ParsedChunks of whole pairs from an interleaved FASTQ or
    FASTA file (an odd record is carried to the next chunk); an odd
    trailing record raises the host reader's exact error (io/fastq.py
    InterleavedSequenceReader)."""
    from .io.chunks import parse_fasta_chunk, parse_fastq_chunk
    from .io.fastq import read_chunks
    from .io.records import FileFormatError

    leftover = b""
    line = 0  # absolute line number for FASTA format errors
    for data in read_chunks(file, size):
        if leftover:
            data = leftover + bytes(data)
            leftover = b""
        if fasta:
            parsed = parse_fasta_chunk(data, first_line=line)
        else:
            parsed = parse_fastq_chunk(data)
        nrec = parsed.n_records
        if nrec % 2:
            # carve the odd record off: head_start - 1 is its '>'/'@'
            cut = int(parsed.head_start[nrec - 1]) - 1
            leftover = bytes(memoryview(data)[cut:])
            parsed = _slice_parsed(parsed, slice(0, nrec - 1))
        if fasta:
            consumed = len(data) - len(leftover)
            line += int(
                (np.frombuffer(data, np.uint8)[:consumed] == 10).sum()
            )
        if parsed.n_records:
            yield parsed
    if leftover:
        if fasta:
            last = parse_fasta_chunk(leftover, first_line=line)
        else:
            last = parse_fastq_chunk(leftover)
        name = bytes(
            last.buf[last.head_start[0] : last.head_end[0]]
        ).decode("latin-1")
        raise FileFormatError(
            "Interleaved input file incomplete: last record "
            f"'{name}' has no partner.",
            line=None,
        )


def _run_paired(pipeline, infiles, progress) -> Optional[Statistics]:
    from . import native

    interleaved_in = infiles.interleaved
    if interleaved_in:
        if len(infiles._files) != 1:
            return _fallback("interleaved input with multiple files")
        f1, f2 = infiles._files[0], None
    else:
        if len(infiles._files) != 2:
            return _fallback("paired pipeline without exactly two input "
                             "files")
        f1, f2 = infiles._files
    fmt1 = _input_format(f1)
    if interleaved_in:
        if fmt1 not in ("fastq", "fasta"):
            return _fallback("interleaved input is not parseable FASTQ/FASTA")
    elif fmt1 not in ("fastq", "fasta") or _input_format(f2) != fmt1:
        return _fallback("paired inputs are not matching FASTQ/FASTA files")
    if not native.AVAILABLE:
        return _fallback("the paired name check needs the native host "
                         "library, which did not build")
    fasta_in = fmt1 == "fasta"
    try:
        translated = _translate_paired(pipeline, interleaved_in,
                                       fasta=fasta_in)
    except _Refused as e:
        return _fallback(str(e))
    stages1, stages2 = translated.stages1, translated.stages2
    cutters, pair_filters = translated.cutters, translated.pair_filters
    sink, pair_stage = translated.sink, translated.pair_stage
    rc_pair, post_stages = translated.rc_pair, translated.post_stages
    extra_tasks = []
    if pair_stage is not None:
        extra_tasks = pair_stage[0] + pair_stage[1]
    elif rc_pair is not None:
        extra_tasks = [t for st in rc_pair[:2] if st is not None
                       for t in st.tasks]
    RUN_TIMES.update(start=time.perf_counter(), device_ready=None,
                     first_submit=None)
    # two engines, one per side, on one device; the pair filters run in
    # emit, so neither engine filters
    engine1, engine2 = _setup_device(
        (stages1, ()), (stages2, ()), extra_tasks=extra_tasks
    )
    RUN_TIMES["device_ready"] = time.perf_counter()

    from .io.chunks import (
        assemble_fasta_transform, assemble_fasta_window, assemble_window,
        parse_fasta_chunk, parse_fastq_chunk,
    )
    from .io.fastq import (
        FastaWriter, InterleavedSequenceWriter, read_paired_chunks,
    )
    from .io.records import FileFormatError, record_names_match

    assemble1 = _stages_assembler(stages1)
    assemble2 = _stages_assembler(stages2)
    rc_side_stages = (_revcomp_stage(stages1), _revcomp_stage(stages2))
    any_inter_filter = any(
        isinstance(step.writer, InterleavedSequenceWriter)
        for step, _t1, _t2, _m in pair_filters
    )

    def side_renders(writer):
        return (
            _make_side_render(stages1, assemble1,
                              isinstance(writer._writer1, FastaWriter)),
            _make_side_render(stages2, assemble2,
                              isinstance(writer._writer2, FastaWriter)),
        )

    inter_out = None
    inter_fasta = False
    if isinstance(sink.writer, InterleavedSequenceWriter):
        inter_out = sink.writer._writer._file
        inter_fasta = isinstance(sink.writer._writer, FastaWriter)
    else:
        out1 = sink.writer._writer1._file
        out2 = sink.writer._writer2._file
        render1, render2 = side_renders(sink.writer)
    filter_renders = [
        side_renders(step.writer)
        if step.writer is not None
        and not isinstance(step.writer, InterleavedSequenceWriter)
        else None
        for step, _t1, _t2, _m in pair_filters
    ]
    n = 0
    bp1 = 0
    bp2 = 0
    wl = sink._statistics

    def check_names(p1, p2):
        if p1.n_records != p2.n_records:
            more = 1 if p1.n_records > p2.n_records else 2
            raise FileFormatError(
                "Reads are improperly paired. There are more reads in "
                f"file {more} than in file {3 - more}.",
                line=None,
            )
        bad = native.check_pair_names(
            p1.buf, p1.head_start, p1.head_end,
            p2.buf, p2.head_start, p2.head_end,
        )
        if bad < 0:
            return
        name1 = bytes(
            p1.buf[p1.head_start[bad] : p1.head_end[bad]]
        ).decode("latin-1")
        name2 = bytes(
            p2.buf[p2.head_start[bad] : p2.head_end[bad]]
        ).decode("latin-1")
        # the C check takes the ID from position 0, Python's split()
        # skips leading whitespace: reconfirm before raising
        if record_names_match(name1, name2):
            return
        if interleaved_in:
            raise FileFormatError(
                "Reads are improperly paired. Read name "
                f"'{name1}' does not match '{name2}'.",
                line=None,
            )
        raise FileFormatError(
            "Reads are improperly paired. Read name "
            f"'{name1}' in file 1 does not match '{name2}' in file 2.",
            line=None,
        )

    def interleave_write(dest, full, ws1, we1, ws2, we2, mask, out_fasta,
                         st1, st2):
        N2 = full.n_records
        wsa = np.empty(N2, np.int32)
        wea = np.empty(N2, np.int32)
        kp = np.empty(N2, bool)
        wsa[0::2], wsa[1::2] = ws1, ws2
        wea[0::2], wea[1::2] = we1, we2
        kp[0::2] = kp[1::2] = mask
        tm = _TRANSFORM_MODES.get(
            st1.get("transform_action") or st2.get("transform_action")
        )
        if tm is None:
            asm = assemble_fasta_window if out_fasta else assemble_window
            dest.write(asm(full, wsa, wea, kp))
            return
        # mask/lowercase: interleave each side's remainder (a side
        # without an adapter stage masks nothing: its remainder is its
        # whole window)
        rsa = np.empty(N2, np.int32)
        rea = np.empty(N2, np.int32)
        rsa[0::2], rea[0::2] = st1.get("remainder", (ws1, we1))
        rsa[1::2], rea[1::2] = st2.get("remainder", (ws2, we2))
        if out_fasta:
            dest.write(assemble_fasta_transform(full, wsa, wea, rsa, rea,
                                                kp, tm))
        else:
            dest.write(_assemble_transform(
                full, wsa, wea, kp, {"remainder": (rsa, rea)}, tm
            ))

    def emit(item):
        nonlocal n, bp1, bp2
        pend1, pend2, full = item
        ws1, we1, _, stats1 = engine1.collect(pend1)
        ws2, we2, _, stats2 = engine2.collect(pend2)
        c = [pend1.parsed, pend2.parsed]
        # per-side rc stages (a ReverseComplementer on one side, built
        # through the API): each side's chosen orientation, before
        # anything downstream reads its bytes
        for side, (rc_st, st) in enumerate(
            zip(rc_side_stages, (stats1, stats2))
        ):
            if rc_st is not None and "is_rc" in st:
                c[side] = _select_rc_chunk(c[side], st, rc_st.suffix)
                st["rc_selected"] = True
        c1, c2 = c
        m1 = stats1["matched_mask"]
        m2 = stats2["matched_mask"]
        if pair_stage is not None:
            m1 = m2 = _pair_match(
                (engine1, engine2), (c1, c2), ((ws1, we1), (ws2, we2)),
                pair_stage, stats_pair=(stats1, stats2),
            )
        elif rc_pair is not None:
            (c1, c2, ws1, we1, ws2, we2, m1, m2, gid1, gid2,
             (rc_action, rem1, rem2)) = _run_rc_pair(
                (engine1, engine2), rc_pair, (c1, c2),
                ((ws1, we1), (ws2, we2)),
            )
            stats1["last_adapter_gid"] = gid1
            stats2["last_adapter_gid"] = gid2
            if rem1 is not None and rc_action is not None:
                # mask/lowercase: the renders and the mask N count read
                # the remainder and the action from the stats
                stats1["remainder"], stats2["remainder"] = rem1, rem2
                stats1["transform_action"] = rc_action
                stats2["transform_action"] = rc_action
            ws1, we1 = _apply_post_stages(
                engine1, post_stages[0], c1, ws1, we1
            )
            ws2, we2 = _apply_post_stages(
                engine2, post_stages[1], c2, ws2, we2
            )
        if (inter_out is not None or any_inter_filter) and (
            full is None or c1 is not pend1.parsed or c2 is not pend2.parsed
        ):
            # the interleaved writer slices a combined chunk: rebuild it
            # when the input came as two files or a side was replaced
            full = _interleave_chunks(c1, c2)
        len1 = we1 - ws1
        len2 = we2 - ws2
        keep = np.ones(c1.n_records, bool)
        for (step, t1, t2, mode), renders in zip(
            pair_filters, filter_renders
        ):
            if t2 is None:
                drop = _pair_condition(t1, c1, ws1, we1, len1, m1, stats1)
            elif t1 is None:
                drop = _pair_condition(t2, c2, ws2, we2, len2, m2, stats2)
            else:
                d1 = _pair_condition(t1, c1, ws1, we1, len1, m1, stats1)
                if mode == "first":
                    drop = d1
                else:
                    d2 = _pair_condition(t2, c2, ws2, we2, len2, m2, stats2)
                    drop = d1 | d2 if mode == "any" else d1 & d2
            newly = drop & keep
            _record_filtered(step, newly)
            if step.writer is not None and newly.any():
                if renders is None:
                    interleave_write(
                        step.writer._writer._file, full, ws1, we1, ws2,
                        we2, newly,
                        isinstance(step.writer._writer, FastaWriter),
                        stats1, stats2,
                    )
                else:
                    step.writer._writer1._file.write(
                        renders[0](c1, ws1, we1, newly, stats1))
                    step.writer._writer2._file.write(
                        renders[1](c2, ws2, we2, newly, stats2))
            keep &= ~drop
        if inter_out is not None:
            interleave_write(inter_out, full, ws1, we1, ws2, we2, keep,
                             inter_fasta, stats1, stats2)
        else:
            out1.write(render1(c1, ws1, we1, keep, stats1))
            out2.write(render2(c2, ws2, we2, keep, stats2))
        _record_written(wl, 1, values=len1[keep])
        _record_written(wl, 2, values=len2[keep])
        bp1 += _apply_side_stats(stats1, stages1, cutters[0], None)
        bp2 += _apply_side_stats(stats2, stages2, cutters[1], None)
        n += stats1["n"]
        if progress is not None:
            progress.update(stats1["n"])

    def chunk_pairs():
        if interleaved_in:
            for full in _interleaved_parsed_chunks(
                f1, _chunk_bytes(), fasta=fasta_in
            ):
                yield (
                    _slice_parsed(full, slice(0, None, 2)),
                    _slice_parsed(full, slice(1, None, 2)),
                    full,
                )
        elif fasta_in:
            lines = [0, 0]
            for d1, d2 in read_paired_chunks(f1, f2, _chunk_bytes()):
                p1 = parse_fasta_chunk(d1, first_line=lines[0])
                p2 = parse_fasta_chunk(d2, first_line=lines[1])
                lines[0] += int((np.frombuffer(d1, np.uint8) == 10).sum())
                lines[1] += int((np.frombuffer(d2, np.uint8) == 10).sum())
                yield p1, p2, None
        else:
            for d1, d2 in read_paired_chunks(f1, f2, _chunk_bytes()):
                yield parse_fastq_chunk(d1), parse_fastq_chunk(d2), None

    def submit_pair(item):
        p1, p2, full = item
        check_names(p1, p2)
        if RUN_TIMES["first_submit"] is None:
            RUN_TIMES["first_submit"] = time.perf_counter()
        return engine1.submit(p1), engine2.submit(p2), full

    try:
        _pipelined_drive(
            chunk_pairs(), _on_device(submit_pair, engine1.device),
            _on_device(emit, engine1.device),
        )
    except NotImplementedError as e:
        raise DeviceError(
            f"the GPU engine cannot finish this input: {e}; run with "
            "CUTADAPT_TPU_TORCH_BATCH=0 to take the host path"
        ) from e
    infiles.close()
    if progress is not None:
        progress.close()
    return Statistics().collect(
        n, bp1, bp2, pipeline._modifiers, pipeline._steps
    )
