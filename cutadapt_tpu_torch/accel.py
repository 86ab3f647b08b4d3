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
--max-n, --max-ee, --max-aer and --discard-casava; the trailing name and
quality edits (--strip-suffix, --length-tag, -x/-y, --zero-cap) and
--rename; the side files (--rest-file, --info-file, --wildcard-file);
and demultiplexing by adapter name, with --untrimmed-output. Reads of
2**14 bp or more take the kernel's wide result; adapters that need more
than 16 query classes (16 or more distinct letters compared as ASCII,
such as ``-a ACGTRYKMXSWBDHVN -N``) its byte lane.

Paired-end (_run_paired): two files or one interleaved file of FASTQ or
FASTA, written as two files or interleaved; per side the same stages
(-a/-g/-b with -A/-G/-B, -q/-Q, -u/-U, -l/-L, --poly-a, per-side
revcomp stages built through the API), --pair-adapters, paired
--revcomp with the host stages after its swap, and the pair filters
(-m/-M per side, --max-n, --max-ee, --discard-(un)trimmed,
--pair-filter=any|both|first) with their routed paired outputs; per
side the trailing name edits and --zero-cap, a paired --rename, the
side files (R1's, and R2's --info-file-paired), and paired and
combinatorial demultiplexing. Two engines, one per side, share one
device; the pair filters, the pair match of --pair-adapters, the four
matching runs of the paired --revcomp and the demultiplexing routes run
in emit.

Everything else is refused in the translation, before an engine is
built, with a reason: the combinations the JAX package's engine refuses
too (a host stage after --revcomp, --rest-file with linked adapters, a
linked adapter whose parts have no task, ...).
A refused run is counted (:data:`FALLBACK_COUNT`) and
takes the per-read host path, or, under
``CUTADAPT_TPU_TORCH_BATCH=require``, fails with
:class:`BatchRequiredError`.

Environment (all read per run):

- ``CUTADAPT_TPU_TORCH_BATCH``: ``0`` is the host path, ``1`` or unset
  the engine, ``require`` the engine with refusals as errors;
- ``CUTADAPT_TPU_TORCH_DEVICE``: unset means CUDA; ``cpu`` runs the
  aligner's plain PyTorch version (the tests);
- ``CUTADAPT_TPU_TORCH_CHUNK_BYTES``: the size of the input chunks;
- ``CUTADAPT_TPU_TORCH_DEVICES``: the shard mesh (_setup_mesh): ``all``
  (the default) every visible card, ``1`` no mesh, ``N`` the first N
  cards, or under ``CUTADAPT_TPU_TORCH_DEVICE=cpu`` N shards of the CPU;
- ``CUTADAPT_TPU_TORCH_DEVICE_STATS``: the statistics reducer
  (_make_stats_reducer): unset means on exactly when a mesh is active,
  ``1`` on without one, ``0`` off.
- ``CUTADAPT_TPU_TORCH_DIST_COORDINATOR`` (``host:port``), with
  ``CUTADAPT_TPU_TORCH_DIST_NPROCS`` and ``_DIST_PID``: the opt-in
  process group of a sharded run (_maybe_init_distributed).

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

from . import tracing
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

    Traced (the tracing module), the drive is a ``drive`` span; its
    threads are the stages ``reader``, ``submit`` and ``emit``, and
    number the chunks from 0 in order. Each chunk's ``submit`` and
    ``emit`` span, each wait of the submit and writer threads for a
    chunk (``wait.parsed``, ``wait.emit``) and each chunk's time in a
    queue from its ``put`` to its ``get`` (``queue.parsed``,
    ``queue.emit``: a blocked put is inside it) are spans; the items
    travel with their queue span.
    """
    parsed_q: queue.Queue = queue.Queue(maxsize=depth)
    emit_q: queue.Queue = queue.Queue(maxsize=depth)
    failures = []

    def read_stage():
        tracing.set_stage("reader", 0)
        try:
            seq = 0
            for item in producer:  # chunk `seq` is read and parsed here
                parsed_q.put((item, tracing.begin("queue.parsed",
                                                  nest=False)))
                seq += 1
                tracing.set_chunk(seq)
                if failures:
                    break
        except BaseException as e:  # noqa: BLE001 - forwarded to caller
            failures.append(e)
        finally:
            parsed_q.put(_STAGE_END)

    def write_stage():
        tracing.set_stage("emit", 0)
        seq = 0
        while True:
            wait = tracing.begin("wait.emit")
            try:
                got = emit_q.get()
            finally:
                tracing.end(wait)
            if got is _STAGE_END:
                return
            pending, queued = got
            tracing.end(queued)
            if not failures:  # else drain without emitting
                span = tracing.begin("emit", cpu=True)
                try:
                    emit(pending)
                except BaseException as e:  # noqa: BLE001
                    failures.append(e)
                finally:
                    tracing.end(span)
            seq += 1
            tracing.set_chunk(seq)

    drive = tracing.begin("drive")
    reader = threading.Thread(target=read_stage, daemon=True)
    writer = threading.Thread(target=write_stage, daemon=True)
    reader.start()
    writer.start()
    try:
        tracing.set_stage("submit", 0)
        seq = 0
        while True:
            wait = tracing.begin("wait.parsed")
            try:
                got = parsed_q.get()
            finally:
                tracing.end(wait)
            if got is _STAGE_END:
                break
            item, queued = got
            tracing.end(queued)
            if failures:
                continue  # keep draining so the reader can finish
            span = tracing.begin("submit", cpu=True)
            try:
                pending = submit(item)
            except BaseException as e:  # noqa: BLE001
                failures.append(e)
                continue
            finally:
                tracing.end(span)
            emit_q.put((pending, tracing.begin("queue.emit", nest=False)))
            seq += 1
            tracing.set_chunk(seq)
    finally:
        tracing.set_stage("caller")
        emit_q.put(_STAGE_END)
        writer.join()
        # the reader stops after at most one more item (bounded queue)
        while reader.is_alive():
            try:
                parsed_q.get(timeout=0.05)
            except queue.Empty:
                pass
        reader.join()
        tracing.end(drive)
    if failures:
        raise failures[0]



@dataclass
class SingleTranslation:
    """An eligible single-end pipeline, translated for the engine."""

    stages: list
    filters: list
    cutter: object
    sink: object  # SingleEndSink or Demultiplexer
    rename: object  # trailing Renamer, if any
    side: dict  # rest/info/wildcard text files
    name_edits: list  # trailing name-edit ops, in order
    zero_cap: object  # ZeroCapper quality base, if any


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
            # a linked adapter whose parts have no task of their own
            raise _Refused(str(e)) from None
    return tasks


def _translate_modifier(mod, has_cutter):
    """Return (stage, cutter or None) for an eligible single-end
    modifier: a host stage, or the one adapter stage."""
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
    from .predicates import Predicate

    if not isinstance(pred, Predicate) or not pred.kind:
        raise _Refused(
            f"filter {type(pred).__name__} has no engine form"
        )
    return (pred.kind, pred.threshold)


def _split_edits(modifiers):
    """Split the trailing name and quality edits (SuffixRemover,
    LengthTagModifier, PrefixSuffixAdder, ZeroCapper) off a modifier
    list: (the window modifiers, the name-edit ops in order, the
    ZeroCapper's quality base or None). The CLI emits them after every
    window-changing modifier; one before a window modifier is refused."""
    from .modifiers import (
        LengthTagModifier, PrefixSuffixAdder, SuffixRemover, ZeroCapper,
    )

    edit_types = (SuffixRemover, LengthTagModifier, PrefixSuffixAdder,
                  ZeroCapper)
    split = next(
        (k for k, mod in enumerate(modifiers) if isinstance(mod, edit_types)),
        len(modifiers),
    )
    edits = []
    zero_cap = None
    for mod in modifiers[split:]:
        if not isinstance(mod, edit_types):
            raise _Refused(
                f"modifier {type(mod).__name__} after a name or quality "
                "edit has no engine form"
            )
        op = _edit_op(mod)
        if op is None:
            zero_cap = mod.quality_base
        else:
            edits.append(op)
    return modifiers[:split], edits, zero_cap


def _edit_op(mod):
    """The name-edit op of a SuffixRemover, LengthTagModifier or
    PrefixSuffixAdder; None for a ZeroCapper."""
    from .modifiers import LengthTagModifier, PrefixSuffixAdder, SuffixRemover

    if isinstance(mod, SuffixRemover):
        return ("strip", mod.suffix)
    if isinstance(mod, LengthTagModifier):
        return ("lentag", mod)
    if isinstance(mod, PrefixSuffixAdder):
        return ("presuf", mod.prefix, mod.suffix)
    return None


def _check_rename(rename_fields, stage_lists):
    """Refuse the --rename fields the engine cannot fill:
    {match_sequence} after a linked adapter (its events carry no single
    match geometry), and {cut_prefix}/{cut_suffix} when a -u cut follows
    another stage (cut bytes are recovered from the parsed read)."""
    from .batch_pipeline import CutStage

    if "match_sequence" in rename_fields and any(
        t.kind == "linked"
        for st in stage_lists for x in st if hasattr(x, "tasks")
        for t in x.tasks
    ):
        raise _Refused("--rename with {match_sequence} after a linked "
                       "adapter has no engine form")
    if {"cut_prefix", "cut_suffix"} & rename_fields:
        for st in stage_lists:
            past_cuts = False
            for stage in st:
                if isinstance(stage, CutStage):
                    if past_cuts:
                        raise _Refused(
                            "--rename with {cut_prefix}/{cut_suffix} and a "
                            "-u cut after another stage has no engine form"
                        )
                else:
                    past_cuts = True


def _has_linked(stages) -> bool:
    return any(
        t.kind == "linked" for st in stages if hasattr(st, "tasks")
        for t in st.tasks
    )


def _translate_single(pipeline, fasta: bool = False) -> SingleTranslation:
    """Map an eligible single-end host pipeline to the engine's stages,
    filters, cutter, sink or Demultiplexer, trailing name edits and
    --rename, and side files, or raise _Refused. Every writer must be a
    Fastq- or FastaWriter (FASTA input requires FASTA output: a FASTQ
    writer would raise on the host path, which must stay in charge of
    that error)."""
    from .batch_pipeline import FilterSpec
    from .io.fastq import FastaWriter, FastqWriter
    from .modifiers import Renamer
    from .steps import (
        Demultiplexer, InfoFileWriter, RestFileWriter, SingleEndFilter,
        SingleEndSink, WildcardFileWriter,
    )

    writer_classes = (FastaWriter,) if fasta else (FastqWriter, FastaWriter)

    def check_writer(w, what):
        if not isinstance(w, writer_classes):
            raise _Refused(
                f"{what} writes {type(w).__name__}, which the engine does "
                f"not assemble{' from FASTA input' if fasta else ''}"
            )

    from .batch_pipeline import NextseqStage, QualityStage

    modifiers = list(pipeline._modifiers)
    rename = None
    if modifiers and type(modifiers[-1]) is Renamer:
        rename = modifiers.pop()
    modifiers, name_edits, zero_cap = _split_edits(modifiers)
    stages = []
    cutter = None
    for mod in modifiers:
        stage, stage_cutter = _translate_modifier(mod, cutter is not None)
        cutter = stage_cutter or cutter
        stages.append(stage)
    if rename is not None:
        _check_rename(
            {text for is_field, text in rename._parts if is_field}, [stages]
        )
    _check_last_stage(stages)
    rc_stage = _revcomp_stage(stages)
    if fasta and rc_stage is not None:
        # FASTA chunks alias quality offsets to the sequence: the rc
        # copy must complement sequences only
        rc_stage.has_quals = False
    if fasta and (zero_cap is not None or any(
        isinstance(s, (QualityStage, NextseqStage)) for s in stages
    )):
        # FASTA carries no qualities: the host path owns that error
        raise _Refused("quality trimming or capping of FASTA input has no "
                       "engine form")

    filters = []
    sink = None
    side = {"rest": None, "info": None, "wildcard": None}
    for step in pipeline._steps:
        if sink is not None:
            raise _Refused(f"step {type(step).__name__} after the sink")
        if isinstance(step, (RestFileWriter, InfoFileWriter,
                             WildcardFileWriter)):
            # side-file rows come from the match events, before any
            # filter (the reference's step order); mask/lowercase record
            # the same match geometry, and under --revcomp the rows slice
            # the orientation-selected chunk
            if filters:
                raise _Refused("a side file after a filter has no engine "
                               "form")
            key = {InfoFileWriter: "info", WildcardFileWriter: "wildcard",
                   RestFileWriter: "rest"}[type(step)]
            if key == "info" and fasta:
                raise _Refused("--info-file of FASTA input has no engine "
                               "form (its rows hold qualities)")
            if key != "info" and _has_linked(stages):
                # the reference's rest()/wildcards() have no linked form:
                # the host path owns that failure
                raise _Refused(f"--{key}-file with linked adapters has no "
                               "engine form")
            if side[key] is not None:
                raise _Refused(f"a second --{key}-file has no engine form")
            side[key] = step._file
            continue
        if isinstance(step, SingleEndSink):
            check_writer(step.writer, "the output")
            sink = step
            continue
        if isinstance(step, Demultiplexer):
            if cutter is None:
                raise _Refused("demultiplexing without an adapter stage has "
                               "no engine form")
            for w in step._writers.values():
                check_writer(w, "a demultiplexed output")
            if step._untrimmed_writer is not None:
                check_writer(step._untrimmed_writer, "the untrimmed output")
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
    return SingleTranslation(stages, filters, cutter, sink, rename, side,
                             name_edits, zero_cap)


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


def _stats_reducer_on() -> bool:
    """Device-reduced statistics apply by themselves with an active
    shard mesh (each shard bins its own events, one sum across shards at
    fold); CUTADAPT_TPU_TORCH_DEVICE_STATS=1 forces them on one device,
    =0 disables them."""
    from .batch_pipeline import get_shard_mesh

    env = os.environ.get("CUTADAPT_TPU_TORCH_DEVICE_STATS")
    return env != "0" and (env == "1" or get_shard_mesh() is not None)


def _make_stats_reducer(device):
    """A DeviceStatsReducer on the active mesh, or on ``device`` without
    one, where _stats_reducer_on(); else None (the host-side fold). A
    ``reducer`` span."""
    span = tracing.begin("reducer")
    try:
        if not _stats_reducer_on():
            return None
        from .batch_pipeline import get_shard_mesh
        from .parallel.stats import DeviceStatsReducer

        return DeviceStatsReducer(get_shard_mesh(), device=device)
    finally:
        tracing.end(span)


def _parsed(parse, chunks):
    """Each of ``chunks`` through ``parse``, in a ``parse`` span."""
    for data in chunks:
        span = tracing.begin("parse", cpu=True)
        try:
            parsed = parse(data)
        finally:
            tracing.end(span)
        yield parsed


def _write(file, data) -> None:
    """One of emit's writes to an output file, in a ``write`` span."""
    span = tracing.begin("write")
    try:
        file.write(data)
    finally:
        tracing.end(span)


def _record_removals(end, removed, errors, reducer=None):
    """Fold a removal event batch into EndStatistics: through the device
    reducer when given, else on the host per unique (length, errors)."""
    if reducer is not None:
        def fold(hist, end=end):
            for ln, er in zip(*np.nonzero(hist)):
                end.record_removal(int(ln), int(er), int(hist[ln, er]))

        reducer.add_hist2d(("rm", id(end)), removed, errors, fold)
        return
    base = int(errors.max(initial=0)) + 1
    enc = removed.astype(np.int64) * base + errors
    uniq, counts = np.unique(enc, return_counts=True)
    for p, c in zip(uniq, counts):
        end.record_removal(int(p // base), int(p % base), int(c))


def _record_adjacent(end, adj_bytes, reducer=None):
    """Adjacent-base tallies (byte 0 and non-ACGT count as '')."""
    codes = _ADJ_CODE[np.asarray(adj_bytes, np.uint8)]
    if reducer is not None:
        def fold(h, end=end):
            for i, c in enumerate(h[:5]):
                if c:
                    end.adjacent_bases[_ADJ_KEYS[i]] += int(c)

        reducer.add_hist1d(("adj", id(end)), codes, fold)
        return
    cnt = np.bincount(codes, minlength=5)
    for i, c in enumerate(cnt[:5]):
        if c:
            end.adjacent_bases[_ADJ_KEYS[i]] += int(c)


def _record_written(wl, side, reducer=None, values=None, hist=None):
    """Written-length histogram for one side: from the kept reads'
    lengths (``values``) or their bincount (``hist``); on the reducer,
    a histogram rides as its nonzero bins weighted by their counts."""
    if reducer is not None:
        def fold(h, wl=wl, side=side):
            wl.add_histogram(h, side=side)

        weights = None
        if values is None:
            values = np.flatnonzero(hist)
            weights = np.asarray(hist)[values]
        reducer.add_hist1d(("wl", id(wl), side), values, fold, weights)
        return
    if hist is None:
        hist = np.bincount(values)
    wl.add_histogram(hist, side=side)


def _record_filtered(step, mask, reducer=None):
    """Filter counter for one step: the reads it newly dropped (a
    popcount on the reducer)."""
    if reducer is not None:
        def fold(n, step=step):
            step._filtered += n

        reducer.add_count(("flt", id(step)), mask, fold)
        return
    step._filtered += int(mask.sum())


def _record_adapter_events(cutter, task, sub, asf, rem, err, adj, reducer):
    """The removal and adjacent-base statistics of one task's match
    events, credited to the adapter each read matched (``sub``: an
    indexed task's sub-adapter, else 0), per adapter end."""
    for s in (np.unique(sub) if len(sub) else ()):
        m = sub == s
        astats = cutter.adapter_statistics[task.adapters[int(s)]]
        fm = m & asf
        bm = m & ~asf
        if fm.any():
            _record_removals(astats.front, rem[fm], err[fm], reducer)
        if bm.any():
            _record_removals(astats.back, rem[bm], err[bm], reducer)
            _record_adjacent(astats.back, adj[bm], reducer)


def _apply_side_stats(stats, stages, cutter, written_lengths, reducer=None):
    """Fold one chunk's engine stats for one side into the host
    pipeline objects (with ``reducer``, the mergeable histograms and
    counters accumulate on the device instead and fold once at the end
    of the run). Returns total_bp of the side."""
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
            if ev.get("rc"):
                # a linked adapter's two events per round credit
                # reverse_complemented once, by the primary (per-read) row
                prim = (np.asarray(ev["primary"], bool) if "primary" in ev
                        else np.ones(len(sub), bool))
                for s in (np.unique(sub) if len(sub) else ()):
                    cutter.adapter_statistics[
                        task.adapters[int(s)]
                    ].reverse_complemented += int(((sub == s) & prim).sum())
            _record_adapter_events(
                cutter, task, sub, asf, np.asarray(ev["removed"]),
                np.asarray(ev["errors"]), np.asarray(ev["adjacent"]),
                reducer,
            )
    if written_lengths is not None:
        _record_written(written_lengths, 1, reducer,
                        hist=stats["written_lengths"])
    return stats["total_bp"]


def _emit_side_files(rest_fh, info_fh, wildcard_fh, chunk, stats, stage,
                     final_ws, final_we, precap_chunk=None, rc_flags=None,
                     walk_chunk=None):
    """Write one chunk's --rest-file, --info-file and --wildcard-file
    rows from the engine's match events, in the reference's formats
    (steps.py RestFileWriter, InfoFileWriter, WildcardFileWriter): rows
    in read order, a read's matches in round order, the trailing is_rc
    column on match rows and the 4-column -1 rows of unmatched reads.

    ``precap_chunk``: with --zero-cap, match rows show the qualities
    before the trailing ZeroCapper ran (the host slices
    info.original_read), unmatched rows the capped read. ``rc_flags``:
    under --revcomp, the per-read is_rc flags ('1'/'0' in the is_rc
    column); ``chunk`` is then the orientation-selected chunk.
    ``walk_chunk``: under paired --revcomp, the info rows walk the
    physical side's read (reverse-complemented where rc won), while the
    matches came from the swapped partner (:func:`_rc_walk_chunk`);
    rest and wildcard rows slice ``chunk``, the matched read's bytes."""
    buf = chunk.buf
    match_qual_buf = (precap_chunk or chunk).buf
    hs, he = chunk.head_start, chunk.head_end
    ss, qo = chunk.seq_start, chunk.qual_start

    def text(start, a, b):
        return bytes(buf[start + a : start + b]).decode("latin-1")

    if walk_chunk is not None:
        w_buf = w_qbuf = walk_chunk.buf
        w_ss, w_qo, w_sl = (walk_chunk.seq_start, walk_chunk.qual_start,
                            walk_chunk.seq_len)
    else:
        w_buf, w_qbuf = buf, match_qual_buf
        w_ss, w_qo, w_sl = ss, qo, chunk.seq_len

    def wtext(start, a, b):
        return bytes(w_buf[start + a : start + b]).decode("latin-1")

    def wqtext(start, a, b):
        return bytes(w_qbuf[start + a : start + b]).decode("latin-1")

    matches_of = {}
    for ev in stats.get("adapter_events", ()):
        task = stage.tasks[ev["task"]]
        for j, r in enumerate(ev["reads"]):
            matches_of.setdefault(int(r), []).append((task, ev, j))

    if rest_fh is not None:
        rows = []
        for r, match_list in sorted(matches_of.items()):
            task, ev, j = match_list[-1]
            w0, w1 = int(ev["ws"][j]), int(ev["we"][j])
            if ev["as_front"][j]:
                lo, hi = w0, w0 + int(ev["qs"][j])
            else:
                lo, hi = w0 + int(ev["qe"][j]), w1
            if hi > lo:
                rows.append(f"{text(ss[r], lo, hi)} "
                            f"{text(hs[r], 0, he[r] - hs[r])}\n")
        rest_fh.write("".join(rows))

    if wildcard_fh is not None:
        rows = []
        for r, match_list in sorted(matches_of.items()):
            task, ev, j = match_list[-1]
            adapter_seq = task.adapters[int(ev["sub"][j])].sequence
            w0, w1 = int(ev["ws"][j]), int(ev["we"][j])
            rel = int(ev["qs"][j])
            astart, astop = int(ev["astart"][j]), int(ev["astop"][j])
            chars = [
                chr(buf[ss[r] + w0 + rel + i])
                for i in range(astop - astart)
                if adapter_seq[astart + i] == "N" and rel + i < w1 - w0
            ]
            rows.append(f"{''.join(chars)} "
                        f"{text(hs[r], 0, he[r] - hs[r])}\n")
        wildcard_fh.write("".join(rows))

    if info_fh is not None:
        rows = []
        for r in range(chunk.n_records):
            name = text(hs[r], 0, he[r] - hs[r])
            match_list = matches_of.get(r)
            if not match_list:
                w0, w1 = int(final_ws[r]), int(final_we[r])
                rows.append(f"{name}\t-1\t{text(ss[r], w0, w1)}"
                            f"\t{text(qo[r], w0, w1)}\n")
                continue
            # the reference slices the original read with coordinates of
            # the modified one (InfoFileWriter walks info.original_read
            # through match.trimmed), clipping included
            lo, hi = 0, int(w_sl[r])
            for task, ev, j in match_list:
                rel_a, rel_b = int(ev["qs"][j]), int(ev["qe"][j])
                a = min(lo + rel_a, hi)
                b = min(lo + rel_b, hi)
                adapter = task.adapters[int(ev["sub"][j])]
                rows.append("\t".join((
                    name, str(int(ev["errors"][j])), str(rel_a), str(rel_b),
                    wtext(w_ss[r], lo, a), wtext(w_ss[r], a, b),
                    wtext(w_ss[r], b, hi),
                    # linked phases carry ';1'/';2' (reference
                    # adapters.py:1157-1171)
                    adapter.name + ev.get("suffix", ""),
                    wqtext(w_qo[r], lo, a), wqtext(w_qo[r], a, b),
                    wqtext(w_qo[r], b, hi),
                    "" if rc_flags is None else ("1" if rc_flags[r] else "0"),
                )) + "\n")
                if ev["as_front"][j]:
                    lo = b
                else:
                    hi = a
        info_fh.write("".join(rows))


def _cut_bytes(cut_chunk, i, cut_lengths):
    """{cut_prefix} and {cut_suffix} of read i: the bytes the -u cuts
    removed, replayed on the parsed read."""
    cbuf, css = cut_chunk.buf, int(cut_chunk.seq_start[i])
    start, end = 0, int(cut_chunk.seq_len[i])
    prefix = suffix = b""
    for length in cut_lengths:
        if length > 0:
            stop = min(start + length, end)
            prefix = bytes(cbuf[css + start : css + stop])
            start = stop
        elif length < 0:
            begin = max(end + length, start)
            suffix = bytes(cbuf[css + begin : css + end])
            end = begin
    return prefix, suffix


def _make_name_editor(edits, rename, chunk, stats, adapter_names,
                      cut_lengths, final_ws, final_we, cut_chunk=None):
    """Per-read header edit of the trailing name modifiers
    (SuffixRemover, LengthTagModifier, PrefixSuffixAdder) and the
    --rename template, in the host's order and semantics.

    Under --revcomp, ``chunk`` is the orientation-selected chunk (so
    {match_sequence} slices the bytes the match was found in) while
    ``cut_chunk`` is the parsed one: the -u cuts ran before the
    orientation choice, so {cut_prefix}/{cut_suffix} show forward
    bytes."""
    buf = chunk.buf
    ss = chunk.seq_start
    if cut_chunk is None:
        cut_chunk = chunk
    gids = stats["last_adapter_gid"]
    is_rc = stats.get("is_rc")
    names = [name.encode("latin-1") for name in adapter_names]
    final_len = (final_we - final_ws).astype(np.int64)

    def adapter_name_of(i):
        g = int(gids[i])
        return names[g] if g >= 0 else b"no_adapter"

    steps = []
    for op in edits:
        if op[0] == "strip":
            def step(i, header, _sfx=op[1].encode("latin-1")):
                if _sfx and header.endswith(_sfx):
                    return header[: -len(_sfx)]
                return header
        elif op[0] == "lentag":
            def step(i, header, _mod=op[1]):
                text = header.decode("latin-1")
                if _mod.length_tag in text:
                    text = _mod.regex.sub(
                        f"{_mod.length_tag}{int(final_len[i])}", text
                    )
                return text.encode("latin-1")
        else:  # presuf
            def step(i, header, _pre=op[1], _suf=op[2]):
                name = adapter_name_of(i).decode("latin-1")
                return (_pre.replace("{name}", name).encode("latin-1")
                        + header
                        + _suf.replace("{name}", name).encode("latin-1"))
        steps.append(step)

    if rename is not None:
        parts = [
            (is_field, text if is_field else text.encode("latin-1"))
            for is_field, text in rename._parts
        ]
        used = {text for is_field, text in rename._parts if is_field}
        geometry = (
            _last_match_geometry(stats, chunk.n_records)
            if "match_sequence" in used else None
        )
        need_cuts = bool({"cut_prefix", "cut_suffix"} & used)

        def render(i, header):
            values = {
                "header": header,
                "rc": b"rc" if is_rc is not None and is_rc[i] else b"",
            }
            if geometry is not None:
                has, a, b = geometry
                values["match_sequence"] = (
                    bytes(buf[ss[i] + a[i] : ss[i] + b[i]]) if has[i] else b""
                )
            fields = header.split(None, 1)
            values["id"] = fields[0] if fields else b""
            values["comment"] = fields[1] if len(fields) == 2 else b""
            if "adapter_name" in used:
                values["adapter_name"] = adapter_name_of(i)
            if need_cuts:
                values["cut_prefix"], values["cut_suffix"] = _cut_bytes(
                    cut_chunk, i, cut_lengths
                )
            return b"".join(
                values[text] if is_field else text for is_field, text in parts
            )

        steps.append(render)

    def edit(i, header):
        for step in steps:
            header = step(i, header)
        return header

    return edit


def _with_headers(chunk, new_heads):
    """A ParsedChunk whose headers are ``new_heads``, appended to the
    original buffer so sequence and quality offsets stay valid."""
    from .io.chunks import ParsedChunk

    lens = np.array([len(h) for h in new_heads], np.int64)
    ends = np.cumsum(lens)
    base = len(chunk.buf)
    combined = np.concatenate(
        [chunk.buf, np.frombuffer(b"".join(new_heads), np.uint8)]
    )
    return ParsedChunk(
        combined, base + ends - lens, base + ends, chunk.seq_start,
        chunk.seq_len, chunk.qual_start, has_cr=chunk.has_cr,
    )


def _edit_headers(chunk, editor):
    """A ParsedChunk whose headers ``editor(i, header)`` rewrote."""
    buf, hs, he = chunk.buf, chunk.head_start, chunk.head_end
    return _with_headers(chunk, [
        editor(i, bytes(buf[hs[i] : he[i]])) for i in range(chunk.n_records)
    ])


def _last_match_geometry(stats, n_records):
    """Per read, the absolute [a, b) window coordinates of the last
    adapter match (later rounds overwrite earlier ones) and a has-match
    mask, for the {match_sequence} field."""
    has = np.zeros(n_records, bool)
    a = np.zeros(n_records, np.int32)
    b = np.zeros(n_records, np.int32)
    for ev in stats.get("adapter_events", ()):
        reads = ev["reads"]
        has[reads] = True
        a[reads] = ev["ws"] + ev["qs"]
        b[reads] = ev["ws"] + ev["qe"]
    return has, a, b


def _paired_rename_headers(chunks, rename, gids_pair, names_pair, cuts_pair,
                           geometry_pair, cut_chunks=None):
    """Renamed header chunks of both sides under PairedEndRenamer's
    semantics (reference modifiers.py:700-803): {rn} is the read number,
    {r1.x}/{r2.x} name a side, bare fields the side being renamed, and
    the renamed IDs of a pair must still match (InvalidTemplate)."""
    from .io.records import record_names_match
    from .modifiers import InvalidTemplate

    parts = [
        (is_field, text if is_field else text.encode("latin-1"))
        for is_field, text in rename._parts
    ]
    plain_used = {text.split(".", 1)[-1]
                  for is_field, text in rename._parts if is_field}
    need_cuts = bool({"cut_prefix", "cut_suffix"} & plain_used)
    if cut_chunks is None:
        cut_chunks = chunks

    def side_values(k, i):
        chunk = chunks[k]
        header = bytes(chunk.buf[chunk.head_start[i] : chunk.head_end[i]])
        fields = header.split(None, 1)
        values = {
            "header": header,
            "id": fields[0] if fields else b"",
            "comment": fields[1] if len(fields) == 2 else b"",
        }
        if "match_sequence" in plain_used:
            has, a, b = geometry_pair[k]
            ss0 = int(chunk.seq_start[i])
            values["match_sequence"] = (
                bytes(chunk.buf[ss0 + a[i] : ss0 + b[i]]) if has[i] else b""
            )
        if "adapter_name" in plain_used:
            g = int(gids_pair[k][i])
            values["adapter_name"] = (
                names_pair[k][g].encode("latin-1") if g >= 0
                else b"no_adapter"
            )
        if need_cuts:
            values["cut_prefix"], values["cut_suffix"] = _cut_bytes(
                cut_chunks[k], i, cuts_pair[k]
            )
        return values

    new_heads = ([], [])
    for i in range(chunks[0].n_records):
        sides = (side_values(0, i), side_values(1, i))

        def render(rn):
            out = []
            for is_field, text in parts:
                if not is_field:
                    out.append(text)
                    continue
                prefix, dot, key = text.partition(".")
                if dot and prefix in ("r1", "r2"):
                    out.append(sides[0 if prefix == "r1" else 1][key])
                elif text == "rn":
                    out.append(str(rn).encode())
                else:
                    out.append(sides[rn - 1][text])
            return b"".join(out)

        name1, name2 = render(1), render(2)
        if not record_names_match(name1.decode("latin-1"),
                                  name2.decode("latin-1")):
            new_id1, new_id2 = (
                n.split(None, 1)[0].decode("latin-1") if n else ""
                for n in (name1, name2)
            )
            raise InvalidTemplate(
                "After renaming R1 and R2, their IDs are no longer "
                f"identical: '{new_id1}' != '{new_id2}'. "
                f"Original read ID: '{sides[0]['id'].decode('latin-1')}'. "
            )
        new_heads[0].append(name1)
        new_heads[1].append(name2)
    return (_with_headers(chunks[0], new_heads[0]),
            _with_headers(chunks[1], new_heads[1]))


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


def _setup_mesh(device) -> None:
    """Shard the DP dispatches over devices like ``device``: the
    engine is data-parallel over reads. CUTADAPT_TPU_TORCH_DEVICES says
    how many take part: ``all`` (the default) every visible card, ``1``
    none (no mesh), ``N`` the first N cards; fewer than 2 means no mesh.
    On the CPU (CUTADAPT_TPU_TORCH_DEVICE=cpu), ``N`` is N shards of the
    CPU and ``all`` is one."""
    import torch

    from .batch_pipeline import set_shard_mesh
    from .parallel.mesh import Mesh

    want = os.environ.get("CUTADAPT_TPU_TORCH_DEVICES", "all")
    if want == "1":
        set_shard_mesh(None)
        return
    if device.type == "cpu":
        devices = [device] * (1 if want == "all" else int(want))
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if want != "all":
            devices = devices[: int(want)]
    set_shard_mesh(Mesh(devices) if len(devices) > 1 else None)


# the process group's rendezvous and set-up wait at most this long for
# every process to join: jax.distributed's default, so that one process
# that dies does not hold the others for torch's 30 minutes
DIST_TIMEOUT_S = 300


def _maybe_init_distributed() -> None:
    """Opt-in process group (CUTADAPT_TPU_TORCH_DIST_COORDINATOR =
    'host:port', with CUTADAPT_TPU_TORCH_DIST_NPROCS and _DIST_PID, or
    torch's own WORLD_SIZE and RANK where those are unset). The sharded
    design does not need it: every process runs independently over its
    input shard (parallel/multihost.py) and no collective runs during
    processing; the group lets runtimes that require every process to
    join one do so. Backend gloo: no tensor crosses it, and NCCL would
    refuse several ranks on one card. Idempotent; a group that cannot
    form is logged and the process goes on alone, which the shard
    contract allows (this is no fallback from the device)."""
    coord = os.environ.get("CUTADAPT_TPU_TORCH_DIST_COORDINATOR")
    if not coord:
        return
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    nprocs = (os.environ.get("CUTADAPT_TPU_TORCH_DIST_NPROCS")
              or os.environ.get("WORLD_SIZE"))
    pid = (os.environ.get("CUTADAPT_TPU_TORCH_DIST_PID")
           or os.environ.get("RANK"))
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(nprocs) if nprocs is not None else -1,
            rank=int(pid) if pid is not None else -1,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
        )
    except (RuntimeError, ValueError) as e:
        logger.warning(
            "torch.distributed.init_process_group failed (%s); continuing "
            "as an independent single process", e,
        )
        return
    logger.debug("process group: rank %d of %d (gloo, %s)",
                 dist.get_rank(), dist.get_world_size(), coord)


def _setup_device(*sides, extra_tasks=()):
    """Build one engine for each (stages, filters[, engine keywords]) of
    ``sides``, all on one device: CUTADAPT_TPU_TORCH_DEVICE, unset
    meaning CUDA, join the opt-in process group
    (_maybe_init_distributed) and set the shard mesh (_setup_mesh). On
    CUDA, pin the device index, build the kernel libraries (the scatter
    kernel's where the statistics reducer will run), then warm every
    engine before any drive thread starts, launching each lane of each
    kernel task once on every device of the mesh (wide where the engine
    wants adapter-side coordinates); ``extra_tasks`` are tasks that run
    outside the engines' stages (--pair-adapters, paired --revcomp).
    Failures, on any shard, raise DeviceError; there is no fallback to
    fewer shards, to one device or to the host path from here."""
    import torch

    from .batch_pipeline import BatchPipelineEngine
    from .ops import stats_cuda
    from .ops.align_cuda import build_library, resolve_device

    name = os.environ.get("CUTADAPT_TPU_TORCH_DEVICE") or "cuda"
    try:
        span = tracing.begin("library")
        try:
            device = resolve_device(name)
            if device.type == "cuda":
                build_library()
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            _maybe_init_distributed()
            _setup_mesh(device)
            if device.type == "cuda" and _stats_reducer_on():
                stats_cuda.build_library()
        finally:
            tracing.end(span)
        span = tracing.begin("engines")
        try:
            engines = [
                BatchPipelineEngine(side[0], side[1], device=device,
                                    **(side[2] if len(side) > 2 else {}))
                for side in sides
            ]
        finally:
            tracing.end(span)
        if device.type == "cuda":
            span = tracing.begin("warmup")
            try:
                with torch.cuda.device(device):
                    for engine in engines:
                        engine.warmup(engine.length_bucket)
                    if extra_tasks:
                        engines[0].warmup(engines[0].length_bucket,
                                          tasks=extra_tasks)
            finally:
                tracing.end(span)
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
    3' phase of a linked adapter's later rounds)."""
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
    from . import native
    from .pipeline import PairedEndPipeline, SingleEndPipeline

    if os.environ.get("CUTADAPT_TPU_TORCH_BATCH") == "0":
        return None  # the host path by request, not a fallback
    if not native.AVAILABLE:
        # submit's staged pass, the byte scans of the host stages and
        # filters, assembly and the paired name check are native code
        return _fallback("the engine needs the native host library "
                         "(native/hostops.cpp), which did not build")
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
    rename, side = translated.rename, translated.side
    name_edits, zero_cap = translated.name_edits, translated.zero_cap
    RUN_TIMES.update(start=time.perf_counter(), device_ready=None,
                     first_submit=None)
    setup = tracing.begin("engine_setup")
    try:
        engine, = _setup_device((stages, filters, dict(
            want_ref_coords=side["wildcard"] is not None,
            qual_cap_base=zero_cap,
        )))
        reducer = _make_stats_reducer(engine.device)
    finally:
        tracing.end(setup)
    RUN_TIMES["device_ready"] = time.perf_counter()

    from .batch_pipeline import CutStage
    from .io.chunks import (
        assemble_fasta_transform,
        assemble_fasta_window,
        parse_bam_chunk,
        parse_fasta_chunk,
        parse_fastq_chunk,
        zero_cap_chunk,
    )
    from .io.fastq import FastaWriter, read_chunks
    from .steps import Demultiplexer

    def out_of(writer):
        """(file, writes_fasta) for one record writer."""
        return (writer._file, isinstance(writer, FastaWriter))

    demux = sink if isinstance(sink, Demultiplexer) else None
    out_file, out_fasta = (None, False) if demux else out_of(sink.writer)
    filter_files = [
        out_of(f.step._writer) if f.step._writer is not None else None
        for f in filters
    ]
    adapter_stage = next(
        (s for s in stages if hasattr(s, "flat_adapters")), None
    )
    if demux is not None:
        # flattened adapter id -> output file
        demux_files = [
            out_of(demux._writers[a.name]) for a in adapter_stage.flat_adapters
        ]
        untrimmed_file = (
            out_of(demux._untrimmed_writer)
            if demux._untrimmed_writer is not None else None
        )
    n = 0
    total_bp = 0
    assemble = _stages_assembler(stages)
    transform_mode = _TRANSFORM_MODES.get(_transform_action(stages))
    rc_stage = _revcomp_stage(stages)
    edits = rename is not None or bool(name_edits)
    # after --revcomp, name edits, --zero-cap, side files and the
    # mask/lowercase transforms read each read in its chosen orientation
    # (the host's modifier order): emit selects it once per chunk
    rc_select = rc_stage is not None and (
        edits or zero_cap is not None or any(side.values())
        or transform_mode is not None
    )
    rename_names = (
        [a.name for a in adapter_stage.flat_adapters]
        if adapter_stage is not None else []
    )
    rename_cuts = [s.length for s in stages if isinstance(s, CutStage)]

    def select(chunk, stats):
        stats["rc_selected"] = True
        return _select_rc_chunk(chunk, stats, rc_stage.suffix)

    def editor(chunk, stats, ws, we, parsed):
        return _make_name_editor(name_edits, rename, chunk, stats,
                                 rename_names, rename_cuts, ws, we,
                                 cut_chunk=parsed)

    if edits and any(f.kind == "casava_filtered" for f in filters):
        # the host runs the modifiers before the steps: the casava filter
        # reads the edited headers (of the chosen orientation, with its
        # rc suffix), so the engine edits before its filters and emit
        # takes the edited chunk from the stats
        def pre_filter_edit(chunk, stats, ws, we):
            parsed = chunk
            if "is_rc" in stats:
                chunk = select(chunk, stats)
            return _edit_headers(chunk, editor(chunk, stats, ws, we, parsed))

        engine.pre_filter_edit = pre_filter_edit

    def render(chunk, ws, we, mask, stats, writes_fasta):
        span = tracing.begin("assemble")
        try:
            return assemble_records(chunk, ws, we, mask, stats, writes_fasta)
        finally:
            tracing.end(span)

    def assemble_records(chunk, ws, we, mask, stats, writes_fasta):
        if writes_fasta:
            if transform_mode is not None:
                rs, re_ = stats["remainder"]
                return assemble_fasta_transform(
                    chunk, ws, we, rs, re_, mask, transform_mode
                )
            if rc_stage is not None and not stats.get("rc_selected"):
                # each read's chosen orientation with the rc name
                # suffix, built once per chunk (filter and demultiplexed
                # outputs render the same chunk)
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
        chunk = stats.pop("edited_chunk", None)
        if chunk is None:
            chunk = pending.parsed
            if rc_select and "is_rc" in stats:
                chunk = select(chunk, stats)
            if edits:
                chunk = _edit_headers(
                    chunk, editor(chunk, stats, ws, we, pending.parsed)
                )
        precap = chunk
        if zero_cap is not None:
            chunk = zero_cap_chunk(chunk, zero_cap)
        if any(side.values()):
            _emit_side_files(
                side["rest"], side["info"], side["wildcard"], chunk, stats,
                adapter_stage, ws, we, precap_chunk=precap,
                rc_flags=stats.get("is_rc") if rc_stage is not None else None,
            )
        written_lengths = None
        if demux is None:
            _write(out_file, render(chunk, ws, we, keep, stats, out_fasta))
            written_lengths = sink._statistics
        else:
            gids = stats["last_adapter_gid"]
            # adapters sharing a name share a file: merge their masks so
            # each file keeps the input order
            per_file = {}
            for gid, out in enumerate(demux_files):
                _merge_route(per_file, out[0], out, keep & (gids == gid))
            untrimmed = keep & (gids == -1)
            if untrimmed_file is not None:
                _merge_route(per_file, untrimmed_file[0], untrimmed_file,
                             untrimmed)
            else:
                _record_filtered(demux, untrimmed, reducer)
            lens_out = we - ws
            for (ff, writes_fasta), mask in per_file.values():
                if mask.any():
                    _write(ff, render(chunk, ws, we, mask, stats,
                                      writes_fasta))
                    _record_written(demux._statistics, 1, reducer,
                                    values=lens_out[mask])
        # routed filter outputs (--too-short-output etc.): records a
        # filter dropped, in input order, with their state at drop time
        for out, newly in zip(filter_files, stats["filter_dropped_masks"]):
            if out is not None and newly.any():
                _write(out[0], render(chunk, ws, we, newly, stats, out[1]))
        if reducer is None:
            for f, count in zip(filters, stats["filter_counts"]):
                f.step._filtered += count
        else:
            for f, newly in zip(filters, stats["filter_dropped_masks"]):
                _record_filtered(f.step, newly, reducer)
        total_bp += _apply_side_stats(stats, stages, cutter, written_lengths,
                                      reducer)
        if reducer is not None:
            reducer.flush()  # one upload and one launch per shard
        n += stats["n"]
        if progress is not None:
            progress.update(stats["n"])

    if fasta_in:
        line = 0

        def parse_fasta(data):
            nonlocal line
            parsed = parse_fasta_chunk(data, first_line=line)
            line += int((np.frombuffer(data, np.uint8) == 10).sum())
            return parsed

        chunks_iter = _parsed(parse_fasta, read_chunks(infile, _chunk_bytes()))
    elif fmt == "bam":
        # qualities may be absent per record (0xFF); that is an error
        # exactly when some output actually needs them
        fasta_outputs = [f[1] for f in filter_files if f is not None]
        if demux is None:
            fasta_outputs.append(out_fasta)
        else:
            fasta_outputs += [writes for _, writes in demux_files]
            if untrimmed_file is not None:
                fasta_outputs.append(untrimmed_file[1])
        quals_required = not all(fasta_outputs) or side["info"] is not None
        chunks_iter = _parsed(
            lambda data: parse_bam_chunk(data, quals_required),
            read_chunks(infile, _chunk_bytes()),
        )
    else:
        chunks_iter = _parsed(parse_fastq_chunk,
                              read_chunks(infile, _chunk_bytes()))
    try:
        _pipelined_drive(
            chunks_iter, _on_device(submit, engine.device),
            _on_device(emit, engine.device),
        )
    finally:
        engine.close()
    if reducer is not None:
        reducer.fold()  # one sum across shards, one copy per buffer
    infiles.close()
    if progress is not None:
        progress.close()
    return Statistics().collect(
        n, total_bp, None, pipeline._modifiers, pipeline._steps
    )


def _merge_route(per_file, fh, out, mask):
    """Add ``mask`` to the route of file ``fh`` (routes that share one
    output file write one merged, input-ordered batch)."""
    key = id(fh)
    if key in per_file:
        per_file[key] = (per_file[key][0], per_file[key][1] | mask)
    else:
        per_file[key] = (out, mask)


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
    rename: object  # trailing PairedEndRenamer, if any
    side_edits: list  # trailing name-edit ops, per side
    zero_caps: list  # ZeroCapper quality base or None, per side
    side: dict  # side files: rest/info/wildcard (R1), info2 (R2)


def _translate_paired(pipeline, interleaved=False, fasta=False):
    """Map an eligible paired-end pipeline to per-side stage lists, pair
    filters and the paired adapter constructs, or raise _Refused. With
    FASTA input, outputs must be FASTA too and quality-reading stages
    and filters keep the run on the host path, which owns those errors.
    Trailing per-side name edits and --zero-cap, a trailing --rename,
    the side files and paired or combinatorial demultiplexing ride
    along."""
    from .batch_pipeline import (
        AdapterStage, AdapterTask, NEndStage, NextseqStage, PolyAStage,
        QualityStage,
    )
    from .io.fastq import (
        FastaWriter, FastqWriter, InterleavedSequenceWriter,
        PairedSequenceWriter,
    )
    from .modifiers import (
        PairedAdapterCutter, PairedEndModifierWrapper, PairedEndRenamer,
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

    modifiers = list(pipeline._modifiers)
    rename = None
    if modifiers and type(modifiers[-1]) is PairedEndRenamer:
        rename = modifiers.pop()
    stages1, stages2 = [], []
    cutters = [None, None]
    pair_stage = None
    rc_pair = None
    post_stages = [[], []]
    side_edits = [[], []]
    zero_caps = [None, None]
    for mod in modifiers:
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
            _, edits, zero_cap = _split_edits([m])
            if edits or zero_cap is not None:
                side_edits[side] += edits
                if zero_cap is not None:
                    zero_caps[side] = zero_cap
                continue
            if side_edits[side] or zero_caps[side] is not None:
                raise _Refused(
                    f"modifier {type(m).__name__} after a name or quality "
                    "edit has no engine form"
                )
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
        if any(z is not None for z in zero_caps) or any(
            isinstance(s, (QualityStage, NextseqStage))
            for st in (stages1, stages2, *post_stages) for s in st
        ):
            raise _Refused("quality trimming or capping of FASTA input has "
                           "no engine form")
        for st in (stages1, stages2):
            rc_st = _revcomp_stage(st)
            if rc_st is not None:
                # FASTA chunks alias quality offsets to the sequence
                rc_st.has_quals = False

    linked1 = _has_linked(stages1) or (
        rc_pair is not None and rc_pair[0] is not None
        and _has_linked([rc_pair[0]])
    )
    pair_filters = []
    sink = None
    side = {"rest": None, "info": None, "wildcard": None, "info2": None}
    for step in pipeline._steps:
        if sink is not None:
            raise _Refused(f"step {type(step).__name__} after the sink")
        inner = step._step if isinstance(step, PairedSingleEndStep) else None
        if isinstance(step, PairedInfoFileWriter) or isinstance(
            inner, (RestFileWriter, InfoFileWriter, WildcardFileWriter)
        ):
            # R1's match events (and R2's for a paired --info-file), before
            # any filter (the reference's step order); under paired
            # --revcomp emit reproduces the reference's info rows, which
            # walk the physical side's read (_rc_walk_chunk)
            if pair_filters:
                raise _Refused("a side file after a filter has no engine "
                               "form")
            info = isinstance(step, PairedInfoFileWriter) or isinstance(
                inner, InfoFileWriter
            )
            if linked1 and not info:
                # the reference's rest()/wildcards() have no linked form
                raise _Refused("--rest-file or --wildcard-file with linked "
                               "adapters has no engine form")
            if info and fasta:
                raise _Refused("--info-file of FASTA input has no engine "
                               "form (its rows hold qualities)")
            if isinstance(step, PairedInfoFileWriter):
                keys = (("info", step._info_writer1._file),
                        ("info2", step._info_writer2._file))
            else:
                key = {InfoFileWriter: "info", WildcardFileWriter: "wildcard",
                       RestFileWriter: "rest"}[type(inner)]
                keys = ((key, inner._file),)
            for key, fh in keys:
                if side[key] is not None or (key == "info"
                                             and side["info2"] is not None):
                    raise _Refused("a second side file of one kind has no "
                                   "engine form")
                side[key] = fh
            continue
        if isinstance(step, (PairedDemultiplexer, CombinatorialDemultiplexer)):
            if interleaved:
                raise _Refused("demultiplexing of interleaved input has no "
                               "engine form")
            # routing needs matches: R1's for paired demultiplexing (the
            # winning pair with --pair-adapters, the chosen orientation
            # with paired --revcomp), both sides' for combinatorial
            if isinstance(step, CombinatorialDemultiplexer):
                if pair_stage is not None:
                    ok = False
                elif rc_pair is not None:
                    ok = rc_pair[0] is not None and rc_pair[1] is not None
                else:
                    ok = cutters[0] is not None and cutters[1] is not None
            else:
                ok = (cutters[0] is not None or pair_stage is not None
                      or (rc_pair is not None and rc_pair[0] is not None))
            if not ok:
                raise _Refused(f"{type(step).__name__} without the adapter "
                               "stages it routes by has no engine form")
            for w in step._writers.values():
                check_writer(w, "a demultiplexed output")
            untrimmed = getattr(step, "_untrimmed_writer", None)
            if untrimmed is not None:
                check_writer(untrimmed, "the untrimmed output")
            sink = step
            continue
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
    if rename is not None:
        scan = [stages1, stages2]
        if rc_pair is not None:
            scan.append([s for s in rc_pair[:2] if s is not None])
        _check_rename(
            {text.split(".", 1)[-1]
             for is_field, text in rename._parts if is_field},
            scan,
        )
    return PairedTranslation(
        stages1, stages2, cutters, pair_filters, sink, pair_stage, rc_pair,
        post_stages, rename, side_edits, zero_caps, side,
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


def _pair_match(engines, chunks, windows, pair_stage, stats_pair=None,
                reducer=None):
    """--pair-adapters: adapter pair i matches iff it matches both
    reads; the pair with the highest total score wins (ties: fewer total
    errors, then the earlier pair), PairedAdapterCutter semantics
    (reference modifiers.py:412-503). Every pair's tasks dispatch on
    both sides before any result is read. Mutates both sides' windows,
    credits the statistics and returns the matched mask; with
    ``stats_pair``, each side's stats get the winning pair index per
    read (-1 where none) as last_adapter_gid and the winning matches as
    adapter events (with their geometry, for the side files; the
    adapter-side span where the side's engine wants it)."""
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
        ref = engines[side].want_ref_coords
        for t in range(n_pairs):
            (sel, futures), lens = disp[side][t]
            # found, qstart, qstop, errors, score, astart, astop
            out = [np.zeros(n, bool)] + [np.zeros(n, np.int32)
                                         for _ in range(6)]
            if len(sel):
                got = engines[side]._fetch_windows(
                    tasks_by_side[side][t], sel, futures, lens,
                    ref_coords=ref,
                )
                for arr, g in zip(out, got):
                    arr[sel] = g
            results[side][t] = out

    best = np.full(n, -1, np.int32)
    best_sc = np.zeros(n, np.int32)
    best_er = np.zeros(n, np.int32)
    for t in range(n_pairs):
        f1, _, _, er1, sc1 = results[0][t][:5]
        f2, _, _, er2, sc2 = results[1][t][:5]
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
            _, qs, qe, er, _, as_a, ae_a = results[side][t]
            ws_ev, we_ev = ws[hit].copy(), we[hit].copy()
            as_front, removed, adj_rel = _apply_match_windows(
                task, mod.action, ws, we, hit, qs[hit], qe[hit]
            )
            if stats_pair is not None:
                stats_pair[side].setdefault("adapter_events", []).append(
                    dict(task=t, reads=hit, removed=removed, errors=er[hit],
                         as_front=as_front,
                         adjacent=np.zeros(len(hit), np.uint8),
                         sub=np.zeros(len(hit), np.int32),
                         qs=qs[hit], qe=qe[hit], ws=ws_ev, we=we_ev,
                         astart=as_a[hit], astop=ae_a[hit])
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
                    astats.front, removed[as_front], e_hit[as_front], reducer
                )
            bk = ~as_front
            if bk.any():
                _record_removals(astats.back, removed[bk], e_hit[bk], reducer)
                _record_adjacent(astats.back, adjacent[bk], reducer)
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


def _rc_walk_chunk(parsed, use_rc):
    """The info rows' walk buffer under paired --revcomp: the reference's
    InfoFileWriter slices ``info.original_read.reverse_complement()``
    for rc-chosen pairs (reference steps.py:233-247), the physical
    side's parsed read, reverse-complemented with its qualities
    reversed, though the match coordinates came from the swapped
    partner. Forward-chosen reads keep their bytes; offsets are
    shared with ``parsed``."""
    if not use_rc.any():
        return parsed
    from . import native
    from .batch_pipeline import _complement_table
    from .io.chunks import ParsedChunk

    buf = parsed.buf.copy()
    idx = np.flatnonzero(use_rc)
    native.reverse_complement_records(
        buf, parsed.seq_start[idx], parsed.seq_len[idx],
        parsed.qual_start[idx], _complement_table(),
    )
    return ParsedChunk(
        buf, parsed.head_start, parsed.head_end, parsed.seq_start,
        parsed.seq_len, parsed.qual_start, has_cr=parsed.has_cr,
    )


def _filter_events(events, mask):
    """The event rows of the reads where ``mask`` holds (one slot's
    chosen orientation under paired --revcomp); scalar fields pass
    through."""
    out = []
    for ev in events:
        sel = mask[ev["reads"]]
        if not sel.any():
            continue
        n = len(ev["reads"])
        out.append({
            k: (v[sel] if isinstance(v, np.ndarray) and len(v) == n else v)
            for k, v in ev.items()
        })
    return out


def _run_rc_pair(engines, rc_pair, chunks, windows, want_events=False,
                 reducer=None):
    """--revcomp on paired data: match (R1 -> cutter1, R2 -> cutter2)
    and the swapped orientation (R2 -> cutter1, R1 -> cutter2), keep
    whichever scores strictly higher (PairedReverseComplementer,
    reference modifiers.py:311-405). The first slot's runs dispatch on
    engines[0], the second slot's on engines[1], from the drive's emit
    thread. Credits the modifiers' statistics for the winning
    orientation and returns (slot chunks, slot windows ws1, we1, ws2,
    we2, matched masks, per slot the last-match adapter ids and match
    geometry, the action with each slot's remainder for the
    mask/lowercase actions, and with ``want_events`` each slot's chosen
    match events and the per-pair is_rc flags, for the side files)."""
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
                    cutter.adapter_statistics[
                        task.adapters[int(s)]
                    ].reverse_complemented += int(
                        use_rc[reads[m if prim is None else (m & prim)]].sum()
                    )
                _record_adapter_events(cutter, task, sub, asf, rem, err, adj,
                                       reducer)

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

    def slot_extras(straight, swapped):
        """The chosen orientation's last-match adapter ids and match
        geometry of one slot (demultiplexing, {adapter_name},
        {match_sequence}): relative coordinates hold against the slot
        chunk, which carries the bytes the chosen run searched."""
        has = np.zeros(B, bool)
        a = np.zeros(B, np.int32)
        b = np.zeros(B, np.int32)
        for result, mask in ((straight, ~use_rc), (swapped, use_rc)):
            for ev in result[1]:
                sel = mask[ev["reads"]]
                r = ev["reads"][sel]
                has[r] = True
                a[r] = (ev["ws"] + ev["qs"])[sel]
                b[r] = (ev["ws"] + ev["qe"])[sel]
        return np.where(use_rc, swapped[5], straight[5]), (has, a, b)

    o_ws1, o_we1, rem1 = slot_windows(a1, b1, (ws1, we1), (ws2, we2))
    o_ws2, o_we2, rem2 = slot_windows(a2, b2, (ws2, we2), (ws1, we1))
    side_events = None
    if want_events:
        # a read's rows come from one orientation's run, so the two
        # filtered lists keep each read's matches in round order
        side_events = (
            _filter_events(a1[1], ~use_rc) + _filter_events(b1[1], use_rc),
            _filter_events(a2[1], ~use_rc) + _filter_events(b2[1], use_rc),
            use_rc,
        )
    return (
        slot1, slot2, o_ws1, o_we1, o_ws2, o_we2,
        np.where(use_rc, b1[0], a1[0]), np.where(use_rc, b2[0], a2[0]),
        slot_extras(a1, b1), slot_extras(a2, b2),
        (action, rem1, rem2), side_events,
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
    paired --revcomp), in an ``assemble`` span."""
    from .io.chunks import assemble_fasta_transform, assemble_fasta_window

    tm_static = _TRANSFORM_MODES.get(_transform_action(stages_s))

    def fasta(c, ws, we, m, st):
        tm = tm_static or _TRANSFORM_MODES.get(st.get("transform_action"))
        if tm is not None:
            rs, re_ = st["remainder"]
            return assemble_fasta_transform(c, ws, we, rs, re_, m, tm)
        return assemble_fasta_window(c, ws, we, m)

    assemble = fasta if writes_fasta else assemble_s

    def render(c, ws, we, m, st):
        span = tracing.begin("assemble")
        try:
            return assemble(c, ws, we, m, st)
        finally:
            tracing.end(span)

    return render


def _paired_demux_router(demux, stages1, stages2, pair_stage=None,
                         rc_pair=None, reducer=None):
    """The routing of paired and combinatorial demultiplexing (reference
    steps.py:422-580): R1's last match routes a PairedDemultiplexer
    (with --pair-adapters the winning pair's R1 adapter, under paired
    --revcomp the chosen orientation's match), the (R1, R2) pair of
    matches a CombinatorialDemultiplexer. Routes that share a writer
    write one merged batch, so every file keeps the input order."""
    from .io.fastq import FastaWriter
    from .steps import CombinatorialDemultiplexer

    def names_of(stages, rc_stage):
        if rc_stage is not None:
            return [a.name for a in rc_stage.flat_adapters]
        stage = next(s for s in stages if hasattr(s, "flat_adapters"))
        return [a.name for a in stage.flat_adapters]

    if pair_stage is not None:
        names1 = [t.adapter.name for t in pair_stage[0]]
    else:
        names1 = names_of(stages1, rc_pair and rc_pair[0])
    combinatorial = isinstance(demux, CombinatorialDemultiplexer)
    if combinatorial:
        names2 = names_of(stages2, rc_pair and rc_pair[1])
    asm = (_stages_assembler(stages1), _stages_assembler(stages2))
    renders = {}

    def render_for(w, side):
        r = renders.get(id(w))
        if r is None:
            r = _make_side_render((stages1, stages2)[side], asm[side],
                                  isinstance(w, FastaWriter))
            renders[id(w)] = r
        return r

    def write_pair(writer, cs, windows, mask, stats_pair):
        for side, w in enumerate((writer._writer1, writer._writer2)):
            ws, we = windows[side]
            _write(w._file, render_for(w, side)(cs[side], ws, we, mask,
                                                stats_pair[side]))
            _record_written(demux._statistics, side + 1, reducer,
                            values=(we - ws)[mask])

    def route(cs, windows, keep, stats_pair):
        g1 = stats_pair[0]["last_adapter_gid"]
        per_writer = {}
        if not combinatorial:
            for gid, name in enumerate(names1):
                w = demux._writers[name]
                _merge_route(per_writer, w, w, keep & (g1 == gid))
        else:
            g2 = stats_pair[1]["last_adapter_gid"]
            span = len(names2) + 1
            codes = (g1.astype(np.int64) + 1) * span + (g2 + 1)
            for code in np.unique(codes[keep]):
                a1, a2 = int(code) // span - 1, int(code) % span - 1
                w = demux._writers.get((
                    names1[a1] if a1 >= 0 else None,
                    names2[a2] if a2 >= 0 else None,
                ))
                if w is not None:  # unknown combinations are dropped
                    _merge_route(per_writer, w, w, keep & (codes == code))
        for writer, mask in per_writer.values():
            if mask.any():
                write_pair(writer, cs, windows, mask, stats_pair)
        if combinatorial:
            return
        untrimmed = keep & (g1 == -1)
        if demux._untrimmed_writer is not None:
            if untrimmed.any():
                write_pair(demux._untrimmed_writer, cs, windows, untrimmed,
                           stats_pair)
        else:
            _record_filtered(demux, untrimmed, reducer)

    return route


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
        span = tracing.begin("parse", cpu=True)
        try:
            if fasta:
                parsed = parse_fasta_chunk(data, first_line=line)
            else:
                parsed = parse_fastq_chunk(data)
        finally:
            tracing.end(span)
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
    rename, side_edits = translated.rename, translated.side_edits
    zero_caps, side_files = translated.zero_caps, translated.side
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
    setup = tracing.begin("engine_setup")
    try:
        engine1, engine2 = _setup_device(
            (stages1, (), dict(
                want_ref_coords=side_files["wildcard"] is not None)),
            (stages2, ()), extra_tasks=extra_tasks,
        )
        reducer = _make_stats_reducer(engine1.device)
    finally:
        tracing.end(setup)
    RUN_TIMES["device_ready"] = time.perf_counter()

    from types import SimpleNamespace

    from .batch_pipeline import CutStage
    from .io.chunks import (
        assemble_fasta_transform, assemble_fasta_window, assemble_window,
        parse_fasta_chunk, parse_fastq_chunk, zero_cap_chunk,
    )
    from .io.fastq import (
        FastaWriter, InterleavedSequenceWriter, read_paired_chunks,
    )
    from .io.records import FileFormatError, record_names_match
    from .steps import CombinatorialDemultiplexer, PairedDemultiplexer

    # the adapter stage of each side, by which the side-file rows, the
    # name edits and --rename resolve a match's task and adapter
    if pair_stage is not None:
        # --pair-adapters: gids are winning pair indices
        side_stages = [SimpleNamespace(
            tasks=pair_stage[k],
            flat_adapters=[t.adapter for t in pair_stage[k]],
        ) for k in (0, 1)]
    elif rc_pair is not None:
        side_stages = list(rc_pair[:2])
    else:
        side_stages = [
            next((x for x in st if hasattr(x, "flat_adapters")), None)
            for st in (stages1, stages2)
        ]
    rename_names = [
        [a.name for a in st.flat_adapters] if st is not None else []
        for st in side_stages
    ]
    rename_cuts = [
        [x.length for x in st if isinstance(x, CutStage)]
        for st in (stages1, stages2)
    ]
    demux = sink if isinstance(
        sink, (PairedDemultiplexer, CombinatorialDemultiplexer)
    ) else None

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
    if demux is not None:
        router = _paired_demux_router(demux, stages1, stages2, pair_stage,
                                      rc_pair, reducer)
    elif isinstance(sink.writer, InterleavedSequenceWriter):
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
        span = tracing.begin("assemble")
        try:
            if tm is None:
                asm = assemble_fasta_window if out_fasta else assemble_window
                data = asm(full, wsa, wea, kp)
            else:
                # mask/lowercase: interleave each side's remainder (a
                # side without an adapter stage masks nothing: its
                # remainder is its whole window)
                rsa = np.empty(N2, np.int32)
                rea = np.empty(N2, np.int32)
                rsa[0::2], rea[0::2] = st1.get("remainder", (ws1, we1))
                rsa[1::2], rea[1::2] = st2.get("remainder", (ws2, we2))
                if out_fasta:
                    data = assemble_fasta_transform(full, wsa, wea, rsa,
                                                    rea, kp, tm)
                else:
                    data = _assemble_transform(
                        full, wsa, wea, kp, {"remainder": (rsa, rea)}, tm
                    )
        finally:
            tracing.end(span)
        _write(dest, data)

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
                st["side_rc_flags"] = st["is_rc"]
        c1, c2 = c
        m1 = stats1["matched_mask"]
        m2 = stats2["matched_mask"]
        if pair_stage is not None:
            m1 = m2 = _pair_match(
                (engine1, engine2), (c1, c2), ((ws1, we1), (ws2, we2)),
                pair_stage, stats_pair=(stats1, stats2), reducer=reducer,
            )
        elif rc_pair is not None:
            (c1, c2, ws1, we1, ws2, we2, m1, m2, (gid1, geom1),
             (gid2, geom2), (rc_action, rem1, rem2),
             rc_events) = _run_rc_pair(
                (engine1, engine2), rc_pair, (c1, c2),
                ((ws1, we1), (ws2, we2)),
                want_events=any(side_files.values()), reducer=reducer,
            )
            if rc_events is not None:
                # side-file rows come from the chosen orientation's
                # matches; the info rows walk the physical sides' parsed
                # reads, reverse-complemented where rc won (the
                # reference's steps.py:233-247)
                stats1["adapter_events"], stats2["adapter_events"] = (
                    rc_events[:2]
                )
                for key, st, pend in (("info", stats1, pend1),
                                      ("info2", stats2, pend2)):
                    st["side_rc_flags"] = rc_events[2]
                    if side_files[key] is not None:
                        st["side_walk_chunk"] = _rc_walk_chunk(
                            pend.parsed, rc_events[2]
                        )
            stats1["last_adapter_gid"] = gid1
            stats2["last_adapter_gid"] = gid2
            stats1["rc_pair_geometry"] = geom1
            stats2["rc_pair_geometry"] = geom2
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
        precap1, precap2 = c1, c2
        if zero_caps[0] is not None:
            c1 = zero_cap_chunk(c1, zero_caps[0])
        if zero_caps[1] is not None:
            c2 = zero_cap_chunk(c2, zero_caps[1])
        stats_pair = (stats1, stats2)
        windows = ((ws1, we1), (ws2, we2))
        if any(side_edits):
            c1, c2 = (
                _edit_headers(c, _make_name_editor(
                    side_edits[k], None, c, stats_pair[k], rename_names[k],
                    rename_cuts[k], *windows[k],
                )) if side_edits[k] else c
                for k, c in enumerate((c1, c2))
            )
        if rename is not None:
            c1, c2 = _paired_rename_headers(
                (c1, c2), rename,
                (stats1["last_adapter_gid"], stats2["last_adapter_gid"]),
                rename_names, rename_cuts,
                tuple(
                    st.get("rc_pair_geometry")
                    or _last_match_geometry(st, c1.n_records)
                    for st in stats_pair
                ),
                # cut bytes come from the physical sides (the host's
                # cutters record them before the orientation swap)
                cut_chunks=(
                    (pend1.parsed, pend2.parsed) if rc_pair is not None
                    else None
                ),
            )
        if (inter_out is not None or any_inter_filter) and (
            full is None or c1 is not pend1.parsed or c2 is not pend2.parsed
        ):
            # the interleaved writer slices a combined chunk: rebuild it
            # when the input came as two files or a side was replaced
            full = _interleave_chunks(c1, c2)
        if any(side_files.values()):
            # the reference runs the side-file writers before the
            # filters: every pair gets its rows
            _emit_side_files(
                side_files["rest"], side_files["info"], side_files["wildcard"],
                c1, stats1, side_stages[0], ws1, we1, precap_chunk=precap1,
                rc_flags=stats1.get("side_rc_flags"),
                walk_chunk=stats1.get("side_walk_chunk"),
            )
            if side_files["info2"] is not None:
                _emit_side_files(
                    None, side_files["info2"], None, c2, stats2,
                    side_stages[1], ws2, we2, precap_chunk=precap2,
                    rc_flags=stats2.get("side_rc_flags"),
                    walk_chunk=stats2.get("side_walk_chunk"),
                )
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
            _record_filtered(step, newly, reducer)
            if step.writer is not None and newly.any():
                if renders is None:
                    interleave_write(
                        step.writer._writer._file, full, ws1, we1, ws2,
                        we2, newly,
                        isinstance(step.writer._writer, FastaWriter),
                        stats1, stats2,
                    )
                else:
                    _write(step.writer._writer1._file,
                           renders[0](c1, ws1, we1, newly, stats1))
                    _write(step.writer._writer2._file,
                           renders[1](c2, ws2, we2, newly, stats2))
            keep &= ~drop
        if demux is not None:
            router((c1, c2), ((ws1, we1), (ws2, we2)), keep, stats_pair)
        else:
            if inter_out is not None:
                interleave_write(inter_out, full, ws1, we1, ws2, we2, keep,
                                 inter_fasta, stats1, stats2)
            else:
                _write(out1, render1(c1, ws1, we1, keep, stats1))
                _write(out2, render2(c2, ws2, we2, keep, stats2))
            _record_written(wl, 1, reducer, values=len1[keep])
            _record_written(wl, 2, reducer, values=len2[keep])
        bp1 += _apply_side_stats(stats1, stages1, cutters[0], None, reducer)
        bp2 += _apply_side_stats(stats2, stages2, cutters[1], None, reducer)
        if reducer is not None:
            reducer.flush()  # one upload and one launch per shard
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

            def parse_pair(pair):
                d1, d2 = pair
                p1 = parse_fasta_chunk(d1, first_line=lines[0])
                p2 = parse_fasta_chunk(d2, first_line=lines[1])
                lines[0] += int((np.frombuffer(d1, np.uint8) == 10).sum())
                lines[1] += int((np.frombuffer(d2, np.uint8) == 10).sum())
                return p1, p2, None

            yield from _parsed(parse_pair,
                               read_paired_chunks(f1, f2, _chunk_bytes()))
        else:
            def parse_pair(pair):
                return (parse_fastq_chunk(pair[0]),
                        parse_fastq_chunk(pair[1]), None)

            yield from _parsed(parse_pair,
                               read_paired_chunks(f1, f2, _chunk_bytes()))

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
    finally:
        engine1.close()
        engine2.close()
    if reducer is not None:
        reducer.fold()  # one sum across shards, one copy per buffer
    infiles.close()
    if progress is not None:
        progress.close()
    return Statistics().collect(
        n, bp1, bp2, pipeline._modifiers, pipeline._steps
    )
