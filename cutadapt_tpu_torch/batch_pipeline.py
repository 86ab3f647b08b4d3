"""
Batched trimming engine on the GPU (a paired run uses one per read side).

The port of ``cutadapt_tpu/batch_pipeline.py``: each read carries a
window [win_start, win_stop) into its original bytes. Host stages
(unconditional cuts, quality and NextSeq trimming, poly-A, N-end and
shortening: C++ byte scans in native/hostops.cpp) update the windows
directly; the one adapter stage (with ``times`` rounds) runs the
exact-semantics DP on the device over the current windows of the reads
that pass the host k-mer prefilter; matches shrink the windows; filters
produce a keep-mask; the trimmed FASTQ is assembled from (window, keep)
on the host.

Adapter tasks: the kernel kinds (regular, front, anywhere, non-internal,
anchored with indels, rightmost), linked adapters (a 5' phase launched
from :meth:`BatchPipelineEngine.submit`, a 3' phase on the 5' phase's
remainders, run by the engine's worker thread as soon as submit has
dispatched the 5' phase, or in :meth:`BatchPipelineEngine.collect` for
a round dispatched there), and two host-only kinds: the anchored
comparers without indels and the indexed anchored adapter sets (dict
lookups).

Per chunk the host work is: parse (C++), the host stages before the
adapter stage, then per dispatch the staged pass (:mod:`staging`, two
C++ calls): k-mer prefilter, split of the candidates into the 2-bit
lane (ACGT-only windows) and the 4-bit lane (windows with N/IUPAC
bytes; a few of those go to the C++ scalar aligner instead), and every
dispatch batch encoded and packed into a slot of the engine's pinned
staging arena; then one kernel launch per dispatch batch
(``ops/align_cuda.py``). An adapter that needs more than
16 query classes (16 or more distinct letters compared as ASCII) sends
every candidate to the kernel's byte lane, one ``query_lut`` code per
base, with no lane split. Results come back through
pinned buffers behind CUDA events, so :func:`process_chunks_pipelined`
overlaps chunk i's device work with chunk i+1's host work.

With a :class:`RevcompStage` (--revcomp), submit dispatches the
adapter stage twice, over the chunk and over a reverse-complemented
copy that shares its offsets, and collect keeps for each read the
orientation that scored higher.

Windows of 2**14 bp or more, and every window of an engine built with
``want_ref_coords`` (--wildcard-file needs the adapter-side span), take
the kernel's wide result: the unpacked (7, B) int32 rows of the JAX
engine's wide format, int32 lengths on the wire. Quality capping
(``qual_cap_base``) and a header-edit hook (``pre_filter_edit``) run
before the filters, in the host's step order.

With a device mesh (:func:`set_shard_mesh`), every DP dispatch is cut
into the mesh's equal row slices, slice i uploaded to and launched on
``devices[i]``, and its results joined in shard order
(:class:`ShardedResult`); the dispatch sizes are padded to the mesh
(:func:`mesh_padded`), so every batch divides.

The shared upload (off under a mesh of more than one shard, as in the
reference): the kernel tasks of a stage that read one encoding of the
windows form a group (:func:`_upload_key`). A group takes the union of
its members' prefilter candidates, splits lanes, encodes and uploads
each dispatch batch once and launches each member's kernel on the batch
on the device (:func:`launch_batch`). 2-bit/4-bit tasks group by
orientation and query-class LUT ("cls": every plain-ACGT adapter set is
one group), byte-lane tasks by wildcard flags and orientation. It
changes the work, never the results: the k-mer prefilter is one-sided
(a read it rejects cannot align), so a member's kernel only adds
found=False rows for the other members' candidates.

Reference semantics: modifiers at cutadapt:src/cutadapt/modifiers.py,
selection order of MultipleAdapters.match_to at adapters.py:1265-1286.
"""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import native, staging, tracing
from .accel import PIPELINE_DEPTH
from .adapters import Where
from .io.chunks import assemble_window, parse_fastq_chunk, zero_cap_chunk
from .ops.align_batch import AlignerSpec, query_class_info, query_lut
from .ops.align_cuda import (
    locate_packed, make_tables, resolve_device, unpack_result, unpack_wide,
)
from .parallel.mesh import on_device

# query coordinates in the packed result are 14-bit: longer windows take
# the wide result
_QS_BITS = 14
# decomposition tail: a lane remainder of at most this many rows after
# the lane's full device batches goes to the C++ scalar aligner instead
# of a padded min_dp_batch dispatch (0: never)
_SCALAR_TAIL = 512

# Wire/work accounting (always on, one int add per dispatch): bytes
# host->device and device->host, candidates and DP rows (padded batch
# rows) are properties of the code, stable from run to run. Beside them
# the staged pass's: the candidates it staged (rows written into the
# arena, and the lane remainders it handed to the scalar aligner), and
# the staging arena's allocations (pinned where the device is CUDA).
# Linked adapters: the 5' phase's candidates (rows handed to the
# aligner from submit), the remainders offered to the 3' phase, those
# past its prefilter, and that phase's wall time (perf_counter_ns at its
# two ends); of the 3' phases run by the engine's worker, collect's wall
# time blocked on their results and the count already done when
# collect asked.
XFER = {"h2d_bytes": 0, "d2h_bytes": 0, "candidates": 0, "dp_rows": 0,
        "staged_rows": 0, "pinned_allocs": 0, "linked_front_rows": 0,
        "linked_back_windows": 0, "linked_back_rows": 0, "linked_back_ns": 0,
        "linked_back_wait_ns": 0, "linked_back_ready": 0}
_XFER_LOCK = threading.Lock()


# the device mesh the DP dispatches shard over (None: one device)
_ACTIVE_MESH = None
# launches per shard of a sharded dispatch, keyed by shard index
SHARD_LAUNCHES = {}
# dispatches active_mesh_for found indivisible (run on one device); the
# engine pads every dispatch to the mesh, so its path leaves this at 0
UNSHARDED_DISPATCHES = 0
_WARNED_UNSHARDED = False
_MESH_LOCK = threading.Lock()


def set_shard_mesh(mesh) -> None:
    """Shard subsequent DP dispatches over ``mesh`` (a 1-D
    ``parallel.mesh.Mesh``: the batch axis is cut into one equal row
    slice per shard). Pass None to return to one device."""
    global _ACTIVE_MESH
    if mesh is not None and len(getattr(mesh, "axis_names", ())) != 1:
        raise ValueError("expected a 1-D mesh")
    _ACTIVE_MESH = mesh


def get_shard_mesh():
    """The active shard mesh, or None (one device)."""
    return _ACTIVE_MESH


def active_mesh_for(batch: int):
    """The active mesh if ``batch`` divides evenly over it. The engine's
    dispatch sizes are padded to the mesh (see ``_dp_sizes``), so an
    indivisible batch means a caller outside the engine: it is counted
    (UNSHARDED_DISPATCHES), warned of once, and runs on one device."""
    global _WARNED_UNSHARDED, UNSHARDED_DISPATCHES
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.size <= 1:
        return None
    if batch % mesh.size != 0:
        with _MESH_LOCK:
            UNSHARDED_DISPATCHES += 1
            warn = not _WARNED_UNSHARDED
            _WARNED_UNSHARDED = True
        if warn:
            import logging

            logging.getLogger(__name__).warning(
                "DP batch of %d does not divide over the %d-device "
                "mesh; running this dispatch on one device",
                batch, mesh.size,
            )
        return None
    return mesh


def mesh_padded(size: int) -> int:
    """``size`` rounded up to a multiple of the active mesh's size, so
    every dispatch batch shards evenly over the mesh."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.size <= 1:
        return size
    m = mesh.size
    return (size + m - 1) // m * m


def reset_shard_counters() -> None:
    global UNSHARDED_DISPATCHES
    with _MESH_LOCK:
        SHARD_LAUNCHES.clear()
        UNSHARDED_DISPATCHES = 0


def _xfer_add(h2d=0, d2h=0, candidates=0, dp_rows=0, staged=0,
              allocs=0, front_rows=0, back_windows=0, back_rows=0,
              back_ns=0, back_wait_ns=0, back_ready=0) -> None:
    with _XFER_LOCK:
        XFER["h2d_bytes"] += h2d
        XFER["d2h_bytes"] += d2h
        XFER["candidates"] += candidates
        XFER["dp_rows"] += dp_rows
        XFER["staged_rows"] += staged
        XFER["pinned_allocs"] += allocs
        XFER["linked_front_rows"] += front_rows
        XFER["linked_back_windows"] += back_windows
        XFER["linked_back_rows"] += back_rows
        XFER["linked_back_ns"] += back_ns
        XFER["linked_back_wait_ns"] += back_wait_ns
        XFER["linked_back_ready"] += back_ready


def _count_alloc() -> None:
    _xfer_add(allocs=1)


def reset_xfer_counters() -> None:
    for k in XFER:
        XFER[k] = 0


def xfer_counters() -> dict:
    return dict(XFER)


def _shared_upload_on() -> bool:
    """One upload per task group of a stage (:func:`_upload_key`), except
    under a mesh of more than one shard, where each task dispatches on
    its own (the reference's rule)."""
    mesh = _ACTIVE_MESH
    return mesh is None or mesh.size <= 1


def _upload_key(task) -> Optional[tuple]:
    """The group of the tasks that can read one encoding of the windows,
    or None for a task that dispatches on its own (comparers, indexed
    and linked tasks). "cls": 2-bit/4-bit tasks with the same
    orientation and query-class LUT; "byte": byte-lane tasks with the
    same wildcard flags and orientation (their ``query_lut`` depends on
    nothing else)."""
    if task.comparer or task.indexed or task.kind == "linked":
        return None
    if task.byte:
        return ("byte", task.spec.wildcard_ref, task.spec.wildcard_query,
                task.reverse)
    return ("cls", task.reverse, task.lut.tobytes())


def _exact_wire_on(device: torch.device) -> bool:
    """Exact-wire mode: DP rows ship at each batch's own max window
    length (rounded to the packing step) instead of the chunk-level
    64-bucket width, with candidates length-sorted so the later batches
    get narrower. Semantically invisible: columns beyond each row's
    length are zero and masked by the length. On for CUDA, off on the
    CPU; CUTADAPT_TPU_TORCH_EXACT_WIRE=1/0 overrides."""
    env = os.environ.get("CUTADAPT_TPU_TORCH_EXACT_WIRE")
    if env is not None:
        return env != "0"
    return device.type == "cuda"


def _eff_width(bmax: int, width: int, pack2: Optional[bool]) -> int:
    """Exact-wire row width for a batch whose longest window is bmax:
    rounded up to the packing step (2-bit: 4 bases/byte; 4-bit: 2; byte
    lane, pack2 None: 1) with a floor of 16 columns, capped at the
    bucketed stage width."""
    step = 4 if pack2 else (1 if pack2 is None else 2)
    w = max(16, (int(bmax) + step - 1) // step * step)
    return min(w, width)


def adapter_kind(adapter) -> Optional[str]:
    """The AdapterTask kind of a host adapter, or None where the engine
    has no task for it (the 'anywhere' search parameter, unknown
    classes). The anchored adapters without indels become the comparer
    kinds."""
    if getattr(adapter, "_force_anywhere", False):
        return None
    kind = getattr(adapter, "kind", None)
    if kind in ("prefix", "suffix") and not adapter.indels:
        return kind + "_cmp"
    if kind in _KIND_INFO or kind in (
        "linked", "indexed_prefix", "indexed_suffix"
    ):
        return kind
    return None


# kind -> (Where flags of the aligner kernel, or None for the host
# comparer; reversed alignment; trim mode: 'before' | 'after' | 'auto')
_KIND_INFO = {
    "back": (Where.BACK.value, False, "after"),
    "front": (Where.FRONT.value, False, "before"),
    "anywhere": (Where.ANYWHERE.value, False, "auto"),
    "noninternal_front": (Where.FRONT_NOT_INTERNAL.value, False, "before"),
    "noninternal_back": (Where.BACK_NOT_INTERNAL.value, False, "after"),
    "prefix": (Where.PREFIX.value, False, "before"),
    "suffix": (Where.SUFFIX.value, False, "after"),
    "rightmost_front": (Where.BACK.value, True, "before"),
    "rightmost_back": (Where.FRONT.value, True, "after"),
    "prefix_cmp": (None, False, "before"),
    "suffix_cmp": (None, True, "after"),
}


class DeviceResult:
    """A packed (2, B) or wide (7, B) int32 result on its way to the
    host. The copy into a pinned host buffer is queued on the current
    stream behind the kernel, and a CUDA event marks its end; reading
    the result waits on that event only."""

    __slots__ = ("_dev", "_host", "_event")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._host = None
        self._event = None

    def copy_to_host_async(self) -> None:
        if self._host is not None:
            return
        dev = self._dev
        if dev.device.type == "cuda":
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))
            self._host = host
        else:
            self._host = dev

    def numpy(self) -> np.ndarray:
        self.copy_to_host_async()
        if self._event is not None:
            span = tracing.begin("result_wait")
            try:
                self._event.synchronize()
            finally:
                tracing.end(span)
        self._dev = None
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)


class _Events:
    """The events of one release of a staging slot on several devices
    (a mesh): passed when all have."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class StagedPass:
    """One staged pass (:meth:`BatchPipelineEngine._stage`): the ordered
    candidates (positions into the windows, their starts and lengths),
    their lanes ([(rows, pack2)]), the rows after them that go to the
    host tail, the wide flag, the dispatch batches ((first row, rows
    taken, pack2, enc, lengths), the tensors views of ``slot``) and each
    lane's scalar-aligner remainder ((first row, end) in the
    candidates)."""

    __slots__ = ("sel", "c_starts", "c_lens", "lanes", "host_tail", "wide",
                 "batches", "tails", "slot")

    def __init__(self, sel, c_starts, c_lens):
        self.sel = sel
        self.c_starts = c_starts
        self.c_lens = c_lens
        self.lanes = []
        self.host_tail = 0
        self.wide = False
        self.batches = []
        self.tails = []
        self.slot = None


class ShardedResult:
    """The results of one dispatch sharded over a mesh: one
    :class:`DeviceResult` per shard, each with its own pinned host buffer
    and event (column slices of one pinned buffer would not be
    contiguous). Reading it waits on each shard's event and joins the
    shards along the batch axis, in shard order."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts

    def copy_to_host_async(self) -> None:
        for part in self.parts:
            part.copy_to_host_async()

    def numpy(self) -> np.ndarray:
        return np.concatenate([part.numpy() for part in self.parts], axis=1)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)


class AdapterTask:
    """Matching program for one adapter (or, indexed, one adapter set).

    The trim mode mirrors Remove{Before,After}Match (reference
    adapters.py:427-493): 'after' trims [qstart:], 'before' trims
    [:qstop], 'auto' (anywhere) picks 'before' when the match starts at
    read position 0. Rightmost variants align the reversed window
    (reversed reference, mirrored coordinates, adapters.py:657-786).
    The *_cmp kinds are the anchored no-indel Prefix/SuffixComparer
    scans and the indexed kinds the AdapterIndex lookups, both on the
    host; a linked task holds a kernel task for each of its phases.
    """

    def __init__(self, adapter, kind: str, index: int):
        from .kmer_finder import KmerFinder

        if kind not in _KIND_INFO and kind not in (
            "linked", "indexed_prefix", "indexed_suffix"
        ):
            raise NotImplementedError(
                f"adapter kind {kind!r} is not ported yet (ported: "
                f"{', '.join(_KIND_INFO)}, linked, indexed_prefix, "
                "indexed_suffix)"
            )
        self.adapter = adapter
        self.kind = kind
        self.index = index
        self.indexed = kind in ("indexed_prefix", "indexed_suffix")
        self.comparer = False
        self.reverse = False
        self.pf_tables = None
        self.spec = None
        self.byte = False  # the kernel's byte lane (> 16 query classes)
        self.adapters = [adapter]  # flattened identities for routing
        if self.indexed:
            self._init_index(adapter)
            return
        if kind == "linked":
            # 5' phase trims first, 3' phase searches the remainder
            # (reference adapters.py:1064-1178)
            self.trim = "linked"
            fk = adapter_kind(adapter.front_adapter)
            bk = adapter_kind(adapter.back_adapter)
            if fk is None or bk is None or "linked" in (fk, bk):
                raise ValueError("linked sub-adapter not batchable")
            self.front_task = AdapterTask(adapter.front_adapter, fk, 0)
            self.back_task = AdapterTask(adapter.back_adapter, bk, 1)
            if (self.front_task.trim != "before"
                    or self.back_task.trim != "after"):
                raise ValueError("linked sub-adapter trim modes unsupported")
            self.front_required = adapter.front_required
            self.back_required = adapter.back_required
            return
        flags, self.reverse, self.trim = _KIND_INFO[kind]
        if flags is None:
            self._init_comparer(adapter.aligner)
            return
        reference = adapter.sequence[::-1] if self.reverse else adapter.sequence
        self.spec = AlignerSpec(
            reference=reference,
            max_error_rate=adapter.max_error_rate,
            flags=flags,
            wildcard_ref=adapter.adapter_wildcards,
            wildcard_query=adapter.read_wildcards,
            indel_cost=1 if adapter.indels else 100000,
            min_overlap=adapter.min_overlap,
        )
        info = query_class_info(self.spec)
        # more than 16 query classes: the kernel's byte lane, one
        # query_lut code per base (JAX batch_pipeline.py:516-517)
        self.byte = info is None
        self.lut = query_lut(self.spec) if self.byte else info[0]
        self.tables = make_tables(self.spec)
        if isinstance(adapter.kmer_finder, KmerFinder):
            self.pf_tables = native.PrefilterTables(adapter.kmer_finder)
        self._scalar = None  # lazy C++ per-read aligner (dirty lane)

    def _init_comparer(self, cmp_) -> None:
        """Anchored no-indel comparer: vectorized Hamming on the host
        over byte-encoded windows (suffix windows reversed)."""
        from .ops.tables import ACGT_LUT, IUPAC_LUT, UPPER_LUT

        self.comparer = True
        self.cmp_ref = np.frombuffer(cmp_.reference, np.uint8)
        self.cmp_max_k = cmp_.max_k
        self.cmp_min_overlap = cmp_.min_overlap
        self.cmp_wildcards = cmp_.wildcard_ref or cmp_.wildcard_query
        if cmp_.wildcard_query:
            self.lut = IUPAC_LUT
        elif cmp_.wildcard_ref:
            self.lut = ACGT_LUT
        else:
            self.lut = UPPER_LUT

    def _init_index(self, adapters) -> None:
        """Anchored multi-adapter dict index (host lookups with the
        exact AdapterIndex semantics, reference adapters.py:1396-1533);
        one task stands for many adapters. With one key length, the
        index is also a sorted fixed-width key array with payload
        columns, queried with searchsorted (reads with N or shorter than
        the key take the exact per-read path)."""
        self.trim = "before" if self.kind == "indexed_prefix" else "after"
        self.adapter_index = idx = adapters._index
        self.adapters = list(idx._adapters)
        self._sub_of = {id(a): i for i, a in enumerate(self.adapters)}
        self._fast_len = None
        if len(idx._lengths) == 1:
            L = idx._lengths[0]
            items = sorted(idx._index.items())
            if items:
                self._fast_len = L
                self._fast_keys = np.array(
                    [k.encode("ascii") for k, _ in items], dtype=f"S{L}"
                )
                self._fast_sub = np.array(
                    [self._sub_of[id(v[0])] for _, v in items], np.int32
                )
                self._fast_err = np.array([v[1] for _, v in items], np.int32)
                self._fast_score = np.array(
                    [v[2] for _, v in items], np.int32
                )

    def kernel_tasks(self) -> list:
        """The tasks of this one that launch the aligner kernel."""
        if self.kind == "linked":
            return self.front_task.kernel_tasks() + self.back_task.kernel_tasks()
        if self.comparer or self.indexed:
            return []
        return [self]

    def run_scalar(self, chunk, starts, lens):
        """Per-read C++ DP over explicit windows: the zero-wire lane for
        small counts of 2-bit-dirty reads. Results are identical to the
        kernel's for the same (possibly reversed) window bytes,
        including reversed-frame coordinates."""
        if self._scalar is None:
            from .ops.align_batch import (
                effective_length, encode_reference, n_counts, query_lut,
            )

            spec = self.spec
            self._byte_lut = query_lut(spec)
            self._scalar = native.ScalarAligner(
                encode_reference(spec).tobytes(),
                n_counts(spec),
                effective_length(spec),
                spec.max_error_rate,
                spec.flags,
                not (spec.wildcard_ref or spec.wildcard_query),
                spec.wildcard_ref,
                spec.indel_cost,
                spec.min_overlap,
            )
        n = len(starts)
        found = np.zeros(n, bool)
        qs = np.zeros(n, np.int32)
        qe = np.zeros(n, np.int32)
        er = np.zeros(n, np.int32)
        sc = np.zeros(n, np.int32)
        astart = np.zeros(n, np.int32)
        astop = np.zeros(n, np.int32)
        buf, lut = chunk.buf, self._byte_lut
        locate = self._scalar.locate
        for i in range(n):
            win = buf[starts[i] : starts[i] + lens[i]]
            if self.reverse:
                win = win[::-1]
            r = locate(lut[win].tobytes())
            if r is None:
                continue
            found[i] = True
            astart[i], astop[i], qs[i], qe[i], sc[i], er[i] = r
        return found, qs, qe, er, sc, astart, astop

    def run_index(self, chunk, starts, lens):
        """Per-read AdapterIndex lookups over the current windows.
        Returns (found, qstart, qstop, errors, score, sub)."""
        n = len(starts)
        found = np.zeros(n, bool)
        qs = np.zeros(n, np.int32)
        qe = np.zeros(n, np.int32)
        er = np.zeros(n, np.int32)
        sc = np.zeros(n, np.int32)
        sub = np.zeros(n, np.int32)
        slow = np.arange(n)
        if self._fast_len is not None and n:
            from .ops.tables import UPPER_LUT

            L = self._fast_len
            ok = np.flatnonzero(lens >= L)
            if len(ok):
                aff_starts = starts[ok]
                if self.kind == "indexed_suffix":
                    aff_starts = aff_starts + (lens[ok] - L)
                aff = native.pad_encode(
                    chunk.buf, aff_starts.astype(np.int64),
                    np.full(len(ok), L, np.int32),
                    np.arange(len(ok), dtype=np.int64), L, UPPER_LUT,
                )
                has_n = (aff == ord("N")).any(axis=1)
                queries = np.ascontiguousarray(aff).view(f"S{L}").ravel()
                pos = np.searchsorted(self._fast_keys, queries)
                pos_c = np.minimum(pos, len(self._fast_keys) - 1)
                hit = (self._fast_keys[pos_c] == queries) & ~has_n
                hi = ok[hit]
                found[hi] = True
                er[hi] = self._fast_err[pos_c[hit]]
                sc[hi] = self._fast_score[pos_c[hit]]
                sub[hi] = self._fast_sub[pos_c[hit]]
                if self.kind == "indexed_prefix":
                    qs[hi] = 0
                    qe[hi] = L
                else:
                    qs[hi] = lens[hi] - L
                    qe[hi] = lens[hi]
                # N-containing affixes need the wildcard-aware
                # re-alignment path; everything else is resolved
                slow = ok[has_n]
        buf = chunk.buf
        match_to = self.adapter_index.match_to
        for i in slow:
            m = match_to(bytes(buf[starts[i] : starts[i] + lens[i]])
                         .decode("latin-1"))
            if m is None:
                continue
            found[i] = True
            qs[i] = m.rstart
            qe[i] = m.rstop
            er[i] = m.errors
            sc[i] = m.score
            sub[i] = self._sub_of[id(m.adapter)]
        return found, qs, qe, er, sc, sub

    def run_comparer(self, enc: np.ndarray, lens: np.ndarray):
        """Vectorized Prefix/SuffixComparer over byte-encoded windows
        (suffix windows arrive reversed); enc is (B, m'), m' >= m."""
        m = len(self.cmp_ref)
        length = np.minimum(lens, m)
        cols = enc[:, :m]
        if self.cmp_wildcards:
            mism = (cols & self.cmp_ref[None, :]) == 0
        else:
            mism = cols != self.cmp_ref[None, :]
        in_prefix = np.arange(m)[None, :] < length[:, None]
        errors = (mism & in_prefix).sum(axis=1).astype(np.int32)
        found = (errors <= self.cmp_max_k) & (length >= self.cmp_min_overlap)
        score = (length - 2 * errors).astype(np.int32)
        if self.kind == "prefix_cmp":
            qstart = np.zeros_like(length)
            qstop = length.astype(np.int32)
        else:  # suffix: forward coordinates (n - length, n)
            qstart = (lens - length).astype(np.int32)
            qstop = lens.astype(np.int32)
        return found, qstart, qstop, errors, score

    def launch(self, enc: torch.Tensor, lengths: torch.Tensor,
               pack2: Optional[bool], wide: bool = False) -> DeviceResult:
        """Launch the aligner in its lane (``pack2``: 2-bit, 4-bit, or
        None the byte lane; ``wide``: the (7, B) result) on a batch that
        is already on its device (int32 lengths, :func:`upload_batch`)."""
        return DeviceResult(
            locate_packed(enc, lengths, self.tables, pack2, wide=wide)
        )

    def step(self, enc: torch.Tensor, lengths: torch.Tensor,
             device: torch.device, pack2: Optional[bool],
             wide: bool = False):
        """Upload one encoded batch and launch this task on it
        (:func:`launch_batch` with one task)."""
        return launch_batch([self], enc, lengths, device, pack2, wide)[0]


def upload_batch(enc: torch.Tensor, lengths: torch.Tensor,
                 device: torch.device):
    """One dispatch batch's host tensors (pinned when the device is
    CUDA) on ``device``: the copies are queued on the current stream,
    and the lengths widened to the kernel's int32 there. Every launch on
    the batch is queued on the same stream, so once the tensors are
    freed the caching allocator hands their memory only to work queued
    after the last of those launches."""
    if device.type == "cuda":
        enc = enc.to(device, non_blocking=True)
        lengths = lengths.to(device, non_blocking=True)
    return enc, lengths.to(torch.int32)


def launch_batch(tasks, enc: torch.Tensor, lengths: torch.Tensor,
                 device: torch.device, pack2: Optional[bool],
                 wide: bool = False) -> list:
    """Upload one encoded batch once and launch each of ``tasks`` on it;
    one result per task. With an active mesh that the batch divides
    over, row slice i is uploaded to and launched on ``mesh.devices[i]``
    (a :class:`ShardedResult` per task); otherwise the batch runs on
    ``device`` (a :class:`DeviceResult` per task)."""
    mesh = active_mesh_for(len(lengths))
    if mesh is None:
        dev_enc, dev_len = upload_batch(enc, lengths, device)
        return [t.launch(dev_enc, dev_len, pack2, wide) for t in tasks]
    per = len(lengths) // mesh.size
    parts = [[] for _ in tasks]
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * per, (i + 1) * per)
        with on_device(dev):
            dev_enc, dev_len = upload_batch(enc[rows], lengths[rows], dev)
            for t, shards in zip(tasks, parts):
                part = t.launch(dev_enc, dev_len, pack2, wide)
                # the copy back and its event on the shard's device
                part.copy_to_host_async()
                shards.append(part)
        with _MESH_LOCK:
            SHARD_LAUNCHES[i] = SHARD_LAUNCHES.get(i, 0) + len(tasks)
    return [ShardedResult(shards) for shards in parts]


class Stage:
    pass


class CutStage(Stage):
    """UnconditionalCutter (-u): remove first n (n>0) / last n (n<0)."""

    def __init__(self, length: int, modifier=None):
        self.length = length
        self.modifier = modifier


class QualityStage(Stage):
    def __init__(self, cutoff_front: int, cutoff_back: int, base: int = 33,
                 modifier=None):
        self.cutoff_front = cutoff_front
        self.cutoff_back = cutoff_back
        self.base = base
        self.modifier = modifier


class NextseqStage(Stage):
    def __init__(self, cutoff: int, base: int = 33, modifier=None):
        self.cutoff = cutoff
        self.base = base
        self.modifier = modifier


class PolyAStage(Stage):
    """--poly-a: A-tail trimming, or T-head trimming in revcomp mode
    (the R2 side of paired data)."""

    def __init__(self, modifier=None, revcomp: bool = False):
        self.modifier = modifier
        self.revcomp = revcomp


class NEndStage(Stage):
    """NEndTrimmer (--trim-n): strip N runs from both read ends."""

    def __init__(self, modifier=None):
        self.modifier = modifier


class ShortenStage(Stage):
    """Shortener (-l): keep the first n (n>=0) / last -n bases."""

    def __init__(self, length: int, modifier=None):
        self.length = length
        self.modifier = modifier


_HOST_STAGES = (CutStage, QualityStage, NextseqStage, PolyAStage, NEndStage,
                ShortenStage)


class AdapterStage(Stage):
    def __init__(self, tasks: Sequence[AdapterTask], times: int = 1,
                 modifier=None, action: Optional[str] = "trim"):
        assert action in ("trim", None, "retain", "crop", "mask", "lowercase")
        if action in ("retain", "crop"):
            assert times == 1  # enforced by AdapterCutter as well
        self.tasks = list(tasks)
        self.times = times
        self.modifier = modifier
        self.action = action
        # flattened adapter ids for routing (demultiplexing): an indexed
        # task stands for all of its adapters
        self.gid_base = []
        off = 0
        for t in self.tasks:
            self.gid_base.append(off)
            off += len(t.adapters)
        self.flat_adapters = [a for t in self.tasks for a in t.adapters]


class RevcompStage(AdapterStage):
    """--revcomp: try forward and reverse-complement, keep the better
    (reference ReverseComplementer, modifiers.py:237-279). The wrapped
    cutter's action may be trim (windows shrink) or mask/lowercase
    (windows keep the chosen orientation's extent; the trimmed-window
    remainder drives the transform assembler)."""

    def __init__(self, tasks, times=1, modifier=None, suffix=" rc",
                 action="trim"):
        super().__init__(tasks, times=times, modifier=modifier,
                         action=action)
        self.suffix = suffix
        # FASTA chunks alias their quality offsets to the sequence, so
        # the rc copy must not reverse "qualities" there (the driver
        # clears this for FASTA input)
        self.has_quals = True


def _complement_table() -> np.ndarray:
    from .io.records import _COMPLEMENT_TABLE

    tbl = np.arange(256, dtype=np.uint8)
    for k, v in _COMPLEMENT_TABLE.items():
        tbl[k] = ord(v)
    return tbl


def _revcomp_sequences_only(rc_buf: np.ndarray, parsed) -> None:
    """Reverse-complement each record's sequence bytes in rc_buf,
    leaving everything else untouched: for FASTA chunks, whose quality
    offsets alias the sequence region."""
    lens = parsed.seq_len.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    reps = np.repeat(np.arange(len(lens)), lens)
    offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    starts = parsed.seq_start[reps]
    src = starts + offs
    dst = starts + (lens[reps] - 1 - offs)
    rc_buf[dst] = _complement_table()[parsed.buf[src]]


def reverse_complement_chunk(parsed, has_quals: bool = True):
    """A reverse-complemented copy of a parsed chunk with the same
    offsets: sequences complemented and reversed, qualities reversed
    (sequences only where ``has_quals`` is false: FASTA)."""
    from .io.chunks import ParsedChunk

    rc_buf = parsed.buf.copy()
    if has_quals:
        native.reverse_complement_records(
            rc_buf, parsed.seq_start, parsed.seq_len, parsed.qual_start,
            _complement_table(),
        )
    else:
        _revcomp_sequences_only(rc_buf, parsed)
    return ParsedChunk(
        rc_buf, parsed.head_start, parsed.head_end, parsed.seq_start,
        parsed.seq_len, parsed.qual_start, has_cr=parsed.has_cr,
    )


class FilterSpec:
    """One filtering step: 'too_short', 'too_long', 'discard_trimmed',
    'discard_untrimmed', 'too_many_n', 'too_many_expected_errors',
    'too_high_average_error_rate' or 'casava_filtered', with its
    threshold; counts how many reads it drops."""

    def __init__(self, kind: str, threshold=None, step=None):
        self.kind = kind
        self.threshold = threshold
        self.step = step


def filter_condition(kind, threshold, chunk, win_start, win_stop,
                     lengths, matched, mask_remainder=None):
    """Per-read boolean 'predicate holds' vector for one filter kind,
    with exact host-predicate semantics (predicates.py).

    `mask_remainder` is the (start, stop) remainder interval of the
    mask action's adapter stage, when one ran: the host predicate sees
    the masked read, whose bytes outside the remainder are all 'N', so
    the N count is the remainder's N count plus the masked byte count."""
    if kind == "too_short":
        return lengths < threshold
    if kind == "too_long":
        return lengths > threshold
    if kind == "discard_trimmed":
        return matched
    if kind == "discard_untrimmed":
        return ~matched
    if kind == "too_many_n":
        if mask_remainder is not None:
            rs, re_ = mask_remainder
            nc = native.count_n(chunk.buf, chunk.seq_start, rs, re_)
            nc = nc + (lengths - (re_ - rs))
        else:
            nc = native.count_n(
                chunk.buf, chunk.seq_start, win_start, win_stop
            )
        if threshold < 1.0:  # proportion of the read length
            out = np.zeros(len(lengths), bool)
            nz = lengths > 0
            out[nz] = nc[nz] / lengths[nz] > threshold
            return out
        return nc > threshold
    if kind in ("too_many_expected_errors", "too_high_average_error_rate"):
        from .qualtrim import _SCORE_TO_ERROR_RATE, expected_errors

        ee = native.expected_errors_win(
            chunk.buf, chunk.qual_start, win_start, win_stop,
            np.asarray(_SCORE_TO_ERROR_RATE, np.float64),
        )
        for i in np.flatnonzero(ee < 0):
            # invalid phred: raise the host path's exact error
            q = bytes(
                chunk.buf[
                    chunk.qual_start[i] + win_start[i] :
                    chunk.qual_start[i] + win_stop[i]
                ]
            ).decode("latin-1")
            expected_errors(q)
        if kind == "too_many_expected_errors":
            return ee > threshold
        out = np.zeros(len(lengths), bool)
        nz = lengths > 0
        out[nz] = ee[nz] / lengths[nz] > threshold
        return out
    if kind == "casava_filtered":
        return native.casava_filtered(
            chunk.buf, chunk.head_start, chunk.head_end
        ).astype(bool)
    raise ValueError(kind)


# filters whose predicate reads the read's bytes, not only its length
_CONTENT_FILTERS = (
    "too_many_n", "too_many_expected_errors", "too_high_average_error_rate",
)


class PendingBatch:
    __slots__ = (
        "parsed", "win_start", "win_stop", "stats", "adapter_stage",
        "post_stages", "dp_futures", "width",
    )

    def __init__(self, parsed, win_start, win_stop, stats, adapter_stage,
                 post_stages, dp_futures, width):
        self.parsed = parsed
        self.win_start = win_start
        self.win_stop = win_stop
        self.stats = stats
        self.adapter_stage = adapter_stage
        self.post_stages = post_stages
        self.dp_futures = dp_futures
        self.width = width


class BatchPipelineEngine:
    """Runs the host stages, at most one adapter stage and the filters
    over parsed FASTQ chunks on ``device`` (None: CUDA; ``"cpu"`` runs
    the aligner's plain PyTorch version).

    ``want_ref_coords``: every kernel dispatch takes the wide result, so
    events carry the adapter-side [astart, astop) span (--wildcard-file).
    ``qual_cap_base``: a trailing ZeroCapper's quality base; the
    expected-error filters read capped qualities. ``pre_filter_edit``
    (an attribute): an optional (chunk, stats, ws, we) -> chunk hook run
    before the filters (name edits the casava filter must see); the
    edited chunk comes back as ``stats["edited_chunk"]``."""

    def __init__(
        self,
        stages: Sequence[Stage],
        filters: Sequence[FilterSpec] = (),
        length_bucket: int = 64,
        min_dp_batch: int = 4096,
        max_dp_batch: int = 131072,
        want_ref_coords: bool = False,
        qual_cap_base: Optional[int] = None,
        device=None,
    ):
        native.require("the batch engine")
        self.device = resolve_device(device)
        for s in stages:
            if not isinstance(s, (AdapterStage,) + _HOST_STAGES):
                raise NotImplementedError(
                    f"{type(s).__name__}: the engine runs the host stages "
                    "and one adapter stage"
                )
        if sum(isinstance(s, AdapterStage) for s in stages) > 1:
            raise ValueError("at most one adapter stage is supported")
        self.want_ref_coords = want_ref_coords
        self.qual_cap_base = qual_cap_base
        self.pre_filter_edit = None
        self.stages = list(stages)
        self.filters = list(filters)
        self.length_bucket = length_bucket
        self.min_dp_batch = min_dp_batch
        self.max_dp_batch = max_dp_batch
        self._pinned = self.device.type == "cuda"
        # one slot more than the drive's hand-off queue holds chunks
        self._arena = staging.StagingArena(PIPELINE_DEPTH + 1, self._pinned,
                                           on_alloc=_count_alloc)
        self._pf_sets = {}  # the prefilter sets of _prefilter
        # the worker of linked adapters' 3' phases, started by the first
        # linked dispatch of submit (_queue_linked)
        self._linked_pool = None
        # split the stages at the adapter stage: everything after it
        # depends on the DP results and runs in collect()
        self._adapter_pos = next(
            (i for i, s in enumerate(self.stages)
             if isinstance(s, AdapterStage)),
            None,
        )

    # --- host stages -------------------------------------------------------

    def _apply_host_stage(self, si, stage, chunk, win_start, win_stop, stats):
        """One host stage over every window; per-stage statistics are
        keyed by the stage's index ``si`` in ``self.stages``."""
        if isinstance(stage, CutStage):
            n = stage.length
            if n > 0:
                win_start = np.minimum(win_start + n, win_stop)
            else:
                win_stop = np.maximum(win_stop + n, win_start)
        elif isinstance(stage, QualityStage):
            # both passes always run, like the host's quality_trim_index:
            # a cutoff of 0 still trims bytes below the quality base
            rs, re_ = native.quality_trim(
                chunk.buf, chunk.qual_start, win_start, win_stop,
                stage.cutoff_front, stage.cutoff_back, stage.base,
            )
            trimmed = (win_stop - win_start) - (re_ - rs)
            stats.setdefault("quality_trimmed", {})[si] = int(trimmed.sum())
            new_start = win_start + rs
            win_stop = win_start + re_
            win_start = new_start
        elif isinstance(stage, NextseqStage):
            re_ = native.nextseq_trim(
                chunk.buf, chunk.seq_start, chunk.qual_start,
                win_start, win_stop, stage.cutoff, stage.base,
            )
            trimmed = (win_stop - win_start) - re_
            stats.setdefault("quality_trimmed", {})[si] = int(trimmed.sum())
            win_stop = win_start + re_
        elif isinstance(stage, PolyAStage):
            idx = native.poly_a_trim(
                chunk.buf, chunk.seq_start, win_start, win_stop,
                revcomp=stage.revcomp,
            )
            if stage.revcomp:  # poly-T head: idx = head length removed
                stats.setdefault("poly_a_removed", {})[si] = idx
                win_start = win_start + idx
            else:
                removed = (win_stop - win_start) - idx
                stats.setdefault("poly_a_removed", {})[si] = removed
                win_stop = win_start + idx
        elif isinstance(stage, NEndStage):
            rs, re_ = native.trim_n_ends(
                chunk.buf, chunk.seq_start, win_start, win_stop
            )
            new_start = win_start + rs
            win_stop = win_start + re_
            win_start = new_start
        elif isinstance(stage, ShortenStage):
            n = stage.length
            if n >= 0:
                win_stop = np.minimum(win_start + n, win_stop)
            else:
                win_start = np.maximum(win_stop + n, win_start)
        else:
            raise TypeError(f"not a host stage: {stage}")
        return win_start, win_stop

    # --- adapter stage -----------------------------------------------------

    def _bucket_length(self, max_len: int) -> int:
        b = self.length_bucket
        return max(b, (int(max_len) + b - 1) // b * b)

    def _dp_sizes(self, n: int) -> List[int]:
        """Dispatch batch sizes covering n reads: the binary
        decomposition of n over power-of-two buckets, floored at
        min_dp_batch, so padding is bounded by min_dp_batch per chunk;
        each size padded to the active mesh (mesh_padded), so every
        dispatch shards evenly over its devices."""
        sizes = []
        big = mesh_padded(self.max_dp_batch)
        while n > big:
            sizes.append(big)
            n -= big
        s = self.max_dp_batch
        while n > 0:
            cap = mesh_padded(s)
            if n >= cap or s <= self.min_dp_batch:
                sizes.append(cap)
                n -= cap
            else:
                s //= 2
        return sizes

    def _host_tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A host tensor holding ``arr``: pinned when the device is
        CUDA, so its upload can be asynchronous."""
        t = torch.from_numpy(arr)
        return t.pin_memory() if self._pinned else t

    def warmup(self, max_len: int, tasks=None) -> None:
        """Build the kernel library and launch every lane each kernel
        task can use once, at the smallest dispatch size padded to the
        mesh (both phases of a linked task; comparers and indexed tasks
        launch nothing; a byte-lane task only its lane), in the wide
        result where reads of ``max_len`` or ``want_ref_coords`` need it.
        With a mesh each launch is sharded, so every device of the mesh
        is warmed. ``tasks`` defaults to those of the engine's adapter
        stage."""
        width = self._bucket_length(max_len)
        wide = self.want_ref_coords or width >= (1 << _QS_BITS)
        if tasks is None:
            tasks = [t for stage in self.stages
                     if isinstance(stage, AdapterStage) for t in stage.tasks]
        rows = mesh_padded(self.min_dp_batch)
        for task in tasks:
            for t in task.kernel_tasks():
                for p2 in (None,) if t.byte else (True, False):
                    enc = self._host_tensor(np.zeros(
                        (rows, staging.row_bytes(width, p2)), np.uint8))
                    lens = self._host_tensor(
                        np.zeros(rows, np.int32 if wide else np.int16)
                    )
                    t.step(enc, lens, self.device, pack2=p2,
                           wide=wide).numpy()

    def _dispatch_stage(self, stage, chunk, subset, win_start, win_stop,
                        width):
        """Prefilter + encode + dispatch of every task over `subset`'s
        current windows; one _dispatch_task result per task. With the
        shared upload (_shared_upload_on) the tasks of a group of two or
        more (_upload_key) dispatch together (_dispatch_group), each
        member getting the group's ('single', sel, futures); the others
        dispatch one by one."""
        tasks = stage.tasks
        disp = [None] * len(tasks)
        groups = {}
        if _shared_upload_on():
            for i, t in enumerate(tasks):
                key = _upload_key(t)
                if key is not None:
                    groups.setdefault(key, []).append(i)
        groups = {k: m for k, m in groups.items() if len(m) > 1}
        if groups:
            starts = (chunk.seq_start[subset]
                      + win_start[subset]).astype(np.int64)
            lens = (win_stop[subset] - win_start[subset]).astype(np.int32)
            for key, members in groups.items():
                sel, futures = self._dispatch_group(
                    key, [tasks[i] for i in members], chunk, starts, lens,
                    width,
                )
                for i, fut in zip(members, futures):
                    disp[i] = ("single", sel, fut)
        return [
            d if d is not None else self._dispatch_task(
                t, chunk, subset, win_start, win_stop, width
            )
            for t, d in zip(tasks, disp)
        ]

    def _dispatch_task(self, task, chunk, subset, win_start, win_stop, width):
        """Dispatch one task over `subset`'s current windows. Returns
        ('single', sel, futures) or, for a linked task, ('linked',
        starts, lens, the 5' phase's (sel, futures), None: the future
        of the 3' phase, which :meth:`_queue_linked` fills in);
        positions are relative to `subset`."""
        starts = (chunk.seq_start[subset] + win_start[subset]).astype(np.int64)
        lens = (win_stop[subset] - win_start[subset]).astype(np.int32)
        if task.kind == "linked":
            fd = self._dispatch_windows(
                task.front_task, chunk, starts, lens, width
            )
            _xfer_add(front_rows=len(fd[0]))
            return ("linked", starts, lens, fd, None)
        sel, futures = self._dispatch_windows(task, chunk, starts, lens, width)
        return ("single", sel, futures)

    def _prefilter(self, tasks):
        """The k-mer prefilter of ``tasks`` for the staged pass (a
        :class:`native.PrefilterSet`, made once per set of tasks), or
        None where every window is a candidate: a task without tables
        (MockKmerFinder)."""
        if any(t.pf_tables is None for t in tasks):
            return None
        key = tuple(id(t) for t in tasks)
        got = self._pf_sets.get(key)
        if got is None:
            # the tasks are kept with their set, so their ids stay theirs
            got = self._pf_sets[key] = (tuple(tasks), native.PrefilterSet(
                [t.pf_tables for t in tasks], [t.reverse for t in tasks]))
        return got[1]

    def _dispatch_windows(self, task, chunk, starts, lens, width):
        """Dispatch one task over explicit (starts, lens) window arrays;
        returns (sel positions into starts, futures)."""
        if task.indexed or task.comparer:
            # host-only tasks: every window, no launch
            sel = np.arange(len(starts))
            if len(sel) == 0:
                return sel, []
            if task.indexed:
                return sel, [("host",) + task.run_index(chunk, starts, lens)]
            m_w = (len(task.cmp_ref) + 1) // 2 * 2
            enc = staging.encode_rows(chunk.buf, starts, lens, sel, len(sel),
                                      m_w, task.lut, task.reverse, None)
            return sel, [("host",) + task.run_comparer(enc, lens)]
        staged = self._stage([task], chunk, starts, lens, width,
                             host_tail_ok=True, tail_max=_SCALAR_TAIL)
        (futures,) = self._launch_staged([task], chunk, staged)
        if staged.host_tail:
            base = len(staged.sel) - staged.host_tail
            futures.append(
                ("host_range", base)
                + task.run_scalar(chunk, staged.c_starts[base:],
                                  staged.c_lens[base:])
            )
        return staged.sel, futures

    def _dispatch_group(self, key, tasks, chunk, starts, lens, width):
        """One upload for a group of ``tasks`` (:func:`_upload_key`
        ``key``) over (starts, lens): the union of their prefilter
        candidates, one lane split with the first member's LUT (clean
        windows before dirty ones, no host tail: every dirty window takes
        the 4-bit lane), each dispatch batch encoded and uploaded once and
        launched once per member, and the 2-bit lane's scalar tail run per
        member (reference batch_pipeline.py:1109-1365). Returns (sel, one
        futures list per member), positions into starts."""
        tail_max = _SCALAR_TAIL if key[0] == "cls" else 0
        staged = self._stage(tasks, chunk, starts, lens, width,
                             host_tail_ok=False, tail_max=tail_max)
        return staged.sel, self._launch_staged(tasks, chunk, staged)

    def _stage(self, tasks, chunk, starts, lens, width, host_tail_ok,
               tail_max) -> "StagedPass":
        """Submit's staged pass (:mod:`staging`) for ``tasks`` over the
        windows (starts, lens): the candidates and their lanes
        (:func:`native.stage_select`, with the first task's LUT and
        orientation); the lanes cut into ``_dp_sizes`` batches, a lane
        remainder of at most ``tail_max`` rows after its full batches
        left to the C++ scalar aligner instead of a padded batch; every
        batch encoded into a slot of the engine's arena
        (:func:`staging.encode`).

        The lanes: a byte-lane task sends every candidate to the byte
        lane. Otherwise ACGT-class-only windows ride the 2-bit encoding
        and come first; the rare N/IUPAC-containing windows take the
        4-bit lane, or, when few and ``host_tail_ok``, the scalar aligner
        (zero wire). In exact-wire mode each lane is length-sorted
        (descending), so the batches after the first get progressively
        narrower widths."""
        span = tracing.begin("stage", cpu=True)
        try:
            task = tasks[0]
            clean = not task.byte
            exact = _exact_wire_on(self.device)
            sel, c_starts, c_lens, (n_clean, n_other, tail, longest) = (
                native.stage_select(chunk.buf, starts, lens,
                                    self._prefilter(tasks),
                                    task.lut if clean else None,
                                    task.reverse, width, host_tail_ok,
                                    exact))
            staged = StagedPass(sel, c_starts, c_lens)
            n = len(sel)
            if n == 0:
                return staged
            if not clean:
                lanes = [(n, None)]
            elif n_other == 0:
                lanes = [(n, True)]
            elif n_clean == 0:
                lanes = [(n, False)]
            elif tail:
                lanes = [(n_clean, True)]
                staged.host_tail = n_other
            else:
                lanes = [(n_clean, True), (n_other, False)]
            staged.lanes = lanes
            # windows of 2**14 bp or more overflow the packed 14-bit
            # coordinates, and adapter-side coordinates ride only the
            # wide result: take it (JAX batch_pipeline.py:1416-1420)
            staged.wide = longest >= (1 << _QS_BITS) or self.want_ref_coords
            batches, staged.tails = self._batch_layout(lanes, c_lens, width,
                                                       tail_max, exact)
            if batches:
                rows, nbytes = staging.layout(batches, staged.wide, exact)
                staged.slot = self._arena.take(nbytes)
                views = staging.encode(chunk.buf, c_starts, c_lens, rows,
                                       task.lut, task.reverse,
                                       staged.slot.array)
                staged.batches = [(row0, take, p2, enc, lengths)
                                  for (row0, take, _, _, p2), (enc, lengths)
                                  in zip(batches, views)]
            return staged
        finally:
            tracing.end(span)

    def _batch_layout(self, lanes, c_lens, width, tail_max, exact):
        """The dispatch batches of ``lanes`` over the ordered candidates,
        (first row, rows taken, size, row width, pack2) each, and each
        lane's scalar-aligner remainder, (first row, end). In exact-wire
        mode a batch's row width is its first (longest) window's length
        rounded to the packing step, else the stage's ``width``."""
        batches, tails = [], []
        base = 0
        for count, p2 in lanes:
            dev_count = count
            if 0 < tail_max < count:
                covered = 0
                for size in self._dp_sizes(count):
                    if covered + size <= count:
                        covered += size
                    else:
                        break  # the padded tail batch
                rem = count - covered
                if covered and 0 < rem <= tail_max:
                    # decomposition remainder: zero-wire scalar lane
                    # instead of a padded min_dp_batch dispatch
                    dev_count = covered
            off = 0
            for size in self._dp_sizes(dev_count):
                take = min(size, dev_count - off)
                if take <= 0:
                    break
                row0 = base + off
                b_w = (_eff_width(int(c_lens[row0]), width, p2) if exact
                       else width)
                batches.append((row0, take, size, b_w, p2))
                off += size
            if dev_count < count:
                tails.append((base + dev_count, base + count))
            base += count
        return batches, tails

    def _record_uploads(self):
        """An event after the work queued so far on the current stream of
        each device the engine uploads to (the mesh's, or its own); None
        on the CPU, where a launch has read its inputs when it returns."""
        if not self._pinned:
            return None
        mesh = _ACTIVE_MESH
        devices = (dict.fromkeys(mesh.devices)
                   if mesh is not None and mesh.size > 1 else [self.device])
        events = []
        for d in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(d))
            events.append(event)
        return events[0] if len(events) == 1 else _Events(events)

    def _launch_staged(self, tasks, chunk, staged) -> list:
        """Upload and launch each batch of ``staged`` once for all
        ``tasks``, in order, then release its slot; then each lane's
        scalar-aligner remainder per task. Returns one futures list per
        task."""
        futures = [[] for _ in tasks]
        h2d = rows = dp_rows = 0
        try:
            for row0, take, p2, enc, sub_len in staged.batches:
                h2d += enc.numel() + sub_len.numel() * sub_len.element_size()
                rows += take
                dp_rows += len(sub_len) * len(tasks)
                span = tracing.begin("launch")
                try:
                    results = launch_batch(tasks, enc, sub_len, self.device,
                                           p2, staged.wide)
                    for fut in results:
                        fut.copy_to_host_async()
                finally:
                    tracing.end(span)
                for futs, fut in zip(futures, results):
                    futs.append((row0, take, fut, staged.wide))
        finally:
            if staged.slot is not None:
                staged.batches = None  # the views die with the pass
                self._arena.release(staged.slot, self._record_uploads())
                staged.slot = None
        for s0, s1 in staged.tails:
            rows += s1 - s0
            for t, futs in zip(tasks, futures):
                futs.append(
                    ("host_range", s0)
                    + t.run_scalar(chunk, staged.c_starts[s0:s1],
                                   staged.c_lens[s0:s1])
                )
        _xfer_add(h2d=h2d, candidates=rows, dp_rows=dp_rows, staged=rows)
        return futures

    def _fetch_task(self, n_cand, futures):
        """One task's results over its n_cand candidates: (found,
        qstart, qstop, errors, score, sub-adapter id, astart, astop)."""
        found = np.zeros(n_cand, bool)
        qstart = np.zeros(n_cand, np.int32)
        qstop = np.zeros(n_cand, np.int32)
        errors = np.zeros(n_cand, np.int32)
        score = np.zeros(n_cand, np.int32)
        sub = np.zeros(n_cand, np.int32)
        # adapter-side spans: the scalar lane and the wide device result
        # report them (the packed one carries none)
        astart = np.zeros(n_cand, np.int32)
        astop = np.zeros(n_cand, np.int32)
        for fut in futures:
            if fut[0] == "host":  # comparer/index result, complete
                if len(fut) == 7:  # indexed: carries sub-adapter ids
                    (_, found[:], qstart[:], qstop[:], errors[:],
                     score[:], sub[:]) = fut
                else:
                    (_, found[:], qstart[:], qstop[:], errors[:],
                     score[:]) = fut
                continue
            if fut[0] == "host_range":  # scalar-aligner dirty tail
                _, off, f, qs, qe, er, sc, as_, ae = fut
                count = len(f)
                astart[off : off + count] = as_
                astop[off : off + count] = ae
            else:
                off, count, dev, wide = fut
                arr = np.asarray(dev)
                _xfer_add(d2h=arr.nbytes)
                if wide:
                    f, qs, qe, er, sc, as_, ae = unpack_wide(arr[:, :count])
                    astart[off : off + count] = as_
                    astop[off : off + count] = ae
                else:
                    f, qs, qe, er, sc = unpack_result(arr[:, :count])
            found[off : off + count] = f
            qstart[off : off + count] = qs
            qstop[off : off + count] = qe
            errors[off : off + count] = er
            score[off : off + count] = sc
        return found, qstart, qstop, errors, score, sub, astart, astop

    def _fetch_windows(self, task, sel, futures, lens, ref_coords=False):
        """Fetch one task's results over `sel`'s positions, with
        coordinates mirrored to forward orientation: (found, qstart,
        qstop, errors, score), and with ``ref_coords`` the adapter-side
        [astart, astop) spans (the dispatches must have taken the wide
        result: want_ref_coords), mirrored like _adapter_round's."""
        f, qs, qe, er, sc, _, as_, ae = self._fetch_task(len(sel), futures)
        if task.reverse and not task.comparer:
            L = lens[sel]
            qs, qe = L - qe, L - qs
            if ref_coords:
                m_len = len(task.spec.reference)
                as_, ae = m_len - ae, m_len - as_
        if not ref_coords:
            return f, qs, qe, er, sc
        if task.comparer:
            # anchored comparers always report the full span
            as_ = np.zeros_like(qs)
            ae = np.full_like(qs, len(task.cmp_ref))
        return f, qs, qe, er, sc, as_, ae

    def _resolve_linked(self, task, chunk, starts, lens, front_disp, width):
        """Run the two-phase linked matching: fetch the 5' phase,
        dispatch and fetch the 3' phase over the remainders. Returns a
        dict of arrays over the subset positions (window-relative
        coordinates; 3' coordinates relative to the remainder)."""
        n = len(starts)
        sel_f, fut_f = front_disp
        span = tracing.begin("linked_front")
        try:
            ff, fqs, fqe, fer, fsc = self._fetch_windows(
                task.front_task, sel_f, fut_f, lens
            )
        finally:
            tracing.end(span)
        front_found = np.zeros(n, bool)
        front_found[sel_f] = ff
        front_qs = np.zeros(n, np.int32)
        front_qs[sel_f] = np.where(ff, fqs, 0)
        front_qe = np.zeros(n, np.int32)
        front_qe[sel_f] = np.where(ff, fqe, 0)
        front_er = np.zeros(n, np.int32)
        front_er[sel_f] = np.where(ff, fer, 0)
        front_sc = np.zeros(n, np.int32)
        front_sc[sel_f] = np.where(ff, fsc, 0)

        back_found = np.zeros(n, bool)
        back_qs = np.zeros(n, np.int32)
        back_qe = np.zeros(n, np.int32)
        back_er = np.zeros(n, np.int32)
        back_sc = np.zeros(n, np.int32)
        # the 3' phase: the remainders, their dispatch and the results
        t0 = time.perf_counter_ns()
        span = tracing.begin("linked_back", cpu=True)
        try:
            el = (np.flatnonzero(front_found) if task.front_required
                  else np.arange(n))
            rows = 0
            if len(el):
                starts_b = starts[el] + front_qe[el]
                lens_b = lens[el] - front_qe[el]
                sel_b, fut_b = self._dispatch_windows(
                    task.back_task, chunk, starts_b, lens_b, width
                )
                rows = len(sel_b)
                bf, bqs, bqe, ber, bsc = self._fetch_windows(
                    task.back_task, sel_b, fut_b, lens_b
                )
                hit = el[sel_b]
                back_found[hit] = bf
                back_qs[hit] = np.where(bf, bqs, 0)
                back_qe[hit] = np.where(bf, bqe, 0)
                back_er[hit] = np.where(bf, ber, 0)
                back_sc[hit] = np.where(bf, bsc, 0)
        finally:
            tracing.end(span)
        _xfer_add(back_windows=len(el), back_rows=rows,
                  back_ns=time.perf_counter_ns() - t0)

        found = (front_found | (not task.front_required)) & (
            back_found | (front_found & (not task.back_required))
        )
        return dict(
            found=found,
            score=front_sc + back_sc,
            errors=front_er + back_er,
            front_found=front_found,
            front_qs=front_qs,
            front_qe=front_qe,
            front_errors=front_er,
            back_found=back_found,
            back_qs=back_qs,
            back_qe=back_qe,
            back_errors=back_er,
        )

    def _queue_linked(self, stage, chunk, dispatched, width):
        """``dispatched`` (one _dispatch_stage result per task of
        ``stage``), each linked task's whole :meth:`_resolve_linked`
        queued on the engine's worker, its future in the dispatch tuple.
        The worker is one thread, started here at the first linked
        dispatch, on the engine's CUDA device (the dispatching thread's
        current one where the engine's names no index); its jobs run in
        the order queued, its spans under the stage ``linked`` and the
        chunk of the dispatching thread."""
        out = []
        for task, disp in zip(stage.tasks, dispatched):
            if disp[0] == "linked":
                if self._linked_pool is None:
                    init, args = None, ()
                    if self.device.type == "cuda":
                        index = self.device.index
                        init, args = torch.cuda.set_device, (
                            torch.cuda.current_device() if index is None
                            else index,)
                    self._linked_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="linked",
                        initializer=init, initargs=args)
                _, starts, lens, fd, _ = disp
                disp = disp[:4] + (self._linked_pool.submit(
                    self._resolve_queued, tracing.current_chunk(), task,
                    chunk, starts, lens, fd, width),)
            out.append(disp)
        return out

    def _resolve_queued(self, seq, task, chunk, starts, lens, front_disp,
                        width):
        """A job of the linked worker: :meth:`_resolve_linked` traced
        under the stage ``linked`` and chunk ``seq``."""
        tracing.set_stage("linked", seq)
        return self._resolve_linked(task, chunk, starts, lens, front_disp,
                                    width)

    def close(self) -> None:
        """Stop the linked worker, if it started: the jobs not begun are
        cancelled, a running one is finished. A later linked dispatch
        starts a new one."""
        pool, self._linked_pool = self._linked_pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def _adapter_round(self, stage, chunk, subset, win_start, win_stop,
                       width, dispatched=None, last_gid=None,
                       score_acc=None):
        """One matching round over `subset`. Returns (matched_mask_over_
        subset, events) and updates windows (and last_gid, and the
        per-read score sum score_acc) in place."""
        B = chunk.n_records
        if dispatched is None:
            dispatched = self._dispatch_stage(
                stage, chunk, subset, win_start, win_stop, width
            )
        # combine: best score, then fewer errors, then first adapter
        best_found = np.zeros(B, bool)
        best_score = np.zeros(B, np.int32)
        best_errors = np.zeros(B, np.int32)
        best_qstart = np.zeros(B, np.int32)
        best_qstop = np.zeros(B, np.int32)
        best_astart = np.zeros(B, np.int32)
        best_astop = np.zeros(B, np.int32)
        best_task = np.full(B, -1, np.int32)
        best_sub = np.zeros(B, np.int32)
        linked_results = {}
        for t_i, (task, disp) in enumerate(zip(stage.tasks, dispatched)):
            if disp[0] == "linked":
                _, starts, lens, front_disp, queued = disp
                if queued is None:  # a round dispatched here
                    res = self._resolve_linked(
                        task, chunk, starts, lens, front_disp, width
                    )
                else:
                    ready = queued.done()
                    t0 = time.perf_counter_ns()
                    span = tracing.begin("linked_wait")
                    try:
                        res = queued.result()
                    finally:
                        tracing.end(span)
                    _xfer_add(back_wait_ns=time.perf_counter_ns() - t0,
                              back_ready=int(ready))
                linked_results[t_i] = res
                cand = subset
                f, er, sc = res["found"], res["errors"], res["score"]
                qs = qe = as_ = ae = sub = np.zeros(len(subset), np.int32)
            else:
                _, sel, futures = disp
                if len(sel) == 0:
                    continue
                cand = subset[sel]
                lens = (win_stop[cand] - win_start[cand]).astype(np.int32)
                f, qs, qe, er, sc, sub, as_, ae = self._fetch_task(
                    len(sel), futures
                )
                if task.reverse and not task.comparer:
                    # mirror reversed coordinates to forward orientation
                    qs, qe = lens - qe, lens - qs
                    m_len = len(task.spec.reference)
                    as_, ae = m_len - ae, m_len - as_
                if task.comparer:
                    # anchored comparers always report the full span
                    as_ = np.zeros_like(qs)
                    ae = np.full_like(qs, len(task.cmp_ref))
                elif task.indexed:
                    as_ = np.zeros_like(qs)
                    ae = np.array(
                        [len(a.sequence) for a in task.adapters], np.int32
                    )[sub]
            better = f & (
                ~best_found[cand]
                | (sc > best_score[cand])
                | ((sc == best_score[cand]) & (er < best_errors[cand]))
            )
            upd = cand[better]
            best_found[upd] = True
            best_score[upd] = sc[better]
            best_errors[upd] = er[better]
            best_qstart[upd] = qs[better]
            best_qstop[upd] = qe[better]
            best_astart[upd] = as_[better]
            best_astop[upd] = ae[better]
            best_task[upd] = t_i
            best_sub[upd] = sub[better]

        matched = best_found[subset]
        # routing ids for demultiplexing: the LAST match decides
        if last_gid is not None:
            idx = np.flatnonzero(best_found)
            last_gid[idx] = (
                np.asarray(stage.gid_base, np.int32)[best_task[idx]]
                + best_sub[idx]
            )
        if score_acc is not None:
            idx = np.flatnonzero(best_found)
            score_acc[idx] += best_score[idx]
        events = []
        for t_i, task in enumerate(stage.tasks):
            hit = np.flatnonzero(best_found & (best_task == t_i))
            if len(hit) == 0:
                continue
            if task.trim == "linked":
                self._linked_events(
                    stage, chunk, t_i, linked_results[t_i], subset, hit,
                    win_start, win_stop, events,
                )
                continue
            qs = best_qstart[hit]
            qe = best_qstop[hit]
            er = best_errors[hit]
            cur_len = (win_stop[hit] - win_start[hit]).astype(np.int32)
            if task.trim == "before":
                as_front = np.ones(len(hit), bool)
            elif task.trim == "after":
                as_front = np.zeros(len(hit), bool)
            else:  # 'auto' (anywhere): 5' iff match begins at read start
                as_front = qs == 0
            # removed lengths + adjacent base (3' side only)
            removed = np.where(as_front, qe, cur_len - qs)
            adj_pos = chunk.seq_start[hit] + win_start[hit] + qs - 1
            adjacent = np.where(
                ~as_front & (qs > 0),
                chunk.buf[np.clip(adj_pos, 0, None)],
                0,
            )
            events.append(
                dict(task=t_i, reads=hit, removed=removed, errors=er,
                     as_front=as_front, adjacent=adjacent,
                     sub=best_sub[hit],
                     # match geometry for side-channel writers: the
                     # window the match was found in, its window-
                     # relative [qs, qe) read coordinates, and the
                     # adapter-side [astart, astop) alignment span
                     qs=qs, qe=qe,
                     astart=best_astart[hit], astop=best_astop[hit],
                     ws=win_start[hit].copy(), we=win_stop[hit].copy())
            )
            # apply the action's window update
            if stage.action == "retain":
                # keep the matched adapter: RemoveBefore -> [rstart, n),
                # RemoveAfter -> [0, rstop) (reference adapters.py:
                # 409-435)
                fr = hit[as_front]
                win_start[fr] = win_start[fr] + qs[as_front]
                bk = hit[~as_front]
                win_stop[bk] = win_start[bk] + qe[~as_front]
            elif stage.action == "crop":
                ns = win_start[hit] + qs
                ne = win_start[hit] + qe
                win_start[hit] = ns
                win_stop[hit] = ne
            else:  # trim (or None, restored later)
                fr = hit[as_front]
                win_start[fr] = win_start[fr] + qe[as_front]
                bk = hit[~as_front]
                win_stop[bk] = win_start[bk] + qs[~as_front]
        return matched, events

    @staticmethod
    def _linked_events(stage, chunk, t_i, res, subset, hit, win_start,
                       win_stop, events):
        """The events of a linked task's matched reads `hit`, one per
        phase that matched (5' with the ';1' info-row suffix, 3' with
        ';2'), and the action's window update."""
        pos = np.searchsorted(subset, hit)
        ws0 = win_start[hit].copy()
        we0 = win_stop[hit].copy()
        ffm = res["front_found"][pos]
        bfm = res["back_found"][pos]
        f_qe_all = res["front_qe"][pos]
        # 5' phase event: removed = front.rstop
        fh = hit[ffm]
        if len(fh):
            events.append(
                dict(task=t_i, reads=fh, removed=f_qe_all[ffm],
                     errors=res["front_errors"][pos][ffm],
                     as_front=np.ones(len(fh), bool),
                     adjacent=np.zeros(len(fh), np.uint8),
                     sub=np.zeros(len(fh), np.int32),
                     suffix=";1",
                     # per-read statistics credit one LinkedMatch per
                     # read and round, not one per phase: the 5' event
                     # is the primary, the 3' event only for 3'-only
                     # matches
                     primary=np.ones(len(fh), bool),
                     qs=res["front_qs"][pos][ffm],
                     qe=f_qe_all[ffm],
                     ws=ws0[ffm], we=we0[ffm])
            )
        # 3' phase event (coordinates relative to the remainder after
        # the 5' phase; adjacent base from that window)
        bh = hit[bfm]
        if len(bh):
            b_qs = res["back_qs"][pos][bfm]
            post_ws = ws0[bfm] + f_qe_all[bfm]
            cur_len = (we0[bfm] - post_ws).astype(np.int32)
            adj_pos = chunk.seq_start[bh] + post_ws + b_qs - 1
            adjacent = np.where(
                b_qs > 0, chunk.buf[np.clip(adj_pos, 0, None)], 0
            )
            events.append(
                dict(task=t_i, reads=bh, removed=cur_len - b_qs,
                     errors=res["back_errors"][pos][bfm],
                     as_front=np.zeros(len(bh), bool),
                     adjacent=adjacent,
                     sub=np.zeros(len(bh), np.int32),
                     suffix=";2",
                     primary=(~ffm)[bfm],
                     qs=b_qs,
                     qe=res["back_qe"][pos][bfm],
                     ws=post_ws, we=we0[bfm])
            )
        if stage.action == "retain":
            # retained interval on the original read: [front.rstart,
            # front.rstop + back.rstop) (reference adapters.py:1027-1037)
            win_start[hit] = np.where(ffm, ws0 + res["front_qs"][pos], ws0)
            win_stop[hit] = np.where(
                bfm, ws0 + f_qe_all + res["back_qe"][pos], we0
            )
        else:  # trim (or None/mask/lowercase, restored later)
            win_start[hit] = np.where(ffm, ws0 + f_qe_all, ws0)
            win_stop[hit] = np.where(
                bfm, win_start[hit] + res["back_qs"][pos], we0
            )

    # --- public API --------------------------------------------------------

    def submit(self, parsed) -> PendingBatch:
        """Start a chunk: the host stages before the adapter stage, then
        prefilter, encode and launch its DP batches, and queue each linked
        task's 3' phase on the engine's worker (:meth:`_queue_linked`)."""
        B = parsed.n_records
        win_start = np.zeros(B, np.int32)
        win_stop = parsed.seq_len.astype(np.int32).copy()
        stats = dict(n=B, total_bp=int(parsed.seq_len.sum()))
        pos = self._adapter_pos
        if pos is None:
            pos = len(self.stages)
        span = tracing.begin("host_stages") if pos else None
        try:
            for si, stage in enumerate(self.stages[:pos]):
                win_start, win_stop = self._apply_host_stage(
                    si, stage, parsed, win_start, win_stop, stats
                )
        finally:
            tracing.end(span)
        stage = None
        dp_futures = None
        width = 0
        if self._adapter_pos is not None:
            stage = self.stages[pos]
            if B > 0:
                width = self._bucket_length(int((win_stop - win_start).max()))
                subset = np.arange(B)
                fwd_disp = self._dispatch_stage(
                    stage, parsed, subset, win_start, win_stop, width
                )
                fwd_disp = self._queue_linked(stage, parsed, fwd_disp, width)
                dp_futures = fwd_disp
                if isinstance(stage, RevcompStage):
                    # the reverse-complemented copy shares every offset,
                    # so the same tasks match the rc reads; both
                    # orientations launch here, ahead of the next
                    # chunk's host work
                    rc_chunk = reverse_complement_chunk(
                        parsed, stage.has_quals
                    )
                    full = parsed.seq_len.astype(np.int32)
                    rc_ws = full - win_stop
                    rc_we = full - win_start
                    rc_disp = self._dispatch_stage(
                        stage, rc_chunk, subset, rc_ws, rc_we, width
                    )
                    rc_disp = self._queue_linked(stage, rc_chunk, rc_disp,
                                                 width)
                    dp_futures = (rc_chunk, rc_ws, rc_we, fwd_disp, rc_disp)
        return PendingBatch(
            parsed, win_start, win_stop, stats, stage, self.stages[pos + 1 :],
            dp_futures, width,
        )

    def _run_rounds(self, stage, chunk, win_start, win_stop, width,
                    dispatched, last_gid, score_acc=None):
        """Run all `times` matching rounds; mutates windows/last_gid/
        score_acc in place; returns (matched_any mask, events)."""
        B = chunk.n_records
        subset = np.arange(B)
        matched, events_all = self._adapter_round(
            stage, chunk, subset, win_start, win_stop, width,
            dispatched=dispatched, last_gid=last_gid, score_acc=score_acc,
        )
        matched_any = np.zeros(B, bool)
        matched_any[subset[matched]] = True
        active = subset[matched]
        for _ in range(1, stage.times):
            if len(active) == 0:
                break
            matched, events = self._adapter_round(
                stage, chunk, active, win_start, win_stop, width,
                last_gid=last_gid, score_acc=score_acc,
            )
            events_all.extend(events)
            active = active[matched]
        return matched_any, events_all

    def _run_revcomp(self, stage, pending, win_start, win_stop, last_gid,
                     stats):
        """--revcomp: match the forward read and its reverse complement
        with full rounds each, keep whichever direction scored higher
        (strictly, like ReverseComplementer, modifiers.py:237-279).
        Events carry ev['rc']; stats gain is_rc/rc_chunk for assembly."""
        chunk = pending.parsed
        B = chunk.n_records
        rc_chunk, rc_ws, rc_we, fwd_disp, rc_disp = pending.dp_futures
        ws_f, we_f = win_start.copy(), win_stop.copy()
        # mask/lowercase/--no-trim keep the chosen orientation's input
        # extent; for the transforms the trimmed windows become the
        # transform remainder
        keep_windows = stage.action in (None, "mask", "lowercase")
        if keep_windows:
            rc_ws0, rc_we0 = rc_ws.copy(), rc_we.copy()
        score_f = np.zeros(B, np.int32)
        gid_f = np.full(B, -1, np.int32)
        matched_f, events_f = self._run_rounds(
            stage, chunk, ws_f, we_f, pending.width, fwd_disp,
            gid_f, score_f,
        )
        score_r = np.zeros(B, np.int32)
        gid_r = np.full(B, -1, np.int32)
        matched_r, events_r = self._run_rounds(
            stage, rc_chunk, rc_ws, rc_we, pending.width, rc_disp,
            gid_r, score_r,
        )
        use_rc = score_r > score_f
        matched_any = np.where(use_rc, matched_r, matched_f)
        if keep_windows:
            if stage.action is not None:
                stats["remainder"] = (
                    np.where(use_rc, rc_ws, ws_f),
                    np.where(use_rc, rc_we, we_f),
                )
                stats["transform_action"] = stage.action
            # win_start/win_stop are the unmutated forward extents
            pending.win_start[:] = np.where(use_rc, rc_ws0, win_start)
            pending.win_stop[:] = np.where(use_rc, rc_we0, win_stop)
        else:
            pending.win_start[:] = np.where(use_rc, rc_ws, ws_f)
            pending.win_stop[:] = np.where(use_rc, rc_we, we_f)
        last_gid[:] = np.where(use_rc, gid_r, gid_f)
        events = []
        for evs, mask, rc in ((events_f, ~use_rc, False),
                              (events_r, use_rc, True)):
            for ev in evs:
                sel = mask[ev["reads"]]
                if not sel.any():
                    continue
                # every per-hit field (geometry, linked-phase suffixes)
                # is valid in the chosen orientation's chunk
                out = {"task": ev["task"], "rc": rc}
                for k, v in ev.items():
                    if k != "task":
                        out[k] = v[sel] if isinstance(v, np.ndarray) else v
                events.append(out)
        stats["is_rc"] = use_rc
        stats["rc_chunk"] = rc_chunk
        stats["revcomped"] = int((use_rc & matched_any).sum())
        return matched_any, events

    def collect(self, pending: PendingBatch):
        """Finish a chunk: fetch the DP results (a linked task's 3' phase
        from the engine's worker, or, for a round dispatched here, run
        here), update the windows, run the host stages after the adapter
        stage, then the filters. Returns (win_start, win_stop, keep,
        stats)."""
        chunk = pending.parsed
        B = chunk.n_records
        win_start, win_stop = pending.win_start, pending.win_stop
        stats = pending.stats
        matched_any = np.zeros(B, bool)
        last_gid = np.full(B, -1, np.int32)
        stage = pending.adapter_stage
        if isinstance(stage, RevcompStage) and B > 0:
            matched_any, events_all = self._run_revcomp(
                stage, pending, win_start, win_stop, last_gid, stats
            )
            win_start, win_stop = pending.win_start, pending.win_stop
            stats["adapter_events"] = events_all
            stats["with_adapters"] = int(matched_any.sum())
        elif stage is not None and B > 0:
            keep_windows = stage.action in (None, "mask", "lowercase")
            if keep_windows:
                # match-only / byte-rewriting modes: rounds still trim
                # their working windows (later rounds search the
                # remainder), but the output keeps the input extent;
                # for mask/lowercase the final windows become the
                # remainder interval the transform assembler uses
                saved = (win_start.copy(), win_stop.copy())
            matched_any, events_all = self._run_rounds(
                stage, chunk, win_start, win_stop, pending.width,
                pending.dp_futures, last_gid,
            )
            if keep_windows:
                if stage.action in ("mask", "lowercase"):
                    stats["remainder"] = (win_start.copy(), win_stop.copy())
                    stats["transform_action"] = stage.action
                win_start, win_stop = saved
                pending.win_start, pending.win_stop = saved
            stats["adapter_events"] = events_all
            stats["with_adapters"] = int(matched_any.sum())
        stats["matched_mask"] = matched_any
        stats["last_adapter_gid"] = last_gid
        base_si = len(self.stages) - len(pending.post_stages)
        for j, post in enumerate(pending.post_stages):
            win_start, win_stop = self._apply_host_stage(
                base_si + j, post, chunk, win_start, win_stop, stats
            )
        # name edits run before the filter steps on the host, so a casava
        # filter reads the edited headers
        if self.pre_filter_edit is not None:
            chunk = self.pre_filter_edit(chunk, stats, win_start, win_stop)
            stats["edited_chunk"] = chunk
        # filters (first matching filter claims the read, like the host
        # step order)
        keep = np.ones(B, bool)
        filter_counts = []
        filter_dropped = []
        lengths = win_stop - win_start
        mask_remainder = (
            stats["remainder"]
            if stats.get("transform_action") == "mask" else None
        )
        capped = {}

        def cond(f, src):
            # a trailing ZeroCapper runs before the filters on the host:
            # the expected-error filters read capped qualities
            if self.qual_cap_base is not None and f.kind in (
                "too_many_expected_errors", "too_high_average_error_rate"
            ):
                if id(src) not in capped:
                    capped[id(src)] = zero_cap_chunk(src, self.qual_cap_base)
                src = capped[id(src)]
            return filter_condition(
                f.kind, f.threshold, src, win_start, win_stop, lengths,
                matched_any, mask_remainder=mask_remainder,
            )

        # content-reading predicates must see the chosen orientation's
        # bytes under --revcomp: evaluate on both chunks, select per
        # read (the rc copy shares all offsets, so the same windows
        # apply)
        is_rc = stats.get("is_rc")
        for f in self.filters:
            drop = cond(f, chunk)
            if is_rc is not None and f.kind in _CONTENT_FILTERS:
                drop = np.where(is_rc, cond(f, stats["rc_chunk"]), drop)
            newly = drop & keep
            filter_counts.append(int(newly.sum()))
            filter_dropped.append(newly)
            keep &= ~drop
        stats["filter_counts"] = filter_counts
        stats["filter_dropped_masks"] = filter_dropped
        stats["written"] = int(keep.sum())
        kept_lengths = lengths[keep]
        stats["written_lengths"] = np.bincount(kept_lengths)
        stats["written_len_values"] = kept_lengths
        stats["written_bp"] = int(kept_lengths.sum())
        return win_start, win_stop, keep, stats

    def process_parsed(self, parsed):
        return self.collect(self.submit(parsed))


def process_chunks_pipelined(engine: BatchPipelineEngine, chunks):
    """Yield (trimmed_bytes, stats) per FASTQ chunk in order, submitting
    chunk i+1 before collecting chunk i so device work overlaps the
    neighbouring chunks' host work."""
    pending = None
    for data in chunks:
        nxt = engine.submit(parse_fastq_chunk(data))
        if pending is not None:
            ws, we, keep, stats = engine.collect(pending)
            yield assemble_window(pending.parsed, ws, we, keep), stats
        pending = nxt
    if pending is not None:
        ws, we, keep, stats = engine.collect(pending)
        yield assemble_window(pending.parsed, ws, we, keep), stats
