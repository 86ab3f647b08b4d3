"""
Batched single-end adapter-trimming engine on the GPU.

The port of ``cutadapt_tpu/batch_pipeline.py`` for one adapter stage
(with ``times`` rounds) and the filters: each read carries a window
[win_start, win_stop) into its original bytes; the adapter stage runs
the exact-semantics DP on the device over the current windows of the
reads that pass the host k-mer prefilter; matches shrink the windows;
filters produce a keep-mask; the trimmed FASTQ is assembled from
(window, keep) on the host.

Per chunk the host work is: parse (C++), k-mer prefilter (C++), split
of the candidates into the 2-bit lane (ACGT-only windows) and the 4-bit
lane (windows with N/IUPAC bytes; a few of those go to the C++ scalar
aligner instead), encode and pack into pinned buffers (C++), then one
kernel launch per dispatch batch (``ops/align_cuda.py``). Results come
back through pinned buffers behind CUDA events, so
:func:`process_chunks_pipelined` overlaps chunk i's device work with
chunk i+1's host work.

Not ported yet, and refused with NotImplementedError: host stages
(cut, quality, NextSeq, poly-A, N-end, shorten), revcomp, linked,
indexed and comparer adapters, adapters needing more than 16 query
classes (the byte lane), adapter-side coordinates and windows of
2**14 bp or more (the wide lane), quality capping before the filters,
and the device mesh (:func:`set_shard_mesh`).

Reference semantics: modifiers at cutadapt:src/cutadapt/modifiers.py,
selection order of MultipleAdapters.match_to at adapters.py:1265-1286.
"""

import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import native
from .adapters import Where
from .io.chunks import assemble_window, parse_fastq_chunk
from .ops.align_batch import AlignerSpec, query_class_info
from .ops.align_cuda import (
    locate_packed, make_tables, resolve_device, unpack_result,
)

# query coordinates in the packed result are 14-bit
_QS_BITS = 14

# Wire/work accounting (always on, one int add per dispatch): bytes
# host->device and device->host, candidates and DP rows (padded batch
# rows) are properties of the code, stable from run to run.
XFER = {"h2d_bytes": 0, "d2h_bytes": 0, "candidates": 0, "dp_rows": 0}
_XFER_LOCK = threading.Lock()


def set_shard_mesh(mesh) -> None:
    """Sharding the DP dispatches over several devices is not ported
    yet: ``None`` (one device) is accepted, a mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding over a device mesh is not ported yet"
        )


def _xfer_add(h2d=0, d2h=0, candidates=0, dp_rows=0) -> None:
    with _XFER_LOCK:
        XFER["h2d_bytes"] += h2d
        XFER["d2h_bytes"] += d2h
        XFER["candidates"] += candidates
        XFER["dp_rows"] += dp_rows


def reset_xfer_counters() -> None:
    for k in XFER:
        XFER[k] = 0


def xfer_counters() -> dict:
    return dict(XFER)


def _wire_lengths(vals: np.ndarray, size: int,
                  width: Optional[int] = None) -> np.ndarray:
    """Window lengths as they ride the wire: int16 (windows are < 2**14
    in the packed result format), or one byte per row on the exact-wire
    path when the batch width fits uint8. The kernel reads int32: the
    step widens them on the device."""
    dt = np.uint8 if width is not None and width < 256 else np.int16
    sub_len = np.zeros(size, dt)
    sub_len[: len(vals)] = vals
    return sub_len


def _pack2_on() -> bool:
    """2-bit candidate packing (reads with N/IUPAC bytes split off to
    the 4-bit or host-scalar lane). CUTADAPT_TPU_TORCH_PACK2=0 disables."""
    return os.environ.get("CUTADAPT_TPU_TORCH_PACK2", "1") != "0"


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


def _scalar_tail_max() -> int:
    """Decomposition-tail threshold: a lane remainder of at most this
    many rows after the full device batches goes to the C++ scalar
    aligner instead of a padded min_dp_batch dispatch. 0 disables;
    applies only after at least one full device batch."""
    return int(os.environ.get("CUTADAPT_TPU_TORCH_SCALAR_TAIL", 512))


def _eff_width(bmax: int, width: int, pack2: bool) -> int:
    """Exact-wire row width for a batch whose longest window is bmax:
    rounded up to the packing step (2-bit: 4 bases/byte; 4-bit: 2)
    with a floor of 16 columns, capped at the bucketed stage width."""
    step = 4 if pack2 else 2
    w = max(16, (int(bmax) + step - 1) // step * step)
    return min(w, width)


# kind -> (Where flags, reversed alignment, trim mode: 'before' |
# 'after' | 'auto'); the packed single-adapter kinds, all flag sets of
# the one aligner kernel
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
}


class DeviceResult:
    """A packed (2, B) int32 result on its way to the host. The copy
    into a pinned host buffer is queued on the current stream behind
    the kernel, and a CUDA event marks its end; reading the result waits
    on that event only."""

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
            self._event.synchronize()
        self._dev = None
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)


class AdapterTask:
    """Device matching program for one adapter.

    The trim mode mirrors Remove{Before,After}Match (reference
    adapters.py:427-493): 'after' trims [qstart:], 'before' trims
    [:qstop], 'auto' (anywhere) picks 'before' when the match starts at
    read position 0. Rightmost variants align the reversed window
    (reversed reference, mirrored coordinates, adapters.py:657-786).
    """

    def __init__(self, adapter, kind: str, index: int):
        from .kmer_finder import KmerFinder

        if kind not in _KIND_INFO:
            raise NotImplementedError(
                f"adapter kind {kind!r} is not ported yet (ported: "
                f"{', '.join(_KIND_INFO)})"
            )
        self.adapter = adapter
        self.kind = kind
        self.index = index
        self.adapters = [adapter]  # flattened identities for routing
        flags, self.reverse, self.trim = _KIND_INFO[kind]
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
        if info is None:
            raise NotImplementedError(
                "adapters needing more than 16 query classes (the byte "
                "lane) are not ported yet"
            )
        self.lut = info[0]
        self.tables = make_tables(self.spec)
        self.pf_tables = None
        if native.AVAILABLE and isinstance(adapter.kmer_finder, KmerFinder):
            self.pf_tables = native.PrefilterTables(adapter.kmer_finder)
        self._scalar = None  # lazy C++ per-read aligner (dirty lane)

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

    def step(self, enc: torch.Tensor, lengths: torch.Tensor,
             device: torch.device, pack2: bool) -> DeviceResult:
        """Upload one encoded batch (host tensors, pinned when the
        device is CUDA), launch the aligner, and queue the result's
        copy back."""
        if device.type == "cuda":
            enc = enc.to(device, non_blocking=True)
            lengths = lengths.to(device, non_blocking=True)
        out = locate_packed(
            enc, lengths.to(torch.int32), self.tables, pack2
        )
        return DeviceResult(out)


class AdapterStage:
    def __init__(self, tasks: Sequence[AdapterTask], times: int = 1,
                 modifier=None, action: Optional[str] = "trim"):
        assert action in ("trim", None, "retain", "crop", "mask", "lowercase")
        if action in ("retain", "crop"):
            assert times == 1  # enforced by AdapterCutter as well
        self.tasks = list(tasks)
        self.times = times
        self.modifier = modifier
        self.action = action
        # flattened adapter ids for routing (demultiplexing)
        self.gid_base = list(range(len(self.tasks)))
        self.flat_adapters = [t.adapter for t in self.tasks]


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


class PendingBatch:
    __slots__ = (
        "parsed", "win_start", "win_stop", "stats", "adapter_stage",
        "dp_futures", "width",
    )

    def __init__(self, parsed, win_start, win_stop, stats, adapter_stage,
                 dp_futures, width):
        self.parsed = parsed
        self.win_start = win_start
        self.win_stop = win_stop
        self.stats = stats
        self.adapter_stage = adapter_stage
        self.dp_futures = dp_futures
        self.width = width


class BatchPipelineEngine:
    """Runs one adapter stage, then the filters, over parsed FASTQ
    chunks on ``device`` (None: CUDA; ``"cpu"`` runs the aligner's plain
    PyTorch version)."""

    def __init__(
        self,
        stages: Sequence[AdapterStage],
        filters: Sequence[FilterSpec] = (),
        length_bucket: int = 64,
        min_dp_batch: int = 4096,
        max_dp_batch: int = 131072,
        want_ref_coords: bool = False,
        qual_cap_base: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if qual_cap_base is not None:
            raise NotImplementedError(
                "quality capping before the filters (a host stage) is not "
                "ported yet"
            )
        for s in stages:
            if not isinstance(s, AdapterStage):
                raise NotImplementedError(
                    f"{type(s).__name__}: host stages are not ported yet"
                )
        if len(stages) > 1:
            raise ValueError("at most one adapter stage is supported")
        if want_ref_coords:
            raise NotImplementedError(
                "adapter-side coordinates (the wide result lane) are not "
                "ported yet"
            )
        self.stages = list(stages)
        self.filters = list(filters)
        self.length_bucket = length_bucket
        self.min_dp_batch = min_dp_batch
        self.max_dp_batch = max_dp_batch
        self._pinned = self.device.type == "cuda"

    # --- adapter stage -----------------------------------------------------

    def _bucket_length(self, max_len: int) -> int:
        b = self.length_bucket
        return max(b, (int(max_len) + b - 1) // b * b)

    def _dp_sizes(self, n: int) -> List[int]:
        """Dispatch batch sizes covering n reads: the binary
        decomposition of n over power-of-two buckets, floored at
        min_dp_batch, so padding is bounded by min_dp_batch per chunk."""
        sizes = []
        while n > self.max_dp_batch:
            sizes.append(self.max_dp_batch)
            n -= self.max_dp_batch
        s = self.max_dp_batch
        while n > 0:
            if n >= s or s <= self.min_dp_batch:
                sizes.append(s)
                n -= s
            else:
                s //= 2
        return sizes

    def _host_tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A host tensor holding ``arr``: pinned when the device is
        CUDA, so its upload can be asynchronous."""
        t = torch.from_numpy(arr)
        return t.pin_memory() if self._pinned else t

    def warmup(self, max_len: int) -> None:
        """Build the kernel library and launch every lane each adapter
        task can use once, at the smallest dispatch size."""
        width = self._bucket_length(max_len)
        lanes = (True, False) if native.AVAILABLE and _pack2_on() else (False,)
        for stage in self.stages:
            for task in stage.tasks:
                for p2 in lanes:
                    w_in = width // 4 if p2 else width // 2
                    enc = self._host_tensor(
                        np.zeros((self.min_dp_batch, w_in), np.uint8)
                    )
                    lens = self._host_tensor(
                        np.zeros(self.min_dp_batch, np.int16)
                    )
                    task.step(enc, lens, self.device, pack2=p2).numpy()

    def _encode(self, task, chunk, starts, lens, sel, rows, width,
                pack2: bool) -> torch.Tensor:
        """(rows, width/4 or /2) uint8 host tensor of the selected
        windows, packed as 2-bit or 4-bit class ids."""
        w_in = width // 4 if pack2 else width // 2
        enc_t = torch.zeros((rows, w_in), dtype=torch.uint8,
                            pin_memory=self._pinned)
        enc = enc_t.numpy()
        if native.AVAILABLE:
            native.pad_encode(
                chunk.buf, starts, lens, sel, width, task.lut,
                pack4=not pack2, pack2=pack2, out=enc, reverse=task.reverse,
            )
        else:
            from .io.chunks import pad_rows

            raw = pad_rows(chunk.buf, starts[sel], lens[sel], width)
            if task.reverse:
                rev = np.zeros_like(raw)
                for pos, (row, ln) in enumerate(zip(raw, lens[sel])):
                    rev[pos, :ln] = row[:ln][::-1]
                raw = rev
            e = task.lut[raw]
            if pack2:
                e = (
                    e[:, 0::4] | (e[:, 1::4] << 2)
                    | (e[:, 2::4] << 4) | (e[:, 3::4] << 6)
                )
            else:
                e = e[:, 0::2] | (e[:, 1::2] << 4)
            enc[: len(sel)] = e
        return enc_t

    def _dispatch_stage(self, stage, chunk, subset, win_start, win_stop,
                        width):
        """Prefilter + encode + dispatch of every task over `subset`'s
        current windows; returns one (sel, futures) per task."""
        starts = (chunk.seq_start[subset] + win_start[subset]).astype(np.int64)
        lens = (win_stop[subset] - win_start[subset]).astype(np.int32)
        return [
            self._dispatch_windows(t, chunk, starts, lens, width)
            for t in stage.tasks
        ]

    def _dispatch_windows(self, task, chunk, starts, lens, width):
        """Dispatch one task over explicit (starts, lens) window arrays;
        returns (sel positions into starts, futures)."""
        if task.pf_tables is not None and native.AVAILABLE:
            mask = native.kmer_prefilter(
                chunk.buf, starts, lens, task.pf_tables, reverse=task.reverse
            ).astype(bool)
            sel = np.flatnonzero(mask)
        else:
            # no prefilter (MockKmerFinder, native library unavailable):
            # every read is a candidate
            sel = np.arange(len(starts))
        futures = []
        if len(sel) == 0:
            return sel, futures
        c_starts = starts[sel]
        c_lens = lens[sel]
        if int(c_lens.max()) >= (1 << _QS_BITS):
            raise NotImplementedError(
                "windows of 2**14 bp or more need the wide result lane, "
                "which is not ported yet"
            )
        # 2-bit lane split: ACGT-class-only windows ride the 2-bit
        # encoding; the rare N/IUPAC-containing reads take the host
        # scalar aligner (zero wire) when few, or the 4-bit lane
        lanes = [(len(sel), False)]  # (count, pack2) over sel's order
        host_tail = 0
        if native.AVAILABLE and _pack2_on():
            clean = native.windows_clean(
                chunk.buf, c_starts, c_lens, width, task.lut,
                reverse=task.reverse,
            )
            n_clean = int(clean.sum())
            n_dirty = len(sel) - n_clean
            if n_dirty == 0:
                lanes = [(len(sel), True)]
            elif n_clean > 0:
                order = np.concatenate(
                    [np.flatnonzero(clean), np.flatnonzero(~clean)]
                )
                sel = sel[order]
                c_starts = c_starts[order]
                c_lens = c_lens[order]
                if n_dirty <= max(64, len(sel) >> 6):
                    lanes = [(n_clean, True)]
                    host_tail = n_dirty
                else:
                    lanes = [(n_clean, True), (n_dirty, False)]
        exact = _exact_wire_on(self.device)
        if exact and len(sel) > 1:
            # length-sort each lane segment (descending) so the batches
            # after the first get progressively narrower widths
            parts, seg_base = [], 0
            for count, _p2 in lanes:
                seg = np.arange(seg_base, seg_base + count)
                parts.append(seg[np.argsort(-c_lens[seg], kind="stable")])
                seg_base += count
            if seg_base < len(sel):  # host-scalar tail, order kept
                parts.append(np.arange(seg_base, len(sel)))
            perm = np.concatenate(parts)
            sel = sel[perm]
            c_starts = c_starts[perm]
            c_lens = c_lens[perm]
        tail_max = _scalar_tail_max() if native.AVAILABLE else 0
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
                if exact:
                    bmax = int(c_lens[base + off : base + off + take].max())
                    b_w = _eff_width(bmax, width, p2)
                else:
                    b_w = width
                enc = self._encode(
                    task, chunk, c_starts, c_lens,
                    np.arange(base + off, base + off + take, dtype=np.int64),
                    size, b_w, pack2=p2,
                )
                sub_len = self._host_tensor(_wire_lengths(
                    c_lens[base + off : base + off + take], size,
                    width=b_w if exact else None,
                ))
                _xfer_add(
                    h2d=enc.numel() + sub_len.numel() * sub_len.element_size(),
                    candidates=take, dp_rows=size,
                )
                fut = task.step(enc, sub_len, self.device, pack2=p2)
                fut.copy_to_host_async()
                futures.append((base + off, take, fut))
                off += size
            if dev_count < count:
                s0, s1 = base + dev_count, base + count
                _xfer_add(candidates=count - dev_count)
                futures.append(
                    ("host_range", s0)
                    + task.run_scalar(chunk, c_starts[s0:s1], c_lens[s0:s1])
                )
            base += count
        if host_tail:
            futures.append(
                ("host_range", base)
                + task.run_scalar(chunk, c_starts[base:], c_lens[base:])
            )
        return sel, futures

    def _fetch_task(self, n_cand, futures):
        found = np.zeros(n_cand, bool)
        qstart = np.zeros(n_cand, np.int32)
        qstop = np.zeros(n_cand, np.int32)
        errors = np.zeros(n_cand, np.int32)
        score = np.zeros(n_cand, np.int32)
        # adapter-side spans: only the scalar lane reports them (the
        # packed device result carries none)
        astart = np.zeros(n_cand, np.int32)
        astop = np.zeros(n_cand, np.int32)
        for fut in futures:
            if fut[0] == "host_range":  # scalar-aligner dirty tail
                _, off, f, qs, qe, er, sc, as_, ae = fut
                count = len(f)
                astart[off : off + count] = as_
                astop[off : off + count] = ae
            else:
                off, count, dev = fut
                arr = np.asarray(dev)
                _xfer_add(d2h=arr.nbytes)
                f, qs, qe, er, sc = unpack_result(arr[:, :count])
            found[off : off + count] = f
            qstart[off : off + count] = qs
            qstop[off : off + count] = qe
            errors[off : off + count] = er
            score[off : off + count] = sc
        return found, qstart, qstop, errors, score, astart, astop

    def _adapter_round(self, stage, chunk, subset, win_start, win_stop,
                       width, dispatched=None, last_gid=None):
        """One matching round over `subset`. Returns (matched_mask_over_
        subset, events) and updates windows (and last_gid) in place."""
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
        for t_i, (task, (sel, futures)) in enumerate(
            zip(stage.tasks, dispatched)
        ):
            if len(sel) == 0:
                continue
            cand = subset[sel]
            lens = (win_stop[cand] - win_start[cand]).astype(np.int32)
            f, qs, qe, er, sc, as_, ae = self._fetch_task(len(sel), futures)
            if task.reverse:
                # mirror reversed coordinates to forward orientation
                qs, qe = lens - qe, lens - qs
                m_len = len(task.spec.reference)
                as_, ae = m_len - ae, m_len - as_
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

        matched = best_found[subset]
        # routing ids for demultiplexing: the LAST match decides
        if last_gid is not None:
            idx = np.flatnonzero(best_found)
            last_gid[idx] = np.asarray(stage.gid_base, np.int32)[best_task[idx]]
        events = []
        for t_i, task in enumerate(stage.tasks):
            hit = np.flatnonzero(best_found & (best_task == t_i))
            if len(hit) == 0:
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
                     sub=np.zeros(len(hit), np.int32),
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

    # --- public API --------------------------------------------------------

    def submit(self, parsed) -> PendingBatch:
        """Start a chunk: prefilter, encode and launch its DP batches."""
        B = parsed.n_records
        win_start = np.zeros(B, np.int32)
        win_stop = parsed.seq_len.astype(np.int32).copy()
        stats = dict(n=B, total_bp=int(parsed.seq_len.sum()))
        stage = self.stages[0] if self.stages else None
        dp_futures = None
        width = 0
        if stage is not None and B > 0:
            width = self._bucket_length(int((win_stop - win_start).max()))
            dp_futures = self._dispatch_stage(
                stage, parsed, np.arange(B), win_start, win_stop, width
            )
        return PendingBatch(
            parsed, win_start, win_stop, stats, stage, dp_futures, width
        )

    def _run_rounds(self, stage, chunk, win_start, win_stop, width,
                    dispatched, last_gid):
        """Run all `times` matching rounds; mutates windows/last_gid in
        place; returns (matched_any mask, events)."""
        B = chunk.n_records
        subset = np.arange(B)
        matched, events_all = self._adapter_round(
            stage, chunk, subset, win_start, win_stop, width,
            dispatched=dispatched, last_gid=last_gid,
        )
        matched_any = np.zeros(B, bool)
        matched_any[subset[matched]] = True
        active = subset[matched]
        for _ in range(1, stage.times):
            if len(active) == 0:
                break
            matched, events = self._adapter_round(
                stage, chunk, active, win_start, win_stop, width,
                last_gid=last_gid,
            )
            events_all.extend(events)
            active = active[matched]
        return matched_any, events_all

    def collect(self, pending: PendingBatch):
        """Finish a chunk: fetch the DP results, update the windows, run
        the filters. Returns (win_start, win_stop, keep, stats)."""
        chunk = pending.parsed
        B = chunk.n_records
        win_start, win_stop = pending.win_start, pending.win_stop
        stats = pending.stats
        matched_any = np.zeros(B, bool)
        last_gid = np.full(B, -1, np.int32)
        stage = pending.adapter_stage
        if stage is not None and B > 0:
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
        for f in self.filters:
            drop = filter_condition(
                f.kind, f.threshold, chunk, win_start, win_stop, lengths,
                matched_any, mask_remainder=mask_remainder,
            )
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
