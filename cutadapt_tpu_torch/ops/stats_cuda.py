"""
Scatter-add of statistics events on the GPU: the wrapper of the CUDA
kernel ``csrc/stats_scatter.cu`` and its plain PyTorch version.

They replace the XLA scatter-add programs of
``cutadapt_tpu/parallel/stats.py:DeviceStatsReducer`` (``_acc``): int32
count buffers that events are binned into where they live, so that only
the buffers, never the per-read events, leave the device.

One entry point, :func:`scatter_add_batch`, bins a batch of descriptors
in one kernel launch (one per MAX_DESCRIPTORS, see :func:`plan_batch`).
A descriptor is one buffer and its events, in one of three forms:

- ``(buf, rows, cols, w)``, buf of shape (R, C):
  ``buf[rows[i], cols[i]] += w[i]``;
- ``(buf, idx, w)``, buf of shape (R,): ``buf[idx[i]] += w[i]``;
- ``(buf, w)``, buf of one int32 (a count): ``buf += w.sum()``.

Events are (n,) int32 tensors on the buffer's device; ``w`` may be None
in the first two forms, for a weight of 1. An event whose index lies
outside the buffer is dropped, as XLA's scatter drops it.
:func:`scatter_add_2d`, :func:`scatter_add_1d` and :func:`count_add`
are one-descriptor calls of the batch.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version (``index_put_`` with ``accumulate=True``, a sum). There is
no fallback from one to the other. The kernel library is compiled with
nvcc on first use into ``csrc/build/``, like the aligner's.
"""

import ctypes
import os
import struct
import threading
from contextlib import nullcontext
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .align_cuda import _CSRC, build_shared_library

_SRC = os.path.join(_CSRC, "stats_scatter.cu")
# the kernel's constants (csrc/stats_scatter.cu), checked against the
# library when it loads: threads per block, blocks per cluster, the
# descriptors one launch takes, the int32 bins a block holds in shared
# memory (a larger buffer is binned in direct mode, with global atomics),
# the events a cluster takes per pass, and the most clusters a
# descriptor gets
THREADS = 512
CLUSTER = 8
MAX_DESCRIPTORS = 16
MAX_BINS_PER_BLOCK = 12288
EVENTS_PER_CLUSTER = CLUSTER * THREADS
MAX_CLUSTERS_PER_DESCRIPTOR = 16
MODES = ("cluster", "direct")

# kernel launches; only the launch path adds to them
LAUNCHES = {"batch": 0}
# launches the plain version stood in for (CPU tensors)
PLAIN_RUNS = {"batch": 0}
# descriptors launched, by mode
DESCRIPTORS = dict.fromkeys(MODES, 0)
_COUNT_LOCK = threading.Lock()
# how the kernel library was obtained: path, build seconds, nvcc log
BUILD_INFO = {}

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counters() -> None:
    with _COUNT_LOCK:
        LAUNCHES["batch"] = 0
        PLAIN_RUNS["batch"] = 0
        for mode in MODES:
            DESCRIPTORS[mode] = 0


def build_library() -> str:
    """Compile the scatter kernel library (once per source and flag
    hash) and return its path; the build is recorded in BUILD_INFO."""
    return build_shared_library(_SRC, BUILD_INFO)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            ci = ctypes.c_int
            for name, want in (
                ("threads", THREADS), ("cluster", CLUSTER),
                ("max_descriptors", MAX_DESCRIPTORS),
                ("max_bins_per_block", MAX_BINS_PER_BLOCK),
                ("events_per_cluster", EVENTS_PER_CLUSTER),
                ("max_clusters_per_descriptor", MAX_CLUSTERS_PER_DESCRIPTOR),
            ):
                fn = getattr(lib, f"stats_scatter_{name}")
                fn.restype = ci
                fn.argtypes = []
                if fn() != want:
                    raise RuntimeError(
                        f"scatter library has {name} {fn()}, the wrapper "
                        f"expects {want}"
                    )
            lib.stats_scatter_batch_launch.restype = ci
            # the table goes in as the bytes of a packed int64 array
            lib.stats_scatter_batch_launch.argtypes = [
                ctypes.c_char_p, ci, ctypes.c_void_p]
            _LIB = lib
    return _LIB


# --- planning (plain Python, so that the CPU tests reach it) ---------------


class Launch(NamedTuple):
    """One kernel launch: the descriptors it bins (indices into the
    batch), each one's bins per block (0 for direct mode) and its
    clusters."""

    descriptors: Tuple[int, ...]
    bins_per_block: Tuple[int, ...]
    clusters: Tuple[int, ...]


def bins_per_block(bins: int) -> int:
    """A buffer's bins per block: each block of a cluster bins into its
    own copy of all the bins, and block r then sums bins [r * per,
    (r + 1) * per) over the cluster. 0 means direct mode: the buffer does
    not fit in a block's shared memory."""
    return -(-bins // CLUSTER) if bins <= MAX_BINS_PER_BLOCK else 0


def clusters_for(n: int) -> int:
    """The clusters that walk a descriptor's n events: one per
    EVENTS_PER_CLUSTER, at most MAX_CLUSTERS_PER_DESCRIPTOR."""
    return max(1, min(-(-n // EVENTS_PER_CLUSTER),
                      MAX_CLUSTERS_PER_DESCRIPTOR))


def plan_batch(sizes: Sequence[Tuple[int, int]]) -> List[Launch]:
    """The launches of a batch of descriptors, given (bins, events) for
    each: MAX_DESCRIPTORS per launch, in order. A descriptor without
    events or bins changes nothing and launches nothing. Descriptors of
    one buffer may share a launch: every add to the buffer is atomic."""
    live = [j for j, (bins, n) in enumerate(sizes) if n and bins]
    return [
        Launch(tuple(part),
               tuple(bins_per_block(sizes[j][0]) for j in part),
               tuple(clusters_for(sizes[j][1]) for j in part))
        for part in (live[k:k + MAX_DESCRIPTORS]
                     for k in range(0, len(live), MAX_DESCRIPTORS))
    ]


# --- the wrapper ------------------------------------------------------------


class _Desc(NamedTuple):
    buf: torch.Tensor
    idx: Optional[torch.Tensor]
    col: Optional[torch.Tensor]
    w: Optional[torch.Tensor]
    n: int
    rows: int
    cols: int


# a descriptor's length -> its buffer's dimensions (0: a count)
_FORMS = {4: 2, 3: 1, 2: 0}


def _descriptor(d) -> _Desc:
    """Check one descriptor and bring it to (buf, idx, col, w)."""
    ndim = _FORMS.get(len(d))
    if ndim is None:
        raise ValueError("a descriptor is (buf, rows, cols, w), (buf, idx, "
                         "w) or (buf, w)")
    buf, events = d[0], d[1:]
    if buf.dtype != torch.int32 or not buf.is_contiguous() or (
            buf.dim() != ndim if ndim else buf.numel() != 1):
        raise ValueError(
            f"the buffer must be contiguous int32 of "
            f"{f'{ndim} dimensions' if ndim else 'one element'}, got "
            f"{buf.dtype} {tuple(buf.shape)}")
    if not (buf.is_cuda or buf.is_cpu):
        raise ValueError(f"unsupported device {buf.device}")
    if any(ev is None for ev in events[:len(events) - (ndim > 0)]):
        raise ValueError("only the weights of a histogram may be None")
    n = events[0].shape[0]
    dev = buf.get_device()
    for ev in events:
        if ev is not None and (ev.dtype != torch.int32 or ev.dim() != 1
                               or ev.shape[0] != n
                               or ev.get_device() != dev):
            raise ValueError(
                f"events must be (n,) int32 of one length on the buffer's "
                f"device {buf.device}, got {ev.dtype} {tuple(ev.shape)} on "
                f"{ev.device}")
    events = [None if ev is None else ev.contiguous() for ev in events]
    if ndim == 2:
        idx, col, w = events
        rows, cols = buf.shape
    elif ndim == 1:
        (idx, w), col = events, None
        rows, cols = buf.shape[0], 1
    else:
        (w,), idx, col = events, None, None
        rows = cols = 1
    return _Desc(buf, idx, col, w, n, rows, cols)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def scatter_add_batch(descriptors: Sequence[tuple]) -> None:
    """Bin every descriptor's events into its buffer, in place, on the
    buffers' device and its current stream (see the module docstring for
    the forms). Descriptors of one buffer may repeat; they add up."""
    descs = [_descriptor(d) for d in descriptors]
    if not descs:
        return
    dev = descs[0].buf.get_device()  # -1: the CPU
    if any(d.buf.get_device() != dev for d in descs):
        raise ValueError("every buffer of a batch must be on one device")
    plan = plan_batch([(d.rows * d.cols, d.n) for d in descs])
    if dev < 0:
        with _COUNT_LOCK:
            PLAIN_RUNS["batch"] += len(plan)
        for launch in plan:
            for j in launch.descriptors:
                _plain_descriptor(descs[j])
        return
    lib = _library()
    # the launch goes to the calling thread's current device
    with (nullcontext() if torch.cuda.current_device() == dev
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan:
            table = []
            for j, per, clusters in zip(*launch):
                d = descs[j]
                table += (_ptr(d.buf), _ptr(d.idx), _ptr(d.col), _ptr(d.w),
                          d.n, d.rows, d.cols, per, clusters)
            err = lib.stats_scatter_batch_launch(
                struct.pack(f"{len(table)}q", *table),
                len(launch.descriptors), stream)
            if err != 0:
                raise RuntimeError(
                    f"stats_scatter batch kernel launch failed: CUDA error "
                    f"{err}")
            with _COUNT_LOCK:
                LAUNCHES["batch"] += 1
                for per in launch.bins_per_block:
                    DESCRIPTORS["cluster" if per else "direct"] += 1


def scatter_add_2d(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """``buf[rows[i], cols[i]] += valid[i]`` for every event, in place."""
    scatter_add_batch([(buf, rows, cols, valid)])


def scatter_add_1d(buf: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """``buf[idx[i]] += valid[i]`` for every event, in place."""
    scatter_add_batch([(buf, idx, valid)])


def count_add(buf: torch.Tensor, valid: torch.Tensor) -> None:
    """``buf += valid.sum()`` in place; ``buf`` holds one int32."""
    scatter_add_batch([(buf, valid)])


# --- the plain PyTorch versions ---------------------------------------------


def _plain_descriptor(d: _Desc) -> None:
    if d.idx is None:
        d.buf.add_(d.w.sum(dtype=torch.int32))
        return
    w = d.w if d.w is not None else torch.ones(
        d.n, dtype=torch.int32, device=d.buf.device)
    ok = (d.idx >= 0) & (d.idx < d.rows)
    if d.col is not None:
        ok &= (d.col >= 0) & (d.col < d.cols)
        d.buf.index_put_((d.idx[ok].long(), d.col[ok].long()), w[ok],
                         accumulate=True)
    else:
        d.buf.index_put_((d.idx[ok].long(),), w[ok], accumulate=True)


def scatter_add_batch_reference(descriptors: Sequence[tuple]) -> None:
    """The plain version of :func:`scatter_add_batch` on any device (no
    counter moves)."""
    for d in descriptors:
        _plain_descriptor(_descriptor(d))

