"""
Scatter-add of statistics events on the GPU: the wrapper of the CUDA
kernel ``csrc/stats_scatter.cu`` and its plain PyTorch version.

They replace the XLA scatter-add programs of
``cutadapt_tpu/parallel/stats.py:DeviceStatsReducer`` (``_acc``): int32
count buffers that events are binned into where they live, so that only
the buffers, never the per-read events, leave the device. Three entry
points, each updating ``buf`` in place on its device's current stream:

- :func:`scatter_add_2d`: ``buf[rows[i], cols[i]] += valid[i]``;
- :func:`scatter_add_1d`: ``buf[idx[i]] += valid[i]``;
- :func:`count_add`: ``buf += valid.sum()`` (the popcount of a mask).

Events are (n,) int32 tensors on the buffer's device. An event whose
index lies outside the buffer is dropped, as XLA's scatter drops it.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version (``index_put_`` with ``accumulate=True``, a sum). There is
no fallback from one to the other. The kernel library is compiled with
nvcc on first use into ``csrc/build/``, like the aligner's.
"""

import ctypes
import os
import threading

import torch

from .align_cuda import _CSRC, build_shared_library

_SRC = os.path.join(_CSRC, "stats_scatter.cu")
# threads per block (csrc/stats_scatter.cu:kThreads)
THREADS = 256
ENTRY_POINTS = ("hist2d", "hist1d", "count")

# kernel launches per entry point; only the launch path adds to them
LAUNCHES = dict.fromkeys(ENTRY_POINTS, 0)
# calls that ran the plain version (CPU tensors), per entry point
PLAIN_RUNS = dict.fromkeys(ENTRY_POINTS, 0)
_COUNT_LOCK = threading.Lock()
# how the kernel library was obtained: path, build seconds, nvcc log
BUILD_INFO = {}

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counters() -> None:
    with _COUNT_LOCK:
        for name in ENTRY_POINTS:
            LAUNCHES[name] = 0
            PLAIN_RUNS[name] = 0


def build_library() -> str:
    """Compile the scatter kernel library (once per source and flag
    hash) and return its path; the build is recorded in BUILD_INFO."""
    return build_shared_library(_SRC, BUILD_INFO)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.stats_scatter_threads.restype = ci
            lib.stats_scatter_threads.argtypes = []
            lib.stats_hist2d_launch.restype = ci
            lib.stats_hist2d_launch.argtypes = [vp] * 4 + [cl, ci, ci, vp]
            lib.stats_hist1d_launch.restype = ci
            lib.stats_hist1d_launch.argtypes = [vp] * 3 + [cl, ci, vp]
            lib.stats_count_launch.restype = ci
            lib.stats_count_launch.argtypes = [vp] * 2 + [cl, vp]
            if lib.stats_scatter_threads() != THREADS:
                raise RuntimeError(
                    f"scatter library has {lib.stats_scatter_threads()} "
                    f"threads per block, the wrapper expects {THREADS}"
                )
            _LIB = lib
    return _LIB


def _check(buf: torch.Tensor, ndim, *events: torch.Tensor) -> None:
    if buf.dtype != torch.int32 or buf.dim() not in ndim:
        raise ValueError(f"the buffer must be int32 of {ndim[0]} dimensions, "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("the buffer must be contiguous")
    n = events[0].shape
    for ev in events:
        if ev.dtype != torch.int32 or ev.dim() != 1 or ev.shape != n:
            raise ValueError(f"events must be (n,) int32 of one length, got "
                             f"{ev.dtype} {tuple(ev.shape)}")
        if ev.device != buf.device:
            raise ValueError(f"buffer on {buf.device} but events on "
                             f"{ev.device}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {buf.device}")


def _plain(name: str) -> None:
    with _COUNT_LOCK:
        PLAIN_RUNS[name] += 1


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"stats_scatter {name} kernel launch failed: CUDA error {err}"
        )
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def scatter_add_2d(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """``buf[rows[i], cols[i]] += valid[i]`` for every event, in place."""
    _check(buf, (2,), rows, cols, valid)
    if buf.device.type == "cpu":
        _plain("hist2d")
        scatter_add_2d_reference(buf, rows, cols, valid)
        return
    n = rows.shape[0]
    if n == 0:
        return
    rows, cols, valid = (t.contiguous() for t in (rows, cols, valid))
    with torch.cuda.device(buf.device):
        err = _library().stats_hist2d_launch(
            buf.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            valid.data_ptr(), n, buf.shape[0], buf.shape[1], _stream(buf),
        )
    _launched("hist2d", err)


def scatter_add_1d(buf: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """``buf[idx[i]] += valid[i]`` for every event, in place."""
    _check(buf, (1,), idx, valid)
    if buf.device.type == "cpu":
        _plain("hist1d")
        scatter_add_1d_reference(buf, idx, valid)
        return
    n = idx.shape[0]
    if n == 0:
        return
    idx, valid = idx.contiguous(), valid.contiguous()
    with torch.cuda.device(buf.device):
        err = _library().stats_hist1d_launch(
            buf.data_ptr(), idx.data_ptr(), valid.data_ptr(), n,
            buf.shape[0], _stream(buf),
        )
    _launched("hist1d", err)


def count_add(buf: torch.Tensor, valid: torch.Tensor) -> None:
    """``buf += valid.sum()`` in place; ``buf`` holds one int32."""
    _check(buf, (0, 1), valid)
    if buf.numel() != 1:
        raise ValueError(f"the count buffer holds one int32, got "
                         f"{tuple(buf.shape)}")
    if buf.device.type == "cpu":
        _plain("count")
        count_add_reference(buf, valid)
        return
    n = valid.shape[0]
    if n == 0:
        return
    valid = valid.contiguous()
    with torch.cuda.device(buf.device):
        err = _library().stats_count_launch(
            buf.data_ptr(), valid.data_ptr(), n, _stream(buf),
        )
    _launched("count", err)


# --- the plain PyTorch versions ---------------------------------------------


def scatter_add_2d_reference(buf, rows, cols, valid) -> None:
    R, C = buf.shape
    ok = (rows >= 0) & (rows < R) & (cols >= 0) & (cols < C)
    buf.index_put_((rows[ok].long(), cols[ok].long()), valid[ok],
                   accumulate=True)


def scatter_add_1d_reference(buf, idx, valid) -> None:
    ok = (idx >= 0) & (idx < buf.shape[0])
    buf.index_put_((idx[ok].long(),), valid[ok], accumulate=True)


def count_add_reference(buf, valid) -> None:
    buf += valid.sum(dtype=torch.int32)
