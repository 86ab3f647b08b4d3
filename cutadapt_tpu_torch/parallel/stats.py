"""
Device-reduced statistics for the batch engine.

The port of ``cutadapt_tpu/parallel/stats.py``. With a reducer, the
engine's mergeable statistics (the per-adapter-end removed length x
errors histograms, adjacent-base counts, written-length histograms and
filter counters) are binned on the device instead of on the host. Each
shard of the mesh bins its slice of a chunk's events into its own
partial buffer on its own device with the scatter kernel
(``ops/stats_cuda.py``), so no add does any cross-device work and none
waits for the in-flight DP launches of another device. :meth:`fold`,
after the drive has drained, sums the partials on the first shard's
device (one copy per partial, the port's ``psum``), copies each total to
the host once and hands it to the same host Statistics objects the
host-side fold fills (``EndStatistics.record_removal(count=...)`` and
the like), so the report is rendered as without a reducer.

So per-read data never leaves its shard: only fixed-shape int32 counter
buffers cross devices, once per run. Without a mesh there is one
partial, on the engine's device.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops.align_cuda import resolve_device
from ..ops.stats_cuda import count_add, scatter_add_1d, scatter_add_2d
from .mesh import on_device, sum_partials


# fold() calls that folded at least one buffer, over the process
FOLDS = 0


def _round_dim(n: int) -> int:
    """Buffer dimensions grow in steps of 64, as the JAX reducer's."""
    return (n + 63) // 64 * 64


class DeviceStatsReducer:
    """Keyed int32 count buffers on the devices of ``mesh`` (one partial
    per shard, shard i on ``mesh.devices[i]``), or, without a mesh, one
    buffer on ``device`` (None: CUDA).

    Keys are arbitrary hashables; the first ``add_*`` of a key fixes its
    kind and fold callback. :meth:`fold` sums every buffer's partials,
    fetches it once and calls the key's callback with the numpy array
    (an ``int`` for counts). The adds of a run come from one thread (the
    drive's emit thread) and fold from the caller after the drive."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        self.devices = (
            tuple(mesh.devices) if mesh is not None
            else (resolve_device(device),)
        )
        self._bufs: Dict[object, List[torch.Tensor]] = {}
        self._folds: Dict[object, Callable] = {}
        self._shapes: Dict[object, Tuple[int, ...]] = {}

    # --- buffer management ---------------------------------------------

    def _buffer(self, key, shape: Tuple[int, ...], fold: Callable):
        """The partials of ``key``, grown to cover ``shape``; a grown
        buffer takes the old region by a copy on its device."""
        cur = self._bufs.get(key)
        if cur is None:
            self._folds[key] = fold
            self._shapes[key] = shape
            cur = [torch.zeros(shape, dtype=torch.int32, device=d)
                   for d in self.devices]
            self._bufs[key] = cur
            return cur
        old = self._shapes[key]
        if all(n <= o for n, o in zip(shape, old)):
            return cur
        new = tuple(max(n, o) for n, o in zip(shape, old))
        region = tuple(slice(0, o) for o in old)
        grown = []
        for d, part in zip(self.devices, cur):
            with on_device(d):
                g = torch.zeros(new, dtype=torch.int32, device=d)
                g[region] = part
            grown.append(g)
        self._bufs[key] = grown
        self._shapes[key] = new
        return grown

    def _shards(self, *arrays: np.ndarray) -> list:
        """The events on the shards' devices: padded with zeros to a
        multiple of the shard count (the last array is ``valid``, so a
        padding event counts nothing), cut into equal row slices, one
        upload per shard. Returns [(shard index, [event tensors])]."""
        size = len(self.devices)
        n = len(arrays[0])
        per = -(-n // size)
        ev = np.zeros((len(arrays), per * size), np.int32)
        for row, a in zip(ev, arrays):
            row[:n] = a
        host = torch.from_numpy(np.ascontiguousarray(
            ev.reshape(len(arrays), size, per).transpose(1, 0, 2)))
        if self.devices[0].type == "cuda":
            # pinned, so that the uploads queue behind the in-flight DP
            # launches instead of waiting for them
            host = host.pin_memory()
        out = []
        for i, d in enumerate(self.devices):
            with on_device(d):
                out.append((i, list(host[i].to(d, non_blocking=True))))
        return out

    # --- public accumulation API ----------------------------------------

    def add_hist2d(self, key, rows, cols, fold: Callable) -> None:
        """buffer[rows[i], cols[i]] += 1 for every i."""
        n = len(rows)
        if n == 0:
            # register the fold so that zero-event adapters still render
            self._buffer(key, (_round_dim(1), _round_dim(1)), fold)
            return
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        shape = (_round_dim(int(rows.max()) + 1),
                 _round_dim(int(cols.max()) + 1))
        bufs = self._buffer(key, shape, fold)
        for i, (r, c, v) in self._shards(rows, cols, np.ones(n, np.int32)):
            with on_device(self.devices[i]):
                scatter_add_2d(bufs[i], r, c, v)

    def add_hist1d(self, key, values, fold: Callable) -> None:
        """buffer[values[i]] += 1 for every i."""
        n = len(values)
        if n == 0:
            self._buffer(key, (_round_dim(1),), fold)
            return
        values = np.asarray(values, np.int32)
        bufs = self._buffer(key, (_round_dim(int(values.max()) + 1),), fold)
        for i, (r, v) in self._shards(values, np.ones(n, np.int32)):
            with on_device(self.devices[i]):
                scatter_add_1d(bufs[i], r, v)

    def add_count(self, key, mask, fold: Callable) -> None:
        """buffer += popcount(mask)."""
        bufs = self._buffer(key, (), fold)
        if len(mask) == 0:
            return
        for i, (v,) in self._shards(np.asarray(mask, np.int32)):
            with on_device(self.devices[i]):
                count_add(bufs[i], v)

    # --- final fold -------------------------------------------------------

    def fold(self) -> None:
        """Sum each buffer's partials once, fetch it once, fold it into
        the host objects through its callback and clear. Call it after
        the drive has drained."""
        for key, parts in self._bufs.items():
            arr = sum_partials(parts)
            self._folds[key](arr if arr.ndim else int(arr))
        global FOLDS
        if self._bufs:
            FOLDS += 1
        self._bufs.clear()
        self._folds.clear()
        self._shapes.clear()
