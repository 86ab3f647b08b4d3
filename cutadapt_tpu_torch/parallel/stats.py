"""
Device-reduced statistics for the batch engine.

The port of ``cutadapt_tpu/parallel/stats.py``. With a reducer, the
engine's mergeable statistics (the per-adapter-end removed length x
errors histograms, adjacent-base counts, written-length histograms and
filter counters) are binned on the device instead of on the host.

The ``add_*`` calls only stage their events on the host. :meth:`flush`,
which the drives call once at the end of each chunk's emit, bins what
was staged: each shard of the mesh gets its slice of every key's events
in one upload and bins them into its own partial buffers on its own
device with one launch of the scatter kernel (``ops/stats_cuda.py``),
so no flush does any cross-device work and none waits for the in-flight
DP launches of another device. :meth:`fold`, after the drive has
drained, flushes, sums the partials on the first shard's device (one
copy per partial, the port's ``psum``), copies each total to the host
once and hands it to the same host Statistics objects the host-side
fold fills (``EndStatistics.record_removal(count=...)`` and the like),
so the report is rendered as without a reducer.

So per-read data never leaves its shard: only fixed-shape int32 counter
buffers cross devices, once per run. Without a mesh there is one
partial, on the engine's device.
"""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.align_cuda import resolve_device
from ..ops.stats_cuda import scatter_add_batch
from .mesh import on_device, sum_partials


# fold() calls that folded at least one buffer, over the process
FOLDS = 0
# each event array starts at a multiple of this many int32 in a shard's
# upload, so that a warp's loads of it are aligned
_ALIGN = 32


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
    (an ``int`` for counts). The adds and flushes of a run come from one
    thread (the drive's emit thread) and fold from the caller after the
    drive."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        self.devices = (
            tuple(mesh.devices) if mesh is not None
            else (resolve_device(device),)
        )
        self._bufs: Dict[object, List[torch.Tensor]] = {}
        self._folds: Dict[object, Callable] = {}
        self._shapes: Dict[object, Tuple[int, ...]] = {}
        # staged since the last flush: the shape each key needs, and its
        # event arrays, one (arrays, weights or None) per add
        self._want: Dict[object, Tuple[int, ...]] = {}
        self._staged: Dict[object, list] = {}
        # per shard: two pinned staging buffers used in turn, the CUDA
        # event recorded after each one's upload, and whose turn it is
        self._pinned = [[None, None] for _ in self.devices]
        self._uploaded = [[None, None] for _ in self.devices]
        self._turn = [0] * len(self.devices)

    # --- buffer management ---------------------------------------------

    def _buffer(self, key, shape: Tuple[int, ...]):
        """The partials of ``key``, grown to cover ``shape``; a grown
        buffer takes the old region by a copy on its device."""
        cur = self._bufs.get(key)
        if cur is None:
            self._shapes[key] = shape
            cur = []
            for d in self.devices:
                with on_device(d):
                    cur.append(torch.zeros(shape, dtype=torch.int32,
                                           device=d))
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

    def _stage(self, key, fold, shape, arrays=(), weights=None) -> None:
        if key not in self._folds:
            self._folds[key] = fold
        want = self._want.get(key)
        self._want[key] = shape if want is None else tuple(
            max(a, b) for a, b in zip(shape, want))
        n = len(weights) if weights is not None else (
            len(arrays[0]) if arrays else 0)
        if n:
            self._staged.setdefault(key, []).append((arrays, weights))

    def _upload(self, i: int, arrays: list, size: int) -> torch.Tensor:
        """Shard i's event arrays, each at its offset, in one int32
        tensor of ``size`` on the shard's device: on a CUDA shard one
        upload from one of its two pinned buffers, taken in turn once the
        upload that last read it has completed (call it on the device)."""
        d = self.devices[i]
        if d.type != "cuda":
            host = torch.empty(size, dtype=torch.int32)
        else:
            k = self._turn[i]
            self._turn[i] ^= 1
            if self._uploaded[i][k] is not None:
                self._uploaded[i][k].synchronize()
            host = self._pinned[i][k]
            if host is None or host.numel() < size:
                # the old buffer goes back to PyTorch's pinned cache,
                # which reuses it only once its last upload has completed
                host = torch.empty(max(size, 1 << 16), dtype=torch.int32,
                                   pin_memory=True)
                self._pinned[i][k] = host
        flat = host.numpy()
        for a, off in arrays:
            flat[off:off + len(a)] = a
        if d.type != "cuda":
            return host
        # pinned, so that the upload queues behind the in-flight DP
        # launches instead of waiting for them
        dev = host[:size].to(d, non_blocking=True)
        self._uploaded[i][k] = torch.cuda.Event()
        self._uploaded[i][k].record(torch.cuda.current_stream(d))
        return dev

    # --- public accumulation API ----------------------------------------

    def add_hist2d(self, key, rows, cols, fold: Callable) -> None:
        """buffer[rows[i], cols[i]] += 1 for every i (staged until the
        next flush)."""
        if len(rows) == 0:
            # register the fold so that zero-event adapters still render
            self._stage(key, fold, (_round_dim(1), _round_dim(1)))
            return
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        self._stage(key, fold, (_round_dim(int(rows.max()) + 1),
                                _round_dim(int(cols.max()) + 1)),
                    (rows, cols))

    def add_hist1d(self, key, values, fold: Callable,
                   weights: Optional[np.ndarray] = None) -> None:
        """buffer[values[i]] += weights[i] (1 without weights) for every
        i (staged until the next flush)."""
        if len(values) == 0:
            self._stage(key, fold, (_round_dim(1),))
            return
        values = np.asarray(values, np.int32)
        if weights is not None:
            weights = np.asarray(weights, np.int32)
        self._stage(key, fold, (_round_dim(int(values.max()) + 1),),
                    (values,), weights)

    def add_count(self, key, mask, fold: Callable) -> None:
        """buffer += popcount(mask) (staged until the next flush)."""
        self._stage(key, fold, (), (), np.asarray(mask, np.int32))

    # --- binning ----------------------------------------------------------

    def flush(self) -> None:
        """Bin everything staged since the last flush: grow the buffers,
        cut each key's merged events into the shards' row slices (shard
        i gets events [i * per, (i + 1) * per), per = ceil(n / shards)),
        and on each shard make one upload of all its slices and one
        scatter_add_batch of one descriptor per key."""
        for key, shape in self._want.items():
            self._buffer(key, shape)
        self._want.clear()
        merged = [(key, _merge(adds)) for key, adds in self._staged.items()]
        self._staged.clear()
        if not merged:
            return
        size = len(self.devices)
        for i, d in enumerate(self.devices):
            parts = []  # (key, [offset or None per event array])
            arrays = []  # (array, offset) of everything to upload
            total = 0
            for key, (events, weights) in merged:
                n = len(weights if weights is not None else events[0])
                per = -(-n // size)
                lo, hi = min(i * per, n), min((i + 1) * per, n)
                if hi == lo:
                    continue
                offs = []
                for a in (*events, weights):
                    if a is None:
                        offs.append(None)
                        continue
                    offs.append((total, hi - lo))
                    arrays.append((a[lo:hi], total))
                    total += -(-(hi - lo) // _ALIGN) * _ALIGN
                parts.append((key, offs))
            if not parts:
                continue
            with on_device(d):
                dev = self._upload(i, arrays, total)
                scatter_add_batch([
                    (self._bufs[key][i], *(
                        None if o is None else dev[o[0]:o[0] + o[1]]
                        for o in offs))
                    for key, offs in parts])

    # --- final fold -------------------------------------------------------

    def fold(self) -> None:
        """Flush, sum each buffer's partials once, fetch it once, fold it
        into the host objects through its callback and clear. Call it
        after the drive has drained."""
        self.flush()
        for key, fold in self._folds.items():
            arr = sum_partials(self._bufs[key])
            fold(arr if arr.ndim else int(arr))
        global FOLDS
        if self._bufs:
            FOLDS += 1
        self._bufs.clear()
        self._folds.clear()
        self._shapes.clear()


def _merge(adds: list):
    """One key's staged adds as one set of event arrays and weights
    (None where every add had weight 1)."""
    arrays = tuple(np.concatenate(col) if len(adds) > 1 else col[0]
                   for col in zip(*(a for a, _ in adds)))
    if all(w is None for _, w in adds):
        return arrays, None
    ws = [w if w is not None else np.ones(len(a[0]), np.int32)
          for a, w in adds]
    return arrays, np.concatenate(ws) if len(ws) > 1 else ws[0]
