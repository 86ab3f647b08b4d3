"""
Submit's staged pass: how the windows of one dispatch become the host
tensors of its dispatch batches.

A dispatch (one kernel task, or one upload group of tasks) over a
chunk's windows takes two native calls, each one run of C++ with the
GIL released (``native/hostops.cpp``):

- :func:`native.stage_select`: the k-mer prefilter of every task (the
  union for a group; none for a task without prefilter tables), the
  candidates compacted, the 2-bit clean test and the lane split, and in
  exact-wire mode each lane ordered longest first;
- :func:`encode`: every dispatch batch of every lane, at its own row
  width and packing, with its wire lengths, into one slot of the
  engine's :class:`StagingArena`, as :func:`layout` placed them.

The batch tensors handed to the launches are views of the slot. The
engine is not built without the native library, so neither step has
another form.
"""

import threading
from typing import Optional

import numpy as np
import torch

from . import native, tracing

# byte alignment of each batch's rows and lengths in a slot
_ALIGN = 64
# a slot grows to this share of what the pass that grows it needs, so
# that the next chunks of the same traffic fit
_HEADROOM = 1.5
# columns of one row of the layout (hostops.cpp:stage_encode)
_LAYOUT_COLS = 8
_WIRE_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}


def row_bytes(width: int, pack2: Optional[bool]) -> int:
    """Bytes of one encoded row of ``width`` bases: 2-bit (pack2 True),
    4-bit (False) or one byte a base (None, the byte lane)."""
    if pack2 is None:
        return width
    return width // 4 if pack2 else width // 2


def wire_bytes(wide: bool, width: Optional[int]) -> int:
    """Bytes of one window length on the wire: int32 in the wide result
    format (long reads overflow int16 at 32,768 bp), one byte on the
    exact-wire path (``width`` given) when the batch width fits uint8,
    else int16 (the packed format's windows are < 2**14). The kernel
    reads int32: the step widens them on the device."""
    if wide:
        return 4
    return 1 if width is not None and width < 256 else 2


def layout(batches, wide: bool, exact: bool):
    """Where each batch of ``batches`` ((first row, rows taken, size,
    row width, pack2) each) lies in a slot: the (n, 8) int64 rows that
    hostops.cpp:stage_encode reads, and the bytes the slot needs."""
    rows = np.empty((len(batches), _LAYOUT_COLS), np.int64)
    pos = 0
    for i, (row0, take, size, width, pack2) in enumerate(batches):
        nb = wire_bytes(wide, width if exact else None)
        enc_off = pos
        pos += -(-size * row_bytes(width, pack2) // _ALIGN) * _ALIGN
        len_off = pos
        pos += -(-size * nb // _ALIGN) * _ALIGN
        pack = 0 if pack2 is None else (2 if pack2 else 1)
        rows[i] = (row0, take, size, width, pack, nb, enc_off, len_off)
    return rows, pos


def encode(buf, c_starts, c_lens, rows: np.ndarray, lut, reverse: bool,
           arena: np.ndarray) -> list:
    """Write every batch of the layout ``rows`` into ``arena`` (a slot's
    uint8 array): :func:`native.stage_encode`. Returns the (enc,
    lengths) host tensors of each batch, views of the slot."""
    if len(rows) and rows[-1, 7] + rows[-1, 2] * rows[-1, 5] > len(arena):
        raise ValueError("the layout does not fit the slot")
    native.stage_encode(buf, c_starts, c_lens, rows, lut, reverse, arena)
    views = []
    for row0, take, size, width, pack, nb, enc_off, len_off in rows.tolist():
        rb = row_bytes(width, None if pack == 0 else pack == 2)
        views.append((
            torch.from_numpy(
                arena[enc_off : enc_off + size * rb].reshape(size, rb)),
            torch.from_numpy(
                arena[len_off : len_off + size * nb].view(_WIRE_DTYPES[nb])),
        ))
    return views


def encode_rows(buf, starts, lens, sel, rows: int, width: int, lut,
                reverse: bool, pack2: Optional[bool]) -> np.ndarray:
    """(rows, row_bytes) uint8 of the windows ``sel`` of (starts, lens)
    encoded through ``lut`` at ``width`` bases (back to front where
    ``reverse``; pack2 as :func:`row_bytes`), the rows past len(sel)
    zero (:func:`native.pad_encode`): one batch, for the host comparers
    and the tools."""
    out = np.zeros((rows, row_bytes(width, pack2)), np.uint8)
    native.pad_encode(buf, starts, lens, np.asarray(sel, np.int64), width,
                      lut, pack4=pack2 is False, pack2=bool(pack2), out=out,
                      reverse=reverse)
    return out


class Slot:
    """One slot of a :class:`StagingArena`: a uint8 host buffer (pinned
    where the device is CUDA) and the event after its last upload."""

    __slots__ = ("tensor", "array", "capacity", "event")

    def __init__(self):
        self.tensor = None
        self.array = None
        self.capacity = 0
        self.event = None

    def passed(self) -> bool:
        return self.event is None or self.event.query()


class StagingArena:
    """An engine's staging buffers for the encoded batches of its
    dispatches: ``slots`` slots, all allocated at the first pass (with
    headroom over what it needs, so that the next chunks of the same
    traffic fit) and each grown only when a pass needs more; every
    allocation is counted by ``on_alloc`` and traced as a
    ``stage.alloc`` span. A pass :meth:`take` s a slot, writes it,
    launches its batches and :meth:`release` s it with an event over the
    uploads queued so far (None: the launches read the slot before they
    returned, as on the CPU); a slot is written again only after its
    event has passed. Several threads may stage at once (submit, and a
    linked adapter's 3' phase on the engine's worker or in collect)."""

    def __init__(self, slots: int, pinned: bool, on_alloc=None):
        self._free = [Slot() for _ in range(slots)]  # oldest release first
        self._pinned = pinned
        self._lock = threading.Lock()
        self._on_alloc = on_alloc

    def take(self, nbytes: int) -> Slot:
        with self._lock:
            slot = self._pick(nbytes)
            if slot.capacity == 0:  # the first pass: every slot at once
                for s in [slot] + self._free:
                    if s.capacity == 0:
                        self._grow(s, nbytes)
        if slot.event is not None:
            if not slot.event.query():
                slot.event.synchronize()
            slot.event = None
        if slot.capacity < nbytes:
            self._grow(slot, nbytes)
        return slot

    def release(self, slot: Slot, event=None) -> None:
        slot.event = event
        with self._lock:
            self._free.append(slot)

    def _pick(self, nbytes: int) -> Slot:
        """The newest released slot that fits and whose uploads are done;
        else the oldest that fits (to wait for); else the oldest (to
        grow, once its uploads are done)."""
        free = self._free
        if not free:
            return Slot()
        fits = [i for i, s in enumerate(free) if s.capacity >= nbytes]
        for i in reversed(fits):
            if free[i].passed():
                return free.pop(i)
        return free.pop(fits[0] if fits else 0)

    def _grow(self, slot: Slot, nbytes: int) -> None:
        span = tracing.begin("stage.alloc")
        try:
            cap = -(-int(nbytes * _HEADROOM) // _ALIGN) * _ALIGN
            slot.tensor = torch.empty(cap, dtype=torch.uint8,
                                      pin_memory=self._pinned)
            slot.array = slot.tensor.numpy()
            slot.capacity = cap
        finally:
            tracing.end(span)
        if self._on_alloc is not None:
            self._on_alloc()
