"""
Data-parallel execution over a 1-D mesh of devices.

The port of ``cutadapt_tpu/parallel/mesh.py``. Trimming is parallel over
reads, so the only mesh is one axis, ``"reads"``: a batch is cut into
``size`` equal row slices, and slice i runs on ``devices[i]``. The
engine shards every DP dispatch this way once a mesh is set
(``batch_pipeline.set_shard_mesh``, ``CUTADAPT_TPU_TORCH_DEVICES``), and
its statistics accumulate per shard in
:class:`~cutadapt_tpu_torch.parallel.stats.DeviceStatsReducer`.

Devices may repeat: eight shards of the CPU are how the tests stand in
for the JAX tests' eight virtual devices, and four shards of one card
are how one card holds the sharded path. The mesh is one process; work
across processes is multi-host's (``--shard``), not the mesh's.

:func:`make_sharded_trim_step` is the self-contained sharded step of the
JAX module: locate on every shard, bin the statistics on each shard's
device with the scatter kernel, and sum the shards' counters once.
"""

from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.align_batch import AlignerSpec, query_class_info, query_lut
from ..ops.align_cuda import locate_packed, make_tables
from ..ops.stats_cuda import scatter_add_batch

AXIS = "reads"


class Mesh:
    """A 1-D mesh: ``devices`` (torch.device, repeats allowed) along the
    axis ``axis_names[0]``; shard i is always ``devices[i]``."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices: Sequence, axis_names=(AXIS,)):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) != 1:
            raise ValueError("expected a 1-D mesh")
        self.devices = tuple(devs)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]!r}: {self.size}, devices="
                f"[{', '.join(str(d) for d in self.devices)}])")


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """A mesh over ``devices``, or over the first ``n_devices`` (all when
    None) visible CUDA devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices needs CUDA devices; pass "
                "devices (for example ['cpu'] * 8) to shard on the CPU"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)


def on_device(device: torch.device):
    """A context with ``device`` as the calling thread's current CUDA
    device (nothing for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def sum_partials(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """The shards' partial buffers summed on the first shard's device
    (one copy per partial, one add), then one copy to the host."""
    total = parts[0]
    if len(parts) > 1:
        dev0 = parts[0].device
        total = parts[0].clone()
        for p in parts[1:]:
            total += p.to(dev0)
    return total.cpu().numpy()


_ADJ_CODE = np.full(256, 4, np.int32)
for _i, _b in enumerate(b"ACGT"):
    _ADJ_CODE[_b] = _i


def _pack(cls: np.ndarray, pack2: Optional[bool]) -> np.ndarray:
    """(B, L) uint8 codes -> the kernel's rows: four 2-bit ids per byte
    (pack2 True), two 4-bit ids (False) or one code per byte (None)."""
    if pack2 is None:
        return np.ascontiguousarray(cls)
    per = 4 if pack2 else 2
    bits = 8 // per
    B, L = cls.shape
    padded = np.zeros((B, -(-L // per) * per), np.uint8)
    padded[:, :L] = cls
    out = np.zeros((B, padded.shape[1] // per), np.uint8)
    for t in range(per):
        out |= padded[:, t::per] << (t * bits)
    return out


def make_sharded_trim_step(
    spec: AlignerSpec,
    mesh: Mesh,
    max_len: int,
    jit: bool = True,
    min_length: int = 0,
):
    """
    Build a sharded step: (queries (B, L) uint8 raw bytes, lengths (B,))
    -> (stops (B,), found (B,), stats dict of counters summed over the
    mesh), with the keys and meanings of the JAX step:
    length_error_histogram ((max_len + 1, k + 2): removed length x
    errors of the reads with a match), adjacent_bases (A, C, G, T,
    other), written_lengths, total_bp, written_bp, with_adapters and
    filtered_too_short.

    B must be divisible by the mesh size. Each shard is encoded into the
    spec's own lane (2-bit where its class ids fit, else 4-bit; the byte
    lane for a spec of more than 16 query classes), located on its
    device in the kernel's wide result, and its seven buffers binned
    there with one launch of the scatter kernel; the partials are summed
    once. ``jit`` is accepted for the
    JAX signature and changes nothing: PyTorch runs eagerly.
    """
    tables = make_tables(spec)
    lut = query_lut(spec) if tables.byte else query_class_info(spec)[0]
    n_err = int(spec.max_error_rate * len(spec.reference)) + 2
    i32 = torch.int32

    def shard(dev, queries, lengths):
        cls = lut[queries]
        cls[np.arange(cls.shape[1])[None, :] >= lengths[:, None]] = 0
        pack2 = None if tables.byte else bool(cls.max(initial=0) < 4)
        enc = torch.from_numpy(_pack(cls, pack2)).to(dev)
        n = torch.from_numpy(lengths).to(dev)
        raw = torch.from_numpy(queries).to(dev)
        out = locate_packed(enc, n, tables, pack2, wide=True)
        found = out[0] != 0
        stops = torch.where(found, out[1], n)
        removed = torch.where(found, n - stops, 0)
        prev = raw.gather(
            1, (stops - 1).clamp(0, queries.shape[1] - 1)[:, None].long()
        )[:, 0]
        adj_code = torch.from_numpy(_ADJ_CODE).to(dev)
        code = torch.where(stops > 0, adj_code[prev.long()], 4).to(i32)
        too_short = stops < min_length
        kept = ~too_short
        hist = torch.zeros((max_len + 1, n_err), dtype=i32, device=dev)
        adjacent = torch.zeros(5, dtype=i32, device=dev)
        wl = torch.zeros(max_len + 1, dtype=i32, device=dev)
        counts = {key: torch.zeros(1, dtype=i32, device=dev) for key in (
            "total_bp", "written_bp", "with_adapters", "filtered_too_short")}
        # the seven buffers of the shard in one launch
        scatter_add_batch([
            (hist, removed.clamp(0, max_len), out[3].clamp(0, n_err - 1),
             found.to(i32)),
            (adjacent, code, found.to(i32)),
            (wl, stops.clamp(0, max_len), kept.to(i32)),
            (counts["total_bp"], n),
            (counts["written_bp"], torch.where(kept, stops, 0).to(i32)),
            (counts["with_adapters"], found.to(i32)),
            (counts["filtered_too_short"], too_short.to(i32)),
        ])
        return stops, found, dict(
            length_error_histogram=hist, adjacent_bases=adjacent,
            written_lengths=wl, **counts,
        )

    def step(queries, lengths):
        queries = np.ascontiguousarray(queries, np.uint8)
        lengths = np.ascontiguousarray(lengths, np.int32)
        B = len(lengths)
        if B % mesh.size:
            raise ValueError(f"a batch of {B} does not divide over the "
                             f"{mesh.size} shards of the mesh")
        per = B // mesh.size
        results = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                results.append(shard(dev, queries[i * per:(i + 1) * per],
                                     lengths[i * per:(i + 1) * per]))
        stops = np.concatenate([r[0].cpu().numpy() for r in results])
        found = np.concatenate([r[1].cpu().numpy() for r in results])
        stats = {}
        for key in results[0][2]:
            total = sum_partials([r[2][key] for r in results])
            stats[key] = total.reshape(()) if total.shape == (1,) else total
        return stops, found, stats

    return step
