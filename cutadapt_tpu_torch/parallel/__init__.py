"""Data-parallel execution over a 1-D mesh of devices, the statistics
reducer that bins per shard and sums the shards once, and the input
sharding over several processes (``multihost``).

``multihost`` needs numpy only, and every input opener imports it: the
names of ``mesh`` and ``stats``, which import torch, load on first use,
so that a run on the host path and the shard coordinator do not pay for
importing torch."""

from . import multihost

_LAZY = {"Mesh": "mesh", "make_mesh": "mesh", "make_sharded_trim_step": "mesh",
         "DeviceStatsReducer": "stats"}

__all__ = ["Mesh", "make_sharded_trim_step", "make_mesh",
           "DeviceStatsReducer", "multihost"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    globals()[name] = value
    return value
