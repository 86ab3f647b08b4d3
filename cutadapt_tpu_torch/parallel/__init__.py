"""Data-parallel execution over a 1-D mesh of devices, and the
statistics reducer that bins per shard and sums the shards once."""

from .mesh import Mesh, make_mesh, make_sharded_trim_step
from .stats import DeviceStatsReducer

__all__ = ["Mesh", "make_sharded_trim_step", "make_mesh",
           "DeviceStatsReducer"]
