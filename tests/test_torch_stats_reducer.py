"""
The port's statistics reducer on the CPU: the scatter kernel's three
entry points run their plain PyTorch versions on CPU tensors and equal
``np.add.at``; the port's ``DeviceStatsReducer``, with no mesh and on 8
shards of the CPU, hands its fold callbacks the same arrays and ints as
the JAX package's reducer with no mesh and on its 8-device mesh
(``tests/conftest.py`` gives JAX 8 virtual CPU devices). Tolerance:
exact (integer counts).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest
import torch

from cutadapt_tpu.parallel import DeviceStatsReducer as JaxReducer
from cutadapt_tpu.parallel import make_mesh as jax_make_mesh
from cutadapt_tpu_torch.ops import stats_cuda
from cutadapt_tpu_torch.parallel import DeviceStatsReducer, make_mesh
from cutadapt_tpu_torch.parallel import stats as port_stats

I32 = torch.int32


def _events(n, R, C, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, R, n).astype(np.int32),
            rng.randint(0, C, n).astype(np.int32),
            rng.randint(0, 3, n).astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_scatter_add_2d_plain_version(n):
    rows, cols, valid = _events(n, 128, 64, seed=n)
    buf = torch.zeros((128, 64), dtype=I32)
    buf[3, 5] = 7  # adds to what is there
    want = buf.numpy().astype(np.int64)
    np.add.at(want, (rows, cols), valid)
    stats_cuda.reset_launch_counters()
    stats_cuda.scatter_add_2d(buf, torch.from_numpy(rows),
                              torch.from_numpy(cols), torch.from_numpy(valid))
    np.testing.assert_array_equal(buf.numpy(), want)
    assert stats_cuda.PLAIN_RUNS["hist2d"] == 1
    assert stats_cuda.LAUNCHES["hist2d"] == 0


@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_scatter_add_1d_plain_version(n):
    idx, _, valid = _events(n, 320, 1, seed=n + 1)
    buf = torch.zeros(320, dtype=I32)
    want = np.zeros(320, np.int64)
    np.add.at(want, idx, valid)
    stats_cuda.reset_launch_counters()
    stats_cuda.scatter_add_1d(buf, torch.from_numpy(idx),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(buf.numpy(), want)
    assert stats_cuda.PLAIN_RUNS["hist1d"] == 1


@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_count_add_plain_version(n):
    mask = (np.random.RandomState(n).rand(n) < 0.3).astype(np.int32)
    buf = torch.full((), 5, dtype=I32)
    want = np.zeros(1, np.int64)
    np.add.at(want, np.zeros(n, np.int64), mask)
    stats_cuda.reset_launch_counters()
    stats_cuda.count_add(buf, torch.from_numpy(mask))
    assert int(buf) == 5 + int(want[0])
    assert stats_cuda.PLAIN_RUNS["count"] == 1


def test_out_of_range_events_are_dropped():
    """As XLA's scatter drops them: the kernel skips them too."""
    buf = torch.zeros((4, 4), dtype=I32)
    stats_cuda.scatter_add_2d(
        buf, torch.tensor([0, 4, -1, 1], dtype=I32),
        torch.tensor([0, 0, 1, 9], dtype=I32), torch.ones(4, dtype=I32))
    assert int(buf.sum()) == 1 and int(buf[0, 0]) == 1
    one = torch.zeros(4, dtype=I32)
    stats_cuda.scatter_add_1d(one, torch.tensor([3, 4], dtype=I32),
                              torch.ones(2, dtype=I32))
    assert one.tolist() == [0, 0, 0, 1]


def test_wrapper_checks_its_arguments():
    buf = torch.zeros((4, 4), dtype=I32)
    ev = torch.zeros(3, dtype=I32)
    with pytest.raises(ValueError):
        stats_cuda.scatter_add_2d(buf.long(), ev, ev, ev)
    with pytest.raises(ValueError):
        stats_cuda.scatter_add_2d(buf, ev, ev[:2], ev)
    with pytest.raises(ValueError):
        stats_cuda.scatter_add_1d(torch.zeros(4, dtype=I32), ev.long(), ev)
    with pytest.raises(ValueError):
        stats_cuda.count_add(torch.zeros(2, dtype=I32), ev)


def _feed(red, got):
    """test_mesh.py:153-192's events (a 2-D key that grows past the
    64-step rounding in both dimensions, a 1-D key with an empty add, a
    count), plus keys with no event at all."""
    rng = np.random.RandomState(3)

    def keep(key):
        return lambda v: got.__setitem__(key, v)

    rows1 = rng.randint(0, 40, 500)
    cols1 = rng.randint(0, 3, 500)
    red.add_hist2d("h2", rows1, cols1, keep("h2"))
    rows2 = rng.randint(0, 200, 77)
    cols2 = rng.randint(0, 90, 77)
    red.add_hist2d("h2", rows2, cols2, lambda h: None)
    vals = rng.randint(0, 130, 999)
    red.add_hist1d("h1", vals, keep("h1"))
    red.add_hist1d("h1", np.array([], np.int32), lambda h: None)
    mask = rng.rand(1000) < 0.3
    red.add_count("c", mask, keep("c"))
    red.add_count("c", mask[:10], lambda n: None)
    # one event, fewer than the shards
    red.add_hist1d("one", np.array([5]), keep("one"))
    # zero-event keys still fold (zero-event adapters render)
    red.add_hist2d("z2", np.array([], np.int32), np.array([], np.int32),
                   keep("z2"))
    red.add_hist1d("z1", np.array([], np.int32), keep("z1"))
    red.add_count("zc", np.array([], bool), keep("zc"))
    red.fold()
    assert not red._bufs  # cleared after fold


@pytest.mark.parametrize("shards", [None, 8])
def test_reducer_matches_the_jax_reducer(shards):
    jax_red = JaxReducer(
        jax_make_mesh(jax.devices()[:8]) if shards else None)
    port_red = DeviceStatsReducer(
        make_mesh(["cpu"] * shards) if shards else None, device="cpu")
    want, got = {}, {}
    _feed(jax_red, want)
    stats_cuda.reset_launch_counters()
    folds = port_stats.FOLDS
    _feed(port_red, got)
    assert port_stats.FOLDS == folds + 1
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            assert type(g) is int and g == w, key
        else:
            assert g.dtype == np.int32 and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
    # one plain run per shard and non-empty add; no launch on the CPU
    per = shards or 1
    assert stats_cuda.PLAIN_RUNS == {"hist2d": 2 * per, "hist1d": 2 * per,
                                     "count": 2 * per}
    assert sum(stats_cuda.LAUNCHES.values()) == 0


def test_reducer_partials_live_on_their_shards():
    """Each shard bins only its own slice of the events (shard i gets
    rows [i * per, (i + 1) * per) of the padded batch)."""
    red = DeviceStatsReducer(make_mesh(["cpu"] * 4), device="cpu")
    red.add_hist1d("k", np.arange(10), lambda h: None)
    parts = red._bufs["k"]
    assert len(parts) == 4
    # 10 events pad to 12, three per shard; the last shard has one
    assert [int(p.sum()) for p in parts] == [3, 3, 3, 1]
    assert [np.flatnonzero(p.numpy()).tolist() for p in parts] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
