"""
The scatter kernel's batch entry point and the reducer's per-chunk flush
on the CPU: ``scatter_add_batch``'s plain version equals ``np.add.at``
over mixed descriptors; the launch plan (cluster or direct mode, bins
per block, the split at the descriptor limit) covers every bin and every
event once; the port's ``DeviceStatsReducer``, flushed once per chunk
and with weighted written lengths, folds bit-equal to the JAX package's
reducer fed the same events unweighted (``np.repeat``), with no mesh
and on 8 shards (``tests/conftest.py`` gives JAX 8 virtual CPU
devices); the engine's ``_record_written(hist=...)`` on the reducer
equals the host fold. Tolerance: exact (integer counts).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest
import torch

from cutadapt_tpu.parallel import DeviceStatsReducer as JaxReducer
from cutadapt_tpu.parallel import make_mesh as jax_make_mesh
from cutadapt_tpu_torch import accel
from cutadapt_tpu_torch.ops import stats_cuda as sc
from cutadapt_tpu_torch.parallel import DeviceStatsReducer, make_mesh
from cutadapt_tpu_torch.statistics import ReadLengthStatistics

I32 = torch.int32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _mixed_batch(rng, n):
    """Buffers of every form, their events (some out of range, negative
    or of weight 0) and the numpy result; the 2-D buffer gets two
    descriptors."""
    h2 = rng.randint(0, 9, (40, 7))
    h1 = rng.randint(0, 9, 50)
    bufs = [torch.from_numpy(h2.astype(np.int32)),
            torch.from_numpy(h1.astype(np.int32)),
            torch.full((), 3, dtype=I32), torch.zeros(1, dtype=I32)]
    want = [h2.astype(np.int64), h1.astype(np.int64), np.int64(3),
            np.int64(0)]
    descs = []
    for _ in range(2):
        r = rng.randint(-3, 44, n)
        c = rng.randint(-2, 9, n)
        w = rng.randint(-2, 4, n)
        descs.append((bufs[0], _t(r), _t(c), _t(w)))
        ok = (r >= 0) & (r < 40) & (c >= 0) & (c < 7)
        np.add.at(want[0], (r[ok], c[ok]), w[ok])
    idx = rng.randint(-5, 55, n)
    descs.append((bufs[1], _t(idx), None))  # weight 1
    ok = (idx >= 0) & (idx < 50)
    np.add.at(want[1], idx[ok], 1)
    for k in (2, 3):
        w = rng.randint(-1, 3, n)
        descs.append((bufs[k], _t(w)))
        want[k] = want[k] + w.sum()
    return bufs, descs, want


@pytest.mark.parametrize("n", [0, 1, 37, 5000])
def test_batch_plain_version_matches_numpy(n):
    rng = np.random.RandomState(n)
    bufs, descs, want = _mixed_batch(rng, n)
    sc.reset_launch_counters()
    sc.scatter_add_batch(descs)
    for b, w in zip(bufs, want):
        np.testing.assert_array_equal(b.numpy(), w)
    # five descriptors, two of one buffer: one launch
    assert sc.PLAIN_RUNS == {"batch": 1 if n else 0}
    assert sc.LAUNCHES == {"batch": 0}
    assert not any(sc.DESCRIPTORS.values())


def test_batch_reference_equals_the_batch():
    rng = np.random.RandomState(5)
    bufs, descs, _ = _mixed_batch(rng, 300)
    ref = [b.clone() for b in bufs]
    ref_descs = [(ref[[b.data_ptr() for b in bufs].index(d[0].data_ptr())],)
                 + tuple(d[1:]) for d in descs]
    sc.scatter_add_batch(descs)
    sc.scatter_add_batch_reference(ref_descs)
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bins", [1, 5, 64, 101, 8192, 12287, 12288,
                                  12289, 98305, 32768 * 64])
def test_plan_modes_cover_every_bin_once(bins):
    per = sc.bins_per_block(bins)
    if bins > sc.MAX_BINS_PER_BLOCK:
        assert per == 0  # direct mode: global atomics, no shared memory
        return
    # every block holds all the bins; block r sums bins [r * per,
    # (r + 1) * per) over the cluster: each bin in exactly one slice, no
    # slice past the cluster, and none more than one bin short of a share
    owners = np.arange(bins) // per
    assert owners.max() < sc.CLUSTER
    assert (per - 1) * sc.CLUSTER < bins


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 33000, 131072,
                               10 ** 6])
def test_plan_clusters_walk_every_event_once(n):
    c = sc.clusters_for(n)
    assert 1 <= c <= sc.MAX_CLUSTERS_PER_DESCRIPTOR
    assert c == min(-(-n // sc.EVENTS_PER_CLUSTER),
                    sc.MAX_CLUSTERS_PER_DESCRIPTOR)
    # thread t of the descriptor's clusters takes events t, t + stride, ...
    stride = c * sc.EVENTS_PER_CLUSTER
    walked = np.bincount(np.arange(n) % stride, minlength=stride)
    assert walked.sum() == n
    assert walked.max() - walked.min() <= 1  # an even share per thread
    assert (walked > 0).all() or n < stride


@pytest.mark.parametrize("seed", range(4))
def test_plan_splits_at_the_descriptor_limit(seed):
    rng = np.random.RandomState(seed)
    k = rng.randint(20, 90)
    sizes = [(int(rng.choice([0, 1, 64, 12288, 12289, 2 ** 21])),
              int(rng.choice([0, 1, 5000, 200000]))) for _ in range(k)]
    plan = sc.plan_batch(sizes)
    seen = [j for launch in plan for j in launch.descriptors]
    # every descriptor with events and bins exactly once, in order
    assert seen == [j for j, (bins, n) in enumerate(sizes) if n and bins]
    assert len(plan) == -(-len(seen) // sc.MAX_DESCRIPTORS)
    for launch in plan:
        assert 0 < len(launch.descriptors) <= sc.MAX_DESCRIPTORS
        for j, per, c in zip(launch.descriptors, launch.bins_per_block,
                             launch.clusters):
            assert per == sc.bins_per_block(sizes[j][0])
            assert c == sc.clusters_for(sizes[j][1])


def test_more_descriptors_than_one_launch_takes():
    rng = np.random.RandomState(9)
    n_desc = 2 * sc.MAX_DESCRIPTORS + 3
    bufs = [torch.zeros(70, dtype=I32) for _ in range(n_desc)]
    want = [np.zeros(70, np.int64) for _ in range(n_desc)]
    descs = []
    for b, w in zip(bufs, want):
        idx = rng.randint(0, 70, 200)
        wt = rng.randint(0, 5, 200)
        descs.append((b, _t(idx), _t(wt)))
        np.add.at(w, idx, wt)
    descs.insert(4, (torch.zeros(3, dtype=I32), _t([]), _t([])))  # empty
    sc.reset_launch_counters()
    sc.scatter_add_batch(descs)
    assert sc.PLAIN_RUNS == {"batch": 3}
    for b, w in zip(bufs, want):
        np.testing.assert_array_equal(b.numpy(), w)


def test_batch_checks_its_descriptors():
    buf = torch.zeros((4, 4), dtype=I32)
    ev = torch.zeros(3, dtype=I32)
    for bad in ([(buf, ev, ev)],               # 2-D buffer, 1-D form
                [(buf[0], ev, ev[:2])],        # lengths differ
                [(buf, None, ev, ev)],         # rows missing
                [(torch.zeros(1, dtype=I32), None)],  # count without w
                [(buf.long(), ev, ev, ev)],
                [(buf[:, 0], ev, ev)],         # not contiguous
                [(buf,)]):
        with pytest.raises(ValueError):
            sc.scatter_add_batch(bad)


def _chunks(seed, n_chunks):
    """Per chunk: removal events, adjacent bases, a written-length
    histogram and a filter mask, at the flagship's proportions."""
    rng = np.random.RandomState(seed)
    out = []
    for c in range(n_chunks):
        n = int(rng.randint(0, 800)) if c else 0  # the first chunk empty
        rem = np.minimum(rng.geometric(0.08, n), 130 + 40 * c)
        err = np.minimum(rng.geometric(0.6, n) - 1, 3 + c)
        adj = rng.randint(0, 5, n)
        lens = rng.randint(0, 101 + 30 * c, int(rng.randint(1, 3000)))
        out.append((rem, err, adj, np.bincount(lens), rng.rand(900) < 0.2))
    return out


@pytest.mark.parametrize("shards", [None, 8])
def test_per_chunk_flush_matches_the_jax_reducer(shards):
    """One flush per chunk, written lengths weighted by their bin counts:
    the fold equals the JAX reducer's on the same events unweighted, and
    each chunk's flush is one batch per shard."""
    chunks = _chunks(2, 5)
    jax_red = JaxReducer(
        jax_make_mesh(jax.devices()[:8]) if shards else None)
    port_red = DeviceStatsReducer(
        make_mesh(["cpu"] * shards) if shards else None, device="cpu")
    want, got = {}, {}

    def keep(out, key):
        return lambda v: out.__setitem__(key, v)

    sc.reset_launch_counters()
    for rem, err, adj, hist, mask in chunks:
        nz = np.flatnonzero(hist)
        for red, out in ((jax_red, want), (port_red, got)):
            red.add_hist2d("rm", rem, err, keep(out, "rm"))
            red.add_hist1d("adj", adj, keep(out, "adj"))
            red.add_count("flt", mask, keep(out, "flt"))
            red.add_hist1d("rm2", rem[:5], keep(out, "rm2"))
        jax_red.add_hist1d("wl", np.repeat(nz, hist[nz]), keep(want, "wl"))
        port_red.add_hist1d("wl", nz, keep(got, "wl"), weights=hist[nz])
        port_red.flush()
    launches = sc.PLAIN_RUNS["batch"]
    jax_red.fold()
    port_red.fold()
    # a chunk's flush is one batch on each shard that holds events; a key
    # of n events reaches ceil(n / ceil(n / shards)) shards
    assert sc.PLAIN_RUNS["batch"] == launches
    size = shards or 1
    assert launches == sum(
        max(-(-n // -(-n // size)) if n else 0
            for n in (len(rem), len(mask), np.count_nonzero(hist)))
        for rem, _, _, hist, mask in chunks)
    assert list(got) == list(want)  # folded in the order of first adds
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            assert type(g) is int and g == w, key
        else:
            assert g.dtype == np.int32 and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_adds_only_stage_until_the_flush():
    red = DeviceStatsReducer(make_mesh(["cpu"] * 2), device="cpu")
    sc.reset_launch_counters()
    red.add_hist2d("a", np.array([1, 2, 3]), np.array([0, 1, 2]),
                   lambda h: None)
    red.add_count("c", np.array([True, False]), lambda n: None)
    assert not red._bufs and sc.PLAIN_RUNS == {"batch": 0}
    red.flush()
    assert sc.PLAIN_RUNS == {"batch": 2}  # one per shard
    assert [int(p.sum()) for p in red._bufs["a"]] == [2, 1]
    red.flush()  # nothing staged: no launch
    assert sc.PLAIN_RUNS == {"batch": 2}


@pytest.mark.parametrize("shards", [None, 3])
def test_record_written_hist_on_the_reducer_equals_the_host(shards):
    rng = np.random.RandomState(4)
    hists = [np.bincount(rng.randint(0, 151, rng.randint(1, 4000)))
             for _ in range(3)] + [np.zeros(7, np.int64)]
    host = ReadLengthStatistics()
    dev = ReadLengthStatistics()
    red = DeviceStatsReducer(
        make_mesh(["cpu"] * shards) if shards else None, device="cpu")
    for side in (1, 2):
        for h in hists:
            accel._record_written(host, side, hist=h)
            accel._record_written(dev, side, red, hist=h)
            red.flush()
    red.fold()
    assert dev._r1 == host._r1 and dev._r2 == host._r2
    assert dev.written_bp() == host.written_bp()
