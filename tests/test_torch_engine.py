"""
The PyTorch port's batch engine (device="cpu", where the aligner runs
its plain PyTorch version) against the JAX package's engine (JAX on the
CPU) on flagship-like reads, some of them with N bases: per chunk the
windows, keep-mask, statistics and assembled FASTQ bytes are equal.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
from cutadapt_tpu.io.chunks import assemble_window as jax_assemble
from cutadapt_tpu.io.chunks import parse_fastq_chunk as jax_parse
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk

import torch_fixtures as fx

# small dispatch batches so a few thousand reads exercise the binary
# decomposition, the scalar tail and both kernel lanes
SIZES = dict(min_dp_batch=256, max_dp_batch=1024)
N_READS = 3000


@pytest.fixture(scope="module")
def reads():
    return fx.add_ns(fx.make_dataset(N_READS, seed=99), 0.1)


def _engines(kind="back", filters=(), times=1, action="trim", **adapter_kw):
    kw = dict(max_errors=0.1, min_overlap=3, **adapter_kw)
    cls = {"back": "BackAdapter", "front": "FrontAdapter",
           "anywhere": "AnywhereAdapter"}[kind]
    jax_engine = jbp.BatchPipelineEngine(
        [jbp.AdapterStage(
            [jbp.AdapterTask(getattr(jad, cls)(fx.ADAPTER, **kw),
                             kind, 0)],
            times=times, action=action)],
        [jbp.FilterSpec(k, t) for k, t in filters], **SIZES,
    )
    port_engine = tbp.BatchPipelineEngine(
        [tbp.AdapterStage(
            [tbp.AdapterTask(getattr(tad, cls)(fx.ADAPTER, **kw),
                             kind, 0)],
            times=times, action=action)],
        [tbp.FilterSpec(k, t) for k, t in filters], **SIZES, device="cpu",
    )
    return jax_engine, port_engine


@pytest.mark.parametrize(
    "kind,filters,times,action",
    [
        ("back", (), 1, "trim"),
        ("back", (("too_short", 20),), 1, "trim"),
        ("back", (("too_short", 20), ("discard_untrimmed", None)), 2,
         "trim"),
        ("front", (("too_short", 15),), 1, "trim"),
        ("anywhere", (), 1, "retain"),
        ("back", (("too_many_n", 1),), 1, "mask"),
    ],
)
def test_engine_matches_jax(reads, kind, filters, times, action):
    jax_engine, port_engine = _engines(kind, filters, times, action)
    jax_chunk = jax_parse(reads)
    chunk = parse_fastq_chunk(reads)
    jws, jwe, jkeep, jstats = jax_engine.process_parsed(jax_chunk)
    ws, we, keep, stats = port_engine.process_parsed(chunk)
    np.testing.assert_array_equal(ws, jws)
    np.testing.assert_array_equal(we, jwe)
    np.testing.assert_array_equal(keep, jkeep)
    fx.assert_same(stats, jstats)
    assert stats["with_adapters"] > 0
    assert assemble_window(chunk, ws, we, keep) == jax_assemble(
        jax_chunk, jws, jwe, jkeep
    )


def test_both_lanes_and_scalar_tail_run(reads, monkeypatch):
    """The comparison above goes through the 2-bit lane, the 4-bit lane
    and the host scalar aligner."""
    lanes = []
    real = tbp.locate_packed
    monkeypatch.setattr(
        tbp, "locate_packed",
        lambda enc, lens, tables, pack2, **kw: lanes.append(pack2)
        or real(enc, lens, tables, pack2, **kw),
    )
    scalar = []
    real_scalar = tbp.AdapterTask.run_scalar
    monkeypatch.setattr(
        tbp.AdapterTask, "run_scalar",
        lambda self, chunk, starts, lens: scalar.append(len(starts))
        or real_scalar(self, chunk, starts, lens),
    )
    _, port_engine = _engines()
    port_engine.process_parsed(parse_fastq_chunk(reads))
    assert True in lanes and False in lanes
    assert scalar and sum(scalar) > 0


def test_process_chunks_pipelined_matches_jax(reads):
    jax_engine, port_engine = _engines(filters=(("too_short", 20),))
    chunks, n = fx.split_records(reads, 1000)
    assert len(chunks) == 3 and n == N_READS
    got = list(tbp.process_chunks_pipelined(port_engine, chunks))
    want = list(jbp.process_chunks_pipelined(jax_engine, chunks))
    assert len(got) == len(want) == 3
    for (out, stats), (jout, jstats) in zip(got, want):
        assert out == jout
        fx.assert_same(stats, jstats)
    assert b"".join(o for o, _ in got) == b"".join(o for o, _ in want)


def test_engine_matches_host_path():
    data = fx.make_dataset(2000, seed=3)
    want, matched = fx.host_trim(data, 2000)
    engine = fx.make_engine(device="cpu", **SIZES)
    chunks, _ = fx.split_records(data, 700)
    outs = list(tbp.process_chunks_pipelined(engine, chunks))
    assert b"".join(o for o, _ in outs) == want
    assert sum(s["with_adapters"] for _, s in outs) == matched


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fx.make_engine()
    with pytest.raises(RuntimeError, match="is_available"):
        fx.make_engine(device="cuda")


def test_unported_paths_raise():
    """What the engine still refuses: stages it has no form for, a shard
    mesh that is not 1-D and unknown task kinds. Adapter-side
    coordinates, quality capping, windows of 2**14 bp or more
    (tests/test_torch_wide.py holds them to the JAX engine) and a 1-D
    device mesh (tests/test_torch_mesh.py) run."""
    adapter = fx.make_adapter()
    task = tbp.AdapterTask(adapter, "back", 0)
    with pytest.raises(NotImplementedError, match="host stages"):
        tbp.BatchPipelineEngine([object()], device="cpu")
    engine = tbp.BatchPipelineEngine([tbp.AdapterStage([task])],
                                     want_ref_coords=True, qual_cap_base=33,
                                     device="cpu")
    assert engine.want_ref_coords and engine.qual_cap_base == 33
    tbp.set_shard_mesh(None)
    with pytest.raises(ValueError, match="mesh"):
        tbp.set_shard_mesh(object())
    from cutadapt_tpu_torch.parallel import make_mesh

    tbp.set_shard_mesh(make_mesh(["cpu"] * 2))
    assert tbp.get_shard_mesh().size == 2
    tbp.set_shard_mesh(None)
    with pytest.raises(NotImplementedError, match="not ported"):
        tbp.AdapterTask(adapter, "unknown", 0)
