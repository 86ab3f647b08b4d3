"""
The port's device mesh on the CPU, held to the JAX package's mesh on the
8 virtual CPU devices that ``tests/conftest.py`` gives JAX: the sharded
trim step (``make_sharded_trim_step``), the dispatch sizes padded to the
mesh (``mesh_padded``, ``_dp_sizes``), the engine with its DP dispatches
sharded over 8 shards of the CPU (``test_mesh.py``'s stages), and the
CLI with ``CUTADAPT_TPU_TORCH_DEVICES=8`` on the four pipeline shapes of
``__graft_entry__.py:_dryrun_real_pipeline`` against the run on one
device and against JAX's CLI on its 8-device mesh. Tolerance: exact
(output bytes, integer statistics).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import functools
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
from cutadapt_tpu.io.chunks import assemble_window as jax_assemble
from cutadapt_tpu.io.chunks import parse_fastq_chunk as jax_parse
from cutadapt_tpu.ops.align_batch import AlignerSpec as JaxSpec
from cutadapt_tpu.parallel import make_mesh as jax_make_mesh
from cutadapt_tpu.parallel import make_sharded_trim_step as jax_step
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.adapters import Where
from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk
from cutadapt_tpu_torch.ops import stats_cuda
from cutadapt_tpu_torch.ops.align_batch import AlignerSpec
from cutadapt_tpu_torch.parallel import Mesh, make_mesh, make_sharded_trim_step
from cutadapt_tpu_torch.parallel import stats as port_stats

import torch_fixtures as fx

ADAPTER = "AGATCGGAAGAGC"
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


@pytest.fixture(autouse=True)
def one_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture
def meshes():
    """Both packages' meshes reset to one device after the test."""
    yield
    tbp.set_shard_mesh(None)
    jbp.set_shard_mesh(None)


def _cpu_mesh(n=8) -> Mesh:
    return make_mesh(["cpu"] * n)


def test_make_mesh():
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.axis_names == ("reads",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        Mesh([])


def _batch(rng, batch, length):
    """test_mesh.py:45-55's batch: random ACGT reads, every third with
    the adapter (a prefix where it runs off the end)."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = bases[rng.randint(0, 4, size=(batch, length))]
    ad = np.frombuffer(ADAPTER.encode(), np.uint8)
    for i in range(0, batch, 3):
        pos = rng.randint(0, length - 4)
        take = min(len(ad), length - pos)
        reads[i, pos : pos + take] = ad[:take]
    return reads, np.full((batch,), length, np.int32)


@pytest.mark.parametrize("variant", ["test_mesh", "ragged_n_min_length"])
def test_sharded_trim_step_matches_jax(variant):
    """test_mesh.py:58-90's batch on 8 shards against JAX's step on its
    8 devices, every returned field; then ragged lengths, reads with N
    (the 4-bit lane on the shards that hold them) and a length filter."""
    rng = np.random.RandomState(7)
    length, batch = 64, 16 * 8
    reads, lengths = _batch(rng, batch, length)
    min_length = 0
    if variant != "test_mesh":
        lengths = rng.randint(5, length + 1, batch).astype(np.int32)
        reads[rng.rand(batch, length) < 0.01] = ord("N")
        min_length = 30
    kw = dict(reference=ADAPTER, max_error_rate=0.1,
              flags=Where.BACK.value, min_overlap=3)
    want = jax_step(JaxSpec(**kw), jax_make_mesh(jax.devices()[:8]),
                    max_len=length, min_length=min_length)(reads, lengths)
    stats_cuda.reset_launch_counters()
    got = make_sharded_trim_step(AlignerSpec(**kw), _cpu_mesh(),
                                 max_len=length, min_length=min_length)(
                                     reads, lengths)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert sorted(got[2]) == sorted(want[2])
    for key, w in want[2].items():
        np.testing.assert_array_equal(got[2][key], np.asarray(w),
                                      err_msg=key)
    # every shard binned with the scatter kernel's plain version
    assert stats_cuda.PLAIN_RUNS == {"hist2d": 8, "hist1d": 16,
                                     "count": 32}
    assert int(got[2]["with_adapters"]) == int(got[1].sum()) > 0


def test_sharded_trim_step_refuses_an_indivisible_batch():
    spec = AlignerSpec(reference=ADAPTER, max_error_rate=0.1,
                       flags=Where.BACK.value)
    step = make_sharded_trim_step(spec, _cpu_mesh(), max_len=16)
    with pytest.raises(ValueError):
        step(np.zeros((12, 16), np.uint8), np.full(12, 16, np.int32))


@pytest.mark.parametrize("size", [1, 3, 4, 8])
def test_dp_sizes_match_the_jax_engine(size, meshes):
    jbp.set_shard_mesh(jax_make_mesh(jax.devices()[:size]))
    tbp.set_shard_mesh(_cpu_mesh(size) if size > 1 else None)
    kw = dict(min_dp_batch=256, max_dp_batch=4096)
    jax_engine = jbp.BatchPipelineEngine([], **kw)
    port_engine = tbp.BatchPipelineEngine([], device="cpu", **kw)
    for s in (1, 5, 255, 256, 257, 1000, 4095, 4096, 4097, 10_000, 131073):
        assert tbp.mesh_padded(s) == jbp.mesh_padded(s), s
        assert port_engine._dp_sizes(s) == jax_engine._dp_sizes(s), s
        assert all(x % size == 0 for x in port_engine._dp_sizes(s))
    assert (tbp.active_mesh_for(tbp.mesh_padded(4096)) is None) == (size == 1)


def test_active_mesh_for_counts_an_indivisible_batch(meshes):
    tbp.set_shard_mesh(_cpu_mesh(8))
    tbp.reset_shard_counters()
    assert tbp.active_mesh_for(12) is None
    assert tbp.UNSHARDED_DISPATCHES == 1
    assert tbp.active_mesh_for(16) is tbp.get_shard_mesh()
    with pytest.raises(ValueError):
        tbp.set_shard_mesh(type("M", (), {"axis_names": ("a", "b")})())


def _engine_reads() -> bytes:
    """test_mesh.py:93-150's reads."""
    rng = random.Random(21)
    recs = []
    for i in range(600):
        L = rng.randint(5, 90)
        s = "".join(rng.choice("ACGT") for _ in range(L))
        if rng.random() < 0.4 and L > 20:
            p = rng.randint(0, L - 14)
            s = (s[:p] + ADAPTER + s[p:])[:L]
        q = "".join(chr(rng.randint(35, 70)) for _ in s)
        recs.append(f"@r{i} c\n{s}\n+\n{q}\n")
    return "".join(recs).encode()


def _run_engine(pkg, parse, assemble, mesh, data, **kw):
    pkg.set_shard_mesh(mesh)
    ad = jad if pkg is jbp else tad
    try:
        engine = pkg.BatchPipelineEngine(
            [
                pkg.QualityStage(0, 12),
                pkg.AdapterStage([
                    pkg.AdapterTask(ad.BackAdapter(
                        ADAPTER, max_errors=0.1, min_overlap=3), "back", 0),
                    pkg.AdapterTask(ad.FrontAdapter(
                        "TTGGCCAA", max_errors=0.1, min_overlap=3),
                        "front", 1),
                ]),
            ],
            [pkg.FilterSpec("too_short", 10)],
            min_dp_batch=64, max_dp_batch=256, **kw,
        )
        parsed = parse(data)
        ws, we, keep, stats = engine.process_parsed(parsed)
        return assemble(parsed, ws, we, keep), stats
    finally:
        pkg.set_shard_mesh(None)


def test_engine_sharded_dispatch_matches(meshes):
    """test_mesh.py:93-150's stages: the port's engine on 8 shards of the
    CPU against the JAX engine on its 8-device mesh and against the port
    on one device: output bytes and statistics equal."""
    data = _engine_reads()
    jax_out, jax_stats = _run_engine(jbp, jax_parse, jax_assemble,
                                     jax_make_mesh(jax.devices()[:8]), data)
    one_out, one_stats = _run_engine(tbp, parse_fastq_chunk,
                                     assemble_window, None, data,
                                     device="cpu")
    tbp.reset_shard_counters()
    out, stats = _run_engine(tbp, parse_fastq_chunk, assemble_window,
                             _cpu_mesh(), data, device="cpu")
    assert out == one_out == jax_out
    fx.assert_same(stats, one_stats)
    for key in ("with_adapters", "filter_counts", "total_bp",
                "written_lengths", "n"):
        fx.assert_same(stats[key], jax_stats[key], key)
    assert sorted(tbp.SHARD_LAUNCHES) == list(range(8))
    assert len(set(tbp.SHARD_LAUNCHES.values())) == 1
    assert tbp.UNSHARDED_DISPATCHES == 0


# --- the CLI: the four pipeline shapes of _dryrun_real_pipeline --------------


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    return fx.write_mesh_pairs(str(tmp_path_factory.mktemp("pairs")),
                               n_pairs=300)


def _outputs(out):
    """The files a run wrote, and its --json report."""
    files = {}
    for name in sorted(os.listdir(out)):
        if name != "report.json":
            with open(os.path.join(out, name), "rb") as f:
                files[name] = f.read()
    return files, fx.json_report(os.path.join(out, "report.json"))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("shape", fx.MESH_SHAPES)
def test_cli_with_8_shards_matches(shape, pair_files, tmp_path, monkeypatch,
                                   meshes):
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_WORKERS",
                 "CUTADAPT_TPU_TORCH_DEVICE_STATS"):
        monkeypatch.delenv(name, raising=False)
    runs = {}
    # JAX's CLI on its 8-device mesh; dispatches of 8 rows, one per
    # device (its XLA aligner computes every padding row)
    monkeypatch.setenv("CUTADAPT_TPU_BATCH", "1")
    monkeypatch.setenv("CUTADAPT_TPU_DEVICES", "8")
    monkeypatch.setattr(
        jbp.BatchPipelineEngine, "__init__", functools.partialmethod(
            jbp.BatchPipelineEngine.__init__, min_dp_batch=8,
            max_dp_batch=8))
    out = str(tmp_path / "jax")
    os.makedirs(out)
    jax_cli.main(fx.mesh_shape_args(shape, pair_files, out)
                 + ["--json", os.path.join(out, "report.json")])
    assert jbp.get_shard_mesh() is not None
    runs["jax"] = _outputs(out)
    # the port on one device, in this process
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICES", "1")
    fallbacks = taccel.FALLBACK_COUNT
    out = str(tmp_path / "one")
    os.makedirs(out)
    port_cli.main(fx.mesh_shape_args(shape, pair_files, out)
                  + ["--json", os.path.join(out, "report.json")])
    assert tbp.get_shard_mesh() is None
    assert taccel.FALLBACK_COUNT == fallbacks
    runs["one"] = _outputs(out)
    # the port on 8 shards of the CPU, through python -m
    out = str(tmp_path / "sharded")
    os.makedirs(out)
    env = {**os.environ, "CUTADAPT_TPU_TORCH_DEVICES": "8",
           "PYTHONPATH": os.pathsep.join([ROOT] + [
               p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
               if p])}
    proc = subprocess.run(
        [sys.executable, "-m", "cutadapt_tpu_torch"]
        + fx.mesh_shape_args(shape, pair_files, out)
        + ["--json", os.path.join(out, "report.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs["sharded"] = _outputs(out)
    assert any(runs["one"][0].values())
    for tag in ("jax", "one"):
        assert sorted(runs["sharded"][0]) == sorted(runs[tag][0]), tag
        for name, data in runs[tag][0].items():
            assert runs["sharded"][0][name] == data, (tag, name)
        assert runs["sharded"][1] == runs[tag][1], tag


def test_cli_shards_and_folds_in_process(pair_files, tmp_path, monkeypatch,
                                         meshes):
    """The sharded CLI run in this process: every shard launched, the
    reducer folded once through the scatter kernel's plain version, no
    dispatch left unsharded; with CUTADAPT_TPU_TORCH_DEVICE_STATS=0 the
    statistics fold on the host and the report is the same."""
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES",
                 "CUTADAPT_TPU_TORCH_DEVICE_STATS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICES", "8")
    runs = {}
    for tag, device_stats in (("reduced", None), ("host", "0")):
        if device_stats is not None:
            monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE_STATS",
                               device_stats)
        tbp.reset_shard_counters()
        stats_cuda.reset_launch_counters()
        folds = port_stats.FOLDS
        out = str(tmp_path / tag)
        os.makedirs(out)
        port_cli.main(fx.mesh_shape_args("flagship", pair_files, out)
                      + ["--json", os.path.join(out, "report.json")])
        runs[tag] = _outputs(out)
        assert tbp.get_shard_mesh().size == 8
        assert sorted(tbp.SHARD_LAUNCHES) == list(range(8))
        assert tbp.UNSHARDED_DISPATCHES == 0
        plain = sum(stats_cuda.PLAIN_RUNS.values())
        if device_stats is None:
            assert port_stats.FOLDS == folds + 1 and plain > 0
        else:
            assert port_stats.FOLDS == folds and plain == 0
    assert runs["reduced"] == runs["host"]


def test_forced_reducer_on_one_device(tmp_path, monkeypatch):
    """CUTADAPT_TPU_TORCH_DEVICE_STATS=1 bins the statistics on the
    device without a mesh; the files and report equal the host-side
    fold's (single-end, with demultiplexing and a length filter)."""
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_TORCH_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    data = fx.make_reads(400, 5, [fx.ADAPTER, "TTAGACATATCTCCGTCG"])
    inp = tmp_path / "in.fastq"
    inp.write_bytes(data)
    runs = {}
    for tag in ("0", "1"):
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE_STATS", tag)
        out = tmp_path / tag
        out.mkdir()
        folds = port_stats.FOLDS
        port_cli.main(["-a", f"a={fx.ADAPTER}", "-a", "b=TTAGACATATCTCCGTCG",
                       "-m", "30", "--untrimmed-output",
                       str(out / "untrimmed.fastq"),
                       "-o", str(out / "{name}.fastq"),
                       "--json", str(out / "report.json"), str(inp)])
        assert port_stats.FOLDS == folds + (tag == "1")
        runs[tag] = _outputs(str(out))
    assert runs["0"] == runs["1"]
