"""
The wide result lane of the port's aligner and engine, against the JAX
package on the CPU (the aligner runs its plain PyTorch version).

- the plain version's wide (7, B) rows equal the JAX XLA aligner's
  unpacked fields (``make_batch_locate``) in both lanes;
- engines built with ``want_ref_coords`` report the adapter-side spans
  of the JAX engine's, for forward, reversed and comparer tasks;
- reads of 2**14 bp or more (fault C1 of the port) go through the wide
  lane: the engine equals the JAX engine, the CLI equals the JAX CLI,
  single-end and paired.

Results are integers, compared exactly: ``found`` everywhere, the other
fields where a match was found.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import random

import numpy as np
import pytest

import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
from cutadapt_tpu.io.chunks import assemble_window as jax_assemble
from cutadapt_tpu.io.chunks import parse_fastq_chunk as jax_parse
from cutadapt_tpu.ops.align_batch import AlignerSpec as JaxSpec
from cutadapt_tpu.ops.align_batch import make_batch_locate
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch import staging
from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk
from cutadapt_tpu_torch.ops import align_cuda
from cutadapt_tpu_torch.ops.align_batch import query_class_info

import torch_fixtures as fx

WIDE_FIELDS = ("found", "query_start", "query_stop", "errors", "score",
               "ref_start", "ref_stop")


@pytest.fixture(autouse=True)
def one_thread():
    with fx.one_torch_thread():
        yield


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.parity_specs())),
    ids=[f"{i}-{s.reference[:8]}-{s.flags}"
         for i, s in enumerate(fx.parity_specs())],
)
def test_plain_wide_matches_xla(index, pack2):
    spec = fx.parity_specs()[index]
    rng = np.random.RandomState(16384 + index)
    # anchored specs find their adapter only at the anchored end
    raw, enc, lens = fx.random_batch(spec, rng, 96, 64, pack2,
                                     at_start=not spec.flags & 2,
                                     at_end=not spec.flags & 8)
    got = align_cuda.locate(spec, enc, lens, pack2=pack2, device="cpu",
                            wide=True)
    assert tuple(got.shape) == (7, 96)
    got = align_cuda.unpack_wide(got.numpy())
    cls = query_class_info(spec)[0][raw]
    packed4 = (cls[:, 0::2] | (cls[:, 1::2] << 4)).astype(np.uint8)
    xla = make_batch_locate(JaxSpec(**spec._asdict()), packed=True)(
        packed4, lens)
    want = tuple(np.asarray(xla[k]) for k in WIDE_FIELDS)
    assert got[0].any()
    assert fx.first_difference(got, want) is None
    # the packed result carries the same first five fields
    packed = align_cuda.unpack_result(align_cuda.locate(
        spec, enc, lens, pack2=pack2, device="cpu").numpy())
    assert fx.first_difference(packed, got[:5]) is None


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize("kind", ["rightmost_front", "rightmost_back"])
def test_plain_wide_matches_xla_reversed(kind, pack2):
    """A reversed task (the rightmost kinds: reversed reference, windows
    encoded back to front by the engine's encoder): the plain version's
    7 fields equal the XLA aligner's on the same encoded windows."""
    cls = {"rightmost_front": tad.RightmostFrontAdapter,
           "rightmost_back": tad.RightmostBackAdapter}[kind]
    task = tbp.AdapterTask(cls(fx.ADAPTER, max_errors=0.1, min_overlap=3),
                           kind, 0)
    assert task.reverse
    data = fx.make_dataset(96, seed=16385)
    if not pack2:
        data = fx.add_ns(data, 0.3)
    chunk = parse_fastq_chunk(data)
    starts = chunk.seq_start.astype(np.int64)
    lens = chunk.seq_len.astype(np.int32)
    sel = np.arange(len(lens), dtype=np.int64)
    enc = staging.encode_rows(chunk.buf, starts, lens, sel, len(sel), 128,
                              task.lut, task.reverse, pack2)
    packed4 = staging.encode_rows(chunk.buf, starts, lens, sel, len(sel),
                                  128, task.lut, task.reverse, False)
    got = align_cuda.unpack_wide(align_cuda.locate(
        task.spec, enc, lens, pack2=pack2, device="cpu", wide=True).numpy())
    xla = make_batch_locate(JaxSpec(**task.spec._asdict()), packed=True)(
        packed4, lens)
    assert got[0].any()
    assert fx.first_difference(
        got, tuple(np.asarray(xla[k]) for k in WIDE_FIELDS)) is None


def _wide_launches(monkeypatch):
    """The wide flag of every aligner launch the engine makes."""
    flags = []
    real = tbp.locate_packed

    def spy(enc, lens, tables, pack2, wide=False):
        flags.append((pack2, wide))
        return real(enc, lens, tables, pack2, wide=wide)

    monkeypatch.setattr(tbp, "locate_packed", spy)
    return flags


def _engines(kind, sequence, want_ref_coords=False, **kw):
    """The same one-task engine in both packages."""
    kw = dict(max_errors=0.1, min_overlap=3, **kw)
    cls = {"back": "BackAdapter", "front": "FrontAdapter",
           "anywhere": "AnywhereAdapter",
           "rightmost_front": "RightmostFrontAdapter",
           "prefix_cmp": "PrefixAdapter"}[kind]
    sizes = dict(min_dp_batch=128, max_dp_batch=128)
    out = []
    for ad, bp, extra in ((jad, jbp, {}), (tad, tbp, dict(device="cpu"))):
        adapter = getattr(ad, cls)(sequence, **(
            dict(kw, indels=False) if kind == "prefix_cmp" else kw))
        out.append(bp.BatchPipelineEngine(
            [bp.AdapterStage([bp.AdapterTask(adapter, kind, 0)])],
            want_ref_coords=want_ref_coords, **sizes, **extra,
        ))
    return out


@pytest.mark.parametrize("kind", ["back", "front", "anywhere",
                                  "rightmost_front", "prefix_cmp"])
def test_ref_coords_match_jax(monkeypatch, kind):
    """want_ref_coords: every kernel launch is wide, and the events'
    adapter-side [astart, astop) spans (mirrored for the reversed
    rightmost task, the full span for a comparer) are the JAX engine's."""
    flags = _wide_launches(monkeypatch)
    data = fx.add_ns(fx.make_dataset(500, seed=41), 0.05)
    if kind == "prefix_cmp":
        # every third read starts with the adapter, one base changed
        lines = data.split(b"\n")
        for i in range(1, len(lines), 12):
            lines[i] = b"AGATCGGTAG" + fx.ADAPTER[10:].encode() + lines[i][33:]
        data = b"\n".join(lines)
    jax_engine, port_engine = _engines(kind, fx.ADAPTER, True)
    jws, jwe, jkeep, jstats = jax_engine.process_parsed(jax_parse(data))
    ws, we, keep, stats = port_engine.process_parsed(parse_fastq_chunk(data))
    np.testing.assert_array_equal(ws, jws)
    np.testing.assert_array_equal(we, jwe)
    fx.assert_same(stats, jstats)
    assert stats["with_adapters"] > 0
    assert any(len(ev["astart"]) for ev in stats["adapter_events"])
    if kind == "prefix_cmp":
        assert not flags
    else:
        assert flags and all(wide for _, wide in flags)


def test_qual_cap_base_matches_jax():
    """--zero-cap before an expected-errors filter: the filter reads
    capped qualities (a byte below '!' counts as Q0), in both packages."""
    rng = random.Random(43)
    records = []
    for i in range(400):
        s = "".join(rng.choice("ACGT") for _ in range(50))
        q = "I" * 50 if i % 2 else "I" * 10 + "\x1f" + "I" * 39
        records.append(f"@q{i}\n{s}\n+\n{q}\n")
    data = "".join(records).encode()
    out = {}
    for name, bp, parse, asm, extra in (
        ("jax", jbp, jax_parse, jax_assemble, {}),
        ("port", tbp, parse_fastq_chunk, assemble_window,
         dict(device="cpu")),
    ):
        engine = bp.BatchPipelineEngine(
            [], [bp.FilterSpec("too_many_expected_errors", 0.9)],
            qual_cap_base=33, **extra,
        )
        chunk = parse(data)
        ws, we, keep, stats = engine.process_parsed(chunk)
        out[name] = (asm(chunk, ws, we, keep), stats["filter_counts"])
    assert out["port"] == out["jax"]
    assert out["port"][1] == [200]


def _long_reads(adapter, lengths, at, seed):
    """Reads of the given lengths, the adapter at ``at`` (None: none)."""
    rng = random.Random(seed)
    records = []
    for i, (n, pos) in enumerate(zip(lengths, at)):
        s = "".join(rng.choice("ACGT") for _ in range(n))
        if pos is not None:
            s = s[:pos] + adapter + s[pos + len(adapter):]
        records.append(f"@r{i}\n{s[:n]}\n+\n{'I' * n}\n")
    return "".join(records).encode()


def test_long_reads_use_wide_result_format(monkeypatch):
    """The port's counterpart of tests/test_batch_pipeline.py's test: a
    20,000 bp read with the adapter at 17,000, an unmatched long read
    and a short one, through the wide lane, equal to the JAX engine."""
    flags = _wide_launches(monkeypatch)
    adapter = "AGATCGGAAGAGC"
    data = _long_reads(adapter, [20000, 20000, 73], [17000, None, 60], 99)
    out = {}
    for name, ad, bp, parse, asm, extra in (
        ("jax", jad, jbp, jax_parse, jax_assemble, {}),
        ("port", tad, tbp, parse_fastq_chunk, assemble_window,
         dict(device="cpu")),
    ):
        engine = bp.BatchPipelineEngine(
            [bp.AdapterStage([bp.AdapterTask(
                ad.BackAdapter(adapter, max_errors=0.1, min_overlap=3),
                "back", 0)])],
            min_dp_batch=4, max_dp_batch=4, **extra,
        )
        chunk = parse(data)
        ws, we, keep, stats = engine.process_parsed(chunk)
        out[name] = (asm(chunk, ws, we, keep), ws, we, stats)
    assert out["port"][0] == out["jax"][0]
    fx.assert_same(out["port"][3], out["jax"][3])
    assert list(out["port"][2]) == [17000, 20000, 60]
    assert flags == [(True, True)]


@pytest.fixture
def port_env(monkeypatch):
    """Both CLIs on their engines. The JAX engine dispatches batches of 8
    rows instead of 4,096: its XLA aligner on the CPU computes every
    padding row of a 20,000-column launch (the port's plain version
    computes one), and the results do not depend on the batch size."""
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_BATCH", "1")
    monkeypatch.setattr(
        jbp.BatchPipelineEngine, "__init__", functools.partialmethod(
            jbp.BatchPipelineEngine.__init__, min_dp_batch=8, max_dp_batch=8))
    for module in (tad, jad):
        monkeypatch.setattr(module, "_adapter_counter", [0])
    return monkeypatch


def _same_as_jax_cli(tmp_path, args, inputs, outputs):
    """Every output and the --json report of the port's CLI (engine, no
    fallback) equal the JAX CLI's on its engine."""
    got = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        fallbacks = taccel.FALLBACK_COUNT
        main(args + ["--json", str(d / "report.json")]
             + [a for o in outputs for a in (o[0], str(d / o[1]))]
             + [str(p) for p in inputs])
        assert taccel.FALLBACK_COUNT == fallbacks
        got[name] = {o[1]: (d / o[1]).read_bytes() for o in outputs}
        got[name]["report"] = fx.json_report(d / "report.json")
    assert got["port"] == got["jax"]
    return got["port"]


def test_c1_long_read_cli_matches_jax(port_env, tmp_path):
    """Fault C1: three reads, one of 20,000 bp. The port's CLI writes all
    three, equal to the JAX CLI (CUTADAPT_TPU_BATCH=1)."""
    adapter = "AGATCGGAAGAGCACACGTC"
    reads = tmp_path / "in.fastq"
    reads.write_bytes(_long_reads(adapter, [120, 20000, 150],
                                  [80, 18500, None], 1))
    got = _same_as_jax_cli(tmp_path, ["-a", adapter], [reads],
                           [("-o", "out.fastq")])
    assert got["out.fastq"].count(b"\n@r") == 2
    assert got["report"]["read_counts"]["read1_with_adapter"] == 2


def test_paired_long_mate_matches_jax(port_env, tmp_path):
    """A pair whose R2 is 17,000 bp, with the R2 adapter past 2**14."""
    r1 = tmp_path / "in.1.fastq"
    r2 = tmp_path / "in.2.fastq"
    r1.write_bytes(_long_reads(fx.TRUSEQ_R1, [150, 150], [100, None], 2))
    r2.write_bytes(_long_reads(fx.TRUSEQ_R2, [17000, 140], [16500, 100], 3))
    got = _same_as_jax_cli(
        tmp_path, ["-a", fx.TRUSEQ_R1, "-A", fx.TRUSEQ_R2], [r1, r2],
        [("-o", "out.1.fastq"), ("-p", "out.2.fastq")],
    )
    assert got["report"]["read_counts"]["read2_with_adapter"] == 2
