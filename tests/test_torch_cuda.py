"""
Tests of the port that need an NVIDIA GPU: the CUDA aligner kernel
against its plain PyTorch version, and the engine on the card against
the engine on the CPU. They import nothing of the JAX package, so they
run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card they skip.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cutadapt_tpu_torch.batch_pipeline as tbp
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk
from cutadapt_tpu_torch.ops import align_cuda

import torch_fixtures as fx


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
def test_kernel_matches_plain_on_card(card, pack2):
    lane = "pack2" if pack2 else "pack4"
    rng = np.random.RandomState(11)
    for spec in fx.parity_specs():
        tables = align_cuda.make_tables(spec)
        _, enc, lens = fx.random_batch(spec, rng, 1024, 128, pack2)
        enc_d = torch.from_numpy(enc).cuda()
        len_d = torch.from_numpy(lens).cuda()
        before = align_cuda.LAUNCHES[lane]
        got = align_cuda.locate_packed(enc_d, len_d, tables, pack2)
        torch.cuda.synchronize()
        assert align_cuda.LAUNCHES[lane] == before + 1
        plain = align_cuda.locate_reference(enc_d, len_d, tables, pack2)
        assert fx.first_difference(
            align_cuda.unpack_result(got.cpu().numpy()),
            align_cuda.unpack_result(plain.cpu().numpy()),
        ) is None


def _held_to_plain_and_scalar(spec, raw, enc, lens, pack2):
    tables = align_cuda.make_tables(spec)
    enc_d = torch.from_numpy(enc).cuda()
    len_d = torch.from_numpy(lens).cuda()
    got = align_cuda.unpack_result(
        align_cuda.locate_packed(enc_d, len_d, tables, pack2).cpu().numpy()
    )
    plain = align_cuda.locate_reference(enc_d, len_d, tables, pack2)
    assert fx.first_difference(
        got, align_cuda.unpack_result(plain.cpu().numpy())
    ) is None
    assert fx.first_difference(got, fx.scalar_locate(spec, raw, lens)) is None
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
def test_wide_kernel_matches_plain_on_card(card, pack2):
    """The wide (7, B) store in each layout mode (a flagship-sized adapter
    in registers, 300 bp in shared memory, 4,000 bp in device scratch)
    and on reads of 2**14 bp or more, against the plain version on all 7
    fields; every launch counts as wide."""
    rng = np.random.RandomState(14)
    align_cuda.reset_launch_counters()
    lane = "pack2" if pack2 else "pack4"
    cases = [(spec, fx.random_batch(spec, rng, 64 if len(spec.reference)
                                    > 1000 else 256, 512, pack2))
             for spec in [fx.parity_specs()[0], fx.long_specs()[-1],
                          fx.very_long_spec()]]
    spec = fx.parity_specs()[0]
    cases.append((spec, fx.long_batch(spec, rng, 32, (16400, 17000),
                                      pack2)))
    for spec, (raw, enc, lens) in cases:
        tables = align_cuda.make_tables(spec)
        enc_d = torch.from_numpy(enc).cuda()
        len_d = torch.from_numpy(lens).cuda()
        got = align_cuda.locate_packed(enc_d, len_d, tables, pack2, wide=True)
        plain = align_cuda.locate_reference(enc_d, len_d, tables, pack2,
                                            wide=True)
        got = align_cuda.unpack_wide(got.cpu().numpy())
        assert got[0].any()
        assert fx.first_difference(
            got, align_cuda.unpack_wide(plain.cpu().numpy())) is None
    assert {key[3] for key in align_cuda.VARIANT_LAUNCHES} == {0, 1, 2}
    assert align_cuda.WIDE_LAUNCHES[lane] == align_cuda.LAUNCHES[lane] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
def test_long_adapter_kernel_matches_plain_on_card(card, pack2):
    """200 bp adapters (32 lanes of 7 rows in registers), a 300 bp one
    (rows in shared memory) and a 4,000 bp one (rows in device scratch)
    against the plain version and the C++ scalar aligner."""
    rng = np.random.RandomState(13)
    align_cuda.reset_launch_counters()
    for spec in fx.long_specs() + [fx.very_long_spec()]:
        B = 64 if len(spec.reference) > 1000 else 512
        raw, enc, lens = fx.random_batch(spec, rng, B, 512, pack2)
        assert _held_to_plain_and_scalar(spec, raw, enc, lens, pack2)[0].any()
    modes = {key[3] for key in align_cuda.VARIANT_LAUNCHES}
    assert modes == {0, 1, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.variant_specs())),
    ids=[f"{len(s.reference)}-{s.flags}" for s in fx.variant_specs()],
)
def test_every_register_variant_on_card(card, index, pack2):
    """Each register variant (lanes, rows) of the kernel, in both lanes,
    with an adapter that fills every lane's block."""
    spec = fx.variant_specs()[index]
    lay = align_cuda.kernel_layout(len(spec.reference))
    raw, enc, lens = fx.random_batch(
        spec, np.random.RandomState(29 + index), 1024,
        fx.variant_read_length(spec), pack2, **fx.placement(spec))
    align_cuda.reset_launch_counters()
    _held_to_plain_and_scalar(spec, raw, enc, lens, pack2)
    key = align_cuda.template_args(2 if pack2 else 4, lay)
    assert align_cuda.VARIANT_LAUNCHES == {key: 1}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "index", range(len(fx.byte_variant_specs())),
    ids=[f"{len(s.reference)}-{s.flags}" for s in fx.byte_variant_specs()],
)
def test_every_byte_lane_instantiation_on_card(card, index):
    """Each instantiation of the byte lane (adapters of more than 16
    query classes), packed and wide, against the plain version and the
    C++ scalar aligner: one launch of each store, on its variant."""
    spec = fx.byte_variant_specs()[index]
    tables = align_cuda.make_tables(spec)
    assert tables.byte
    raw, enc, lens = fx.byte_variant_batch(
        spec, np.random.RandomState(90 + index))
    align_cuda.reset_launch_counters()
    got = _held_to_plain_and_scalar(spec, raw, enc, lens, None)
    assert got[0].any()
    enc_d = torch.from_numpy(enc).cuda()
    len_d = torch.from_numpy(lens).cuda()
    wide = align_cuda.locate_packed(enc_d, len_d, tables, None, wide=True)
    plain = align_cuda.locate_reference(enc_d, len_d, tables, None, wide=True)
    assert fx.first_difference(
        align_cuda.unpack_wide(wide.cpu().numpy()),
        align_cuda.unpack_wide(plain.cpu().numpy())) is None
    key = align_cuda.template_args(8, align_cuda.kernel_layout(tables.m))
    assert align_cuda.VARIANT_LAUNCHES == {key: 2}
    assert align_cuda.LAUNCHES["byte"] == 2
    assert align_cuda.WIDE_LAUNCHES["byte"] == 1


@pytest.mark.cuda
def test_byte_lane_long_reads_on_card(card):
    """The byte lane's wide store on reads of 2**14 bp or more."""
    spec = fx.byte_lane_specs()[0]
    raw, enc, lens = fx.long_batch(spec, np.random.RandomState(16401), 16,
                                   (16400, 17000), None)
    tables = align_cuda.make_tables(spec)
    enc_d = torch.from_numpy(enc).cuda()
    len_d = torch.from_numpy(lens).cuda()
    got = align_cuda.unpack_wide(align_cuda.locate_packed(
        enc_d, len_d, tables, None, wide=True).cpu().numpy())
    plain = align_cuda.locate_reference(enc_d, len_d, tables, None, wide=True)
    assert got[0].any()
    assert fx.first_difference(
        got, align_cuda.unpack_wide(plain.cpu().numpy())) is None
    assert fx.first_difference(got[:5], fx.scalar_locate(spec, raw,
                                                         lens)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
def test_block_edge_adapters_on_card(card, pack2):
    """DP rows ending one short of, at, and one past the flagship
    layout's lane blocks."""
    rng = np.random.RandomState(17)
    for spec in fx.block_edge_specs():
        raw, enc, lens = fx.random_batch(spec, rng, 1024, 128, pack2,
                                         **fx.placement(spec))
        _held_to_plain_and_scalar(spec, raw, enc, lens, pack2)


@pytest.mark.cuda
def test_half_padding_launch_on_card(card):
    """A 4096-row launch whose second half is padding rows of length 0,
    as the engine's smaller dispatches are."""
    spec = fx.parity_specs()[0]
    raw, enc, lens = fx.random_batch(spec, np.random.RandomState(19), 4096,
                                     100, True)
    raw[2048:] = 0
    enc[2048:] = 0
    lens[2048:] = 0
    got = _held_to_plain_and_scalar(spec, raw, enc, lens, True)
    assert got[0][:2048].any() and not got[0][2048:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
def test_mixed_lengths_within_a_warp_on_card(card, pack2):
    """Reads of one warp that differ in length (0 to 512, neighbours far
    apart) and, for suffix adapters, start their columns at min_n > 0."""
    rng = np.random.RandomState(23)
    for spec in [fx.parity_specs()[i] for i in (0, 7, 10)] \
            + fx.block_edge_specs()[2::3]:
        raw, enc, lens = fx.random_batch(spec, rng, 1024, 512, pack2)
        order = np.argsort(lens)
        order = np.stack([order[:512], order[512:][::-1]], 1).ravel()
        raw, enc, lens = raw[order], enc[order], lens[order]
        if not spec.stop_in_query:
            m, k = len(spec.reference), int(spec.max_error_rate
                                            * len(spec.reference))
            assert (lens - m - k > 0).sum() > 100
        _held_to_plain_and_scalar(spec, raw, enc, lens, pack2)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card):
    """Both kernel lanes run, and the card's output equals the CPU
    engine's byte for byte. A fifth of the reads carry N, so that each
    chunk has more N-bearing candidates than the host scalar aligner
    takes (64)."""
    reads = fx.add_ns(fx.make_dataset(6000, seed=99), 0.2)
    chunks, _ = fx.split_records(reads, 2000)
    sizes = dict(min_dp_batch=256, max_dp_batch=1024)
    align_cuda.reset_launch_counters()
    got = list(tbp.process_chunks_pipelined(
        fx.make_engine(device="cuda", **sizes), chunks
    ))
    assert align_cuda.LAUNCHES["pack2"] > 0
    assert align_cuda.LAUNCHES["pack4"] > 0
    want = list(tbp.process_chunks_pipelined(
        fx.make_engine(device="cpu", **sizes), chunks
    ))
    assert len(got) == len(want) == 3
    for (out, stats), (wout, wstats) in zip(got, want):
        assert out == wout
        assert stats["with_adapters"] == wstats["with_adapters"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["single", "paired"])
def test_staged_submit_on_card_matches_cpu(card, layout):
    """Submit's staged pass on the card: eight chunks through the
    single-end engine, or through both engines of a pair, give the CPU
    engines' outputs; every candidate goes through the pass
    (``staged_rows`` equals ``candidates``), and the arenas' pinned
    allocations all fall in the first chunk."""
    if layout == "single":
        sides = [(fx.add_ns(fx.make_dataset(40000, seed=77), 0.05),
                  fx.ADAPTER)]
    else:
        r1, r2 = fx.make_pairs(40000, seed=78)
        sides = [(r1, fx.ADAPTER), (r2, fx.TRUSEQ_R2)]
    sizes = dict(min_dp_batch=1024, max_dp_batch=8192)
    outs = {}
    for device in ("cuda", "cpu"):
        engines = [tbp.BatchPipelineEngine(
            [tbp.AdapterStage([tbp.AdapterTask(
                fx.BackAdapter(ad, max_errors=0.1, min_overlap=3), "back",
                0)])], device=device, **sizes) for _, ad in sides]
        chunks = [fx.split_records(data, 5000)[0] for data, _ in sides]
        assert all(len(c) == 8 for c in chunks)
        tbp.reset_xfer_counters()
        allocs, out, pending = [], [], None
        for i in range(8):
            nxt = [e.submit(parse_fastq_chunk(c[i]))
                   for e, c in zip(engines, chunks)]
            allocs.append(tbp.XFER["pinned_allocs"])
            if pending is not None:
                out.append([e.collect(p)[:3] for e, p in zip(engines,
                                                             pending)])
            pending = nxt
        out.append([e.collect(p)[:3] for e, p in zip(engines, pending)])
        xfer = tbp.xfer_counters()
        assert xfer["candidates"] > 0
        assert xfer["staged_rows"] == xfer["candidates"]
        assert allocs[0] > 0 and allocs == allocs[:1] * 8, allocs
        outs[device] = out
    for got, want in zip(outs["cuda"], outs["cpu"]):
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def _engine_on_card_and_cpu(stages_fn, filters, data, records=1000):
    """The same chunks through the engine on the card and on the CPU:
    outputs and statistics equal. Returns the launch counters of the
    card's run."""
    chunks, _ = fx.split_records(data, records)
    sizes = dict(min_dp_batch=256, max_dp_batch=1024)
    outs = {}
    for device in ("cuda", "cpu"):
        align_cuda.reset_launch_counters()
        engine = tbp.BatchPipelineEngine(
            stages_fn(), [tbp.FilterSpec(k, t) for k, t in filters],
            device=device, **sizes,
        )
        outs[device] = list(tbp.process_chunks_pipelined(engine, chunks))
        if device == "cuda":
            launches = dict(align_cuda.LAUNCHES)
            assert not any(align_cuda.PLAIN_RUNS.values())
    assert len(outs["cuda"]) == len(outs["cpu"]) == len(chunks)
    for (out, stats), (wout, wstats) in zip(outs["cuda"], outs["cpu"]):
        assert out == wout
        for key in ("with_adapters", "quality_trimmed", "filter_counts",
                    "written"):
            assert stats.get(key) == wstats.get(key), key
        for key in ("poly_a_removed",):
            for si, removed in wstats.get(key, {}).items():
                np.testing.assert_array_equal(stats[key][si], removed)
    return launches


@pytest.mark.cuda
def test_linked_engine_on_card_matches_cpu(card, monkeypatch):
    """The linked primers of chip_smoke.py's phase 7: the 5' phase
    launches from submit, the 3' phase from the engine's linked worker,
    both in the 2-bit lane; the card's output equals the CPU engine's."""
    phases = []
    real = tbp.locate_packed
    monkeypatch.setattr(
        tbp, "locate_packed",
        lambda enc, lens, tables, pack2, **kw: phases.append(
            (tables.spec.flags, pack2, enc.device.type))
        or real(enc, lens, tables, pack2, **kw),
    )
    launches = _engine_on_card_and_cpu(
        lambda: [fx.cutter_stage(fx.PORT_MODULES,
                                 [("back", fx.LINKED_PRIMERS)])[0]],
        [("discard_untrimmed", None)], fx.make_amplicons(3000, seed=35),
    )
    assert launches["pack2"] > 0
    on_card = {(f, p2) for f, p2, dev in phases if dev == "cuda"}
    prefix, back = tbp.Where.PREFIX.value, tbp.Where.BACK.value
    assert {(prefix, True), (back, True)} <= on_card


@pytest.mark.cuda
def test_quality_trimmed_windows_on_card_matches_cpu(card):
    """-q 20 -a ADAPTER --poly-a -m 10 (chip_smoke.py's phase 6) on
    reads of which 3% are trimmed to nothing by -q and others start
    past 0: empty rows and shifted windows reach the kernel."""
    data = fx.edit_reads(fx.make_reads(4000, 3, [fx.ADAPTER], polya=True), 4)
    launches = _engine_on_card_and_cpu(
        lambda: [tbp.QualityStage(0, 20), tbp.AdapterStage(
            [tbp.AdapterTask(fx.make_adapter(), "back", 0)]),
            tbp.PolyAStage()],
        [("too_short", 10)], data,
    )
    assert launches["pack2"] > 0 and launches["pack4"] > 0


GOLDEN = fx.golden_cases()
ENGINE_GOLDEN = [c for c in GOLDEN if c[0] not in fx.ENGINE_NOT_YET]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ENGINE_GOLDEN, ids=[c[0] for c in ENGINE_GOLDEN],
)
def test_cli_golden_on_card(card, monkeypatch, tmp_path, case):
    """Each golden case the engine accepts, through the port's main on
    the card in require mode: byte-identical to tests/cut/."""
    from cutadapt_tpu_torch import accel, cli

    case_id, params, expected, inpath = case
    for name in ("CUTADAPT_TPU_TORCH_DEVICE", "CUTADAPT_TPU_TORCH_CHUNK_BYTES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    out = tmp_path / expected
    fallbacks = accel.FALLBACK_COUNT
    # the warm-up launches both lanes once per kernel task; the reads
    # add more
    warm = []
    real_warmup = tbp.BatchPipelineEngine.warmup

    def counted_warmup(engine, max_len):
        real_warmup(engine, max_len)
        warm.append(sum(align_cuda.LAUNCHES.values()))

    monkeypatch.setattr(tbp.BatchPipelineEngine, "warmup", counted_warmup)
    align_cuda.reset_launch_counters()
    cli.main(fx.golden_args(params, str(out), inpath))
    with open(out, "rb") as got, open(fx.golden_path(expected), "rb") as want:
        assert got.read() == want.read()
    assert accel.FALLBACK_COUNT == fallbacks
    assert not any(align_cuda.PLAIN_RUNS.values())
    data_launches = sum(align_cuda.LAUNCHES.values()) - sum(warm)
    if case_id in fx.NO_ALIGNER_RUN:
        assert data_launches == 0
    else:
        assert data_launches > 0


PAIRED_GOLDEN = fx.paired_golden_cases()
# the paired revcomp cases of tests/test_paired.py and the single-end
# one of tests/test_commandline.py: (params, in1, in2 or None, outputs)
REVCOMP_GOLDEN = {
    "paired_r1_and_r2": (
        "--revcomp -g ^TTATTTGTCT -G ^TCCGCACTGGC", "revcomp.1.fastq",
        "revcomp.2.fastq", ("revcomp-r1r2.1.fastq", "revcomp-r1r2.2.fastq")),
    "paired_only_r1": (
        "--revcomp -g ^TTATTTGTCT -g ^TCCGCACTGGC", "revcomp.1.fastq",
        "revcomp.2.fastq", ("revcomp.1.fastq", "revcomp.2.fastq")),
    "single_normalized": (
        "--revcomp --no-index -g ^TTATTTGTCT -g ^TCCGCACTGG",
        "revcomp.1.fastq", None, ("revcomp-single-normalize.fastq",)),
}


def _card_main(monkeypatch, args):
    """The port's main on the card in require mode: no fallback, no run
    of the plain version; returns the launch counters."""
    from cutadapt_tpu_torch import accel, cli

    for name in ("CUTADAPT_TPU_TORCH_DEVICE", "CUTADAPT_TPU_TORCH_CHUNK_BYTES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    fallbacks = accel.FALLBACK_COUNT
    align_cuda.reset_launch_counters()
    cli.main([str(a) for a in args])
    assert accel.FALLBACK_COUNT == fallbacks
    assert not any(align_cuda.PLAIN_RUNS.values())
    return dict(align_cuda.LAUNCHES)


def _same_file(path, expected):
    with open(path, "rb") as got, open(fx.golden_path(expected), "rb") as want:
        assert got.read() == want.read(), expected


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", PAIRED_GOLDEN, ids=[c[0] for c in PAIRED_GOLDEN],
)
def test_paired_golden_on_card(card, monkeypatch, tmp_path, case):
    """Each paired golden case through the port's main on the card in
    require mode: both outputs byte-identical to tests/cut/."""
    _, params, in1, in2, expected1, expected2 = case
    (tmp_path / "r1").mkdir()
    (tmp_path / "r2").mkdir()
    out1, out2 = tmp_path / "r1" / expected1, tmp_path / "r2" / expected2
    _card_main(monkeypatch,
               fx.paired_golden_args(params, out1, out2, in1, in2))
    _same_file(out1, expected1)
    _same_file(out2, expected2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REVCOMP_GOLDEN))
def test_revcomp_golden_on_card(card, monkeypatch, tmp_path, name):
    params, in1, in2, expected = REVCOMP_GOLDEN[name]
    outs = [tmp_path / f"{i}-{e}" for i, e in enumerate(expected)]
    if in2 is None:
        args = fx.golden_args(params, str(outs[0]), in1)
    else:
        args = fx.paired_golden_args(params, outs[0], outs[1], in1, in2)
    _card_main(monkeypatch, args)
    for out, exp in zip(outs, expected):
        _same_file(out, exp)


@pytest.mark.cuda
def test_byte_lane_cli_on_card(card, monkeypatch, tmp_path):
    """-N -a with an adapter of 17 query classes through the port's main
    on the card under require: only the byte lane launches, and the
    output and the --json report's counts equal the port's host path."""
    from cutadapt_tpu_torch import cli

    reads = tmp_path / "in.fastq"
    reads.write_bytes(fx.make_byte_lane_reads(20000))
    args = ["-N", "-e", "0.1", "-a", fx.BYTE_LANE_ADAPTER]
    outs = {}
    for mode in ("0", "require"):
        out, rep = tmp_path / f"{mode}.fastq", tmp_path / f"{mode}.json"
        run = args + ["-o", out, "--json", rep, reads]
        if mode == "0":
            monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "0")
            cli.main([str(a) for a in run])
        else:
            launches = _card_main(monkeypatch, run)
        outs[mode] = (out.read_bytes(), fx.json_report(rep)["read_counts"])
    assert outs["require"] == outs["0"]
    assert outs["0"][1]["read1_with_adapter"] > 4000
    assert launches["byte"] > 1 and launches["pack2"] == launches["pack4"] == 0


class _Spy:
    """Records the inputs of every kernel launch (CUDA tensors only) and
    the orientation of the dispatch it came from."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.rc = False
        real = tbp.locate_packed

        def spy(enc, lens, tables, pack2, wide=False):
            self.calls.append((self.rc, enc.device.type, enc.clone(),
                               lens.clone(), tables, pack2, wide))
            return real(enc, lens, tables, pack2, wide=wide)

        monkeypatch.setattr(tbp, "locate_packed", spy)

    def held_to_plain(self):
        """Every recorded launch on the card equals the plain version on
        the same CUDA tensors; returns the launch shapes."""
        shapes = set()
        for _, dev, enc, lens, tables, pack2, wide in self.calls:
            if dev != "cuda":
                continue  # the CPU twin of a _card_and_cpu run
            unpack = (align_cuda.unpack_wide if wide
                      else align_cuda.unpack_result)
            got = align_cuda.locate_packed(enc, lens, tables, pack2,
                                           wide=wide)
            plain = align_cuda.locate_reference(enc, lens, tables, pack2,
                                                wide=wide)
            assert fx.first_difference(
                unpack(got.cpu().numpy()), unpack(plain.cpu().numpy()),
            ) is None
            shapes.add((pack2, tuple(enc.shape)))
        return shapes


def _pair_chunks(n, seed):
    from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk

    # a fifth of the reads with N, so that both kernel lanes launch
    return tuple(parse_fastq_chunk(fx.add_ns(r, 0.2, seed=seed + i))
                 for i, r in enumerate(fx.make_pairs(n, seed)))


def _card_and_cpu(fn):
    """fn(device) on the card and on the CPU: the card's result, after
    checking that both are equal."""
    got = {dev: fn(dev) for dev in ("cuda", "cpu")}
    fx.assert_same(got["cuda"], got["cpu"])
    return got["cuda"]


@pytest.mark.cuda
def test_pair_match_on_card(card, monkeypatch):
    """One --pair-adapters batch (two adapter pairs) on the card: the
    same windows, matched mask and winning pair as on the CPU; every
    launch shape held to the plain version."""
    from cutadapt_tpu_torch import accel, parser
    from cutadapt_tpu_torch.modifiers import PairedAdapterCutter

    search = dict(max_errors=0.1, min_overlap=3, read_wildcards=False,
                  adapter_wildcards=True, indels=True)
    spy = _Spy(monkeypatch)

    def run(device):
        chunks = _pair_chunks(3000, 21)
        ads = [parser.make_adapters_from_specifications(
            [("back", a), ("back", a[:20])], search)
            for a in (fx.TRUSEQ_R1, fx.TRUSEQ_R2)]
        mod = PairedAdapterCutter(*ads)
        tasks = [[tbp.AdapterTask(a, tbp.adapter_kind(a), i)
                  for i, a in enumerate(side)] for side in ads]
        engines = [tbp.BatchPipelineEngine([], device=device, min_dp_batch=256,
                                           max_dp_batch=1024)
                   for _ in (1, 2)]
        windows = [(np.zeros(c.n_records, np.int32),
                    c.seq_len.astype(np.int32)) for c in chunks]
        stats = ({}, {})
        with torch.cuda.device(0):
            matched = accel._pair_match(engines, chunks, windows,
                                        (tasks[0], tasks[1], mod),
                                        stats_pair=stats)
        return dict(matched=matched, windows=windows,
                    gid=stats[0]["last_adapter_gid"],
                    with_adapters=mod.with_adapters)

    got = _card_and_cpu(run)
    assert got["with_adapters"] > 500
    shapes = spy.held_to_plain()
    assert {p2 for p2, _ in shapes} == {True, False}


@pytest.mark.cuda
def test_run_rc_pair_on_card(card, monkeypatch):
    """One paired --revcomp batch on the card (a third of the pairs with
    R1 and R2 exchanged): the same slot windows, matched masks and
    winning orientation as on the CPU; every launch shape held to the
    plain version."""
    from cutadapt_tpu_torch import accel
    from cutadapt_tpu_torch.io.chunks import ParsedChunk
    from cutadapt_tpu_torch.modifiers import PairedReverseComplementer

    spy = _Spy(monkeypatch)

    def swapped(chunks, share, seed):
        c1, c2 = chunks
        swap = np.random.RandomState(seed).rand(c1.n_records) < share
        buf = np.concatenate([c1.buf, c2.buf])
        off = len(c1.buf)
        pick = [np.where(swap, b + off, a) for a, b in (
            (c1.seq_start, c2.seq_start), (c1.qual_start, c2.qual_start))]
        back = [np.where(swap, a, b + off) for a, b in (
            (c1.seq_start, c2.seq_start), (c1.qual_start, c2.qual_start))]
        return (ParsedChunk(buf, c1.head_start, c1.head_end, pick[0],
                            c1.seq_len, pick[1]),
                ParsedChunk(buf, c2.head_start + off, c2.head_end + off,
                            back[0], c2.seq_len, back[1]))

    def run(device):
        chunks = swapped(_pair_chunks(3000, 22), 1 / 3, 23)
        st1 = fx.cutter_stage(fx.PORT_MODULES, [("back", fx.TRUSEQ_R1)])[0]
        st2 = fx.cutter_stage(fx.PORT_MODULES, [("back", fx.TRUSEQ_R2)])[0]
        mod = PairedReverseComplementer(st1.modifier, st2.modifier)
        engines = [tbp.BatchPipelineEngine([], device=device, min_dp_batch=256,
                                           max_dp_batch=1024)
                   for _ in (1, 2)]
        windows = [(np.zeros(c.n_records, np.int32),
                    c.seq_len.astype(np.int32)) for c in chunks]
        with torch.cuda.device(0):
            res = accel._run_rc_pair(engines, (st1, st2, mod), chunks,
                                     windows)
        return dict(windows=list(res[2:6]), matched=list(res[6:8]),
                    gids=[res[8][0], res[9][0]],
                    geometry=[res[8][1], res[9][1]],
                    rc=mod.reverse_complemented)

    got = _card_and_cpu(run)
    # a swapped pair is told apart where an adapter is read (a third)
    assert 200 < got["rc"] < 450
    assert spy.held_to_plain()


@pytest.mark.cuda
def test_revcomp_dispatch_reaches_kernel_on_card(card, monkeypatch):
    """Under --revcomp the rc copy's dispatch launches the kernel on CUDA
    tensors, as the forward one does, both from submit."""
    from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk

    spy = _Spy(monkeypatch)
    stage, tasks = fx.cutter_stage(fx.PORT_MODULES,
                                   [("front", "^" + fx.PRIMER_515F)])
    engine = tbp.BatchPipelineEngine(
        [tbp.RevcompStage(tasks, modifier=stage.modifier)], device="cuda",
        min_dp_batch=256, max_dp_batch=1024,
    )
    chunk = parse_fastq_chunk(fx.make_amplicons(2000, seed=24, rc_share=0.5))
    real = engine._dispatch_stage

    def tagged(stage, c, *args):
        spy.rc = c is not chunk
        return real(stage, c, *args)

    engine._dispatch_stage = tagged
    align_cuda.reset_launch_counters()
    pending = engine.submit(chunk)
    in_submit = len(spy.calls)
    _, _, _, stats = engine.collect(pending)
    assert len(spy.calls) == in_submit
    assert {(rc, dev) for rc, dev, *_ in spy.calls} == {
        (False, "cuda"), (True, "cuda")}
    assert not any(align_cuda.PLAIN_RUNS.values())
    assert 700 < int(stats["is_rc"].sum()) < 1300
    spy.held_to_plain()


# --- the statistics reducer and the device mesh --------------------------------


def _card_mesh(size=4):
    """``size`` shards on the first min(size, cards) cards, repeated in
    order: the sharded path on however many cards the machine has."""
    from cutadapt_tpu_torch.parallel import make_mesh

    n = min(size, torch.cuda.device_count())
    return make_mesh([torch.device("cuda", i % n) for i in range(size)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 33_000, 131_072])
@pytest.mark.parametrize("entry", ["hist2d", "hist1d", "count"])
def test_scatter_kernel_matches_plain_on_card(card, entry, n):
    """Each entry point of the scatter kernel against its plain version
    on the same CUDA tensors (a launch per non-empty batch, none for an
    empty one); tolerance: exact."""
    from cutadapt_tpu_torch.ops import stats_cuda

    rng = np.random.RandomState(n)
    i32 = torch.int32
    rows = torch.from_numpy(rng.randint(0, 128, n).astype(np.int32)).cuda()
    cols = torch.from_numpy(rng.randint(0, 64, n).astype(np.int32)).cuda()
    valid = torch.from_numpy((rng.rand(n) < 0.7).astype(np.int32)).cuda()
    shape = {"hist2d": (128, 64), "hist1d": (128,), "count": ()}[entry]
    buf = torch.from_numpy(rng.randint(0, 5, shape).astype(np.int32)).cuda()
    want = buf.clone()
    events = {"hist2d": (rows, cols, valid), "hist1d": (rows, valid),
              "count": (valid,)}[entry]
    stats_cuda.reset_launch_counters()
    {"hist2d": stats_cuda.scatter_add_2d, "hist1d": stats_cuda.scatter_add_1d,
     "count": stats_cuda.count_add}[entry](buf, *events)
    stats_cuda.scatter_add_batch_reference([(want, *events)])
    torch.cuda.synchronize()
    assert torch.equal(buf, want)
    # a one-descriptor batch: one launch where there are events
    assert stats_cuda.LAUNCHES == {"batch": 1 if n else 0}
    assert stats_cuda.DESCRIPTORS == {"cluster": 1 if n else 0, "direct": 0}
    assert not any(stats_cuda.PLAIN_RUNS.values())


@pytest.mark.cuda
def test_reducer_on_4_card_shards_matches_one_device(card):
    from cutadapt_tpu_torch.ops import stats_cuda
    from cutadapt_tpu_torch.parallel import DeviceStatsReducer

    rng = np.random.RandomState(3)
    events = [
        ("h2", rng.randint(0, 200, 5000), rng.randint(0, 90, 5000)),
        ("h1", rng.randint(0, 300, 7000)),
        ("c", rng.rand(9000) < 0.3),
        ("z", np.array([], np.int32)),
    ]
    got = {}
    for tag, mesh in (("one", None), ("mesh", _card_mesh())):
        red = DeviceStatsReducer(mesh, device="cuda")
        out = got[tag] = {}
        stats_cuda.reset_launch_counters()
        for key, *ev in events:
            fold = (lambda k: lambda v: out.__setitem__(k, v))(key)
            if key == "h2":
                red.add_hist2d(key, *ev, fold)
            elif key == "c":
                red.add_count(key, ev[0], fold)
            else:
                red.add_hist1d(key, ev[0], fold)
        red.fold()
        # the adds stage; fold's flush is one launch per shard
        shards = 1 if mesh is None else 4
        assert stats_cuda.LAUNCHES == {"batch": shards}
        assert not any(stats_cuda.PLAIN_RUNS.values())
    assert sorted(got["one"]) == sorted(got["mesh"])
    for key, want in got["one"].items():
        np.testing.assert_array_equal(got["mesh"][key], want, err_msg=key)
    assert got["one"]["c"] == int(events[2][1].sum())


def _scatter_case(case, dev):
    """Descriptors of one batch-kernel case on ``dev``: the flush of a
    flagship chunk (the reducer's shapes), a long-read removal histogram
    past the cluster's shared memory beside a small one (direct and
    cluster mode), more descriptors than one launch takes (buffers
    repeated), and empty descriptors."""
    from cutadapt_tpu_torch.ops import stats_cuda

    rng = np.random.RandomState(len(case))
    i32 = torch.int32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def removals(n, rows):
        return (t(np.minimum(rng.geometric(0.08, n), rows - 1)),
                t(np.minimum(rng.geometric(0.6, n) - 1, 3)))

    if case == "reducer":
        hist = np.bincount(rng.randint(0, 101, 131072))
        nz = np.flatnonzero(hist)
        return [
            (torch.zeros((128, 64), dtype=i32, device=dev),
             *removals(33000, 128), None),
            (torch.zeros(64, dtype=i32, device=dev),
             t(rng.randint(0, 5, 33000)), None),
            (torch.zeros(128, dtype=i32, device=dev), t(nz), t(hist[nz])),
            (torch.zeros((), dtype=i32, device=dev),
             t(rng.rand(131072) < 0.25)),
        ]
    if case == "direct":
        rows = 32768
        assert stats_cuda.bins_per_block(rows * 64) == 0
        return [
            (torch.zeros((rows, 64), dtype=i32, device=dev),
             t(rng.randint(-5, rows + 5, 8192)), t(rng.randint(-1, 70, 8192)),
             t(rng.randint(-2, 5, 8192))),
            (torch.zeros((192, 64), dtype=i32, device=dev),
             *removals(20000, 192), t(rng.randint(0, 3, 20000))),
        ]
    if case == "many":
        bufs = [torch.zeros(rng.choice([5, 130, 12289 * 8]), dtype=i32,
                            device=dev) for _ in range(20)]
        descs = []
        for k in range(2 * stats_cuda.MAX_DESCRIPTORS + 5):
            b = bufs[k % len(bufs)]
            n = int(rng.randint(1, 5000))
            descs.append((b, t(rng.randint(0, b.numel() + 3, n)),
                          t(rng.randint(0, 4, n))))
        return descs
    assert case == "empty"
    return [
        (torch.zeros((64, 64), dtype=i32, device=dev), t([]), t([]), t([])),
        (torch.zeros(64, dtype=i32, device=dev), t([3, 3, 70]), None),
        (torch.zeros(1, dtype=i32, device=dev), t([])),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reducer", "direct", "many", "empty"])
def test_scatter_batch_matches_plain_on_card(card, case):
    """The batch kernel against its plain version on the same CUDA
    tensors, every buffer; the launches and each descriptor's mode as the
    plan says; tolerance: exact."""
    from cutadapt_tpu_torch.ops import stats_cuda

    dev = torch.device("cuda", 0)
    descs = _scatter_case(case, dev)
    # one copy per buffer: descriptors of one buffer add up in it
    copies = {}
    want = [(copies.setdefault(d[0].data_ptr(), d[0].clone()),)
            + tuple(d[1:]) for d in descs]
    plan = stats_cuda.plan_batch([(d[0].numel(), d[-1].shape[0]
                                   if d[-1] is not None else d[1].shape[0])
                                  for d in descs])
    stats_cuda.reset_launch_counters()
    stats_cuda.scatter_add_batch(descs)
    stats_cuda.scatter_add_batch_reference(want)
    torch.cuda.synchronize()
    for d, w in zip(descs, want):
        assert torch.equal(d[0], w[0])
    modes = [per for launch in plan for per in launch.bins_per_block]
    assert stats_cuda.LAUNCHES == {"batch": len(plan)}
    assert stats_cuda.DESCRIPTORS == {
        "cluster": sum(1 for p in modes if p), "direct": modes.count(0)}
    assert not any(stats_cuda.PLAIN_RUNS.values())
    assert len(plan) == {"reducer": 1, "direct": 1, "many": 3,
                         "empty": 1}[case]
    if case == "direct":
        assert modes == [0, 192 * 64 // stats_cuda.CLUSTER]


@pytest.mark.cuda
def test_reducer_flushes_once_per_chunk_on_card(card):
    """Chunks of events flushed one by one on one device and on 4 shards
    of the card(s): one launch per chunk and shard, and the fold equal to
    the plain version's on the CPU."""
    from cutadapt_tpu_torch.ops import stats_cuda
    from cutadapt_tpu_torch.parallel import DeviceStatsReducer, make_mesh

    rng = np.random.RandomState(12)
    chunks = []
    for _ in range(3):
        n = int(rng.randint(1000, 5000))
        hist = np.bincount(rng.randint(0, 150, 20000))
        chunks.append((rng.randint(0, 150, n), rng.randint(0, 4, n),
                       rng.randint(0, 5, n), hist, rng.rand(20000) < 0.1))
    got = {}
    for tag, mesh, device in (
            ("cpu", make_mesh(["cpu"] * 4), "cpu"), ("one", None, "cuda"),
            ("mesh", _card_mesh(), "cuda")):
        red = DeviceStatsReducer(mesh, device=device)
        out = got[tag] = {}
        stats_cuda.reset_launch_counters()
        for rem, err, adj, hist, mask in chunks:
            nz = np.flatnonzero(hist)
            red.add_hist2d("rm", rem, err, lambda v: out.__setitem__("rm", v))
            red.add_hist1d("adj", adj, lambda v: out.__setitem__("adj", v))
            red.add_hist1d("wl", nz, lambda v: out.__setitem__("wl", v),
                           weights=hist[nz])
            red.add_count("flt", mask, lambda v: out.__setitem__("flt", v))
            red.flush()
        red.fold()
        shards = 1 if mesh is None else 4
        counter = stats_cuda.PLAIN_RUNS if tag == "cpu" else stats_cuda.LAUNCHES
        assert counter == {"batch": 3 * shards}, tag
    for tag in ("one", "mesh"):
        assert sorted(got[tag]) == sorted(got["cpu"])
        for key, want in got["cpu"].items():
            np.testing.assert_array_equal(got[tag][key], want,
                                          err_msg=(tag, key))


@pytest.mark.cuda
def test_sharded_trim_step_bins_in_one_launch_per_shard_on_card(card):
    """make_sharded_trim_step on 4 shards of the card(s) against the same
    step on 4 shards of the CPU: every field equal, and the seven buffers
    of each shard binned in one scatter launch."""
    from cutadapt_tpu_torch.adapters import Where
    from cutadapt_tpu_torch.ops import stats_cuda
    from cutadapt_tpu_torch.ops.align_batch import AlignerSpec
    from cutadapt_tpu_torch.parallel import make_mesh, make_sharded_trim_step

    rng = np.random.RandomState(21)
    batch, length = 1024, 100
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, (batch, length))]
    ad = np.frombuffer(fx.ADAPTER.encode(), np.uint8)
    for i in range(0, batch, 3):
        pos = rng.randint(0, length - 4)
        take = min(len(ad), length - pos)
        reads[i, pos:pos + take] = ad[:take]
    lengths = rng.randint(20, length + 1, batch).astype(np.int32)
    spec = AlignerSpec(reference=fx.ADAPTER, max_error_rate=0.1,
                       flags=Where.BACK.value, min_overlap=3)
    want = make_sharded_trim_step(spec, make_mesh(["cpu"] * 4), length,
                                  min_length=30)(reads, lengths)
    stats_cuda.reset_launch_counters()
    got = make_sharded_trim_step(spec, _card_mesh(), length,
                                 min_length=30)(reads, lengths)
    assert stats_cuda.LAUNCHES == {"batch": 4}
    assert stats_cuda.DESCRIPTORS == {"cluster": 28, "direct": 0}
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for key, w in want[2].items():
        np.testing.assert_array_equal(got[2][key], w, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
@pytest.mark.parametrize("pack2", [True, False, None],
                         ids=["2bit", "4bit", "byte"])
def test_sharded_step_matches_unsharded_on_card(card, pack2, wide):
    """AdapterTask.step with a mesh of 4 shards of the card(s): one
    launch per shard, each on its own device, and the joined result
    equal to the unsharded launch's, in every lane and both stores."""
    from cutadapt_tpu_torch.adapters import BackAdapter

    # -N: the byte lane's adapter compares as ASCII (17 query classes)
    adapter = fx.BYTE_LANE_ADAPTER if pack2 is None else fx.ADAPTER
    task = tbp.AdapterTask(BackAdapter(adapter, max_errors=0.1, min_overlap=3,
                                       adapter_wildcards=False), "back", 0)
    assert task.byte == (pack2 is None)
    _, enc, lens = fx.random_batch(task.spec, np.random.RandomState(8),
                                   4096, 128, pack2)
    enc_h = torch.from_numpy(enc).pin_memory()
    len_h = torch.from_numpy(lens).pin_memory()
    dev = torch.device("cuda", 0)
    want = task.step(enc_h, len_h, dev, pack2, wide=wide).numpy()
    tbp.set_shard_mesh(_card_mesh())
    try:
        tbp.reset_shard_counters()
        align_cuda.reset_launch_counters()
        res = task.step(enc_h, len_h, dev, pack2, wide=wide)
        assert isinstance(res, tbp.ShardedResult)
        assert [p._dev.device for p in res.parts] == list(
            tbp.get_shard_mesh().devices)
        got = res.numpy()
    finally:
        tbp.set_shard_mesh(None)
    np.testing.assert_array_equal(got, want)
    assert tbp.SHARD_LAUNCHES == {0: 1, 1: 1, 2: 1, 3: 1}
    lane = align_cuda.LANE_NAMES[pack2]
    assert align_cuda.LAUNCHES[lane] == 4
    assert align_cuda.WIDE_LAUNCHES[lane] == (4 if wide else 0)
    assert tbp.UNSHARDED_DISPATCHES == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "paired"])
def test_shard_runs_on_card_equal_the_unsharded_run(card, monkeypatch,
                                                    tmp_path, kind):
    """`--shard 0/2` and `--shard 1/2` through the port's main on the card
    in require mode: each shard launches the kernel, the outputs
    concatenate to the unsharded run's byte for byte and the merged
    statistics pickles give its report; the pickles hold no torch
    object."""
    from cutadapt_tpu_torch.report import full_report

    if kind == "single":
        inputs = [tmp_path / "in.fastq"]
        inputs[0].write_bytes(fx.add_ns(fx.make_dataset(20000), 0.05))
        args = ["-a", f"a1={fx.ADAPTER}", "-e", "0.1", "-O", "3"]
    else:
        inputs = [tmp_path / "in.1.fastq", tmp_path / "in.2.fastq"]
        for path, data in zip(inputs, fx.make_pairs(8000)):
            path.write_bytes(data)
        args = ["-a", f"a1={fx.TRUSEQ_R1}", "-A", f"a2={fx.TRUSEQ_R2}",
                "-q", "20", "-m", "20"]
    # named adapters: unnamed ones are numbered per process
    names = ["out.1.fastq", "out.2.fastq"][: len(inputs)]

    def outputs(d):
        d.mkdir()
        outs = ["-o", d / names[0]]
        if len(names) == 2:
            outs += ["-p", d / names[1]]
        return outs

    launches = _card_main(monkeypatch, ["--quiet", *args,
                                        *outputs(tmp_path / "full"), *inputs])
    assert launches["pack2"] > 0
    pickles = []
    for i in range(2):
        d = tmp_path / f"shard{i}"
        launches = _card_main(monkeypatch, [
            "--quiet", *args, *outputs(d), "--shard", f"{i}/2", *inputs])
        assert launches["pack2"] > 0
        pickles.append(fx.load_host_pickle(d / (names[0]
                                                + ".shard-stats.pickle")))
    for name in names:
        got = b"".join((tmp_path / f"shard{i}" / name).read_bytes()
                       for i in range(2))
        assert got == (tmp_path / "full" / name).read_bytes()
    merged = pickles[0]
    merged += pickles[1]
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "0")
    from cutadapt_tpu_torch import cli

    host = cli.main([str(a) for a in ["--quiet", *args,
                                      *outputs(tmp_path / "host"), *inputs]])
    assert merged.as_json() == host.as_json()
    assert full_report(merged, 0, 0.5) == full_report(host, 0, 0.5)


@pytest.mark.cuda
def test_shared_upload_on_card(card, monkeypatch):
    """The TruSeq, Nextera and small-RNA 3' adapters form one group on
    the card: each dispatch batch is uploaded once and launched once per
    member on the uploaded tensors; the output equals the per-task
    dispatch's (each member through ``_dispatch_windows`` on its own) on
    the card and the plain version's (the engine on the CPU)."""
    adapters = (fx.ADAPTER, fx.NEXTERA, "TGGAATTCTCGGGTGCCAAGG")
    events = []
    real_upload, real_locate = tbp.upload_batch, tbp.locate_packed

    def upload(enc, lengths, device):
        out = real_upload(enc, lengths, device)
        events.append(("upload", out[0].data_ptr(), None))
        return out

    def locate(enc, lengths, tables, pack2, wide=False):
        events.append(("launch", enc.data_ptr(), tables.spec.reference))
        return real_locate(enc, lengths, tables, pack2, wide=wide)

    def per_task(engine, stage, chunk, subset, win_start, win_stop, width):
        return [engine._dispatch_task(t, chunk, subset, win_start, win_stop,
                                      width) for t in stage.tasks]

    monkeypatch.setattr(tbp, "upload_batch", upload)
    monkeypatch.setattr(tbp, "locate_packed", locate)
    chunks, _ = fx.split_records(
        fx.add_ns(fx.make_reads(6000, 12, list(adapters)), 0.05), 2000)
    outs = {}
    for device, shared in (("cuda", "1"), ("cuda", "0"), ("cpu", "1")):
        stage, _ = fx.cutter_stage(fx.PORT_MODULES,
                                   [("back", ad) for ad in adapters])
        engine = tbp.BatchPipelineEngine(
            [stage], device=device, min_dp_batch=256, max_dp_batch=1024)
        if shared == "0":
            monkeypatch.setattr(engine, "_dispatch_stage",
                                per_task.__get__(engine))
        align_cuda.reset_launch_counters()
        events.clear()
        outs[device, shared] = [
            out for out, _ in tbp.process_chunks_pipelined(engine, chunks)]
        if device == "cpu":
            continue
        assert not any(align_cuda.PLAIN_RUNS.values())
        ups = [i for i, e in enumerate(events) if e[0] == "upload"]
        assert ups and sum(align_cuda.LAUNCHES.values()) == \
            len(events) - len(ups)
        per_upload = 3 if shared == "1" else 1
        assert len(events) == len(ups) * (1 + per_upload)
        for i in ups:
            batch = events[i + 1 : i + 1 + per_upload]
            assert all(e[0] == "launch" and e[1] == events[i][1]
                       for e in batch)
            if shared == "1":
                assert sorted(e[2] for e in batch) == sorted(adapters)
    assert outs["cuda", "1"] == outs["cuda", "0"] == outs["cpu", "1"]


def _run_program(args, **env):
    """Run a program of the repository to its end; returns the JSON
    object on its last line (None if it printed nothing) and the
    completed process."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict({k: v for k, v in os.environ.items()
                if not k.startswith(("CUTADAPT_TPU", "BENCH_"))}, **env)
    r = subprocess.run([sys.executable, *args], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    return (json.loads(lines[-1]) if lines else None), r


@pytest.mark.cuda
def test_bench_torch_on_card(card):
    """bench_torch.py at 65,536 reads on the card: exit 0, this card's
    name, the kernel parity matrix ok, the kernel alone at no less than
    its bound, every device field present."""
    out, _ = _run_program(["bench_torch.py"], BENCH_READS="65536")
    assert out["device"] == torch.cuda.get_device_name(0)
    assert out["kernel_parity"] == "ok"
    assert out["metric"] == "reads_per_sec_se_3p_adapter_trim"
    assert out["value"] > 0 and out["power_limit_w"] > 0
    assert out["x_bound"] >= 1 / 1.05
    assert 0 <= out["idle_share"] < 1
    assert out["link_pre"]["h2d_gbps"] > 0 and out["link_post"]["rtt_us"] > 0
    assert out["device_kernel"]["rows"] == 65536
    assert out["pipelined_pass"]["launches"]["pack2"] > 0
    assert all(d["ms"] > 0 for d in out["pipelined_pass"]["per_shape"])


@pytest.mark.cuda
def test_verify_cuda_torch_on_card(card):
    _, r = _run_program(["tools/verify_cuda_torch.py"])
    assert "all 26 spec runs agree" in r.stderr


@pytest.mark.cuda
def test_bound_of_on_a_flagship_batch_on_card(card):
    """The moved bound_of on 4,096 flagship reads staged on the card gives
    what chip_smoke.py's bound_of gave before the move at 132 SMs and
    1980 MHz, and at this card's SM count and clock the same count over
    its own rate; the kernel runs those inputs at no less than that
    bound."""
    import chip_smoke

    raw, lens = fx.flagship_rows(4096)
    tables = align_cuda.make_tables(fx.make_engine(device="cpu")
                                    .stages[-1].tasks[0].spec)
    enc = torch.from_numpy(fx.encode_rows(tables.spec, raw, True)).cuda()
    lengths = torch.from_numpy(lens).cuda()
    args = (enc.cpu().numpy(), lengths.cpu().numpy(), tables, True)
    ms, by, work = align_cuda.bound_of(*args, 1980e6, 132)
    assert (by, work) == ("operations", (409600, 13516800, 3398563,
                                         406987496))
    assert ms == pytest.approx(0.024331112737220693, rel=1e-12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    card_ms, _, _ = align_cuda.bound_of(*args, mhz * 1e6, sms)
    assert card_ms == pytest.approx(
        work[3] / (sms * align_cuda.INT32_LANES_PER_SM * mhz * 1e6) * 1e3,
        rel=1e-12)
    kernel_ms = chip_smoke.cuda_ms(
        lambda: align_cuda.locate_packed(enc, lengths, tables, True), 20,
        graph=True)
    assert kernel_ms >= card_ms / 1.05
