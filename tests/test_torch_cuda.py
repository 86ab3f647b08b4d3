"""
Tests of the port that need an NVIDIA GPU: the CUDA aligner kernel
against its plain PyTorch version, and the engine on the card against
the engine on the CPU. They import nothing of the JAX package, so they
run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card they skip.
"""

import numpy as np
import pytest
import torch

import cutadapt_tpu_torch.batch_pipeline as tbp
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


GOLDEN = fx.golden_cases()
ADAPTER_OPTIONS = ("-a", "-g", "-b", "--adapter", "--front", "--anywhere")
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
    align_cuda.reset_launch_counters()
    cli.main(fx.golden_args(params, str(out), inpath))
    with open(out, "rb") as got, open(fx.golden_path(expected), "rb") as want:
        assert got.read() == want.read()
    assert accel.FALLBACK_COUNT == fallbacks
    assert align_cuda.PLAIN_RUNS == {"pack2": 0, "pack4": 0}
    # the warm-up launches both lanes once per adapter; the reads add more
    words = params.split() if isinstance(params, str) else params
    warm = 2 * sum(w in ADAPTER_OPTIONS for w in words)
    data_launches = sum(align_cuda.LAUNCHES.values()) - warm
    if case_id in fx.NO_ALIGNER_RUN:
        assert data_launches == 0
    else:
        assert data_launches > 0
