"""
The PyTorch port's batched aligner (``cutadapt_tpu_torch.ops.align_cuda``)
against the JAX package's XLA aligner and its Pallas kernel in interpret
mode, and against the port's C++ scalar aligner.

Results are integers, compared exactly: ``found`` everywhere, query
start/stop, errors and score where a match was found (the other fields
are undefined there). On the CPU the wrapper runs the plain PyTorch
version; the CUDA kernel itself is compared with it on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from cutadapt_tpu.ops.align_batch import AlignerSpec as JaxSpec
from cutadapt_tpu.ops.align_batch import make_batch_locate
from cutadapt_tpu.ops.align_pallas import make_pallas_locate
from cutadapt_tpu_torch.ops import align_cuda
from cutadapt_tpu_torch.ops.align_batch import (
    encode_reference,
    query_class_info,
    query_lut,
)

import torch_fixtures as fx
from test_torch_spec import CASES


def _batch(spec, seed, B, L, pack2):
    """Reads as tests/test_align_pallas.py draws them: the 4-bit lane
    from ACGTNacgtX, the 2-bit lane from ACGTacgt."""
    cls_lut, _ = query_class_info(spec)
    rng = np.random.RandomState(seed)
    alphabet = b"ACGTacgt" if pack2 else b"ACGTNacgtX"
    raw = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
    lens = rng.randint(0, L + 1, B).astype(np.int32)
    raw[np.arange(L)[None, :] >= lens[:, None]] = 0
    cls = cls_lut[raw]
    packed4 = (cls[:, 0::2] | (cls[:, 1::2] << 4)).astype(np.uint8)
    packed2 = (cls[:, 0::4] | (cls[:, 1::4] << 2) | (cls[:, 2::4] << 4)
               | (cls[:, 3::4] << 6)).astype(np.uint8)
    return raw, packed2 if pack2 else packed4, packed4, lens


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "spec", CASES, ids=[f"{s.reference}-{s.flags}-{s.max_error_rate}"
                        for s in CASES],
)
def test_locate_matches_jax(spec, pack2):
    B, L = 128, (64 if pack2 else 48)
    raw, enc, packed4, lens = _batch(spec, 1000 + CASES.index(spec), B, L,
                                     pack2)
    got = align_cuda.locate(spec, enc, lens, pack2=pack2, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, B)
    got = align_cuda.unpack_result(got.numpy())

    jspec = JaxSpec(**spec._asdict())
    xla = make_batch_locate(jspec, packed=True)(packed4, lens)
    xla = tuple(np.asarray(xla[k]) for k in (
        "found", "query_start", "query_stop", "errors", "score"))
    assert fx.first_difference(got, xla) is None

    pal = make_pallas_locate(jspec, block_b=128, interpret=True, pack2=pack2)
    pal = align_cuda.unpack_result(np.asarray(pal(enc, lens)))
    assert fx.first_difference(got, pal) is None


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.parity_specs())),
    ids=[f"{i}-{s.reference[:8]}-{s.flags}"
         for i, s in enumerate(fx.parity_specs())],
)
def test_locate_matches_scalar_aligner(index, pack2):
    spec = fx.parity_specs()[index]
    rng = np.random.RandomState(20260816 + index)
    raw, enc, lens = fx.random_batch(spec, rng, 96, 64, pack2)
    got = align_cuda.locate(spec, enc, lens, pack2=pack2, device="cpu")
    want = fx.scalar_locate(spec, raw, lens)
    got = align_cuda.unpack_result(got.numpy())
    assert fx.first_difference(got, want) is None


def test_locate_reference_long_reads():
    """512 bp reads, both lanes, against the XLA aligner."""
    spec = fx.parity_specs()[0]
    jspec = JaxSpec(**spec._asdict())
    rng = np.random.RandomState(7)
    for pack2 in (True, False):
        raw, enc, lens = fx.random_batch(spec, rng, 32, 512, pack2)
        cls = query_class_info(spec)[0][raw]
        packed4 = (cls[:, 0::2] | (cls[:, 1::2] << 4)).astype(np.uint8)
        got = align_cuda.locate(spec, enc, lens, pack2=pack2, device="cpu")
        xla = make_batch_locate(jspec, packed=True)(packed4, lens)
        xla = tuple(np.asarray(xla[k]) for k in (
            "found", "query_start", "query_stop", "errors", "score"))
        got = align_cuda.unpack_result(got.numpy())
        assert fx.first_difference(got, xla) is None


def _against_xla_and_scalar(spec, seed, B, L, pack2, at_start=False):
    rng = np.random.RandomState(seed)
    raw, enc, lens = fx.random_batch(spec, rng, B, L, pack2, at_start)
    got = align_cuda.locate(spec, enc, lens, pack2=pack2, device="cpu")
    got = align_cuda.unpack_result(got.numpy())
    assert got[0].any()
    cls = query_class_info(spec)[0][raw]
    packed4 = (cls[:, 0::2] | (cls[:, 1::2] << 4)).astype(np.uint8)
    xla = make_batch_locate(JaxSpec(**spec._asdict()), packed=True)(
        packed4, lens)
    xla = tuple(np.asarray(xla[k]) for k in (
        "found", "query_start", "query_stop", "errors", "score"))
    assert fx.first_difference(got, xla) is None
    assert fx.first_difference(got, fx.scalar_locate(spec, raw, lens)) is None


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.long_specs())),
    ids=[f"{i}-{s.flags}" for i, s in enumerate(fx.long_specs())],
)
def test_long_adapter_matches_jax_and_scalar(index, pack2):
    """200 bp adapters (32 lanes of 7 rows in registers) and a 300 bp one
    (rows in shared memory) against the XLA aligner and the C++ scalar
    aligner."""
    _against_xla_and_scalar(fx.long_specs()[index], 31 + index, 24, 256,
                            pack2)


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.block_edge_specs())),
    ids=[f"{i}-{len(s.reference)}-{s.flags}"
         for i, s in enumerate(fx.block_edge_specs())],
)
def test_block_edge_adapters_match_jax_and_scalar(index, pack2):
    """Adapters whose DP rows end at the flagship layout's lane blocks
    against the XLA aligner and the C++ scalar aligner."""
    spec = fx.block_edge_specs()[index]
    _against_xla_and_scalar(spec, 60 + index, 64, 96, pack2,
                            at_start=not spec.start_in_query)


def test_kernel_layout_follows_the_adapter_length():
    """Every DP row is owned by exactly one lane; rows stay in registers,
    at most REG_ROWS_MAX per lane with the fewest lanes that allow it,
    then go to shared memory, then to device scratch; shared memory stays
    under the block limit."""
    modes = set()
    for m in list(range(1, 401)) + [3615, 3616, 4000, 20000]:
        lay = align_cuda.kernel_layout(m)
        R = m + 1
        assert lay.rows == -(-R // lay.lanes)
        owners = [[l for l in range(lay.lanes)
                   if l * lay.rows <= i < (l + 1) * lay.rows]
                  for i in range(R)]
        assert all(len(o) == 1 for o in owners)
        assert owners[0] == [0] and owners[m] == [m // lay.rows]
        lanes = next((L for L in align_cuda.LANE_WIDTHS
                      if -(-R // L) <= align_cuda.REG_ROWS_MAX), None)
        if lanes is not None:
            assert (lay.lanes, lay.mode) == (lanes, "registers")
            assert lay.smem_bytes == 4 * 3 * lay.rows * align_cuda.THREADS
            assert lay.scratch_words == 0
        else:
            assert lay.lanes == 32 and lay.mode in ("shared", "scratch")
            words = align_cuda.THREADS * (3 * lay.rows
                                          + 2 * -(-32 * lay.rows // 64))
            fits = 4 * words <= align_cuda._SMEM_LIMIT
            assert lay.mode == ("shared" if fits else "scratch")
            assert (lay.smem_bytes, lay.scratch_words) == (
                (4 * words, 0) if fits else (0, words))
        assert lay.smem_bytes <= align_cuda._SMEM_LIMIT
        modes.add(lay.mode)
    assert modes == set(align_cuda.MODES)
    assert align_cuda.kernel_layout(255).mode == "registers"
    assert align_cuda.kernel_layout(256).mode == "shared"
    assert align_cuda.kernel_layout(3615).mode == "shared"
    assert align_cuda.kernel_layout(3616).mode == "scratch"
    for spec in fx.parity_specs() + CASES + fx.block_edge_specs():
        assert align_cuda.kernel_layout(len(spec.reference)).mode \
            == "registers"
    assert [align_cuda.kernel_layout(len(s.reference)).mode
            for s in fx.long_specs()] == ["registers"] * 3 + ["shared"]
    assert align_cuda.kernel_layout(
        len(fx.very_long_spec().reference)).mode == "scratch"


def test_kernel_source_instantiates_what_the_layout_picks():
    """The library's dispatch (csrc/align_locate.cu) instantiates exactly
    the variants kernel_layout picks for some m: none is missing, and none
    is compiled that no adapter length reaches."""
    with open(align_cuda._SRC) as f:
        src = f.read()
    regs = {(int(L), int(R)) for L, R in
            re.findall(r"ALIGN_VARIANT\((\d+), (\d+)\)", src)}
    mem = {(int(L), align_cuda.MODES.index(mode.lower())) for L, mode in
           re.findall(r"launch<BITS, (\d+), 0, k(Shared|Scratch)>", src)}
    # the register variants that the byte lane (m >= 16) never reaches sit
    # in a block of their own
    packed_only = re.search(r"if constexpr \(BITS != 8\) \{([^}]*)\}", src)
    small = {(int(L), int(R)) for L, R in re.findall(
        r"ALIGN_VARIANT\((\d+), (\d+)\)", packed_only.group(1))}
    assert small == {(8, 1), (8, 2)}
    got = {(bits, L, R, 0) for L, R in regs for bits in (2, 4, 8)
           if bits != 8 or (L, R) not in small}
    got |= {(bits, L, 0, mode) for L, mode in mem for bits in (2, 4, 8)}
    assert "dispatch<8>" in src
    assert got == align_cuda.instantiations()
    assert len(got) == 52


def test_parity_fixtures_reach_every_instantiation():
    """The adapters that chip_smoke.py and the card tests run take every
    instantiation of the kernel, in both packed lanes and, byte-lane
    adapters of lanes x rows - 1 bp, in the byte lane."""
    specs = fx.variant_specs() + fx.long_specs() + [fx.very_long_spec()]
    reached = {align_cuda.template_args(
        bits, align_cuda.kernel_layout(len(s.reference)))
        for s in specs for bits in (2, 4)}
    byte_specs = fx.byte_variant_specs()
    assert all(align_cuda.make_tables(s).byte for s in byte_specs)
    reached |= {align_cuda.template_args(
        8, align_cuda.kernel_layout(len(s.reference))) for s in byte_specs}
    assert reached == align_cuda.instantiations()
    assert len(byte_specs) == 16
    for s in byte_specs[:-2]:
        lay = align_cuda.kernel_layout(len(s.reference))
        assert lay.lanes * lay.rows == len(s.reference) + 1
    for s in fx.variant_specs():
        lay = align_cuda.kernel_layout(len(s.reference))
        assert lay.lanes * lay.rows == len(s.reference) + 1
        assert fx.variant_read_length(s) >= 2 * len(s.reference)


@pytest.mark.parametrize("pack2", [False, True, None],
                         ids=["4bit", "2bit", "byte"])
@pytest.mark.parametrize("index", [0, 1, 2],
                         ids=["back", "front", "prefix"])
def test_bound_counts_the_cells_the_kernel_runs(index, pack2):
    """align_cuda.dp_work counts the active columns, cells and matching
    cells that the kernel's loops run, read by read; the byte lane's match
    is one compare of the query code with the reference code."""
    if pack2 is None:
        spec = fx.byte_lane_specs()[index]
    else:
        spec = fx.parity_specs()[(0, 3, 9)[index]]
    tables = align_cuda.make_tables(spec)
    m, k = tables.m, tables.k
    raw, enc, lens = fx.random_batch(spec, np.random.RandomState(5), 40,
                                     48, pack2)
    if pack2 is None:
        ref = encode_reference(spec)
        lut = query_lut(spec)

        def matches(byte):
            return int((ref == lut[byte]).sum())
    else:
        cls_lut, row_masks = query_class_info(spec)

        def matches(byte):
            return sum(int(rm >> int(cls_lut[byte])) & 1 for rm in row_masks)
    per_byte = {True: 4, False: 2, None: 1}[pack2]
    cols = eq = 0
    for r in range(len(lens)):
        n = int(lens[r])
        max_n = n if spec.start_in_query else min(n, m + k)
        min_n = 0 if spec.stop_in_query else max(0, n - m - k)
        for j in range(min_n + 1, min(max_n, enc.shape[1] * per_byte) + 1):
            cols += 1
            eq += matches(raw[r, j - 1])
    got = align_cuda.dp_work(enc, lens, tables, pack2)
    assert got[:3] == (cols, cols * m, eq)
    assert 0 < eq < cols * m
    per_cell = (align_cuda.OPS_PER_CELL_BYTE if pack2 is None
                else align_cuda.OPS_PER_CELL)
    assert got[3] == (cols * align_cuda.OPS_PER_COLUMN + cols * m * per_cell
                      + (cols * m - eq) * align_cuda.OPS_PER_MISMATCH)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_a_card_raises(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = CASES[0]
    _, enc, _, lens = _batch(spec, 1, 8, 16, True)
    with pytest.raises(RuntimeError, match="is_available"):
        align_cuda.locate(spec, enc, lens, device=device)
    with pytest.raises(RuntimeError, match="is_available"):
        align_cuda.resolve_device(device)


def test_wrapper_checks_its_inputs():
    tables = align_cuda.make_tables(CASES[0])
    enc = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        align_cuda.locate_packed(enc.to(torch.int32),
                                 torch.zeros(4, dtype=torch.int32), tables,
                                 True)
    with pytest.raises(ValueError, match="int32"):
        align_cuda.locate_packed(enc, torch.zeros(4, dtype=torch.int16),
                                 tables, True)
    with pytest.raises(ValueError, match="shape"):
        align_cuda.locate_packed(enc, torch.zeros(3, dtype=torch.int32),
                                 tables, True)
    with pytest.raises(ValueError, match="unsupported device"):
        align_cuda.resolve_device("meta")


def _jax_byte_lane(spec, enc, lens, wide):
    """The JAX package's XLA aligner in its byte use (packed=False) on the
    same query codes: (found, qstart, qstop, errors, score[, ref_start,
    ref_stop])."""
    xla = make_batch_locate(JaxSpec(**spec._asdict()), packed=False)(
        enc, lens)
    keys = ("found", "query_start", "query_stop", "errors", "score")
    if wide:
        keys += ("ref_start", "ref_stop")
    return tuple(np.asarray(xla[k]) for k in keys)


@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
@pytest.mark.parametrize(
    "index", range(len(fx.byte_lane_specs())),
    ids=[f"{i}-{len(s.reference)}-{s.flags}-{s.indel_cost}"
         for i, s in enumerate(fx.byte_lane_specs())],
)
def test_byte_lane_matches_jax(index, wide):
    """Specs of more than 16 query classes take the byte lane: one
    query_lut code per byte, held to the XLA aligner's byte use
    (make_batch_locate(packed=False)) on the same codes, in the packed
    (2, B) and the wide (7, B) store, and to the C++ scalar aligner.
    Tolerance: found equal everywhere, the other fields where found."""
    spec = fx.byte_lane_specs()[index]
    assert query_class_info(spec) is None
    tables = align_cuda.make_tables(spec)
    assert tables.byte
    rng = np.random.RandomState(700 + index)
    raw, enc, lens = fx.random_batch(spec, rng, 96, 64, None,
                                     **fx.placement(spec))
    assert enc.shape == (96, 64)
    got = align_cuda.locate(spec, enc, lens, pack2=None, device="cpu",
                            wide=wide)
    assert got.shape == (7 if wide else 2, 96)
    unpack = align_cuda.unpack_wide if wide else align_cuda.unpack_result
    got = unpack(got.numpy())
    assert got[0].any()
    assert fx.first_difference(got, _jax_byte_lane(spec, enc, lens,
                                                   wide)) is None
    assert fx.first_difference(got[:5], fx.scalar_locate(spec, raw,
                                                         lens)) is None


def test_byte_lane_long_window_matches_jax():
    """A byte-lane window past 2**14 bp in the wide store, against the
    XLA aligner's byte use on all 7 fields."""
    spec = fx.byte_lane_specs()[0]
    rng = np.random.RandomState(16400)
    raw, enc, lens = fx.long_batch(spec, rng, 3, (16400, 16500), None)
    got = align_cuda.locate(spec, enc, lens, pack2=None, device="cpu",
                            wide=True)
    got = align_cuda.unpack_wide(got.numpy())
    assert (lens >= 1 << 14).all() and got[0].any()
    assert fx.first_difference(got, _jax_byte_lane(spec, enc, lens,
                                                   True)) is None


def test_lane_follows_the_spec():
    """A spec of more than 16 query classes takes the byte lane and only
    it; a spec of at most 16 takes only the packed lanes."""
    byte = align_cuda.make_tables(fx.byte_lane_specs()[0])
    packed = align_cuda.make_tables(CASES[0])
    enc = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    for tables, lanes in ((byte, (True, False)), (packed, (None,))):
        for pack2 in lanes:
            with pytest.raises(ValueError, match="16 query classes"):
                align_cuda.locate_packed(enc, lens, tables, pack2)
    assert align_cuda.locate_packed(enc, lens, byte, None).shape == (2, 4)


def test_kernel_ab_loads_another_trees_own_wrapper(monkeypatch):
    """kernel_ab.py imports another checkout's wrapper under its own
    package name, beside this one's, and needs a card to run."""
    import sys

    import kernel_ab

    root = os.path.dirname(os.path.dirname(align_cuda._CSRC))
    other = kernel_ab.load_wrapper(root, "ab_test_tree")
    assert other.__name__ == "ab_test_tree.ops.align_cuda"
    assert other is not align_cuda
    assert other.LAUNCHES is not align_cuda.LAUNCHES
    assert other.kernel_layout(33) == align_cuda.kernel_layout(33)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["kernel_ab.py", root])
    assert kernel_ab.main() == 2


def test_kernel_build_flags():
    """The kernel library is built for Hopper (sm_90a) with a plain C
    interface; the build itself runs only where nvcc is."""
    flags = " ".join(align_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-std=c++17" in flags
    assert os.path.exists(align_cuda._SRC)
