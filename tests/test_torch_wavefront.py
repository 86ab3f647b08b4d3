"""
A step-by-step model of the CUDA aligner's wavefront schedule
(``cutadapt_tpu_torch/csrc/align_locate.cu``), held to the plain PyTorch
version on the CPU, where the kernel itself cannot run.

The model follows the kernel's data flow, not only its arithmetic: a
group of ``lanes`` lanes per read, lane l owning DP rows
[l * rows, (l + 1) * rows), running column j at step j + l with what lane
l - 1 handed down at step j + l - 1 (the cascade value of the row above,
the query class, the row mask of cells within the error budget); the band
and the last-row candidate resolved late in the lane that holds row m; the
stale origin read from the final column. It runs at the layouts
``kernel_layout`` picks and at other lane counts, so that block edges fall
on every row. Results compare on every field of every read.
"""

import numpy as np
import pytest

from cutadapt_tpu_torch.ops import align_cuda
from cutadapt_tpu_torch.ops.align_batch import BIG_NEG, INF_COST

import torch_fixtures as fx

MATCH, MISMATCH, INS, DEL = 1, -1, -2, -2


def _key_min(a, b):
    a_wins = a[0] < b[0] or (a[0] == b[0] and (
        a[1] < b[1] or (a[1] == b[1] and a[2] <= b[2])))
    return a if a_wins else b


def _init_row(i, min_n, sr, sq, dc):
    if not sr and not sq:
        return max(i, min_n) * dc, i * DEL, 0
    if sr and not sq:
        return min_n * dc, 0, min(0, min_n - i)
    if not sr and sq:
        return i * dc, i * DEL, max(0, min_n - i)
    return min(i, min_n) * dc, 0, min_n - i


def wavefront_read(tables, cls, n, lanes, rows):
    """One read through the kernel's schedule: (found, qstart, qstop,
    errors, score)."""
    spec = tables.spec
    m, k = tables.m, tables.k
    tab = tables.table
    ncnt, minlen = tab[m:2 * m + 1], tab[2 * m + 1:]
    sr, sq = spec.start_in_reference, spec.start_in_query
    stop_r, stop_q = spec.stop_in_reference, spec.stop_in_query
    ic = dc = int(spec.indel_cost)
    o_inc = 1 if sq else 0
    c_inc = 0 if sq else ic
    s_inc = 0 if sq else INS
    cap = tables.n_minlen - 1
    max_n = n if sq else min(n, m + k)
    min_n = 0 if stop_q else max(0, n - m - k)
    n_cols = max(0, min(max_n, len(cls)) - min_n)
    lm = m // rows

    dp = {i: list(_init_row(i, min_n, sr, sq, dc)) for i in range(m + 1)}
    up = [tuple(dp[l * rows - 1]) if 0 < l <= lm else None
          for l in range(lanes)]
    handed = [None] * lanes  # (run, qc, mask) each lane produced last step
    last = m if sr else min(m, k + 1)
    last_filled = 0
    best = dict(found=False, c=INF_COST, s=0, o=0, ref_stop=m, q_stop=0)
    done = False
    for t in range(n_cols + lm if n_cols else 0):
        received = [None] + handed[:-1]
        for lane in range(min(lm, lanes - 1) + 1):
            col = t - lane
            if not 0 <= col < n_cols:
                continue
            j = min_n + 1 + col
            if lane == 0:
                qc = int(cls[j - 1])
                d = tuple(dp[0])
                run = (d[0] + c_inc, 1, BIG_NEG, d[1] + s_inc, d[2] + o_inc)
                dp[0] = [run[0], run[3], run[4]]
                mask = 1 if run[0] <= k else 0
                first = 1
            else:
                run, qc, mask = received[lane]
                d, up[lane] = up[lane], (run[0], run[3], run[4])
                first = lane * rows
            for i in range(first, min(lane * rows + rows, m + 1)):
                p = tuple(dp[i])
                eq = (int(tab[i - 1]) >> qc) & 1
                diag = (d[0] if eq else d[0] + 1, 0, -i,
                        d[1] + (MATCH if eq else MISMATCH), d[2])
                leaf = diag if eq else _key_min(
                    diag, (p[0] + ic, 1, i, p[1] + INS, p[2]))
                dele = (min(run[0] + (INF_COST if eq else dc), INF_COST),
                        run[1], run[2], run[3] + DEL, run[4])
                run = _key_min(leaf, dele)
                dp[i] = [run[0], run[3], run[4]]
                if run[0] <= k:
                    mask |= 1 << i
                d = p
            handed[lane] = (run, qc, mask)
            if lane != lm:
                continue
            fill_end = last
            low = mask & ((2 << fill_end) - 1)
            shrunk = low.bit_length() - 1
            last = shrunk + 1 if shrunk < m else m
            last_filled = fill_end
            if stop_q and shrunk == m and not done:
                length = m + min(run[4], 0)
                eff = length
                if spec.wildcard_ref:
                    tail = ncnt[m] - ncnt[min(max(m - length, 0), m)]
                    eff = length - tail if length < m else tables.eff_len
                ok = (length >= spec.min_overlap
                      and eff >= minlen[min(run[0], cap)])
                if ok and (not best["found"]
                           or (run[4] <= best["o"] + m // 2
                               and run[3] > best["s"])
                           or (length > m + min(best["o"], 0)
                               and run[3] > best["s"])):
                    best.update(found=True, c=run[0], s=run[3], o=run[4],
                                ref_stop=m, q_stop=j)
                    done = run[0] == 0 and run[4] >= 0

    stale = dp[last_filled][2] if last_filled >= 1 else 0
    if max_n == n:
        for i in range(m, (0 if stop_r else m) - 1, -1):
            c, s, o = dp[i]
            length = i + min(o, 0)
            eff = length
            if spec.wildcard_ref:
                span = ncnt[i] - ncnt[min(max(-min(o, 0), 0), m)]
                eff = length - span if length < m else tables.eff_len
            ok = (i <= last_filled and length >= spec.min_overlap
                  and eff >= minlen[min(c, cap)])
            if ok and (not best["found"]
                       or (stale <= best["o"] + m // 2 and s > best["s"])
                       or (length > best["ref_stop"] + min(best["o"], 0)
                           and s > best["s"])):
                best.update(found=True, c=c, s=s, o=o, ref_stop=i, q_stop=n)
    return (best["found"], max(best["o"], 0), best["q_stop"], best["c"],
            best["s"])


def wavefront(tables, enc, lens, pack2, lanes, rows):
    per_byte = 4 if pack2 else 2
    bits = 8 // per_byte
    cls = np.stack([(enc >> (t * bits)) & ((1 << bits) - 1)
                    for t in range(per_byte)], axis=2).reshape(len(enc), -1)
    res = [wavefront_read(tables, cls[b], int(lens[b]), lanes, rows)
           for b in range(len(lens))]
    found, qstart, qstop, cost, score = (np.array(x, np.int64)
                                         for x in zip(*res))
    # packed as the kernel writes its result
    packed = np.stack([qstart | (qstop << 14) | (found << 28),
                       cost | ((score + 32768) << 16)]) & 0xFFFFFFFF
    return align_cuda.unpack_result(packed.astype(np.uint32).view(np.int32))


def _check(spec, lanes, rows, pack2, seed, B=64, L=48, place=None):
    tables = align_cuda.make_tables(spec)
    assert lanes * rows >= tables.m + 1
    _, enc, lens = fx.random_batch(spec, np.random.RandomState(seed), B, L,
                                   pack2, **(place or {}))
    want = align_cuda.unpack_result(align_cuda.locate(
        spec, enc, lens, pack2=pack2, device="cpu").numpy())
    got = wavefront(tables, enc, lens, pack2, lanes, rows)
    assert got[0].any()
    assert fx.first_difference(got, want) is None
    # not found: the kernel's initial best state, as the plain version's
    nf = ~want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[nf], w[nf])


@pytest.mark.parametrize("pack2", [False, True], ids=["4bit", "2bit"])
@pytest.mark.parametrize(
    "index", range(len(fx.parity_specs())),
    ids=[f"{i}-{s.reference[:8]}-{s.flags}"
         for i, s in enumerate(fx.parity_specs())],
)
def test_wavefront_model_at_the_kernel_layout(index, pack2):
    spec = fx.parity_specs()[index]
    lay = align_cuda.kernel_layout(len(spec.reference))
    _check(spec, lay.lanes, lay.rows, pack2, 300 + index)


@pytest.mark.parametrize(
    "index", range(len(fx.variant_specs())),
    ids=[f"{len(s.reference)}-{s.flags}" for s in fx.variant_specs()],
)
def test_wavefront_model_at_every_register_variant(index):
    """The schedule at each register variant the kernel instantiates,
    every lane's block full (8 x 1: lane 0 holds row 0 alone)."""
    spec = fx.variant_specs()[index]
    lay = align_cuda.kernel_layout(len(spec.reference))
    _check(spec, lay.lanes, lay.rows, index % 2 == 0, 400 + index, B=24,
           L=fx.variant_read_length(spec), place=fx.placement(spec))


@pytest.mark.parametrize("lanes,rows", [(32, 1), (16, 3), (8, 7), (3, 12)])
@pytest.mark.parametrize("index", [0, 3, 9, 10],
                         ids=["back", "front", "prefix", "suffix"])
def test_wavefront_model_at_other_block_edges(index, lanes, rows):
    """Block edges on other rows than the chosen layout's: a lane count
    whose last lanes own no row (32 x 1 for m = 10..33), and blocks
    that split the adapter unevenly."""
    spec = fx.parity_specs()[index]
    if lanes * rows < len(spec.reference) + 1:
        lanes = -(-(len(spec.reference) + 1) // rows)
    _check(spec, lanes, rows, True, 300 + index)
