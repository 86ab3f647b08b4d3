"""
The batched semi-global aligner on the GPU: wrapper of the CUDA kernel
``csrc/align_locate.cu`` and its plain PyTorch version.

Both compute, per read, what the TPU kernel
``cutadapt_tpu/ops/align_pallas.py:make_pallas_locate`` computes: the
banded semi-global DP of the query against the adapter with hybrid
cost/score/origin, Ukkonen band tracking, last-row candidate folding and
the bottom-up final-column scan, returning one packed (2, B) int32:

    row 0 = query_start | query_stop << 14 | found << 28
    row 1 = errors | (score + 32768) << 16

or, with ``wide=True``, the unpacked (7, B) int32 rows of the JAX
engine's wide format (``cutadapt_tpu/batch_pipeline.py:
_make_locate_step(wide=True)``):

    found, query_start, query_stop, errors, score, ref_start, ref_stop

for windows of 2**14 bp or more, whose coordinates overflow the 14-bit
fields, and for adapter-side coordinates (--wildcard-file). The kernel
chooses the store at run time: every variant serves both modes.

Queries arrive as (B, Wp) uint8 rows of query class ids
(:func:`query_class_info`): four 2-bit ids per byte, lowest pair first
(``pack2=True``), or two 4-bit ids per byte, low nibble first. Bytes past
a read's length are zero and masked by the length.

The kernel is a wavefront: a group of L lanes holds one read, lane l owns
a block of r DP rows and runs column j at step j + l, handing the
in-column deletion cascade, the query class and a row mask of the cells
within the error budget down to the next lane. What bounds it is integer
ALU work per DP cell; for small launches, the length of one group's chain
of dependent cells (columns + lanes - 1 steps of r cells). Ukkonen's band
update needs the whole column, so the lane that holds row m resolves it
late, from the row mask. :func:`kernel_layout` picks the variant from the
adapter length alone: rows in registers for up to 256 DP rows, in shared
memory beyond, in a device scratch buffer past what a block's shared
memory holds.

:func:`locate_packed` dispatches on the tensors' device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs
:func:`locate_reference`. There is no fallback from one to the other.

The kernel library is compiled with nvcc on first use into
``csrc/build/`` beside the source, keyed by the hash of the source and
flags, and loaded with ctypes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .align_batch import (
    AlignerSpec,
    BIG_NEG,
    DELETION_SCORE,
    INF_COST,
    INSERTION_SCORE,
    MATCH_SCORE,
    MISMATCH_SCORE,
    effective_length,
    min_length_table,
    n_counts,
    query_class_info,
)

_QS_MASK = (1 << 14) - 1
_QSTOP_SHIFT = 14
_FOUND_SHIFT = 28
_SCORE_BIAS = 32768

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
_SRC = os.path.join(_CSRC, "align_locate.cu")
_BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory one block may use on Hopper
_SMEM_LIMIT = 232448
# threads per block (csrc/align_locate.cu:kThreads)
THREADS = 128
# lanes per read of the register variants, and their most rows per lane
LANE_WIDTHS = (8, 16, 32)
REG_ROWS_MAX = 8
# where a lane keeps its rows (csrc/align_locate.cu:Mode)
MODES = ("registers", "shared", "scratch")

# kernel launches per lane; only the wrapper's launch path adds to them
LAUNCHES = {"pack2": 0, "pack4": 0}
# the same launches by instantiation (template_args), beside LAUNCHES
VARIANT_LAUNCHES = {}
# the launches of LAUNCHES that stored the wide (7, B) result, per lane
WIDE_LAUNCHES = {"pack2": 0, "pack4": 0}
# rows of the wide result
WIDE_ROWS = 7
# calls of the wrapper that ran the plain version (CPU tensors), per lane
PLAIN_RUNS = {"pack2": 0, "pack4": 0}
# the counters are bumped from whichever thread launches
_COUNT_LOCK = threading.Lock()
# how the kernel library was obtained: path, build seconds, nvcc log
BUILD_INFO = {}

_LIB = None
_LIB_LOCK = threading.Lock()


def unpack_result(arr: np.ndarray):
    """Packed (2, B) int32 result -> (found, qstart, qstop, errors,
    score)."""
    r0 = arr[0].view(np.uint32)
    r1 = arr[1].view(np.uint32)
    return (
        ((r0 >> _FOUND_SHIFT) & 1).astype(bool),
        (r0 & _QS_MASK).astype(np.int32),
        ((r0 >> _QSTOP_SHIFT) & _QS_MASK).astype(np.int32),
        (r1 & 0xFFFF).astype(np.int32),
        (r1 >> 16).astype(np.int32) - _SCORE_BIAS,
    )


def unpack_wide(arr: np.ndarray):
    """Wide (7, B) int32 result -> (found, qstart, qstop, errors, score,
    ref_start, ref_stop)."""
    return (arr[0].astype(bool),) + tuple(
        arr[i].astype(np.int32) for i in range(1, WIDE_ROWS)
    )


def reset_launch_counters() -> None:
    with _COUNT_LOCK:
        for lane in LAUNCHES:
            LAUNCHES[lane] = 0
            PLAIN_RUNS[lane] = 0
            WIDE_LAUNCHES[lane] = 0
        VARIANT_LAUNCHES.clear()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means CUDA. Asking for
    CUDA where there is none raises; only an explicit ``"cpu"`` runs the
    plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but there is no CUDA "
                "device (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch versions"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")


class LocateTables:
    """One aligner's constants: the spec's scalars and one int32 table
    [row masks (m) | n-counts (m+1) | minimum lengths (k+2)], with its
    copies on each device it was used on."""

    __slots__ = ("spec", "m", "k", "n_minlen", "eff_len", "table", "_dev")

    def __init__(self, spec: AlignerSpec):
        m = len(spec.reference)
        if m == 0:
            raise ValueError("the aligner requires a non-empty reference")
        info = query_class_info(spec)
        if info is None:
            raise NotImplementedError(
                "specs needing more than 16 query classes (the byte lane) "
                "are not ported yet"
            )
        minlen = min_length_table(spec)
        self.spec = spec
        self.m = m
        self.k = int(spec.max_error_rate * m)
        self.n_minlen = len(minlen)
        self.eff_len = effective_length(spec)
        self.table = np.concatenate(
            [info[1].astype(np.int32), n_counts(spec).astype(np.int32),
             minlen.astype(np.int32)]
        )
        self._dev = {}

    def on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self.table).to(device)
            self._dev[key] = t
        return t


@lru_cache(maxsize=64)
def make_tables(spec: AlignerSpec) -> LocateTables:
    return LocateTables(spec)


def locate(spec: AlignerSpec, enc, lengths, pack2: bool = True,
           device=None, wide: bool = False) -> torch.Tensor:
    """Align a batch of packed queries against ``spec``'s reference on
    ``device`` (None: CUDA). ``enc`` is (B, Wp) uint8 packed class ids,
    ``lengths`` (B,) integers; numpy arrays or tensors. Returns the
    packed (2, B) int32 result on ``device``, or the wide (7, B) one."""
    dev = resolve_device(device)
    enc_t = torch.as_tensor(np.ascontiguousarray(enc), dtype=torch.uint8)
    len_t = torch.as_tensor(np.asarray(lengths)).to(torch.int32)
    return locate_packed(
        enc_t.to(dev), len_t.to(dev), make_tables(spec), pack2, wide=wide
    )


def locate_packed(enc: torch.Tensor, lengths: torch.Tensor,
                  tables: LocateTables, pack2: bool,
                  wide: bool = False) -> torch.Tensor:
    """The kernel's wrapper: launches the CUDA kernel for CUDA tensors,
    runs :func:`locate_reference` for CPU tensors. ``wide`` selects the
    (7, B) result."""
    if enc.dtype != torch.uint8 or enc.dim() != 2:
        raise ValueError(f"enc must be a 2-D uint8 tensor, got {enc.dtype} "
                         f"{tuple(enc.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (enc.shape[0],):
        raise ValueError(
            f"lengths must be int32 of shape ({enc.shape[0]},), got "
            f"{lengths.dtype} {tuple(lengths.shape)}"
        )
    if lengths.device != enc.device:
        raise ValueError(
            f"enc on {enc.device} but lengths on {lengths.device}"
        )
    if enc.device.type == "cpu":
        with _COUNT_LOCK:
            PLAIN_RUNS["pack2" if pack2 else "pack4"] += 1
        return locate_reference(enc, lengths, tables, pack2, wide=wide)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    return _launch(enc.contiguous(), lengths.contiguous(), tables, pack2,
                   wide)


# --- the CUDA kernel ---------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the aligner kernel"
        )
    return path


def build_library() -> str:
    """Compile the kernel library (once per source and flag hash) and
    return its path. Records the build time and the compiler's log
    (register and shared-memory use per kernel) in BUILD_INFO."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(_BUILD_DIR, f"align_locate-{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        BUILD_INFO.update(path=so, seconds=0.0, cached=True, log="")
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=900,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {r.returncode}:\n{r.stderr}"
            )
        os.replace(tmp, so)  # atomic under concurrent builders
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, log=r.stderr)
    return so


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.align_locate_threads.restype = ci
            lib.align_locate_threads.argtypes = []
            lib.align_locate_launch.restype = ci
            lib.align_locate_launch.argtypes = (
                [ci] * 4 + [vp] * 5 + [ci] * 11 + [ctypes.c_longlong, vp]
            )
            if lib.align_locate_threads() != THREADS:
                raise RuntimeError(
                    f"kernel library has {lib.align_locate_threads()} "
                    f"threads per block, the wrapper expects {THREADS}"
                )
            _LIB = lib
    return _LIB


class KernelLayout(NamedTuple):
    """One kernel variant: lanes per read, DP rows per lane, where a lane
    keeps its rows, dynamic shared-memory bytes per block and device
    scratch words per block."""

    lanes: int
    rows: int
    mode: str
    smem_bytes: int
    scratch_words: int


def kernel_layout(m: int) -> KernelLayout:
    """The kernel variant for an adapter of length m, from m alone.

    Lane l owns rows [l * rows, (l + 1) * rows) of the m + 1 DP rows. The
    fewest lanes whose rows fit in REG_ROWS_MAX registers each: shared
    memory then holds only the final column for the last lane's scan.
    Past 256 rows, 32 lanes keep their rows and row masks in shared memory
    ([q][c,s,o][thread], then [word][thread] 64-bit mask words), or in a
    device scratch buffer of that layout when a block's share does not
    fit."""
    R = m + 1
    for lanes in LANE_WIDTHS:
        rows = -(-R // lanes)
        if rows <= REG_ROWS_MAX:
            return KernelLayout(lanes, rows, "registers",
                                4 * 3 * rows * THREADS, 0)
    lanes = LANE_WIDTHS[-1]
    rows = -(-R // lanes)
    mask_words = -(-(lanes * rows) // 64)
    words = THREADS * (3 * rows + 2 * mask_words)
    if 4 * words <= _SMEM_LIMIT:
        return KernelLayout(lanes, rows, "shared", 4 * words, 0)
    return KernelLayout(lanes, rows, "scratch", 0, words)


def template_args(bits: int, lay: KernelLayout) -> tuple:
    """The instantiation locate_kernel<BITS, L, RR, MODE> that runs
    ``lay`` in the ``bits`` lane (RR is 0 where the rows per lane are a
    runtime argument)."""
    registers = lay.mode == "registers"
    return (bits, lay.lanes, lay.rows if registers else 0,
            MODES.index(lay.mode))


def instantiations() -> frozenset:
    """Every instantiation the kernel library holds: the variants that
    kernel_layout picks for some m, in both lanes. Register variants end
    at LANE_WIDTHS[-1] * REG_ROWS_MAX DP rows; the memory modes take
    every m beyond."""
    top = LANE_WIDTHS[-1] * REG_ROWS_MAX
    lays = {kernel_layout(m) for m in range(1, top)}
    lays.add(kernel_layout(top))
    lays.add(kernel_layout(_SMEM_LIMIT))
    return frozenset(template_args(bits, lay) for bits in (2, 4)
                     for lay in lays)


def _launch(enc, lengths, tables: LocateTables, pack2: bool, wide: bool):
    lib = _library()
    B, Wp = enc.shape
    out = torch.empty((WIDE_ROWS if wide else 2, B), dtype=torch.int32,
                      device=enc.device)
    if B == 0:
        return out
    tab = tables.on(enc.device)
    lay = kernel_layout(tables.m)
    scratch = None
    if lay.scratch_words:  # very long adapters: rows in device memory
        blocks = -(-B // (THREADS // lay.lanes))
        scratch = torch.empty(
            blocks * lay.scratch_words, dtype=torch.int32, device=enc.device
        )
    spec = tables.spec
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream(enc.device).cuda_stream
        err = lib.align_locate_launch(
            2 if pack2 else 4, lay.lanes, lay.rows, MODES.index(lay.mode),
            enc.data_ptr(), lengths.data_ptr(), tab.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, Wp, tables.m, tables.k, int(spec.flags),
            int(spec.indel_cost), int(spec.min_overlap), tables.eff_len,
            int(spec.wildcard_ref), tables.n_minlen, int(wide),
            lay.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"align_locate kernel launch failed: CUDA error {err}")
    key = template_args(2 if pack2 else 4, lay)
    lane = "pack2" if pack2 else "pack4"
    with _COUNT_LOCK:
        LAUNCHES[lane] += 1
        VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1
        if wide:
            WIDE_LAUNCHES[lane] += 1
    return out


# --- the plain PyTorch version -----------------------------------------------


# The tie-break (cls, pos) of a DP cell as one int32 word: class 0 is
# pos (in [-m, 0]), class 1 is _TIE_CLASS1 + pos (pos in [1, m] or
# BIG_NEG = -2**28), and the class-3 filler of the ladder's shifted-in
# rows is _TIE_FILL. The lexicographic order of (cls, pos) and the order
# of the word are the same.
_TIE_CLASS1 = 1 << 29
_TIE_FILL = 1 << 30


def _key_min(a, b):
    """Lexicographic min over (cost, tie) of stacked (4, rows, B) cells
    [cost, tie, score, origin]: a wins on a smaller-or-equal key."""
    a_wins = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))
    return torch.where(a_wins, a, b)


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the int32 with those bits."""
    v = v & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


def locate_reference(enc: torch.Tensor, lengths: torch.Tensor,
                     tables: LocateTables, pack2: bool,
                     wide: bool = False) -> torch.Tensor:
    """The aligner in plain PyTorch: vectorised over the batch, a loop
    over columns, and the in-column deletion cascade as the TPU kernel's
    (min,+) Hillis-Steele ladder cut at ceil(log2(k+2)) passes. Returns
    the packed (2, B) result, or with ``wide`` the (7, B) rows."""
    B = enc.shape[0]
    empty = torch.nonzero(lengths == 0).flatten()
    if len(empty) > 1:
        # rows of length 0 (a batch's padding) share one result, whatever
        # their bytes: compute it once, beside the other rows
        rows = torch.cat([torch.nonzero(lengths != 0).flatten(), empty[:1]])
        sub = locate_reference(enc[rows], lengths[rows], tables, pack2,
                               wide=wide)
        out = sub[:, -1:].expand(-1, B).clone()
        out[:, rows[:-1]] = sub[:, :-1]
        return out
    dev = enc.device
    i32 = torch.int32
    B, Wp = enc.shape
    spec = tables.spec
    m, k = tables.m, tables.k
    R = m + 1
    start_in_reference = spec.start_in_reference
    start_in_query = spec.start_in_query
    ins_cost = del_cost = int(spec.indel_cost)
    min_overlap = int(spec.min_overlap)
    origin_increment = 1 if start_in_query else 0
    ins_cost_inc = 0 if start_in_query else ins_cost
    ins_score_inc = 0 if start_in_query else INSERTION_SCORE
    init_last = m if start_in_reference else min(m, k + 1)
    first_i = 0 if spec.stop_in_reference else m
    cost_cap = tables.n_minlen - 1
    eff_len = tables.eff_len

    tab = tables.on(dev)
    rm = tab[:m, None]  # (m, 1)
    ncnt = tab[m : m + R]
    minlen = tab[m + R :]
    n = lengths.to(i32)[None, :]  # (1, B)
    i_col = torch.arange(R, dtype=i32, device=dev)[:, None]
    posb = torch.arange(1, m + 1, dtype=i32, device=dev)[:, None].expand(m, B)
    lane0 = torch.zeros((1, B), dtype=i32, device=dev)

    max_n = n if start_in_query else torch.clamp(n, max=m + k)
    min_n = lane0 if spec.stop_in_query else torch.clamp(n - m - k, min=0)

    mn = min_n
    if not start_in_reference and not start_in_query:
        score = i_col * DELETION_SCORE + 0 * mn
        cost = torch.maximum(i_col, mn) * del_cost
        origin = 0 * (i_col + mn)
    elif start_in_reference and not start_in_query:
        score = 0 * (i_col + mn)
        cost = mn * del_cost + 0 * i_col
        origin = torch.clamp(mn - i_col, max=0)
    elif not start_in_reference and start_in_query:
        score = i_col * DELETION_SCORE + 0 * mn
        cost = i_col * del_cost + 0 * mn
        origin = torch.clamp(mn - i_col, min=0)
    else:
        score = 0 * (i_col + mn)
        cost = torch.minimum(i_col, mn) * del_cost
        origin = mn - i_col
    # the DP column, stacked: [cost, score, origin]
    state = torch.stack([
        x.expand(R, B).to(i32) for x in (cost, score, origin)
    ]).contiguous()
    cost, score, origin = state[0], state[1], state[2]

    last = lane0 + init_last
    last_filled = lane0
    stale = lane0
    best_found = lane0.bool()
    best_cost = lane0 + INF_COST
    best_score = lane0
    best_origin = lane0
    best_ref_stop = lane0 + m
    best_query_stop = lane0
    done = lane0.bool()

    def minlen_lookup(c):
        return minlen[torch.clamp(c, max=cost_cap).long()]

    def ncnt_lookup(idx):
        return ncnt[torch.clamp(idx, 0, m).long()]

    limit = min(m, k + 2) if del_cost >= 1 else m
    per_byte = 4 if pack2 else 2
    bits = 8 // per_byte
    enc_i = enc.to(i32)
    n_cols = Wp * per_byte
    if B:  # columns outside every read's (min_n, max_n] are no-ops
        n_cols = min(n_cols, int(max_n.max()))
        j0 = int(min_n.min()) + 1
    else:
        j0 = 1
    # per-call constants of the column step
    v0_inc = torch.tensor([ins_cost_inc, ins_score_inc, origin_increment],
                          dtype=i32, device=dev)[:, None, None]
    diag_tie = -posb
    ins_tie = posb + _TIE_CLASS1
    zero_mb = torch.zeros((m, B), dtype=i32, device=dev)
    del_score = zero_mb + DELETION_SCORE
    seed_tie = torch.full((1, m, B), _TIE_CLASS1 + BIG_NEG, dtype=i32,
                          device=dev)
    ladder = []  # (d, filler of the shifted cells, zero cascade rows)
    d = 1
    while d < limit:
        fill = torch.zeros((4, d, B), dtype=i32, device=dev)
        fill[0] = INF_COST
        fill[1] = _TIE_FILL
        ladder.append((d, fill, torch.zeros((2, d, B), dtype=i32,
                                            device=dev)))
        d *= 2
    for j in range(j0, n_cols + 1):
        q = j - 1
        qc = (enc_i[:, q // per_byte] >> ((q % per_byte) * bits)) & (
            (1 << bits) - 1
        )
        active = (j > min_n) & (j <= max_n)  # (1, B)
        eq = ((rm >> qc[None, :]) & 1) != 0  # (m, B)
        mismatch = (~eq).to(i32)

        v0 = state[:, 0:1] + v0_inc  # row 0: (3, 1, B)
        diag, prev = state[:, :-1], state[:, 1:]
        diag_score = MATCH_SCORE - (MATCH_SCORE - MISMATCH_SCORE) * mismatch
        diag_leaf = torch.stack([diag[0] + mismatch, diag_tie,
                                 diag[1] + diag_score, diag[2]])
        ins_leaf = torch.stack([prev[0] + ins_cost, ins_tie,
                                prev[1] + INSERTION_SCORE, prev[2]])
        kk = torch.where(eq, diag_leaf, _key_min(diag_leaf, ins_leaf))
        # the deletion cascade's (cost, score) steps
        cc = torch.stack([torch.where(eq, INF_COST, del_cost).to(i32),
                          del_score])
        for d, fill, zero_cc in ladder:
            shifted = torch.cat([fill, kk[:, :-d]], dim=1)
            prop = shifted + torch.stack([cc[0], zero_mb, cc[1], zero_mb])
            prop[0].clamp_(max=INF_COST)
            kk = _key_min(kk, prop)
            cc = torch.cat([zero_cc, cc[:, :-d]], dim=1) + cc
            cc[0].clamp_(max=INF_COST)
        seed = torch.cat([
            torch.stack([torch.clamp(v0[0] + cc[0], max=INF_COST)]),
            seed_tie,
            torch.stack([v0[1] + cc[1], v0[2].expand(m, B)]),
        ])
        final = _key_min(kk, seed)
        state = torch.where(
            active, torch.cat([v0, final[[0, 2, 3]]], dim=1), state
        )
        new_cost, new_score, new_origin = state[0], state[1], state[2]

        # band update (Ukkonen)
        fill_end = last
        within = (i_col <= fill_end) & (new_cost <= k)
        shrunk = torch.where(within, i_col, -1).amax(dim=0, keepdim=True)
        new_last = torch.where(shrunk < m, shrunk + 1, m)
        last = torch.where(active, new_last, last)
        last_filled = torch.where(active, fill_end, last_filled)
        edge_origin = torch.gather(new_origin, 0, fill_end.long())
        stale = torch.where(active & (fill_end >= 1), edge_origin, stale)

        if spec.stop_in_query:
            cand_mask = active & (shrunk == m) & ~done
            cand_cost = new_cost[m : m + 1]
            cand_score = new_score[m : m + 1]
            cand_origin = new_origin[m : m + 1]
            length = m + torch.clamp(cand_origin, max=0)
            if spec.wildcard_ref:
                tail_n = ncnt[m] - ncnt_lookup(m - length)
                cur_eff = torch.where(length < m, length - tail_n, eff_len)
            else:
                cur_eff = length
            acceptable = (length >= min_overlap) & (
                cur_eff >= minlen_lookup(cand_cost)
            )
            best_length = m + torch.clamp(best_origin, max=0)
            update = cand_mask & acceptable & (
                ~best_found
                | ((cand_origin <= best_origin + m // 2)
                   & (cand_score > best_score))
                | ((length > best_length) & (cand_score > best_score))
            )
            best_found = best_found | update
            best_cost = torch.where(update, cand_cost, best_cost)
            best_score = torch.where(update, cand_score, best_score)
            best_origin = torch.where(update, cand_origin, best_origin)
            best_ref_stop = torch.where(update, m, best_ref_stop)
            best_query_stop = torch.where(update, j, best_query_stop)
            done = done | (update & (cand_cost == 0) & (cand_origin >= 0))
        cost, score, origin = new_cost, new_score, new_origin

    # final-column scan (bottom-up, rows m..first_i)
    scan_applies = max_n == n
    for i in range(m, first_i - 1, -1):
        cand_cost = cost[i : i + 1]
        cand_score = score[i : i + 1]
        cand_origin = origin[i : i + 1]
        length = i + torch.clamp(cand_origin, max=0)
        if spec.wildcard_ref:
            span_n = ncnt[i] - ncnt_lookup(-torch.clamp(cand_origin, max=0))
            cur_eff = torch.where(length < m, length - span_n, eff_len)
        else:
            cur_eff = length
        acceptable = (length >= min_overlap) & (
            cur_eff >= minlen_lookup(cand_cost)
        )
        mask = scan_applies & (i <= last_filled) & acceptable
        best_length = best_ref_stop + torch.clamp(best_origin, max=0)
        update = mask & (
            ~best_found
            | ((stale <= best_origin + m // 2) & (cand_score > best_score))
            | ((length > best_length) & (cand_score > best_score))
        )
        best_found = best_found | update
        best_cost = torch.where(update, cand_cost, best_cost)
        best_score = torch.where(update, cand_score, best_score)
        best_origin = torch.where(update, cand_origin, best_origin)
        best_ref_stop = torch.where(update, i, best_ref_stop)
        best_query_stop = torch.where(update, n, best_query_stop)

    if wide:
        return torch.cat([
            best_found.to(i32), torch.clamp(best_origin, min=0),
            best_query_stop, best_cost, best_score,
            torch.clamp(-best_origin, min=0), best_ref_stop,
        ]).to(i32)
    i64 = torch.int64
    query_start = torch.clamp(best_origin, min=0).to(i64)
    r0 = (query_start | (best_query_stop.to(i64) << _QSTOP_SHIFT)
          | (best_found.to(i64) << _FOUND_SHIFT))
    r1 = best_cost.to(i64) | ((best_score.to(i64) + _SCORE_BIAS) << 16)
    return _to_int32_bits(torch.cat([r0, r1], dim=0))
