"""The yardstick of the aligner's roofline: the card's peaks and the DP
work a launch's data needs, frozen here from the arithmetic of
cutadapt_tpu_torch/ops/align_cuda.py:dp_work (4 integer operations per
active column, 24 per cell of rows 1..m, 8 more per cell whose query
class does not match the row), counted over the rows actually handed to
the kernel and their real lengths, never over padding."""

import subprocess

import numpy as np

# NVIDIA H100 SXM (Hopper data sheet): int32 lanes per SM, HBM3 rate,
# and the maximum SM clock, used where nvidia-smi cannot be read
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int32_lanes_per_sm": 64,
                              "bytes_per_s": 3.35e12,
                              "max_sm_clock_hz": 1.98e9},
}
OPS_PER_COLUMN = 4
OPS_PER_CELL = 24
OPS_PER_CELL_BYTE = 23
OPS_PER_MISMATCH = 8
LANE_BITS = {True: 2, False: 4, None: 8}


def card_clock() -> dict:
    """The card's maximum SM clock (Hz) and power limit (W) as nvidia-smi
    reports them; None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        clock, limit = (float(x) for x in out.split(","))
        return {"sm_clock_hz": clock * 1e6, "power_limit_w": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"sm_clock_hz": None, "power_limit_w": None}


def launch_work(enc: np.ndarray, lengths: np.ndarray, rows_table: np.ndarray,
                m: int, k: int, start_in_query: bool, stop_in_query: bool,
                pack2, wide: bool):
    """(integer operations, bytes) that one launch's real rows need:
    ``enc`` (B, Wp) uint8 packed classes (or codes), ``lengths`` (B,),
    ``rows_table`` the m reference rows (class bitmasks, or codes in the
    byte lane). Padding rows (length 0) and padding columns add nothing."""
    real = lengths > 0
    if not real.any():
        return 0, 4 * len(rows_table)
    enc, n = enc[real], lengths[real].astype(np.int64)
    bits = LANE_BITS[pack2]
    per_byte = 8 // bits
    rows = rows_table[:m].astype(np.int64)
    if pack2 is None:
        n_eq = np.bincount(rows, minlength=256)
        per_cell = OPS_PER_CELL_BYTE
    else:
        n_eq = np.array([int(((rows >> c) & 1).sum()) for c in range(16)])
        per_cell = OPS_PER_CELL
    # eq_in[b, p]: the reference rows matching the first p classes of byte b
    b = np.arange(256)[:, None]
    cls = (b >> (np.arange(per_byte)[None, :] * bits)) & ((1 << bits) - 1)
    eq_in = np.concatenate([np.zeros((256, 1), np.int64),
                            np.cumsum(n_eq[cls], axis=1)], axis=1)
    B, Wp = enc.shape
    # per row, the matching cells of its first j whole bytes
    upto = np.zeros((B, Wp + 1), np.int64)
    np.cumsum(eq_in[enc, per_byte], axis=1, out=upto[:, 1:])
    rows_b = np.arange(B)

    def matching_before(x):
        """Per row, the matching cells of the columns before x."""
        full, part = x // per_byte, x % per_byte
        last = enc[rows_b, np.minimum(full, Wp - 1)]
        return upto[rows_b, full] + np.where(full < Wp, eq_in[last, part], 0)

    max_n = n if start_in_query else np.minimum(n, m + k)
    min_n = np.zeros_like(n) if stop_in_query else np.maximum(0, n - m - k)
    j_end = np.minimum(max_n, Wp * per_byte)
    lo = np.minimum(min_n, j_end)
    cols = int((j_end - lo).sum())
    cells = cols * m
    eq_cells = int((matching_before(j_end) - matching_before(lo)).sum())
    ops = cols * OPS_PER_COLUMN + cells * per_cell \
        + (cells - eq_cells) * OPS_PER_MISMATCH
    # each real row's bases, its length and its result, read or written
    # once, and the table once per launch
    nbytes = int((-(-n * bits // 8)).sum()) + 4 * len(n) \
        + 4 * (7 if wide else 2) * len(n) + 4 * len(rows_table)
    return ops, nbytes
