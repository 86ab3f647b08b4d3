"""The plain reference of the benchmark's configurations: cutadapt's
3' adapter trimming (regular 3' adapters, ``-a``/``-A``), 3' quality
trimming (``-q``) and the minimum-length pair filter (``-m``), in plain
PyTorch over every read at once, on any device.

The aligner is cutadapt's semi-global DP (``_align.pyx``: unit-cost
edit distance with a parallel score and the start of the alignment,
Ukkonen's band, candidates from the last row left to right and from the
last column bottom up, the reference's acceptance and preference rules,
its early exit on an exact match and its stale origin in the last
column's overlap test) written out cell by cell, one read per lane.
cutadapt's k-mer prefilter only skips reads that cannot match, so it is
left out. Nothing here comes from the program: the reads are the
generator's, and the parameters the configuration file's.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.generate import Reads

MATCH, MISMATCH, INDEL = 1, -1, -2


@dataclass
class BackMatches:
    """Per read: whether the adapter matched, where the match starts in
    the read (its length after trimming) and the errors of the match."""

    found: np.ndarray  # bool
    rstart: np.ndarray  # int64
    errors: np.ndarray  # int64


def locate_back(seqs: torch.Tensor, lens: torch.Tensor, adapter: str,
                max_error_rate: float, min_overlap: int,
                read_wildcards: bool = False) -> BackMatches:
    """cutadapt's Aligner.locate for a regular 3' adapter (flags
    QUERY_START | QUERY_STOP | REFERENCE_END, indel cost 1) of A, C, G
    and T on every read: ``seqs`` (B, W) uint8 and ``lens`` (B,), both
    on the device it runs on. An N in a read is a mismatch, or with
    ``read_wildcards`` (cutadapt's --match-read-wildcards) a match."""
    dev = seqs.device
    B, W = seqs.shape
    m = len(adapter)
    ref = torch.tensor(list(adapter.upper().encode()), dtype=torch.uint8,
                       device=dev)
    n = lens.to(torch.int32)
    k = int(max_error_rate * m)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(m + 1, **i32)[:, None]
    # column 0: a prefix of the reference costs its deletions
    cost = rows.expand(m + 1, B).clone()
    score = (rows * INDEL).expand(m + 1, B).clone()
    origin = torch.zeros((m + 1, B), **i32)
    last = torch.full((B,), min(m, k + 1), **i32)
    last_filled = torch.zeros(B, **i32)
    cur_origin = torch.zeros(B, **i32)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    best_score = torch.zeros(B, **i32)
    best_cost = torch.zeros(B, **i32)
    best_origin = torch.zeros(B, **i32)
    best_ref_stop = torch.full((B,), m, **i32)
    half = m // 2
    rate = torch.tensor(max_error_rate, dtype=torch.float64, device=dev)

    def acceptable(length, c):
        return (length >= min_overlap) & (c.double() <= length.double() * rate)

    def better(cand_origin_test, cand_score, length, best_length):
        return (~have
                | ((cand_origin_test <= best_origin + half)
                   & (cand_score > best_score))
                | ((length > best_length) & (cand_score > best_score)))

    # reads are compared upper-cased, as cutadapt does
    by_col = seqs.t().contiguous()
    lower = (by_col >= ord("a")) & (by_col <= ord("z"))
    by_col = torch.where(lower, by_col - 32, by_col)
    for j in range(1, int(n.max().item()) + 1 if B else 1):
        col = (j <= n) & ~done
        if not bool(col.any()):
            break
        qc = by_col[j - 1]
        diag_c, diag_s, diag_o = cost[0].clone(), score[0].clone(), origin[0].clone()
        origin[0] += col.to(torch.int32)  # a skipped query prefix is free
        top = int(torch.where(col, last, 0).max().item())
        for i in range(1, top + 1):
            act = col & (i <= last)
            eq = ref[i - 1] == qc
            if read_wildcards:
                eq |= qc == ord("N")
            c_diag = diag_c + 1
            c_del = cost[i - 1] + 1
            c_ins = cost[i] + 1
            mis = (c_diag <= c_del) & (c_diag <= c_ins)
            dele = c_del <= c_ins
            new_c = torch.where(eq, diag_c, torch.where(
                mis, c_diag, torch.where(dele, c_del, c_ins)))
            new_o = torch.where(eq | mis, diag_o, torch.where(
                dele, origin[i - 1], origin[i]))
            new_s = torch.where(eq, diag_s + MATCH, torch.where(
                mis, diag_s + MISMATCH,
                torch.where(dele, score[i - 1], score[i]) + INDEL))
            diag_c, diag_s, diag_o = cost[i].clone(), score[i].clone(), origin[i].clone()
            cost[i] = torch.where(act, new_c, cost[i])
            score[i] = torch.where(act, new_s, score[i])
            origin[i] = torch.where(act, new_o, origin[i])
            cur_origin = torch.where(act, new_o, cur_origin)
        last_filled = torch.where(col, last, last_filled)
        # Ukkonen: the last row, at or below `last`, whose cost is <= k
        within = (cost <= k) & (rows <= last[None, :])
        new_last = torch.where(within, rows, -1).amax(0)
        cand = col & (new_last == m)
        last = torch.where(col, torch.where(new_last < m, new_last + 1, last),
                           last)
        # a candidate in the last row
        c_cost, c_score, c_origin = cost[m], score[m], origin[m]
        cur_origin = torch.where(cand, c_origin, cur_origin)
        length = m + torch.clamp(c_origin, max=0)
        upd = cand & acceptable(length, c_cost) & better(
            c_origin, c_score, length, m + torch.clamp(best_origin, max=0))
        best_score = torch.where(upd, c_score, best_score)
        best_cost = torch.where(upd, c_cost, best_cost)
        best_origin = torch.where(upd, c_origin, best_origin)
        best_ref_stop = torch.where(upd, m, best_ref_stop)
        have |= upd
        done |= upd & (c_cost == 0) & (c_origin >= 0)
    # the last column, bottom up, with the stale origin of the column loop
    for i in range(m, -1, -1):
        o = origin[i]
        length = i + torch.clamp(o, max=0)
        upd = (i <= last_filled) & acceptable(length, cost[i]) & better(
            cur_origin, score[i], length,
            best_ref_stop + torch.clamp(best_origin, max=0))
        best_score = torch.where(upd, score[i], best_score)
        best_cost = torch.where(upd, cost[i], best_cost)
        best_origin = torch.where(upd, o, best_origin)
        best_ref_stop = torch.where(upd, i, best_ref_stop)
        have |= upd
    rstart = torch.where(have, torch.clamp(best_origin, min=0), n)
    return BackMatches(have.cpu().numpy(), rstart.long().cpu().numpy(),
                       torch.where(have, best_cost, 0).long().cpu().numpy())


def quality_trim_3p(quals: torch.Tensor, lens: torch.Tensor, cutoff: int,
                    base: int = 33) -> torch.Tensor:
    """cutadapt's 3' quality trimming (BWA's algorithm): the new length
    of each read. Going from the 3' end, s adds cutoff - phred and the
    walk stops where s falls below 0; the read is cut at the position of
    the largest positive s, the one nearest the 3' end among equals."""
    W = quals.shape[1]
    pos = torch.arange(W, device=quals.device)[None, :]
    inside = pos < lens[:, None]
    v = torch.where(inside, cutoff - (quals.int() - base), 0)
    s = v.flip(1).cumsum(1, dtype=torch.int32).flip(1)  # s[i]: v[i:len]
    stop_at = torch.where(inside & (s < 0), pos, -1).amax(1)
    valid = inside & (pos > stop_at[:, None])
    s_valid = torch.where(valid, s, torch.iinfo(torch.int32).min)
    best = s_valid.amax(1)
    # the largest position among equal maxima (the first seen from 3')
    where_best = torch.where(s_valid == best[:, None], pos, -1).amax(1)
    return torch.where(best > 0, where_best, lens)


def _mate(reads: Reads, adapter: str, cfg: dict, device):
    """One mate through -q and its adapter: (quality-trimmed lengths,
    BackMatches on the quality-trimmed reads)."""
    lens = torch.from_numpy(reads.lens.astype(np.int64)).to(device)
    if cfg.get("quality_cutoff"):
        quals = torch.from_numpy(np.ascontiguousarray(reads.quals)).to(device)
        lens = quality_trim_3p(quals, lens, cfg["quality_cutoff"])
        del quals
    lens_np = lens.cpu().numpy()
    if adapter is None:  # no adapter for this mate
        none = np.zeros(len(lens_np), bool)
        return lens_np, BackMatches(none, lens_np, np.zeros_like(lens_np))
    seqs = torch.from_numpy(np.ascontiguousarray(reads.seqs)).to(device)
    hit = locate_back(seqs, lens, adapter, cfg["max_error_rate"],
                      cfg["min_overlap"], cfg.get("read_wildcards", False))
    return lens_np, hit


def _adapter_stats(reads: Reads, qlens: np.ndarray, hit: BackMatches) -> dict:
    """cutadapt's statistics of one 3' adapter: matches, the base before
    each match, and per removed length the count of each error count."""
    found = hit.found
    removed = (qlens - hit.rstart)[found]
    errors = hit.errors[found]
    rs = hit.rstart[found]
    rows = np.flatnonzero(found)
    before = np.where(rs > 0, reads.seqs[rows, np.maximum(rs - 1, 0)], 0)
    adjacent = {b: int((before == ord(b)).sum()) for b in "ACGT"}
    adjacent[""] = int(found.sum()) - sum(adjacent.values())
    lengths = []
    for length in np.unique(removed):
        e = errors[removed == length]
        lengths.append([int(length), np.bincount(e).tolist()])
    return {"matches": int(found.sum()), "adjacent_bases": adjacent,
            "trimmed_lengths": lengths}


def run(cfg: dict, mates: list, device="cpu") -> tuple:
    """What cutadapt writes for the configuration ``cfg`` on ``mates``
    (one Reads per input file; an adapter of None trims nothing on its
    mate): (one Reads with the output lengths and
    the mask of records written, per output file; the report's counts
    and adapter statistics, as compare.report_summary gives them)."""
    adapters = cfg["adapters"]
    qlens, hits = [], []
    for reads, adapter in zip(mates, adapters):
        ql, hit = _mate(reads, adapter, cfg, device)
        qlens.append(ql)
        hits.append(hit)
    out_lens = [h.rstart for h in hits]  # a match cuts; rstart = len if none
    keep = np.ones(len(mates[0]), bool)
    min_len = cfg.get("minimum_length")
    if min_len:
        for ol in out_lens:
            keep &= ol >= min_len
    paired = len(mates) == 2
    outputs = [(Reads(r.names, r.seqs, r.quals, ol), keep)
               for r, ol in zip(mates, out_lens)]
    input_bp = [int(r.lens.sum()) for r in mates]
    written_bp = [int(ol[keep].sum()) for ol in out_lens]
    quality = ([int((r.lens - ql).sum()) for r, ql in zip(mates, qlens)]
               if cfg.get("quality_cutoff") else None)
    summary = {
        "read_counts": {
            "input": len(keep),
            "too_short": int((~keep).sum()) if min_len else None,
            "output": int(keep.sum()),
            "read1_with_adapter": int(hits[0].found.sum()),
            "read2_with_adapter": (int(hits[1].found.sum())
                                   if paired and adapters[1] else None),
        },
        "basepair_counts": {
            "input": sum(input_bp),
            "input_read1": input_bp[0],
            "input_read2": input_bp[1] if paired else None,
            "quality_trimmed": sum(quality) if quality else None,
            "quality_trimmed_read1": quality[0] if quality else None,
            "quality_trimmed_read2": (quality[1] if quality and paired
                                      else None),
            "output": sum(written_bp),
            "output_read1": written_bp[0],
            "output_read2": written_bp[1] if paired else None,
        },
        "adapters": [_adapter_stats(r, ql, h)
                     for r, ql, h, a in zip(mates, qlens, hits, adapters)
                     if a is not None],
    }
    return outputs, summary
