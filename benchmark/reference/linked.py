"""The plain reference of the linked-primer configuration: cutadapt's
linked adapters ``-a ^FWD...RCREV`` and ``-A ^REV...RCFWD`` on read
pairs with ``--discard-untrimmed``, in plain PyTorch over every read at
once, on any device.

A linked adapter is a 5' part and a 3' part searched in what follows
the 5' match. An anchored 5' part (``^``, cutadapt's PrefixAdapter) is
the whole primer aligned from the read's first base, with indels, at
most ``int(e * len)`` errors; a non-anchored one a regular 5' adapter of
``-O`` bases or more. The 3' part is a regular 3' adapter. With ``-a`` an
anchored part is required and a non-anchored one optional: a read
matches where its required parts do and at least one part does. A pair
goes to the output only where both mates matched: cutadapt applies
``--discard-untrimmed`` with ``--pair-filter=any`` when both mates have
adapters (the configuration's ``pair_filter``, absent here, would say
``both``).

The aligner is cutadapt's semi-global DP (``_align.pyx``, unit-cost
edit distance with a parallel score and the start of the alignment) for
the flag sets with a free query stop, written out cell by cell like
reference/trim.py's, one read per lane: each flag's column-0 costs and
free skips, Ukkonen's band, candidates from the last row left to right
and, where the last column is computed, from it bottom up, the
acceptance and preference rules, the early exit on an exact match and
the stale origin in the last column's test. Nothing here comes from the
program: the reads are the generator's, the parameters the
configuration file's.

Departures from cutadapt's ``_align.pyx`` and ``adapters.py``, none of
which this configuration reaches:

- only flag sets with a free query stop (PREFIX, FRONT, BACK and
  ANYWHERE), so the first column computed is always column 0;
- primers of A, C, G and T only: no adapter wildcards, so no effective
  length of an adapter with N;
- the k-mer prefilter is left out: it only skips reads that cannot
  match;
- an anchored 3' part (``$``) is refused (ValueError), and so is
  ``-g``'s form, which requires both parts;
- ``--no-indels`` is not read: an anchored part has indels, as by
  default.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.generate import Reads

MATCH, MISMATCH, INDEL = 1, -1, -2
# the aligner's flags: which ends may be skipped at no cost
REFERENCE_START, QUERY_START, REFERENCE_END, QUERY_STOP = 1, 2, 4, 8
PREFIX = QUERY_STOP
FRONT = QUERY_START | QUERY_STOP | REFERENCE_START
BACK = QUERY_START | QUERY_STOP | REFERENCE_END


@dataclass
class Matches:
    """Per read: whether the adapter matched, the match's [rstart,
    rstop) in the read and its errors (rstart = rstop = the read's
    length, and 0 errors, where it did not)."""

    found: torch.Tensor  # bool
    rstart: torch.Tensor  # int64
    rstop: torch.Tensor  # int64
    errors: torch.Tensor  # int64


def locate(seqs: torch.Tensor, lens: torch.Tensor, adapter: str, flags: int,
           max_error_rate: float, min_overlap: int,
           read_wildcards: bool = False) -> Matches:
    """cutadapt's Aligner.locate with ``flags`` (indel cost 1) of an
    adapter of A, C, G and T on every read: ``seqs`` (B, W) uint8 and
    ``lens`` (B,), both on the device it runs on. An N in a read is a
    mismatch, or with ``read_wildcards`` (--match-read-wildcards) a
    match."""
    if not flags & QUERY_STOP:
        raise ValueError("only flag sets with a free query stop")
    if set(adapter.upper()) - set("ACGT"):
        raise ValueError("only adapters of A, C, G and T")
    start_ref = bool(flags & REFERENCE_START)
    start_query = bool(flags & QUERY_START)
    stop_ref = bool(flags & REFERENCE_END)
    dev = seqs.device
    B = seqs.shape[0]
    m = len(adapter)
    ref = torch.tensor(list(adapter.upper().encode()), dtype=torch.uint8,
                       device=dev)
    n = lens.to(torch.int32)
    k = int(max_error_rate * m)
    # without a free query start, costs only grow after column m + k
    max_n = n if start_query else n.clamp(max=m + k)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(m + 1, **i32)[:, None]
    if start_ref:  # a skipped reference prefix is free
        cost = torch.zeros((m + 1, B), **i32)
        score = torch.zeros((m + 1, B), **i32)
        origin = (-rows).expand(m + 1, B).clone()
    else:  # a prefix of the reference costs its deletions
        cost = rows.expand(m + 1, B).clone()
        score = (rows * INDEL).expand(m + 1, B).clone()
        origin = torch.zeros((m + 1, B), **i32)
    last = torch.full((B,), m if start_ref else min(m, k + 1), **i32)
    last_filled = torch.zeros(B, **i32)
    cur_origin = torch.zeros(B, **i32)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    best_score = torch.zeros(B, **i32)
    best_cost = torch.zeros(B, **i32)
    best_origin = torch.zeros(B, **i32)
    best_ref_stop = torch.full((B,), m, **i32)
    best_query_stop = n.clone()
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
    for j in range(1, int(max_n.max().item()) + 1 if B else 1):
        col = (j <= max_n) & ~done
        if not bool(col.any()):
            break
        step = col.to(torch.int32)
        qc = by_col[j - 1]
        diag_c, diag_s, diag_o = cost[0].clone(), score[0].clone(), origin[0].clone()
        if start_query:  # a skipped query prefix is free
            origin[0] += step
        else:  # it costs its insertions
            cost[0] += step
            score[0] += step * INDEL
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
        best_query_stop = torch.where(upd, j, best_query_stop)
        have |= upd
        done |= upd & (c_cost == 0) & (c_origin >= 0)
    # the last column, bottom up, where it was computed (the read ends by
    # column m + k, or the query start is free), with the stale origin
    # of the column loop
    whole = max_n == n
    for i in range(m, -1 if stop_ref else m - 1, -1):
        o = origin[i]
        length = i + torch.clamp(o, max=0)
        upd = whole & (i <= last_filled) & acceptable(length, cost[i]) & better(
            cur_origin, score[i], length,
            best_ref_stop + torch.clamp(best_origin, max=0))
        best_score = torch.where(upd, score[i], best_score)
        best_cost = torch.where(upd, cost[i], best_cost)
        best_origin = torch.where(upd, o, best_origin)
        best_ref_stop = torch.where(upd, i, best_ref_stop)
        best_query_stop = torch.where(upd, n, best_query_stop)
        have |= upd
    return Matches(have,
                   torch.where(have, best_origin.clamp(min=0), n).long(),
                   torch.where(have, best_query_stop, n).long(),
                   torch.where(have, best_cost, 0).long())


def _parts(spec: str):
    """The 5' part of ``-a FRONT...BACK``, whether it is anchored, and
    the 3' part."""
    front, sep, back = spec.partition("...")
    if not sep or back.endswith("$"):
        raise ValueError(f"not a linked adapter with a 3' part of -a's kind: "
                         f"{spec!r}")
    return front.lstrip("^"), front.startswith("^"), back


def _shifted(x: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` moved left by ``by`` of its bytes."""
    W = x.shape[1]
    idx = (by[:, None] + torch.arange(W, device=x.device)[None, :]).clamp(
        max=W - 1)
    return torch.gather(x, 1, idx)


@dataclass
class LinkedMatches:
    """One mate's linked adapter on every read: whether it matched, the
    5' match, the 3' match in the remainder after the 5' match (the
    whole read where there is none) and that remainder, moved to the
    row's start, with its length."""

    matched: torch.Tensor
    front: Matches
    back: Matches
    rest: torch.Tensor  # (B, W) uint8
    rest_lens: torch.Tensor


def match_mate(reads: Reads, spec: str, cfg: dict, device) -> LinkedMatches:
    """cutadapt's LinkedAdapter.match_to (``-a``) on every read of one
    mate."""
    front, anchored, back = _parts(spec)
    seqs = torch.from_numpy(np.ascontiguousarray(reads.seqs)).to(device)
    lens = torch.from_numpy(reads.lens.astype(np.int64)).to(device)
    rate, wild = cfg["max_error_rate"], cfg.get("read_wildcards", False)
    overlap = cfg["min_overlap"]
    # anchored: the whole primer, so its length is the least overlap
    f = locate(seqs, lens, front, PREFIX if anchored else FRONT, rate,
               len(front) if anchored else overlap, wild)
    cut = torch.where(f.found, f.rstop, 0)
    rest, rest_lens = _shifted(seqs, cut), lens - cut
    b = locate(rest, rest_lens, back, BACK, rate, overlap, wild)
    # a required 5' part that did not match leaves the 3' part unsearched
    if anchored:
        b.found &= f.found
    matched = (f.found | b.found) & (f.found | (not anchored))
    return LinkedMatches(matched, f, b, rest, rest_lens)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def end_statistics(found, removed, errors, before=None) -> dict:
    """One end's statistics as compare.report_summary gives them:
    matches, the base before each match (``before``; a 5' end records
    none, and no match none) and per removed length the count of each
    error count."""
    adjacent = None
    if before is not None and found.any():
        b = before[found]
        adjacent = {x: int((b == ord(x)).sum()) for x in "ACGT"}
        adjacent[""] = int(found.sum()) - sum(adjacent.values())
    lengths = []
    for length in np.unique(removed[found]):
        e = errors[found & (removed == length)]
        lengths.append([int(length), np.bincount(e).tolist()])
    return {"matches": int(found.sum()), "adjacent_bases": adjacent,
            "trimmed_lengths": lengths}


def three_prime_end(hit: LinkedMatches) -> dict:
    """The 3' part's statistics (the report's ``three_prime_end``): the
    bases it removed from the remainder, and the base before it there."""
    b = hit.back
    at = _np(b.rstart) - 1
    rows = np.arange(len(at))
    before = np.where(at >= 0, _np(hit.rest)[rows, np.maximum(at, 0)], 0)
    return end_statistics(_np(b.found), _np(hit.rest_lens - b.rstart),
                          _np(b.errors), before)


def five_prime_end(hit: LinkedMatches) -> dict:
    """The 5' part's statistics (the report's ``five_prime_end``): the
    bases it removed from the read's start."""
    f = hit.front
    return end_statistics(_np(f.found), _np(f.rstop), _np(f.errors))


def run(cfg: dict, mates: list, device="cpu") -> tuple:
    """What cutadapt writes for the configuration ``cfg`` on the read
    pairs ``mates`` (one Reads per input file, a linked adapter per mate
    in ``cfg["adapters"]``): (one Reads with the output bases and
    lengths and the mask of records written, per output file; the
    report's counts and 3' adapter statistics, as
    compare.report_summary gives them)."""
    return summarize(cfg, mates, [match_mate(r, a, cfg, device) for r, a in
                                  zip(mates, cfg["adapters"])])


def summarize(cfg: dict, mates: list, hits: list) -> tuple:
    """:func:`run`'s outputs and summary from each mate's matches."""
    matched = [_np(h.matched) for h in hits]
    any_filter = cfg.get("pair_filter", "any") == "any"
    # --discard-untrimmed drops a pair where any (with "both": each) of
    # its mates went untrimmed
    keep = (np.logical_and if any_filter else np.logical_or)(*matched)
    outputs = []
    for reads, h in zip(mates, hits):
        # an unmatched read is written whole: its remainder is the read
        cut = torch.where(h.front.found, h.front.rstop, 0)
        quals = _shifted(torch.from_numpy(np.ascontiguousarray(
            reads.quals)).to(cut.device), cut)
        out_len = torch.where(h.back.found, h.back.rstart, h.rest_lens)
        outputs.append((Reads(reads.names, _np(h.rest), _np(quals),
                              _np(out_len)), keep))
    input_bp = [int(r.lens.sum()) for r in mates]
    written_bp = [int(r.lens[keep].sum()) for r, _ in outputs]
    summary = {
        "read_counts": {
            "input": len(keep),
            "too_short": None,
            "output": int(keep.sum()),
            "read1_with_adapter": int(matched[0].sum()),
            "read2_with_adapter": int(matched[1].sum()),
        },
        "basepair_counts": {
            "input": sum(input_bp),
            "input_read1": input_bp[0],
            "input_read2": input_bp[1],
            "quality_trimmed": None,
            "quality_trimmed_read1": None,
            "quality_trimmed_read2": None,
            "output": sum(written_bp),
            "output_read1": written_bp[0],
            "output_read2": written_bp[1],
        },
        "adapters": [three_prime_end(h) for h in hits],
    }
    return outputs, summary
