"""
K-mer prefilter construction (pigeonhole principle).

If an adapter may match with at most e errors, then split into e+1
pieces at least one piece must occur exactly; a read containing none
of the pieces cannot contain an acceptable match and can skip the DP
alignment entirely. For adapters that may overlap a read end only
partially, the error budget shrinks with the overlap length, so
position-bounded search windows are emitted per error-count
breakpoint, with short 1-4-base anchors confined to the read end where
a whole-read search would fire randomly too often.

The correctness contract is one-sided: a window set may fire on reads
the aligner rejects, but must never stay silent on a read it would
accept (tests/test_kmer_heuristic.py checks this property against the
aligner). Same construction as the reference heuristic
(cutadapt:src/cutadapt/kmer_heuristic.py:6-164); the scan
itself runs in C++ on the batch path (native/hostops.cpp stage_select).
"""

import io
from collections import defaultdict
from typing import List, Optional, Set, Tuple

# A search window: (start, stop, kmers). Negative start counts from the
# read end; stop None means "through the end".
SearchSet = Tuple[int, Optional[int], Set[str]]

#: k-mers shorter than this are only searched at the read end
_MIN_FREE_KMER_LENGTH = 5


def kmer_chunks(sequence: str, chunks: int) -> Set[str]:
    """Cut `sequence` into `chunks` contiguous, nearly equal pieces."""
    base, extra = divmod(len(sequence), chunks)
    pieces = set()
    pos = 0
    for i in range(chunks):
        width = base + (1 if i < extra else 0)
        pieces.add(sequence[pos : pos + width])
        pos += width
    return pieces


def _error_breakpoints(length: int, error_rate: float) -> List[Tuple[int, int]]:
    """(max_errors, longest overlap with that budget) pairs, ascending."""
    breakpoints = []
    budget = 0
    for overlap in range(length + 1):
        if int(overlap * error_rate) > budget:
            breakpoints.append((budget, overlap - 1))
            budget += 1
    breakpoints.append((budget, length))
    return breakpoints


def create_back_overlap_searchsets(
    adapter: str, min_overlap: int, error_rate: float
) -> List[SearchSet]:
    """Windows covering partial 3' overlaps: for each error budget, the
    pigeonhole pieces of the longest prefix that must be present,
    searched within the last `overlap` bases of the read."""
    search_sets: List[SearchSet] = []
    shortest = min_overlap
    for budget, overlap in _error_breakpoints(len(adapter), error_rate):
        if shortest > overlap:
            continue
        if budget == 0 and shortest < _MIN_FREE_KMER_LENGTH:
            # exact short anchors: restrict each i-mer to the last i bases
            for i in range(shortest, _MIN_FREE_KMER_LENGTH):
                search_sets.append((-i, None, {adapter[:i]}))
            shortest = _MIN_FREE_KMER_LENGTH
        pieces = kmer_chunks(adapter[:shortest], budget + 1)
        search_sets.append((-overlap, None, pieces))
        shortest = overlap + 1
    return search_sets


def _mirror_searchsets(search_sets: List[SearchSet]) -> List[SearchSet]:
    """Turn read-end windows over a reversed adapter into read-start
    windows over the forward adapter."""
    return [
        (0, -start, {kmer[::-1] for kmer in kmers})
        for start, stop, kmers in search_sets
    ]


def minimize_kmer_search_list(
    kmer_search_list: List[Tuple[str, int, Optional[int]]],
) -> List[Tuple[str, int, Optional[int]]]:
    """Collapse duplicate k-mers: each surviving entry searches the
    union of the windows its duplicates covered."""
    by_kmer = defaultdict(list)
    for kmer, start, stop in kmer_search_list:
        by_kmer[kmer].append((start, stop))
    merged: List[Tuple[str, int, Optional[int]]] = []
    for kmer, windows in by_kmer.items():
        if len(windows) == 1:
            merged.append((kmer, *windows[0]))
            continue
        if (0, None) in windows:
            merged.append((kmer, 0, None))
            continue
        heads = [stop for start, stop in windows if start == 0]
        tails = [start for start, stop in windows if stop is None]
        if len(heads) + len(tails) != len(windows):
            raise NotImplementedError(
                "Situations with searches starting in the middle have not "
                "been considered."
            )
        if heads:
            # (0, None) was handled above, so no stop here is None
            merged.append((kmer, 0, max(heads)))
        if tails:
            merged.append((kmer, min(tails), None))
    return merged


def remove_redundant_kmers(
    search_sets: List[SearchSet],
) -> List[Tuple[int, Optional[int], List[str]]]:
    """
    Merge k-mers occurring in multiple search sets so each is searched
    once in the largest applicable window (fewer false positives), then
    regroup by window.
    """
    flat = [
        (kmer, start, stop)
        for start, stop, kmers in search_sets
        for kmer in kmers
    ]
    by_window = defaultdict(list)
    for kmer, start, stop in minimize_kmer_search_list(flat):
        by_window[(start, stop)].append(kmer)
    return [(start, stop, kmers) for (start, stop), kmers in by_window.items()]


def create_positions_and_kmers(
    adapter: str,
    min_overlap: int,
    error_rate: float,
    back_adapter: bool,
    front_adapter: bool,
    internal: bool = True,
) -> List[Tuple[int, Optional[int], List[str]]]:
    """
    Build the (start, stop, kmers) windows of which at least one k-mer
    must hit for an alignment to be possible.
    """
    search_sets: List[SearchSet] = []
    if back_adapter:
        search_sets.extend(
            create_back_overlap_searchsets(adapter, min_overlap, error_rate)
        )
    if front_adapter:
        search_sets.extend(
            _mirror_searchsets(
                create_back_overlap_searchsets(
                    adapter[::-1], min_overlap, error_rate
                )
            )
        )
    if internal:
        budget = int(len(adapter) * error_rate)
        search_sets.append((0, None, kmer_chunks(adapter, budget + 1)))
    return remove_redundant_kmers(search_sets)


def kmer_probability_analysis(
    kmers_and_offsets: List[Tuple[int, Optional[int], List[str]]],
    default_length: int = 150,
) -> str:  # pragma: no cover  # debugging aid
    """Tab-separated table of hit chances per kmer on random sequence."""
    out = io.StringIO()
    out.write(
        "kmer\tstart\tstop\tconsidered sites\thit chance by random sequence (%)\n"
    )
    accumulated_miss_chance = 1.0
    for start, stop, kmers in kmers_and_offsets:
        if stop is None:
            window = -start if start < 0 else default_length - start
        else:
            start = default_length - start if start < 0 else start
            window = max(stop - start, 0)
        for kmer in kmers:
            sites = window - len(kmer) + 1
            miss_chance = (1 - 1 / 4 ** len(kmer)) ** sites
            accumulated_miss_chance *= miss_chance
            out.write(
                f"{kmer:10}\t{start}\t{stop}\t{sites}"
                f"\t{(1 - miss_chance) * 100:.2f}\n"
            )
    out.write(
        "Chance for profile hit by random sequence: "
        f"{(1 - accumulated_miss_chance) * 100:.2f}%\n"
    )
    return out.getvalue()
