"""
Multi-pattern k-mer prefilter via a concatenated Shift-And scan.

Multiple k-mers are packed into one machine word: each pattern gets a
bit range; an init mask seeds a 1 at every pattern start, and a found
mask checks the bit at every pattern end. One pass over the sequence
then detects whether *any* pattern occurs in its search window.

Host implementation of the reference's prefilter
(cutadapt:src/cutadapt/_kmer_finder.pyx:66-257); the batch
path runs the same scan in C++ inside submit's staged pass
(native/hostops.cpp stage_select), so rejected reads never cross the
host-device link.
"""

from typing import List, Optional, Tuple

from .ops.tables import matches_lookup

MAXIMUM_WORD_SIZE = 64


class MockKmerFinder:
    """Prefilter that never rejects (used when k-mers are too long)."""

    def kmers_present(self, sequence: str) -> bool:
        return True


class _SearchEntry:
    __slots__ = ("start", "stop", "init_mask", "found_mask", "masks")

    def __init__(self, start, stop, init_mask, found_mask, masks):
        self.start = start
        self.stop = stop  # 0 encodes "end of sequence"
        self.init_mask = init_mask
        self.found_mask = found_mask
        self.masks = masks  # 128-entry list: char -> bitmask


class KmerFinder:
    """
    Find k-mers in strings, with positional search windows and optional
    IUPAC wildcard matching on either side.

    positions_and_kmers: list of (start, stop, [kmers]); negative start
    counts from the end of the sequence, stop None means to the end.
    """

    def __init__(
        self,
        positions_and_kmers: List[Tuple[int, Optional[int], List[str]]],
        ref_wildcards: bool = False,
        query_wildcards: bool = False,
    ):
        self.positions_and_kmers = positions_and_kmers
        self.ref_wildcards = bool(ref_wildcards)
        self.query_wildcards = bool(query_wildcards)
        match_lookup = matches_lookup(ref_wildcards, query_wildcards)
        self._entries: List[_SearchEntry] = []
        for start, stop, kmers in positions_and_kmers:
            index = 0
            while index < len(kmers):
                offset = 0
                init_mask = 0
                found_mask = 0
                word_chars: List[Tuple[int, int]] = []  # (position, char)
                # Pack as many kmers as fit into one word; open a new
                # word (another entry with the same window) otherwise.
                while index < len(kmers):
                    kmer = kmers[index]
                    if not isinstance(kmer, str):
                        raise TypeError(
                            f"Kmer should be a string not {type(kmer)}"
                        )
                    kmer_bytes = kmer.encode("ascii")
                    kmer_length = len(kmer_bytes)
                    if kmer_length > MAXIMUM_WORD_SIZE:
                        raise ValueError(
                            f"{kmer} of length {kmer_length} is longer "
                            f"than the maximum of {MAXIMUM_WORD_SIZE}."
                        )
                    if offset + kmer_length > MAXIMUM_WORD_SIZE:
                        break
                    init_mask |= 1 << offset
                    for pos, ch in enumerate(kmer_bytes):
                        word_chars.append((offset + pos, ch))
                    found_mask |= 1 << (offset + kmer_length - 1)
                    offset += kmer_length
                    index += 1
                masks = [0] * 128
                for pos, ch in word_chars:
                    for qc in match_lookup[ch]:
                        masks[qc] |= 1 << pos
                entry_stop = 0 if stop is None else stop
                self._entries.append(
                    _SearchEntry(start, entry_stop, init_mask, found_mask, masks)
                )
        # C++ fast path for the per-read scan (same predicate)
        self._native = None
        from . import native as _native_mod

        if _native_mod.AVAILABLE:
            self._native = _native_mod.ScalarKmerMatcher(
                _native_mod.PrefilterTables(self)
            )

    def __reduce__(self):
        return (
            KmerFinder,
            (self.positions_and_kmers, self.ref_wildcards, self.query_wildcards),
        )

    def kmers_present(self, sequence: str) -> bool:
        seq = sequence.encode("ascii")
        if self._native is not None:
            return self._native.kmers_present(seq)
        seq_length = len(seq)
        for entry in self._entries:
            start = entry.start
            stop = entry.stop
            if start < 0:
                start = seq_length + start
                if start < 0:
                    start = 0
            elif start > seq_length:
                continue
            if stop < 0:
                stop = seq_length + stop
                if stop <= 0:
                    continue
            elif stop == 0:  # to end of sequence
                stop = seq_length
            if stop > seq_length:
                stop = seq_length
            if stop - start <= 0:
                continue
            masks = entry.masks
            init_mask = entry.init_mask
            found_mask = entry.found_mask
            r = 0
            for i in range(start, stop):
                c = seq[i]
                r = ((r << 1) | init_mask) & (masks[c] if c < 128 else 0)
                if r & found_mask:
                    return True
        return False
