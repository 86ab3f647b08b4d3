"""
Read modifications: adapter cutting, quality trimming, renaming etc.

A modifier is a callable taking (read, info) — or the four-argument
paired form — and returning the modified read(s). This is the per-read
oracle layer; the batch engine executes the same transforms as window
updates over whole chunks (batch_pipeline.py), and accel.py translates
eligible modifier lists onto it.

Design notes: adapter-match *actions* (trim/retain/mask/lowercase/
crop/none) are one dispatch table shared by AdapterCutter and
PairedAdapterCutter; the forward-vs-reverse-complement choice is one
helper shared by both revcomp modifiers; rename templates compile to
a list of literal/field parts instead of being re-interpreted per
read.

Capability parity: cutadapt:src/cutadapt/modifiers.py:32-918.
"""

import logging
import re
from abc import ABC, abstractmethod
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .adapters import (
    Adapter,
    AdapterIndex,
    IndexedPrefixAdapters,
    IndexedSuffixAdapters,
    Match,
    MultipleAdapters,
    remainder,
)
from .info import ModificationInfo
from .io.records import SequenceRecord, record_names_match
from .qualtrim import nextseq_trim_index, poly_a_trim_index, quality_trim_index
from .tokenizer import BraceToken, Token, TokenizeError, tokenize_braces

logger = logging.getLogger()


class SingleEndModifier(ABC):
    @abstractmethod
    def __call__(self, read: SequenceRecord, info: ModificationInfo):
        pass


class PairedEndModifier(ABC):
    @abstractmethod
    def __call__(
        self,
        read1: SequenceRecord,
        read2: SequenceRecord,
        info1: ModificationInfo,
        info2: ModificationInfo,
    ) -> Tuple[SequenceRecord, SequenceRecord]:
        pass


class PairedEndModifierWrapper(PairedEndModifier):
    """Wrap one or two single-end modifiers to apply to R1/R2."""

    paired = True

    def __init__(
        self,
        modifier1: Optional[SingleEndModifier],
        modifier2: Optional[SingleEndModifier],
    ):
        """Set one of the modifiers to None to work on R1 or R2 only."""
        if modifier1 is None and modifier2 is None:
            raise ValueError("Not both modifiers may be None")
        self._modifier1 = modifier1
        self._modifier2 = modifier2

    def __repr__(self):
        return (
            "PairedEndModifierWrapper("
            f"modifier1={self._modifier1!r}, modifier2={self._modifier2!r})"
        )

    def __call__(self, read1, read2, info1, info2):
        out1 = (
            self._modifier1(read1, info1) if self._modifier1 is not None
            else read1
        )
        out2 = (
            self._modifier2(read2, info2) if self._modifier2 is not None
            else read2
        )
        return out1, out2


# --- adapter-match actions ----------------------------------------------------
#
# Every action maps (original read, trim-applied read, matches) to the
# output read. 'trim' returns the already-trimmed read; the others
# reconstruct their result from the original.


def _masked(original, trimmed, matches: Sequence[Match]):
    start, stop = remainder(matches)
    out = original[:]
    out.sequence = (
        "N" * start
        + original.sequence[start:stop]
        + "N" * (len(original) - stop)
    )
    return out


def _lowercased(original, trimmed, matches: Sequence[Match]):
    start, stop = remainder(matches)
    seq = original.sequence
    out = original[:]
    out.sequence = (
        seq[:start].lower() + seq[start:stop].upper() + seq[stop:].lower()
    )
    return out


def _retained(original, trimmed, matches: Sequence[Match]):
    start, stop = matches[-1].retained_adapter_interval()
    return original[start:stop]


def _cropped(original, trimmed, matches: Sequence[Match]):
    last = matches[-1]
    return original[last.rstart : last.rstop]


MATCH_ACTIONS: Dict[Optional[str], Callable] = {
    "trim": lambda original, trimmed, matches: trimmed,
    "mask": _masked,
    "lowercase": _lowercased,
    "retain": _retained,
    "crop": _cropped,
    None: lambda original, trimmed, matches: original[:],
}


class AdapterCutter(SingleEndModifier):
    """
    Repeatedly find the best of multiple adapters in reads and act on
    the match (trim/retain/mask/lowercase/crop/none).
    """

    def __init__(
        self,
        adapters: Sequence[Adapter],
        times: int = 1,
        action: Optional[str] = "trim",
        index: bool = True,
    ):
        if action not in MATCH_ACTIONS:
            raise ValueError(f"action must be one of {set(MATCH_ACTIONS)}")
        if action in ("retain", "crop") and times > 1:
            raise ValueError(
                "'retain' and 'crop' cannot be combined with times > 1"
            )
        self.times = times
        self.action = action
        self.with_adapters = 0
        self.adapter_statistics = {a: a.create_statistics() for a in adapters}
        matchables = (
            self._regroup_into_indexed_adapters(adapters) if index
            else adapters
        )
        self.adapters = MultipleAdapters(matchables)

    def __repr__(self):
        return (
            "AdapterCutter("
            f"adapters={self.adapters!r}, times={self.times}, "
            f"action='{self.action}')"
        )

    @staticmethod
    def _regroup_into_indexed_adapters(adapters):
        """Replace groups of >1 indexable anchored adapters with one
        dict-index matcher; otherwise keep the given order."""
        groups: Dict[str, list] = {"prefix": [], "suffix": [], "other": []}
        for adapter in adapters:
            if AdapterIndex.is_acceptable(adapter, prefix=True):
                groups["prefix"].append(adapter)
            elif AdapterIndex.is_acceptable(adapter, prefix=False):
                groups["suffix"].append(adapter)
            else:
                groups["other"].append(adapter)
        if len(groups["prefix"]) < 2 and len(groups["suffix"]) < 2:
            return adapters
        result = list(groups["other"])
        for side, indexed_class in (
            ("prefix", IndexedPrefixAdapters),
            ("suffix", IndexedSuffixAdapters),
        ):
            members = groups[side]
            if len(members) > 1:
                result.append(indexed_class(members))
            else:
                result.extend(members)
        return result

    def __call__(self, read, info: ModificationInfo):
        trimmed_read, matches = self.match_and_trim(read)
        if matches:
            self.with_adapters += 1
            for match in matches:
                self.adapter_statistics[match.adapter].add_match(match)
        info.matches.extend(matches)
        return trimmed_read

    def match_and_trim(self, read):
        """
        Search for the best-matching adapter, up to `times` rounds,
        then perform the configured action. Return (read, matches).
        """
        if self.times == 1 and self.action == "trim":
            # dominant configuration: skip the multi-round bookkeeping
            match = self.adapters.match_to(read.sequence)
            if match is None:
                return read, []
            return match.trimmed(read), [match]

        if self.action == "lowercase":
            read.sequence = read.sequence.upper()
        matches = []
        current = read
        for _ in range(self.times):
            match = self.adapters.match_to(current.sequence)
            if match is None:
                break
            matches.append(match)
            current = match.trimmed(current)
        if not matches:
            return current, []
        result = MATCH_ACTIONS[self.action](read, current, matches)
        if self.action == "lowercase":
            assert len(result.sequence) == len(read)
        return result, matches


def _credit_matches(cutter, matches, info, reverse_complemented: bool):
    """Record one read's final matches into the cutter's statistics."""
    if not matches or cutter is None:
        return
    cutter.with_adapters += 1
    for match in matches:
        stats = cutter.adapter_statistics[match.adapter]
        stats.add_match(match)
        stats.reverse_complemented += bool(reverse_complemented)
    info.matches.extend(matches)


class ReverseComplementer(SingleEndModifier):
    """Trim adapters from a read or its reverse complement, whichever
    matches better (strictly better: ties keep the forward read)."""

    def __init__(
        self, adapter_cutter: AdapterCutter, rc_suffix: Optional[str] = " rc"
    ):
        self.adapter_cutter = adapter_cutter
        self.reverse_complemented = 0
        self._suffix = rc_suffix

    def __repr__(self):
        return f"ReverseComplementer(adapter_cutter={self.adapter_cutter})"

    def __call__(self, read: SequenceRecord, info: ModificationInfo):
        cutter = self.adapter_cutter
        fwd_read, fwd_matches = cutter.match_and_trim(read)
        rev_read, rev_matches = cutter.match_and_trim(read.reverse_complement())
        use_rc = sum(m.score for m in rev_matches) > sum(
            m.score for m in fwd_matches
        )
        if use_rc:
            self.reverse_complemented += 1
            assert rev_matches
            trimmed, matches = rev_read, rev_matches
            info.is_rc = True
            if self._suffix:
                trimmed.name += self._suffix
        else:
            info.is_rc = False
            trimmed, matches = fwd_read, fwd_matches
        _credit_matches(cutter, matches, info, use_rc)
        return trimmed


class PairedReverseComplementer(PairedEndModifier):
    """Trim adapters from a read pair or its reverse complement (R1/R2
    swapped), whichever matches better."""

    def __init__(
        self,
        adapter_cutter1: Optional[AdapterCutter],
        adapter_cutter2: Optional[AdapterCutter],
        rc_suffix: Optional[str] = " rc",
    ):
        self.adapter_cutter1 = adapter_cutter1
        self.adapter_cutter2 = adapter_cutter2
        self.reverse_complemented = 0
        self._suffix = rc_suffix

    def __repr__(self):
        return (
            "PairedReverseComplementer("
            f"adapter_cutter1={self.adapter_cutter1}, "
            f"adapter_cutter2={self.adapter_cutter2})"
        )

    def _trim_pair(self, first, second):
        """Trim (first -> cutter1, second -> cutter2); return reads,
        matches, and the total score."""
        if self.adapter_cutter1 is not None:
            out1, matches1 = self.adapter_cutter1.match_and_trim(first)
        else:
            out1, matches1 = first, []
        if self.adapter_cutter2 is not None:
            out2, matches2 = self.adapter_cutter2.match_and_trim(second)
        else:
            out2, matches2 = second, []
        score = sum(m.score for m in matches1) + sum(m.score for m in matches2)
        return (out1, out2, matches1, matches2, score)

    def __call__(self, r1, r2, info1, info2):
        straight = self._trim_pair(r1, r2)
        swapped = self._trim_pair(r2, r1)  # equivalent to revcomping
        use_rc = swapped[4] > straight[4]
        out1, out2, matches1, matches2, _ = swapped if use_rc else straight
        if use_rc:
            self.reverse_complemented += 1
            info1.is_rc = info2.is_rc = True
            if self._suffix:
                out1.name += self._suffix
                out2.name += self._suffix
        else:
            info1.is_rc = info2.is_rc = False
        _credit_matches(self.adapter_cutter1, matches1, info1, use_rc)
        _credit_matches(self.adapter_cutter2, matches2, info2, use_rc)
        return out1, out2


class PairedAdapterCutterError(Exception):
    pass


class PairedAdapterCutter(PairedEndModifier):
    """Trim adapter i from R1 only when adapter i also matches R2
    (--pair-adapters): the pair with the best total score wins."""

    def __init__(self, adapters1, adapters2, action="trim"):
        if len(adapters1) != len(adapters2):
            raise PairedAdapterCutterError(
                "The number of adapters to trim from R1 and R2 must be "
                f"the same. Given: {len(adapters1)} for R1, "
                f"{len(adapters2)} for R2"
            )
        if not adapters1:
            raise PairedAdapterCutterError("No adapters given")
        self._adapter_pairs = list(zip(adapters1, adapters2))
        logger.debug("Adapter pairs:")
        for a1, a2 in self._adapter_pairs:
            logger.debug(
                " • %s=%s -- %s=%s", a1.name, a1.spec(), a2.name, a2.spec()
            )
        self.action = action
        self.with_adapters = 0
        self.adapter_statistics = [
            {a: a.create_statistics() for a in adapters1},
            {a: a.create_statistics() for a in adapters2},
        ]

    def __repr__(self):
        return f"PairedAdapterCutter(adapter_pairs={self._adapter_pairs!r})"

    def __call__(self, read1, read2, info1, info2):
        winner = self._find_best_match_pair(read1.sequence, read2.sequence)
        if winner is None:
            return read1, read2
        self.with_adapters += 1
        result = []
        for side, (match, read, info) in enumerate(
            zip(winner, (read1, read2), (info1, info2))
        ):
            if self.action == "lowercase":
                read.sequence = read.sequence.upper()
            trimmed = match.trimmed(read)
            self.adapter_statistics[side][match.adapter].add_match(match)
            result.append(MATCH_ACTIONS[self.action](read, trimmed, [match]))
            info.matches.append(match)
        return result

    def _find_best_match_pair(self, sequence1: str, sequence2: str):
        best = None
        best_rank = None
        for adapter1, adapter2 in self._adapter_pairs:
            match1 = adapter1.match_to(sequence1)
            if match1 is None:
                continue
            match2 = adapter2.match_to(sequence2)
            if match2 is None:
                continue
            # higher total score wins; ties go to fewer total errors
            rank = (
                match1.score + match2.score,
                -(match1.errors + match2.errors),
            )
            if best is None or rank > best_rank:
                best = (match1, match2)
                best_rank = rank
        return best


class UnconditionalCutter(SingleEndModifier):
    """
    Remove the first n (length > 0) or last n (length < 0) bases.
    """

    def __init__(self, length: int):
        self.length = length

    def __repr__(self):
        return f"UnconditionalCutter(length={self.length})"

    def __call__(self, read, info: ModificationInfo):
        n = self.length
        if n > 0:
            info.cut_prefix = read.sequence[:n]
            return read[n:]
        if n < 0:
            info.cut_suffix = read.sequence[n:]
            return read[:n]


class LengthTagModifier(SingleEndModifier):
    """Replace 'length=...' strings in read names."""

    def __init__(self, length_tag):
        self.regex = re.compile(r"\b" + length_tag + r"[0-9]*\b")
        self.length_tag = length_tag

    def __repr__(self):
        return f"LengthTagModifier(length_tag='{self.length_tag}')"

    def __call__(self, read, info: ModificationInfo):
        read = read[:]
        if self.length_tag in read.name:
            read.name = self.regex.sub(
                f"{self.length_tag}{len(read.sequence)}", read.name
            )
        return read


class SuffixRemover(SingleEndModifier):
    """Remove a given suffix from read names."""

    def __init__(self, suffix):
        self.suffix = suffix

    def __repr__(self):
        return f"SuffixRemover('{self.suffix}')"

    def __call__(self, read, info: ModificationInfo):
        read = read[:]
        if read.name.endswith(self.suffix):
            read.name = read.name[: -len(self.suffix)]
        return read


class PrefixSuffixAdder(SingleEndModifier):
    """Add a prefix and a suffix to read names."""

    def __init__(self, prefix, suffix):
        self.prefix = prefix
        self.suffix = suffix

    def __repr__(self):
        return (
            f"PrefixSuffixAdder(prefix='{self.prefix}', "
            f"suffix='{self.suffix}')"
        )

    def __call__(self, read, info):
        read = read[:]
        adapter_name = (
            info.matches[-1].adapter.name if info.matches else "no_adapter"
        )
        read.name = (
            self.prefix.replace("{name}", adapter_name)
            + read.name
            + self.suffix.replace("{name}", adapter_name)
        )
        return read


class InvalidTemplate(Exception):
    pass


def _parse_read_id(read_name: str) -> Tuple[str, str]:
    """Split a read header into (id, comment)."""
    fields = read_name.split(maxsplit=1)
    if len(fields) == 2:
        return fields[0], fields[1]
    return read_name, ""


def _compile_template(template: str, allowed: Set[str]):
    """Compile a brace template into [(is_field, text)] parts; raise
    InvalidTemplate for syntax errors or unknown field names."""
    try:
        tokens = list(tokenize_braces(template))
    except TokenizeError as e:
        raise InvalidTemplate(f"Error in template '{template}': {e}")
    parts = []
    for token in tokens:
        is_field = isinstance(token, BraceToken)
        if is_field and token.value not in allowed:
            raise InvalidTemplate(
                f"Error in template: Variable '{token.value}' not recognized"
            )
        parts.append((is_field, token.value))
    return parts


class Renamer(SingleEndModifier):
    """
    Rename reads using a template with placeholders:
    {header}, {id}, {comment}, {cut_prefix}, {cut_suffix},
    {adapter_name}, {match_sequence}, {rc}.

    The template is compiled once into literal and field parts; each
    read evaluates only the fields its template actually uses.
    """

    variables = {
        "header",
        "id",
        "comment",
        "cut_prefix",
        "cut_suffix",
        "adapter_name",
        "rc",
        "match_sequence",
    }

    def __init__(self, template: str):
        template = template.replace(r"\t", "\t")
        self._parts = _compile_template(template, self.variables)
        self._template = template

    def __repr__(self):
        return f"{self.__class__.__name__}('{self._template}')"

    def __reduce__(self):
        return Renamer, (self._template,)

    @staticmethod
    def raise_if_invalid_variable(tokens: List[Token], allowed: Set[str]) -> None:
        for token in tokens:
            if isinstance(token, BraceToken) and token.value not in allowed:
                raise InvalidTemplate(
                    f"Error in template: Variable '{token.value}' not recognized"
                )

    @staticmethod
    def parse_name(read_name: str) -> Tuple[str, str]:
        """Parse read header into an (id, comment) tuple."""
        return _parse_read_id(read_name)

    @staticmethod
    def _field_values(read, info) -> Dict[str, str]:
        id_, comment = _parse_read_id(read.name)
        last = info.matches[-1] if info.matches else None
        return {
            "header": read.name,
            "id": id_,
            "comment": comment,
            "cut_prefix": info.cut_prefix or "",
            "cut_suffix": info.cut_suffix or "",
            "adapter_name": last.adapter.name if last else "no_adapter",
            "rc": "rc" if info.is_rc else "",
            "match_sequence": last.match_sequence() if last else "",
        }

    def __call__(self, read: SequenceRecord, info: ModificationInfo):
        values = self._field_values(read, info)
        read.name = "".join(
            values[text] if is_field else text
            for is_field, text in self._parts
        )
        return read


class PairedEndRenamer(PairedEndModifier):
    """
    Rename paired-end reads using a template evaluated separately for
    R1 and R2, with the additional variables {rn}, {r1.x} and {r2.x}.
    """

    def __init__(self, template: str):
        self._template = template.replace(r"\t", "\t")
        self._parts = _compile_template(
            self._template, self._allowed_variables()
        )

    @staticmethod
    def _allowed_variables() -> Set[str]:
        allowed = (Renamer.variables - {"rc"}) | {"rn"}
        for name in Renamer.variables - {"id", "rc"}:
            allowed.add(f"r1.{name}")
            allowed.add(f"r2.{name}")
        return allowed

    def __call__(self, read1, read2, info1, info2):
        if not record_names_match(read1.name, read2.name):
            id1 = _parse_read_id(read1.name)[0]
            id2 = _parse_read_id(read1.name)[1]
            raise ValueError(
                f"Input read IDs not identical: '{id1}' != '{id2}'"
            )
        name1, name2 = self._render_names(read1, read2, info1, info2)
        if not record_names_match(name1, name2):
            new_id1 = _parse_read_id(name1)[0]
            new_id2 = _parse_read_id(name2)[0]
            id1 = _parse_read_id(read1.name)[0]
            raise InvalidTemplate(
                "After renaming R1 and R2, their IDs are no longer identical: "
                f"'{new_id1}' != '{new_id2}'. Original read ID: '{id1}'. "
            )
        read1.name = name1
        read2.name = name2
        return read1, read2

    def _render_names(self, read1, read2, info1, info2) -> Tuple[str, str]:
        sides = (
            Renamer._field_values(read1, info1),
            Renamer._field_values(read2, info2),
        )

        def lookup(field: str, rn: int) -> str:
            side, dot, key = field.partition(".")
            if dot and side in ("r1", "r2"):
                return sides[0 if side == "r1" else 1][key]
            if field == "rn":
                return str(rn)
            if field == "id":
                return sides[rn - 1]["id"]
            return sides[rn - 1][field]

        names = []
        for rn in (1, 2):
            names.append(
                "".join(
                    lookup(text, rn) if is_field else text
                    for is_field, text in self._parts
                )
            )
        return names[0], names[1]


class ZeroCapper(SingleEndModifier):
    """Change negative quality values of a read to zero."""

    def __init__(self, quality_base=33):
        self.quality_base = quality_base
        below = range(quality_base)
        self.zero_cap_trans = str.maketrans(
            "".join(map(chr, below)), chr(quality_base) * len(below)
        )

    def __repr__(self):
        return f"ZeroCapper(quality_base={self.quality_base})"

    def __call__(self, read, info: ModificationInfo):
        read = read[:]
        read.qualities = read.qualities.translate(self.zero_cap_trans)
        return read


class NextseqQualityTrimmer(SingleEndModifier):
    """3' quality trimming that treats dark-cycle G runs as low quality."""

    def __init__(self, cutoff: int, base: int = 33):
        self.cutoff = cutoff
        self.base = base
        self.trimmed_bases = 0

    def __repr__(self):
        return f"NextseqQualityTrimmer(cutoff={self.cutoff}, base={self.base})"

    def __call__(self, read, info: ModificationInfo):
        stop = nextseq_trim_index(read, self.cutoff, self.base)
        self.trimmed_bases += len(read) - stop
        return read[:stop]


class QualityTrimmer(SingleEndModifier):
    """BWA-style quality trimming from either or both read ends."""

    def __init__(self, cutoff_front: int, cutoff_back: int, base: int = 33):
        self.cutoff_front = cutoff_front
        self.cutoff_back = cutoff_back
        self.base = base
        self.trimmed_bases = 0

    def __repr__(self):
        return (
            f"QualityTrimmer(cutoff_front={self.cutoff_front}, "
            f"cutoff_back={self.cutoff_back}, base={self.base})"
        )

    def __call__(self, read, info: ModificationInfo):
        start, stop = quality_trim_index(
            read.qualities, self.cutoff_front, self.cutoff_back, self.base
        )
        self.trimmed_bases += len(read) - (stop - start)
        return read[start:stop]


class PolyATrimmer(SingleEndModifier):
    """Trim poly-A tails (or, in revcomp mode, poly-T heads)."""

    def __init__(self, revcomp=False):
        self.trimmed_bases = defaultdict(int)
        self.revcomp = revcomp

    def __repr__(self):
        return "PolyATrimmer()"

    def __call__(self, record: SequenceRecord, info: ModificationInfo):
        if self.revcomp:
            index = poly_a_trim_index(record.sequence, revcomp=True)
            self.trimmed_bases[index] += 1
            return record[index:]
        index = poly_a_trim_index(record.sequence)
        self.trimmed_bases[len(record) - index] += 1
        return record[:index]


class Shortener(SingleEndModifier):
    """Shorten reads to the given length (negative: keep the end)."""

    def __init__(self, length):
        self.length = length

    def __repr__(self):
        return f"Shortener(length={self.length})"

    def __call__(self, read, info: ModificationInfo):
        if self.length >= 0:
            return read[: self.length]
        return read[self.length :]


class NEndTrimmer(SingleEndModifier):
    """Trim N runs from both ends of the read."""

    def __init__(self):
        self.start_trim = re.compile(r"^N+")
        self.end_trim = re.compile(r"N+$")

    def __repr__(self):
        return "NEndTrimmer()"

    def __call__(self, read, info: ModificationInfo):
        sequence = read.sequence
        head = self.start_trim.match(sequence)
        tail = self.end_trim.search(sequence)
        start = head.end() if head else 0
        stop = tail.start() if tail else len(read)
        return read[start:stop]
