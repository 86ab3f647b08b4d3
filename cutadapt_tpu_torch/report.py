"""
Statistics collection and report rendering (text, minimal TSV, JSON).

The Statistics object is the single mergeable summary of a run: every
field either sums, Counter-merges, or must agree across shards, and
``+=`` applies the right rule per field. That merge contract is what
multicore workers rely on: their summaries merge and render
identically to a single-worker run.

Rendering is split per concern: a summary block, a read-fate table, a
per-adapter section laid out by the adapter statistics' kind
('front' / 'back' / 'both' / 'linked'), and poly-A tables. The exact
output text is a compatibility surface (byte-parity with the
reference's reports, cutadapt:src/cutadapt/report.py:81-900)
and must not drift.
"""

import textwrap
from collections import Counter, defaultdict
from dataclasses import dataclass
from io import StringIO
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from .adapters import (
    AdapterStatistics, AnywhereAdapter, BackAdapter, EndStatistics,
    FrontAdapter, LinkedAdapter, SingleAdapter,
)
from .json_utils import OneLine
from .modifiers import (
    AdapterCutter, NextseqQualityTrimmer, PairedAdapterCutter,
    PairedEndModifierWrapper, PairedReverseComplementer, PolyATrimmer,
    QualityTrimmer, ReverseComplementer,
)
from .statistics import ReadLengthStatistics
from .steps import HasFilterStatistics, HasStatistics

# filter kind -> read-fate table wording (report contract text)
FILTERS = dict(
    too_short="that were too short",
    too_long="that were too long",
    too_many_n="with too many N",
    too_many_expected_errors="with too many exp. errors",
    casava_filtered="failed CASAVA filter",
    discard_trimmed="discarded as trimmed",
    discard_untrimmed="discarded as untrimmed",
)


def safe_divide(numerator: Optional[int], denominator: int) -> float:
    return numerator / denominator if numerator and denominator else 0.0


def add_if_not_none(a: Optional[int], b: Optional[int]) -> Optional[int]:
    return b if a is None else a if b is None else a + b


def _merge_optional_counter(
    mine: Optional[Dict[int, int]], theirs: Optional[Dict[int, int]]
) -> Optional[Dict[int, int]]:
    if mine is None:
        return theirs
    if theirs is None:
        return mine
    return defaultdict(int, Counter(mine) + Counter(theirs))


class Statistics:
    """Mergeable summary of one (partial) run.

    Field-by-field merge rules (`_SIDED_MERGES` + the scalar rules in
    ``__iadd__``) define the shard-reduction contract."""

    # per-side list fields merged element-wise: attr -> merge function
    _SIDED_MERGES = (
        ("total_bp", lambda a, b: a + b),
        ("with_adapters", add_if_not_none),
        ("quality_trimmed_bp", add_if_not_none),
        ("poly_a_trimmed_lengths", _merge_optional_counter),
    )

    def __init__(self) -> None:
        self.__dict__.update(
            paired=None,
            # filter name -> number of filtered reads/read pairs
            filtered=defaultdict(int),
            reverse_complemented=None,
            n=0,
            total_bp=[0, 0],
            read_length_statistics=ReadLengthStatistics(),
            with_adapters=[None, None],
            quality_trimmed_bp=[None, None],
            poly_a_trimmed_lengths=[None, None],
            adapter_stats=[[], []],
            _collected=False,
        )

    # --- merging (the shard-reduction contract) -----------------------

    def __iadd__(self, other: Any):
        if not isinstance(other, Statistics):
            raise ValueError(f"Cannot add {other.__class__.__name__}")
        if self.paired is None:
            self.paired = other.paired
        elif self.paired != other.paired:
            raise ValueError("Incompatible Statistics: paired is not equal")

        self.n += other.n
        self.read_length_statistics += other.read_length_statistics
        self.reverse_complemented = add_if_not_none(
            self.reverse_complemented, other.reverse_complemented
        )
        for name, count in other.filtered.items():
            self.filtered[name] += count

        for side in (0, 1):
            for attr, merge in self._SIDED_MERGES:
                mine, theirs = getattr(self, attr), getattr(other, attr)
                mine[side] = merge(mine[side], theirs[side])
            self._merge_adapter_stats(side, other.adapter_stats[side])
        return self

    def _merge_adapter_stats(self, side: int, theirs: List[AdapterStatistics]):
        mine = self.adapter_stats[side]
        if not theirs:
            return
        if not mine:
            self.adapter_stats[side] = theirs
            return
        if len(mine) != len(theirs):
            raise ValueError(
                "Incompatible Statistics objects (adapter_stats length)"
            )
        for j, other_stats in enumerate(theirs):
            mine[j] += other_stats

    # --- collection from pipeline objects -----------------------------

    def collect(
        self, n: int, total_bp1: int, total_bp2: Optional[int], modifiers, steps
    ):
        """
        n -- total number of reads
        total_bp1 -- number of bases in first reads
        total_bp2 -- number of bases in second reads; None for single-end
        """
        if self._collected:
            raise ValueError("Cannot call Statistics.collect more than once")
        self.n = n
        self.total_bp[0] = total_bp1
        self.paired = total_bp2 is not None
        if total_bp2 is not None:
            self.total_bp[1] = total_bp2

        for step in steps:
            if isinstance(step, HasStatistics):
                self.read_length_statistics += step.get_statistics()
            if isinstance(step, HasFilterStatistics):
                self.filtered[step.descriptive_identifier()] = step.filtered()
        for modifier in modifiers:
            self._collect_modifier(modifier)
        self._collected = True
        return self

    def _take_cutter(self, side: int, cutter: AdapterCutter) -> None:
        """Fold one AdapterCutter's tallies into one read side."""
        if self.with_adapters[side] is None:
            self.with_adapters[side] = cutter.with_adapters
            self.adapter_stats[side] = list(cutter.adapter_statistics.values())
        else:
            self.with_adapters[side] += cutter.with_adapters
            self.adapter_stats[side] += list(cutter.adapter_statistics.values())

    def _collect_modifier(self, m) -> None:
        if isinstance(m, PairedAdapterCutter):
            for side in (0, 1):
                self.with_adapters[side] = m.with_adapters
                self.adapter_stats[side] = list(
                    m.adapter_statistics[side].values()
                )
            return
        if isinstance(m, PairedEndModifierWrapper):
            per_side = [(0, m._modifier1), (1, m._modifier2)]
        elif isinstance(m, PairedReverseComplementer):
            per_side = [(0, m.adapter_cutter1), (1, m.adapter_cutter2)]
            self.reverse_complemented = m.reverse_complemented
        else:
            per_side = [(0, m)]
        for side, modifier in per_side:
            if isinstance(modifier, (QualityTrimmer, NextseqQualityTrimmer)):
                self.quality_trimmed_bp[side] = add_if_not_none(
                    self.quality_trimmed_bp[side], modifier.trimmed_bases
                )
            if isinstance(modifier, PolyATrimmer):
                self.poly_a_trimmed_lengths[side] = modifier.trimmed_bases
            elif isinstance(modifier, AdapterCutter):
                self._take_cutter(side, modifier)
            elif isinstance(modifier, ReverseComplementer):
                first = self.with_adapters[side] is None
                self._take_cutter(side, modifier.adapter_cutter)
                if first:
                    self.reverse_complemented = modifier.reverse_complemented
                else:
                    self.reverse_complemented = add_if_not_none(
                        self.reverse_complemented, modifier.reverse_complemented
                    )

    # --- JSON ----------------------------------------------------------

    def as_json(self, gc_content: float = 0.5, one_line: bool = False) -> Dict:
        """Return a dict representation suitable for the JSON report.

        Key names and nesting are the reference's JSON schema 0.3
        (contract); built here as (key, value) rows per section."""
        filtered = {name: self.filtered.get(name) for name in FILTERS}
        written_reads = self.read_length_statistics.written_reads()
        written_bp = self.read_length_statistics.written_bp()
        assert written_reads + sum(self.filtered.values()) == self.n
        if_paired = lambda v: v if self.paired else None  # noqa: E731

        def adapters_json(side):
            return [
                self._adapter_statistics_as_json(
                    astats, self.n, gc_content, one_line=one_line
                )
                for astats in self.adapter_stats[side]
            ]

        read_counts = (  # pairs or reads
            ("input", self.n),
            ("filtered", filtered),
            ("output", written_reads),
            ("reverse_complemented", self.reverse_complemented),
            ("read1_with_adapter", self.with_adapters[0]),
            ("read2_with_adapter", if_paired(self.with_adapters[1])),
        )
        basepair_counts = (
            ("input", self.total),
            ("input_read1", self.total_bp[0]),
            ("input_read2", if_paired(self.total_bp[1])),
            ("quality_trimmed", self.quality_trimmed),
            ("quality_trimmed_read1", self.quality_trimmed_bp[0]),
            ("quality_trimmed_read2", self.quality_trimmed_bp[1]),
            ("poly_a_trimmed", self.poly_a_trimmed),
            ("poly_a_trimmed_read1", self.poly_a_trimmed_bp[0]),
            ("poly_a_trimmed_read2", self.poly_a_trimmed_bp[1]),
            ("output", self.total_written_bp),
            ("output_read1", written_bp[0]),
            ("output_read2", if_paired(written_bp[1])),
        )
        top = (
            ("read_counts", dict(read_counts)),
            ("basepair_counts", dict(basepair_counts)),
            ("adapters_read1", adapters_json(0)),
            ("adapters_read2", if_paired(adapters_json(1))),
            (
                "poly_a_trimmed_read1",
                self._poly_a_trimmed_as_json(self.poly_a_trimmed_lengths[0]),
            ),
            (
                "poly_a_trimmed_read2",
                self._poly_a_trimmed_as_json(self.poly_a_trimmed_lengths[1]),
            ),
        )
        return dict(top)

    def _adapter_statistics_as_json(
        self,
        adapter_statistics: AdapterStatistics,
        n: int,
        gc_content: float,
        one_line: bool = False,
    ):
        make_line = OneLine if one_line else (lambda value: value)

        def end_json(es: Optional[EndStatistics]):
            """(json-dict-or-None, match count) for one adapter end."""
            if es is None:
                return None, 0
            total = sum(es.lengths.values())
            eranges = (
                error_range_lengths(es.effective_length, es.max_error_rate)
                if es.allows_partial_matches else None
            )
            base_stats = AdjacentBaseStatistics(es.adjacent_bases)
            rows = [
                make_line(dict(
                    len=row.length,
                    expect=round(row.expect, 1),
                    counts=row.error_counts,
                ))
                for row in histogram_rows(es, n, gc_content)
            ]
            return dict((
                ("type", es.adapter_type),
                ("sequence", es.sequence),
                ("error_rate", es.max_error_rate),
                ("indels", es.indels),
                ("error_lengths", make_line(eranges)),
                ("matches", total),
                ("adjacent_bases", base_stats.as_json()),
                ("dominant_adjacent_base", base_stats.warnbase),
                ("trimmed_lengths", rows),
            )), total

        ends, totals = zip(
            *map(end_json, adapter_statistics.end_statistics())
        )
        return dict((
            ("name", adapter_statistics.name),
            ("total_matches", sum(totals)),
            ("on_reverse_complement", (
                adapter_statistics.reverse_complemented
                if self.reverse_complemented else None
            )),
            ("linked",
             isinstance(adapter_statistics.adapter, LinkedAdapter)),
            ("five_prime_end", ends[0]),
            ("three_prime_end", ends[1]),
        ))

    @staticmethod
    def _poly_a_trimmed_as_json(poly_a):
        if poly_a is None:
            return None
        return [
            OneLine({"len": length, "count": poly_a[length]})
            for length in sorted(poly_a)
        ]

    # --- derived quantities --------------------------------------------

    total = property(lambda s: sum(s.total_bp))
    quality_trimmed = property(
        lambda s: add_if_not_none(*s.quality_trimmed_bp)
    )
    poly_a_trimmed = property(
        lambda s: add_if_not_none(*s.poly_a_trimmed_bp)
    )
    total_written_bp = property(
        lambda s: sum(s.read_length_statistics.written_bp())
    )
    written = property(
        lambda s: s.read_length_statistics.written_reads()
    )
    written_bp = property(
        lambda s: s.read_length_statistics.written_bp()
    )

    @property
    def poly_a_trimmed_bp(self) -> Tuple[Optional[int], Optional[int]]:
        return tuple(
            None if lengths is None
            else sum(ln * count for ln, count in lengths.items())
            for lengths in self.poly_a_trimmed_lengths
        )

    # <numerator attr> as a fraction of <denominator attr>
    def _fraction(num: str, den: str):  # noqa: N805 (descriptor maker)
        return property(
            lambda s: safe_divide(getattr(s, num), getattr(s, den))
        )

    written_fraction = _fraction("written", "n")
    quality_trimmed_fraction = _fraction("quality_trimmed", "total")
    total_written_bp_fraction = _fraction("total_written_bp", "total")
    reverse_complemented_fraction = _fraction("reverse_complemented", "n")
    poly_a_trimmed_fraction = _fraction("poly_a_trimmed", "total")
    del _fraction

    @property
    def with_adapters_fraction(self) -> List[float]:
        return [safe_divide(v, self.n) for v in self.with_adapters]

    def filtered_fraction(self, filter_name: str) -> float:
        return safe_divide(self.filtered.get(filter_name), self.n)


# --- error-range table -------------------------------------------------------


def error_range_lengths(length: int, error_rate: float) -> List[int]:
    """Longest overlap length for each allowed error count, ascending:
    element e is the largest length at which e errors are accepted."""
    k = int(error_rate * length)
    lengths = [int(e / error_rate) - 1 for e in range(1, k + 1)]
    return lengths + ([length] if not lengths or lengths[-1] < length else [])


def format_error_ranges(length: int, error_rate: float) -> str:
    """'1-9 bp: 0; 10-19 bp: 1; ...' — each band of overlap lengths
    with its allowed error count."""
    uppers = error_range_lengths(length, error_rate)
    lowers = [1] + [u + 1 for u in uppers[:-1]]
    final = len(uppers) - 1
    bands = [
        # only the final band collapses to the single-length form
        f"{lo} bp" if i == final and lo == up else f"{lo}-{up} bp"
        for i, (lo, up) in enumerate(zip(lowers, uppers))
    ]
    return "; ".join(f"{band}: {e}" for e, band in enumerate(bands))


class ErrorRanges:
    """Pretty-printer for the allowed-errors-by-length table (kept as
    a class for API parity with the reference's report module)."""

    def __init__(self, length: int, error_rate: float):
        self.length = length
        self.error_rate = error_rate
        self._lengths = error_range_lengths(length, error_rate)

    def __repr__(self):
        args = (
            f"length={self.length}, error_rate={self.error_rate}, "
            f"_lengths={self._lengths}"
        )
        return f"ErrorRanges({args})"

    def __str__(self):
        return format_error_ranges(self.length, self.error_rate)

    def lengths(self):
        return self._lengths


def error_ranges(end_statistics: EndStatistics) -> str:
    """The 'No. of allowed errors:' block for one adapter end."""
    length = end_statistics.effective_length
    rate = end_statistics.max_error_rate
    body = (
        "\n" + format_error_ranges(length, rate)
        if end_statistics.allows_partial_matches
        else f" {int(rate * length)}"
    )
    return f"No. of allowed errors:{body}\n"


# --- histograms --------------------------------------------------------------


@dataclass
class HistogramRow:
    """One row in the 'trimmed lengths' histogram."""

    length: int
    count: int
    expect: float
    max_err: int
    error_counts: List[int]


def histogram_rows(
    end_statistics: EndStatistics,
    n: int,
    gc_content: float,
) -> Iterator[HistogramRow]:
    """Yield histogram rows. n -- total number of reads."""
    es = end_statistics
    chance = es.random_match_probabilities(gc_content=gc_content)
    cap = len(es.sequence)  # beyond it the chance stops increasing
    for length, count in sorted(es.lengths.items()):
        by_errors = es.errors[length]
        yield HistogramRow(
            length=length,
            count=count,
            expect=n * chance[min(cap, length)],
            max_err=int(
                es.max_error_rate * min(length, es.effective_length)
            ),
            error_counts=[
                by_errors[e] for e in range(max(by_errors) + 1)
            ],
        )


def histogram(end_statistics: EndStatistics, n: int, gc_content: float) -> str:
    """
    Formatted histogram of trimmed lengths, including the number of
    reads expected to be trimmed by chance.
    """
    lines = ["length\tcount\texpect\tmax.err\terror counts"]
    lines += [
        "\t".join((
            str(row.length), str(row.count), f"{row.expect:.1F}",
            str(row.max_err),
            " ".join(map(str, row.error_counts)),
        ))
        for row in histogram_rows(end_statistics, n, gc_content)
    ]
    return "\n".join(lines) + "\n\n"


class AdjacentBaseStatistics:
    """Distribution of the base preceding removed 3' adapters; warns
    when one base dominates (likely incomplete adapter sequence)."""

    _ORDER = ("A", "C", "G", "T", "")

    def __init__(self, bases: Dict[str, int]):
        self.bases: Dict[str, int] = bases
        self._warnbase: Optional[str] = None
        total = sum(self.bases.values())
        self._fractions = None
        if total == 0:
            return
        self._fractions = [
            (base or "none/other", self.bases[base] / total)
            for base in self._ORDER
        ]
        dominant = [
            label for (label, fraction), base in zip(
                self._fractions, self._ORDER
            )
            if base and fraction > 0.8
        ]
        # under 20 observations a dominant base is not meaningful
        if dominant and total >= 20:
            self._warnbase = dominant[-1]

    def __repr__(self):
        return f"AdjacentBaseStatistics(bases={self.bases})"

    should_warn = property(lambda s: s._warnbase is not None)
    warnbase = property(lambda s: s._warnbase)

    def __str__(self) -> str:
        if not self._fractions:
            return ""
        lines = ["Bases preceding removed adapters:"] + [
            f"  {label}: {fraction:.1%}"
            for label, fraction in self._fractions
        ]
        if self.should_warn:
            lines += [
                "WARNING:",
                f"    The adapter is preceded by '{self._warnbase}'"
                " extremely often.",
                "    The provided adapter sequence could be incomplete"
                " at its 5' end.",
                "    Ignore this warning when trimming primers.",
            ]
        return "\n".join(lines) + "\n"

    def as_json(self) -> Optional[Dict[str, int]]:
        if not self._fractions:
            return None
        return {b: self.bases.get(b, 0) for b in self._ORDER}


# --- text reports ------------------------------------------------------------


def _summary_block(stats: Statistics) -> str:
    """The '=== Summary ===' block (counts, fate breakdown, bp totals)."""
    report = "\n=== Summary ===\n\n"
    if stats.paired:
        report += f"Total read pairs processed:      {stats.n:13,d}\n"
        for i in (0, 1):
            if stats.with_adapters[i] is not None:
                report += (
                    f"  Read {i+1} with adapter:           "
                    f"{stats.with_adapters[i]:13,d} "
                    f"({stats.with_adapters_fraction[i]:.1%})\n"
                )
    else:
        report += f"Total reads processed:           {stats.n:13,d}\n"
        if stats.with_adapters[0] is not None:
            report += (
                f"Reads with adapters:             "
                f"{stats.with_adapters[0]:13,d} "
                f"({stats.with_adapters_fraction[0]:.1%})\n"
            )

    if stats.reverse_complemented is not None:
        report += (
            "Reverse-complemented:            "
            "{o.reverse_complemented:13,d} ({o.reverse_complemented_fraction:.1%})\n"
        )

    filter_report = format_filter_report(stats)
    if filter_report:
        report += "\n== Read fate breakdown ==\n"
        report += filter_report

    report += textwrap.dedent(
        """\
    {pairs_or_reads} written (passing filters): {o.written:13,d} ({o.written_fraction:.1%})

    Total basepairs processed: {o.total:13,d} bp
    """
    )
    if stats.paired:
        report += "  Read 1: {o.total_bp[0]:13,d} bp\n"
        report += "  Read 2: {o.total_bp[1]:13,d} bp\n"

    if stats.quality_trimmed is not None:
        report += (
            "Quality-trimmed:           "
            f"{stats.quality_trimmed:13,d} bp "
            f"({stats.quality_trimmed_fraction:.1%})\n"
        )
        if stats.paired:
            for i in (0, 1):
                if stats.quality_trimmed_bp[i] is not None:
                    report += (
                        f"  Read {i + 1}: {stats.quality_trimmed_bp[i]:13,d} bp\n"
                    )

    if stats.poly_a_trimmed is not None:
        report += (
            "Poly-A-trimmed:            "
            f"{stats.poly_a_trimmed:13,d} bp ({stats.poly_a_trimmed_fraction:.1%})\n"
        )
        if stats.paired:
            for i in (0, 1):
                if stats.poly_a_trimmed_bp[i] is not None:
                    report += (
                        f"  Read {i + 1}: {stats.poly_a_trimmed_bp[i]:13,d} bp\n"
                    )

    report += (
        "Total written (filtered):  "
        "{o.total_written_bp:13,d} bp ({o.total_written_bp_fraction:.1%})\n"
    )
    if stats.paired:
        report += "  Read 1: {o.written_bp[0]:13,d} bp\n"
        report += "  Read 2: {o.written_bp[1]:13,d} bp\n"
    pairs_or_reads = "Pairs" if stats.paired else "Reads"
    return report.format(o=stats, pairs_or_reads=pairs_or_reads)


def _adapter_header_line(
    adapter_statistics: AdapterStatistics, total_front, total_back, total
) -> str:
    """The 'Sequence: ...; Type: ...' line (without rc suffix)."""
    adapter = adapter_statistics.adapter
    if adapter_statistics.kind == "linked":
        front_seq = adapter_statistics.front.sequence
        back_seq = adapter_statistics.back.sequence
        return (
            f"Sequence: {front_seq}...{back_seq}; Type: linked; "
            f"Length: {len(front_seq)}+{len(back_seq)}; "
            f"5' trimmed: {total_front} times; "
            f"3' trimmed: {total_back} times"
        )
    assert isinstance(adapter, (SingleAdapter, AnywhereAdapter))
    return (
        f"Sequence: {adapter.sequence}; Type: {adapter.description}; "
        f"Length: {len(adapter.sequence)}; Trimmed: {total} times"
    )


def _adapter_detail_section(
    print_s, stats, adapter_statistics, total_front, total_back, gc_content
) -> bool:
    """Per-kind detail block; returns whether an incomplete-adapter
    warning was triggered."""
    adapter = adapter_statistics.adapter
    kind = adapter_statistics.kind
    n = stats.n
    if kind == "both":
        assert isinstance(adapter, AnywhereAdapter)
        print_s(total_front, "times, it overlapped the 5' end of a read")
        print_s(
            total_back,
            "times, it overlapped the 3' end or was within the read",
        )
        print_s()
        print_s("Minimum overlap:", adapter.min_overlap)
        print_s(error_ranges(adapter_statistics.front))
        print_s("Overview of removed sequences (5')")
        print_s(histogram(adapter_statistics.front, n, gc_content))
        print_s()
        print_s("Overview of removed sequences (3' or within)")
        print_s(histogram(adapter_statistics.back, n, gc_content))
        return False
    if kind == "linked":
        assert isinstance(adapter, LinkedAdapter)
        print_s()
        print_s(
            f"Minimum overlap: "
            f"{adapter.front_adapter.min_overlap}"
            f"+{adapter.back_adapter.min_overlap}"
        )
        print_s(error_ranges(adapter_statistics.front))
        print_s(error_ranges(adapter_statistics.back))
        print_s("Overview of removed sequences at 5' end")
        print_s(histogram(adapter_statistics.front, n, gc_content))
        print_s()
        print_s("Overview of removed sequences at 3' end")
        print_s(histogram(adapter_statistics.back, n, gc_content))
        return False
    if kind == "front":
        assert isinstance(adapter, FrontAdapter)
        print_s()
        if adapter.allows_partial_matches:
            print_s("Minimum overlap:", adapter.min_overlap)
        print_s(error_ranges(adapter_statistics.end))
        print_s("Overview of removed sequences")
        print_s(histogram(adapter_statistics.end, n, gc_content))
        return False
    assert kind == "back"
    assert isinstance(adapter, BackAdapter)
    print_s()
    if adapter.allows_partial_matches:
        print_s("Minimum overlap:", adapter.min_overlap)
    print_s(error_ranges(adapter_statistics.end))
    base_stats = AdjacentBaseStatistics(adapter_statistics.end.adjacent_bases)
    print_s(base_stats)
    print_s("Overview of removed sequences")
    print_s(histogram(adapter_statistics.end, n, gc_content))
    return base_stats.should_warn


def full_report(stats: Statistics, time: float, gc_content: float) -> str:
    """Render the full human-readable report."""
    if stats.n == 0:
        return "No reads processed!"
    sio = StringIO()

    def print_s(*args, **kwargs):
        kwargs["file"] = sio
        print(*args, **kwargs)

    print_s(_summary_block(stats))

    warning = False
    for which_in_pair in (0, 1):
        for adapter_statistics in stats.adapter_stats[which_in_pair]:
            front_end, back_end = adapter_statistics.end_statistics()
            total_front = (
                sum(front_end.lengths.values()) if front_end is not None else 0
            )
            total_back = (
                sum(back_end.lengths.values()) if back_end is not None else 0
            )
            total = total_front + total_back
            adapter = adapter_statistics.adapter
            if isinstance(adapter, BackAdapter):
                assert total_front == 0
            if isinstance(adapter, FrontAdapter):
                assert total_back == 0

            if stats.paired:
                extra = "First read: " if which_in_pair == 0 else "Second read: "
            else:
                extra = ""
            print_s("=" * 3, extra + "Adapter", adapter_statistics.name, "=" * 3)
            print_s()
            print_s(
                _adapter_header_line(
                    adapter_statistics, total_front, total_back, total
                ),
                end="",
            )
            if stats.reverse_complemented is not None:
                print_s(
                    f"; Reverse-complemented: "
                    f"{adapter_statistics.reverse_complemented} times"
                )
            else:
                print_s()
            if total == 0:
                print_s()
                continue
            warned = _adapter_detail_section(
                print_s, stats, adapter_statistics, total_front, total_back,
                gc_content,
            )
            warning = warning or warned

        poly_a = stats.poly_a_trimmed_lengths[which_in_pair]
        if poly_a is not None:
            print_s(poly_a_report(poly_a, which_in_pair if stats.paired else None))

    if warning:
        print_s("WARNING:")
        print_s("    One or more of your adapter sequences may be incomplete.")
        print_s("    Please see the detailed output above.")

    return sio.getvalue().rstrip()


def poly_a_report(poly_a: Mapping[int, int], which_in_pair: Optional[int]) -> str:
    titles = {None: "Poly-A", 0: "R1 poly-A", 1: "R2 poly-A"}
    sio = StringIO()
    print(f"=== {titles[which_in_pair]} trimmed ===", file=sio)
    print(file=sio)
    print("length", "count", sep="\t", file=sio)
    for length in sorted(poly_a):
        print(length, poly_a[length], sep="\t", file=sio)
    return sio.getvalue() + "\n"


def format_filter_report(stats):
    report = ""
    for name, description in FILTERS.items():
        if name not in stats.filtered:
            continue
        value = stats.filtered[name]
        fraction = stats.filtered_fraction(name)
        report += (
            "{pairs_or_reads} "
            + (description + ":").ljust(27)
            + f"{value:13,d} ({fraction:.1%})\n"
        )
    return report


def minimal_report(stats: Statistics, time: float, gc_content: float) -> str:
    """Create a minimal tabular report suitable for concatenation."""
    del time, gc_content

    written_bp = stats.read_length_statistics.written_bp()
    incomplete_adapter = any(
        astats.kind == "back"
        and AdjacentBaseStatistics(astats.end.adjacent_bases).should_warn
        for astats in stats.adapter_stats[0] + stats.adapter_stats[1]
    )
    columns = [  # (header, value) pairs; column order is contract
        ("status", "WARN" if incomplete_adapter else "OK"),
        ("in_reads", stats.n),
        ("in_bp", stats.total),
        ("too_short", stats.filtered.get("too_short", 0)),
        ("too_long", stats.filtered.get("too_long", 0)),
        ("too_many_n", stats.filtered.get("too_many_n", 0)),
        ("out_reads", stats.read_length_statistics.written_reads()),
        ("w/adapters", stats.with_adapters[0] or 0),
        ("qualtrim_bp", stats.quality_trimmed_bp[0] or 0),
        ("out_bp", written_bp[0]),
    ]
    if stats.paired:
        columns += [
            ("w/adapters2", stats.with_adapters[1] or 0),
            ("qualtrim2_bp", stats.quality_trimmed_bp[1] or 0),
            ("out2_bp", written_bp[1]),
        ]
    return "\t".join(h for h, _ in columns) + "\n" + "\t".join(
        str(v) for _, v in columns
    )
