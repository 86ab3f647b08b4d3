"""
Filtering criteria applied to reads after modification.

Each predicate is a *kind* — a stable snake_case identifier — plus at
most one numeric threshold. The kind does triple duty: it is the JSON
report key for the filter, the dispatch key for the batch engine's
vectorized filter evaluation (batch_pipeline.filter_condition runs the
same kinds over whole chunks on the fast path), and the name used when
translating a host pipeline onto the device (accel._translate_predicate
forwards ``(kind, threshold)`` verbatim). The scalar ``test`` methods
here are the oracle semantics those vector forms must reproduce.

Reference parity: predicates.py:10-173 of cutadapt:src/cutadapt.
"""

from abc import ABC, abstractmethod

from .qualtrim import expected_errors


class Predicate(ABC):
    """Base criterion. ``test`` returns True when the read should be
    acted on (usually: discarded or routed to a side output)."""

    #: stable identifier; also the batch-filter dispatch key
    kind: str = ""
    #: the kind's single numeric parameter (None if parameterless)
    threshold = None

    @abstractmethod
    def test(self, read, info) -> bool:
        """Scalar evaluation for one read."""

    @classmethod
    def descriptive_identifier(cls) -> str:
        """Identifier used for this filter in the JSON report."""
        return cls.kind

    def __repr__(self):
        if self.threshold is None:
            return f"{type(self).__name__}()"
        return f"{type(self).__name__}({self.threshold!r})"


class TooShort(Predicate):
    """Reads shorter than a minimum length."""

    kind = "too_short"

    def __init__(self, minimum_length: int):
        self.threshold = minimum_length

    def test(self, read, info) -> bool:
        return len(read) < self.threshold


class TooLong(Predicate):
    """Reads longer than a maximum length."""

    kind = "too_long"

    def __init__(self, maximum_length: int):
        self.threshold = maximum_length

    def test(self, read, info) -> bool:
        return len(read) > self.threshold


class TooManyExpectedErrors(Predicate):
    """Reads whose total expected error count (computed from the
    quality values; cf. usearch's -fastq_maxee) exceeds a threshold."""

    kind = "too_many_expected_errors"

    def __init__(self, max_errors: float):
        self.threshold = max_errors

    def test(self, read, info) -> bool:
        return expected_errors(read.qualities) > self.threshold


class TooHighAverageErrorRate(Predicate):
    """Reads whose expected error count *per base* exceeds a threshold
    (length-normalized variant for mixed-length inputs)."""

    kind = "too_high_average_error_rate"

    def __init__(self, max_error_rate: float):
        if not 0.0 < max_error_rate < 1.0:
            raise ValueError(
                f"max_error_rate must be between 0.0 and 1.0, "
                f"got {max_error_rate}."
            )
        self.threshold = max_error_rate

    def test(self, read, info) -> bool:
        n = len(read)
        return n > 0 and expected_errors(read.qualities) / n > self.threshold


class TooManyN(Predicate):
    """Reads with too many N bases: an absolute count when the cutoff
    is >= 1, a fraction of the read length when it is < 1."""

    kind = "too_many_n"

    def __init__(self, count: float):
        assert count >= 0
        self.threshold = count

    def test(self, read, info) -> bool:
        n_bases = read.sequence.lower().count("n")
        if self.threshold < 1.0:
            return len(read) > 0 and n_bases / len(read) > self.threshold
        return n_bases > self.threshold


class CasavaFiltered(Predicate):
    """Reads the CASAVA pipeline marked as filtered (a header second
    field of the form ``x:Y:x:x``)."""

    kind = "casava_filtered"

    def test(self, read, info) -> bool:
        comment = read.name.partition(" ")[2]
        return comment[1:4] == ":Y:"


class IsUntrimmed(Predicate):
    """Reads without any adapter match."""

    kind = "discard_untrimmed"

    def test(self, read, info) -> bool:
        return not info.matches


class IsTrimmed(Predicate):
    """Reads with at least one adapter match."""

    kind = "discard_trimmed"

    def test(self, read, info) -> bool:
        return bool(info.matches)
