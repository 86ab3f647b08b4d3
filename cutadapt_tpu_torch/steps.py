"""
Output pipeline steps: side-channel writers, filters, sinks and
demultiplexers. Each step either passes the read (pair) on or consumes
it; sinks and demultiplexers tally written-length statistics that the
report layer collects.

The three demultiplexers share one routing core (`_RoutedSink`): a
writers table keyed by the routing decision (adapter name, R1 adapter
name, or the R1×R2 name combination), an optional fallback writer for
unmatched reads, and a drop counter when there is no fallback.
Demultiplexing runs on this per-read path only: the GPU engine
(accel.py) refuses it.

Capability parity: cutadapt:src/cutadapt/steps.py:34-580.
"""

import itertools
from abc import ABC, abstractmethod
from typing import Any, Optional, Sequence, TextIO, Tuple

from .info import ModificationInfo
from .io.files import OutputFiles
from .io.records import SequenceRecord
from .predicates import Predicate
from .statistics import ReadLengthStatistics

RecordPair = Tuple[SequenceRecord, SequenceRecord]


class SingleEndStep(ABC):
    @abstractmethod
    def __call__(self, read, info: ModificationInfo) -> Optional[SequenceRecord]:
        """Process a read; return None if it was consumed."""


class PairedEndStep(ABC):
    @abstractmethod
    def __call__(
        self, read1, read2, info1: ModificationInfo, info2: ModificationInfo
    ) -> Optional[RecordPair]:
        """Process (read1, read2); return None if the pair was consumed."""


class HasStatistics(ABC):
    """Final steps (sinks) that track read length statistics."""

    @abstractmethod
    def get_statistics(self) -> ReadLengthStatistics:
        pass


class HasFilterStatistics(ABC):
    @abstractmethod
    def filtered(self) -> int:
        """Number of filtered reads or read pairs."""

    @abstractmethod
    def descriptive_identifier(self) -> str:
        """Name used in statistics."""


# --- filters -----------------------------------------------------------------


class SingleEndFilter(SingleEndStep, HasFilterStatistics):
    """Drop reads matching a predicate, optionally routing the dropped
    ones to a writer."""

    def __init__(self, predicate: Predicate, writer=None):
        self._filtered = 0
        self._predicate = predicate
        self._writer = writer

    def __repr__(self):
        return (
            f"SingleEndFilter(predicate={self._predicate}, "
            f"writer={self._writer})"
        )

    def descriptive_identifier(self) -> str:
        return self._predicate.descriptive_identifier()

    def filtered(self) -> int:
        return self._filtered

    def __call__(self, read, info) -> Optional[SequenceRecord]:
        if not self._predicate.test(read, info):
            return read
        self._filtered += 1
        if self._writer is not None:
            self._writer.write(read)
        return None


class PairedEndFilter(PairedEndStep, HasFilterStatistics):
    """
    Drop read pairs by predicate. With predicates on both sides,
    pair_filter_mode decides how the two verdicts combine: 'any'
    (either side suffices), 'both', or 'first' (R1 decides alone).
    """

    def __init__(
        self,
        predicate1: Optional[Predicate],
        predicate2: Optional[Predicate],
        writer=None,
        pair_filter_mode="any",
    ):
        if pair_filter_mode not in ("any", "both", "first"):
            raise ValueError("pair_filter_mode must be 'any', 'both' or 'first'")
        self._pair_filter_mode = pair_filter_mode
        self._filtered = 0
        self.predicate1 = predicate1
        self.predicate2 = predicate2
        self.writer = writer

    def __repr__(self):
        return (
            f"PairedEndFilter(predicate1={self.predicate1}, "
            f"predicate2={self.predicate2}, writer={self.writer}, "
            f"pair_filter_mode='{self._pair_filter_mode}')"
        )

    def descriptive_identifier(self) -> str:
        primary = self.predicate1 or self.predicate2
        assert primary is not None
        return primary.descriptive_identifier()

    def filtered(self) -> int:
        return self._filtered

    def _verdict(self, read1, read2, info1, info2) -> bool:
        if self.predicate2 is None:
            return self.predicate1.test(read1, info1)
        if self.predicate1 is None:
            return self.predicate2.test(read2, info2)
        mode = self._pair_filter_mode
        if mode == "first":
            return self.predicate1.test(read1, info1)
        if mode == "any":
            return self.predicate1.test(read1, info1) or self.predicate2.test(
                read2, info2
            )
        return self.predicate1.test(read1, info1) and self.predicate2.test(
            read2, info2
        )

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        if not self._verdict(read1, read2, info1, info2):
            return (read1, read2)
        self._filtered += 1
        if self.writer is not None:
            self.writer.write(read1, read2)
        return None


# --- side-channel writers ----------------------------------------------------


class RestFileWriter(SingleEndStep):
    """--rest-file: log the read part beyond the last adapter match."""

    def __init__(self, file: TextIO):
        self._file = file

    def __repr__(self):
        return f"RestFileWriter(file={self._file})"

    def __call__(self, read, info) -> Optional[SequenceRecord]:
        if info.matches:
            rest = info.matches[-1].rest()
            if rest:
                print(rest, read.name, file=self._file)
        return read


class WildcardFileWriter(SingleEndStep):
    """--wildcard-file: log the bases matched by adapter N wildcards."""

    def __init__(self, file: TextIO):
        self._file = file

    def __repr__(self):
        return f"WildcardFileWriter(file={self._file})"

    def __call__(self, read, info) -> Optional[SequenceRecord]:
        if info.matches:
            print(info.matches[-1].wildcards(), read.name, file=self._file)
        return read


class InfoFileWriter(SingleEndStep):
    """--info-file: one tab-separated row per adapter match (or a
    single -1 row for unmatched reads)."""

    RC_MAP = {None: "", True: "1", False: "0"}

    def __init__(self, file: TextIO):
        self._file = file

    def __repr__(self):
        return f"InfoFileWriter(file={self._file})"

    def __call__(self, read, info: ModificationInfo) -> Optional[SequenceRecord]:
        if not info.matches:
            qualities = read.qualities if read.qualities is not None else ""
            print(read.name, -1, read.sequence, qualities, sep="\t",
                  file=self._file)
            return read
        current = info.original_read
        if info.is_rc:
            current = current.reverse_complement()
        rc_flag = self.RC_MAP[info.is_rc]
        for match in info.matches:
            for row in match.get_info_records(current):
                # row[0] is a read-name suffix (linked-adapter phase)
                print(
                    read.name + row[0], *row[1:], rc_flag,
                    sep="\t", file=self._file,
                )
            current = match.trimmed(current)
        return read


class PairedInfoFileWriter(PairedEndStep):
    def __init__(self, file1: TextIO, file2: TextIO):
        self._info_writer1 = InfoFileWriter(file1)
        self._info_writer2 = InfoFileWriter(file2)

    def __repr__(self):
        return (
            f"PairedInfoFileWriter({self._info_writer1}, "
            f"{self._info_writer2})"
        )

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        self._info_writer1(read1, info1)
        self._info_writer2(read2, info2)
        return (read1, read2)


class PairedSingleEndStep(PairedEndStep):
    """Wrap a SingleEndStep; it is called with the first read only."""

    def __init__(self, step: SingleEndStep):
        self._step = step

    def __repr__(self):
        return f"PairedSingleEndStep(step={self._step})"

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        result = self._step(read1, info1)
        if result is None:
            return None
        return (result, read2)


# --- sinks -------------------------------------------------------------------


class SingleEndSink(SingleEndStep, HasStatistics):
    """Write each read to a writer; used as the last pipeline step."""

    def __init__(self, writer):
        self.writer = writer
        self._statistics = ReadLengthStatistics()

    def __repr__(self):
        return f"SingleEndSink({self.writer})"

    def __call__(self, read, info) -> Optional[SequenceRecord]:
        self.writer.write(read)
        self._statistics.update(read)
        return None

    def get_statistics(self) -> ReadLengthStatistics:
        return self._statistics


class PairedEndSink(PairedEndStep, HasStatistics):
    """Write each read pair to a writer; the last pipeline step."""

    def __init__(self, writer):
        self.writer = writer
        self._statistics = ReadLengthStatistics()

    def __repr__(self):
        return f"PairedEndSink({self.writer})"

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        self.writer.write(read1, read2)
        self._statistics.update2(read1, read2)
        return None

    def get_statistics(self) -> ReadLengthStatistics:
        return self._statistics


# --- demultiplexers ----------------------------------------------------------


def _fill_template(template: str, **names: Optional[str]) -> str:
    """Substitute {key} placeholders, using 'unknown' for None."""
    for key, value in names.items():
        template = template.replace(
            "{" + key + "}", value if value is not None else "unknown"
        )
    return template


class _RoutedSink(HasStatistics):
    """Routing core shared by the demultiplexers: deliver each read
    (pair) to the writer its routing key selects, to the fallback
    writer when there is no key, or count it as dropped."""

    def __init__(self):
        self._writers: dict = {}
        self._untrimmed_writer = None  # fallback for unmatched reads
        self._statistics = ReadLengthStatistics()
        self._filtered = 0

    def _deliver(self, key: Any, *reads) -> None:
        writer = (
            self._writers[key] if key in self._writers
            else self._untrimmed_writer
        )
        if writer is None:
            self._filtered += 1
            return
        if len(reads) == 1:
            self._statistics.update(reads[0])
        else:
            self._statistics.update2(*reads)
        writer.write(*reads)

    def descriptive_identifier(self) -> str:
        return "discard_untrimmed"

    def get_statistics(self) -> ReadLengthStatistics:
        return self._statistics

    def filtered(self) -> int:
        return self._filtered


def _last_adapter_name(info: ModificationInfo) -> Optional[str]:
    return info.matches[-1].adapter.name if info.matches else None


class Demultiplexer(_RoutedSink, SingleEndStep, HasFilterStatistics):
    """Route each read to an output file by its last adapter match
    (``{name}`` template); unmatched reads go to the untrimmed output
    unless discarded."""

    def __init__(
        self,
        adapter_names: Sequence[str],
        template: str,
        untrimmed_output: Optional[str],
        discard_untrimmed: bool,
        outfiles: OutputFiles,
    ):
        super().__init__()
        for name in adapter_names:
            self._writers[name] = outfiles.open_record_writer(
                _fill_template(template, name=name)
            )
        if not discard_untrimmed:
            fallback_path = untrimmed_output or _fill_template(
                template, name=None
            )
            self._untrimmed_writer = outfiles.open_record_writer(fallback_path)

    def __repr__(self):
        return f"<Demultiplexer len(writers)={len(self._writers)}>"

    def __call__(self, read, info) -> Optional[SequenceRecord]:
        self._deliver(_last_adapter_name(info), read)
        return None


class PairedDemultiplexer(_RoutedSink, PairedEndStep, HasFilterStatistics):
    """Route read pairs to output files; the R1 match decides."""

    def __init__(
        self,
        adapter_names: Sequence[str],
        template1: str,
        template2: str,
        untrimmed_output: Optional[str],
        untrimmed_paired_output: Optional[str],
        discard_untrimmed: bool,
        outfiles: OutputFiles,
    ):
        super().__init__()
        for name in adapter_names:
            self._writers[name] = outfiles.open_record_writer(
                _fill_template(template1, name=name),
                _fill_template(template2, name=name),
            )
        if not discard_untrimmed:
            self._untrimmed_writer = outfiles.open_record_writer(
                untrimmed_output or _fill_template(template1, name=None),
                untrimmed_paired_output or _fill_template(template2, name=None),
            )

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        assert read2 is not None
        self._deliver(_last_adapter_name(info1), read1, read2)
        return None


class CombinatorialDemultiplexer(_RoutedSink, PairedEndStep):
    """Route read pairs by the combination of R1 and R2 matches
    (``{name1}``/``{name2}`` templates). Without --discard-untrimmed,
    every partially- and fully-unmatched combination gets its own
    'unknown' output; with it, those pairs are dropped."""

    def __init__(
        self,
        adapter_names,
        adapter_names2,
        template1: str,
        template2: str,
        discard_untrimmed: bool,
        outfiles: OutputFiles,
    ):
        super().__init__()
        keys = list(itertools.product(adapter_names, adapter_names2))
        if not discard_untrimmed:
            keys.append((None, None))
            keys.extend((None, name2) for name2 in adapter_names2)
            keys.extend((name1, None) for name1 in adapter_names)
        for name1, name2 in keys:
            self._writers[(name1, name2)] = outfiles.open_record_writer(
                _fill_template(template1, name1=name1, name2=name2),
                _fill_template(template2, name1=name1, name2=name2),
            )

    def __call__(self, read1, read2, info1, info2) -> Optional[RecordPair]:
        assert read2 is not None
        key = (_last_adapter_name(info1), _last_adapter_name(info2))
        if key in self._writers:
            self._deliver(key, read1, read2)
        return None

    def get_statistics(self) -> ReadLengthStatistics:
        return self._statistics
