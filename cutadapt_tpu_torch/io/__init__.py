"""Sequence I/O: records, FASTA/FASTQ/BAM parsing, compressed files and
record-aligned FASTQ chunks."""

from .records import (
    BamFormatError,
    FastaFormatError,
    FastqFormatError,
    FileFormatError,
    SequenceRecord,
    UnknownFileFormat,
    record_names_match,
    records_are_mates,
    reverse_complement,
)
from .fastq import (
    open_sequence_file,
    parse_fasta,
    parse_fastq,
    read_chunks,
    read_paired_chunks,
)
from .compressed import xopen
from .chunks import ParsedChunk, assemble_window, parse_fastq_chunk

__all__ = [
    "BamFormatError",
    "FastaFormatError",
    "FastqFormatError",
    "FileFormatError",
    "ParsedChunk",
    "SequenceRecord",
    "UnknownFileFormat",
    "assemble_window",
    "open_sequence_file",
    "parse_fasta",
    "parse_fastq",
    "parse_fastq_chunk",
    "read_chunks",
    "read_paired_chunks",
    "record_names_match",
    "records_are_mates",
    "reverse_complement",
    "xopen",
]
