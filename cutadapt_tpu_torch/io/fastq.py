"""
FASTA/FASTQ/BAM reading and writing, and record-boundary chunking.

This is the engine's own sequence-I/O layer (capability equivalent of
the reference's external ``dnaio`` dependency; the chunking contract
mirrors dnaio.read_chunks/read_paired_chunks as used in
cutadapt:src/cutadapt/runners.py:116-126).

Readers accept binary file objects. CRLF line endings are tolerated
and stripped. Writers always emit '\n'. FASTA output is unwrapped.
"""

import io
import struct
from os import fspath
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from .. import tracing
from .records import (
    BamFormatError,
    FastaFormatError,
    FastqFormatError,
    FileFormatError,
    SequenceRecord,
    UnknownFileFormat,
    record_names_match,
)

# ---------------------------------------------------------------------------
# Format detection


def detect_format_from_name(name: str) -> Optional[str]:
    """Guess the sequence file format from a file name, or None."""
    lowered = name.lower()
    for ext in (".gz", ".bz2", ".xz", ".zst", ".lzma"):
        if lowered.endswith(ext):
            lowered = lowered[: -len(ext)]
            break
    for ext, fmt in (
        (".fasta", "fasta"),
        (".fa", "fasta"),
        (".fna", "fasta"),
        (".csfasta", "fasta"),
        (".csfa", "fasta"),
        (".fastq", "fastq"),
        (".fq", "fastq"),
        (".bam", "bam"),
    ):
        if lowered.endswith(ext):
            return fmt
    return None


def detect_format_from_content(file: BinaryIO) -> Optional[str]:
    """Guess the format by peeking at the first bytes of an open file."""
    if file.seekable():
        pos = file.tell()
        magic = file.read(4)
        file.seek(pos)
    else:
        try:
            magic = file.peek(4)[:4]
        except AttributeError:
            return None
    if magic.startswith(b"@") or magic == b"":
        return "fastq"
    if magic.startswith(b">") or magic.startswith(b"#"):
        return "fasta"
    if magic == b"BAM\x01":
        return "bam"
    return None


# ---------------------------------------------------------------------------
# Parsers


def _iter_lines(file: BinaryIO) -> Iterator[bytes]:
    for line in file:
        if line.endswith(b"\r\n"):
            yield line[:-2]
        elif line.endswith(b"\n"):
            yield line[:-1]
        else:
            yield line


def parse_fastq(file: BinaryIO) -> Iterator[SequenceRecord]:
    lines = _iter_lines(file)
    line_number = 0
    while True:
        try:
            header = next(lines)
        except StopIteration:
            return
        if not header and line_number == 0:
            # Completely empty input
            return
        if not header.startswith(b"@"):
            raise FastqFormatError(
                "Line expected to start with '@', but found "
                f"{chr(header[0]) if header else '(empty line)'!r}",
                line=line_number,
            )
        try:
            sequence = next(lines)
            plus = next(lines)
            qualities = next(lines)
        except StopIteration:
            raise FastqFormatError(
                "Premature end of file encountered. The incomplete final "
                "record was: " + repr(header.decode("latin-1")),
                line=line_number,
            )
        if not plus.startswith(b"+"):
            raise FastqFormatError(
                "Line expected to start with '+', but found "
                f"{chr(plus[0]) if plus else '(empty line)'!r}",
                line=line_number + 2,
            )
        if len(sequence) != len(qualities):
            raise FastqFormatError(
                "Length of sequence and qualities differ",
                line=line_number + 3,
            )
        yield SequenceRecord(
            header[1:].decode("latin-1"),
            sequence.decode("latin-1"),
            qualities.decode("latin-1"),
        )
        line_number += 4


def parse_fasta(file: BinaryIO) -> Iterator[SequenceRecord]:
    name: Optional[str] = None
    seq_parts: List[bytes] = []
    for i, line in enumerate(_iter_lines(file)):
        # Leading/trailing whitespace on any line is insignificant
        line = line.strip()
        if line.startswith(b"#"):
            continue
        if line.startswith(b">"):
            if name is not None:
                yield SequenceRecord(name, b"".join(seq_parts).decode("latin-1"))
            name = line[1:].decode("latin-1")
            seq_parts = []
        else:
            if name is None:
                if not line:
                    continue
                raise FastaFormatError(
                    "Expected '>' at beginning of record", line=i
                )
            seq_parts.append(line)
    if name is not None:
        yield SequenceRecord(name, b"".join(seq_parts).decode("latin-1"))


_BAM_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_BAM_NIBBLE_LUT = np.zeros((256, 2), dtype=np.uint8)
for _b in range(256):
    _BAM_NIBBLE_LUT[_b, 0] = ord(_BAM_SEQ_CODES[_b >> 4])
    _BAM_NIBBLE_LUT[_b, 1] = ord(_BAM_SEQ_CODES[_b & 0xF])


def read_bam_header(file: BinaryIO) -> bytes:
    """Consume and return the raw BAM header block (magic through refs)."""
    out = io.BytesIO()

    def take(n: int) -> bytes:
        data = file.read(n)
        if len(data) != n:
            raise BamFormatError("Truncated BAM header", line=None)
        out.write(data)
        return data

    magic = take(4)
    if magic != b"BAM\x01":
        raise BamFormatError("Not a BAM file (bad magic)", line=None)
    (l_text,) = struct.unpack("<i", take(4))
    take(l_text)
    (n_ref,) = struct.unpack("<i", take(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", take(4))
        take(l_name + 4)
    return out.getvalue()


def parse_bam_records(file: BinaryIO) -> Iterator[SequenceRecord]:
    """Parse raw BAM alignment records (header must have been consumed)."""
    while True:
        size_raw = file.read(4)
        if not size_raw:
            return
        if len(size_raw) != 4:
            raise BamFormatError("Truncated BAM record", line=None)
        (block_size,) = struct.unpack("<i", size_raw)
        data = file.read(block_size)
        if len(data) != block_size:
            raise BamFormatError("Truncated BAM record", line=None)
        (
            _refid,
            _pos,
            l_read_name,
            _mapq,
            _bam_bin,
            n_cigar_op,
            flag,
            l_seq,
            _next_refid,
            _next_pos,
            _tlen,
        ) = struct.unpack("<iiBBHHHiiii", data[:32])
        offset = 32
        name = data[offset : offset + l_read_name - 1].decode("latin-1")
        offset += l_read_name
        offset += n_cigar_op * 4
        n_packed = (l_seq + 1) // 2
        packed = np.frombuffer(
            data[offset : offset + n_packed], dtype=np.uint8
        )
        seq = _BAM_NIBBLE_LUT[packed].reshape(-1)[:l_seq].tobytes().decode("ascii")
        offset += n_packed
        quals_raw = data[offset : offset + l_seq]
        offset += l_seq
        if l_seq and quals_raw[0] == 0xFF:
            qualities: Optional[str] = None
        else:
            qualities = (
                (np.frombuffer(quals_raw, dtype=np.uint8) + 33)
                .tobytes()
                .decode("latin-1")
            )
        if flag & 16:  # reverse strand: stored reverse-complemented
            record = SequenceRecord(name, seq, qualities).reverse_complement()
        else:
            record = SequenceRecord(name, seq, qualities)
        yield record


def parse_bam(file: BinaryIO) -> Iterator[SequenceRecord]:
    read_bam_header(file)
    yield from parse_bam_records(file)


# ---------------------------------------------------------------------------
# Reader / writer objects (dnaio.open equivalent)


class SequenceReader:
    def __init__(self, file: BinaryIO, fileformat: Optional[str] = None):
        self._file = file
        if fileformat is None:
            fileformat = detect_format_from_content(file)
            if fileformat is None:
                raise UnknownFileFormat(
                    "Could not determine the file format of the input"
                )
        self.fileformat = fileformat
        if fileformat == "fastq":
            self._iter = parse_fastq(file)
            self.delivers_qualities = True
        elif fileformat == "fasta":
            self._iter = parse_fasta(file)
            self.delivers_qualities = False
        elif fileformat == "bam":
            self._iter = parse_bam(file)
            self.delivers_qualities = True
        elif fileformat == "bam_no_header":
            self._iter = parse_bam_records(file)
            self.delivers_qualities = True
        else:
            raise UnknownFileFormat(f"Unknown file format '{fileformat}'")

    def __iter__(self):
        return self._iter

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        pass


class PairedSequenceReader:
    def __init__(
        self,
        file1: BinaryIO,
        file2: BinaryIO,
        fileformat: Optional[str] = None,
    ):
        self._reader1 = SequenceReader(file1, fileformat)
        self._reader2 = SequenceReader(file2, fileformat)
        self.delivers_qualities = self._reader1.delivers_qualities

    def __iter__(self):
        it1 = iter(self._reader1)
        it2 = iter(self._reader2)
        while True:
            try:
                r1 = next(it1)
            except StopIteration:
                try:
                    next(it2)
                except StopIteration:
                    return
                raise FileFormatError(
                    "Reads are improperly paired. There are more reads in "
                    "file 2 than in file 1.",
                    line=None,
                ) from None
            try:
                r2 = next(it2)
            except StopIteration:
                raise FileFormatError(
                    "Reads are improperly paired. There are more reads in "
                    "file 1 than in file 2.",
                    line=None,
                ) from None
            if not record_names_match(r1.name, r2.name):
                raise FileFormatError(
                    "Reads are improperly paired. Read name "
                    f"'{r1.name}' in file 1 does not match "
                    f"'{r2.name}' in file 2.",
                    line=None,
                )
            yield r1, r2

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        self._reader1.close()
        self._reader2.close()


class InterleavedSequenceReader:
    def __init__(self, file: BinaryIO, fileformat: Optional[str] = None):
        self._reader = SequenceReader(file, fileformat)
        self.delivers_qualities = self._reader.delivers_qualities

    def __iter__(self):
        it = iter(self._reader)
        while True:
            try:
                r1 = next(it)
            except StopIteration:
                return
            try:
                r2 = next(it)
            except StopIteration:
                raise FileFormatError(
                    "Interleaved input file incomplete: last record "
                    f"'{r1.name}' has no partner.",
                    line=None,
                ) from None
            if not record_names_match(r1.name, r2.name):
                raise FileFormatError(
                    "Reads are improperly paired. Read name "
                    f"'{r1.name}' does not match '{r2.name}'.",
                    line=None,
                )
            yield r1, r2

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        self._reader.close()


class FastqWriter:
    """NB: close() does not close the underlying stream; its lifecycle
    belongs to the caller (it may be stdout or a shared buffer)."""

    def __init__(self, file: BinaryIO):
        self._file = file

    def write(self, record: SequenceRecord) -> None:
        if record.qualities is None:
            raise ValueError(
                f"Record {record.name!r} has no qualities, cannot be "
                "written to FASTQ"
            )
        self._file.write(record.fastq_bytes())

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class FastaWriter:
    """See FastqWriter: close() leaves the underlying stream open."""

    def __init__(self, file: BinaryIO):
        self._file = file

    def write(self, record: SequenceRecord) -> None:
        self._file.write(record.fasta_bytes())

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class PairedSequenceWriter:
    def __init__(self, writer1, writer2):
        self._writer1 = writer1
        self._writer2 = writer2

    def write(self, record1: SequenceRecord, record2: SequenceRecord) -> None:
        self._writer1.write(record1)
        self._writer2.write(record2)

    def close(self):
        self._writer1.close()
        self._writer2.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class InterleavedSequenceWriter:
    def __init__(self, writer):
        self._writer = writer

    def write(self, record1: SequenceRecord, record2: SequenceRecord) -> None:
        self._writer.write(record1)
        self._writer.write(record2)

    def close(self):
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def _writer_format(
    file: BinaryIO, fileformat: Optional[str], qualities: Optional[bool]
) -> str:
    if fileformat is None:
        name = getattr(file, "name", None)
        if isinstance(name, (str, bytes)):
            if isinstance(name, bytes):
                name = name.decode()
            fileformat = detect_format_from_name(name)
    if fileformat is None:
        fileformat = "fastq" if qualities in (True, None) else "fasta"
    if fileformat == "fastq" and qualities is False:
        raise ValueError(
            "Output format is FASTQ, but the input does not provide "
            "quality values"
        )
    if fileformat not in ("fasta", "fastq"):
        raise UnknownFileFormat(
            f"Cannot write file format '{fileformat}'"
        )
    return fileformat


def open_sequence_file(
    *files,
    mode: str = "r",
    interleaved: bool = False,
    fileformat: Optional[str] = None,
    qualities: Optional[bool] = None,
):
    """Open sequence file(s) for reading or writing records.

    Equivalent surface to dnaio.open as the reference uses it.
    """
    if mode == "r":
        if len(files) == 2:
            return PairedSequenceReader(files[0], files[1], fileformat)
        if interleaved:
            return InterleavedSequenceReader(files[0], fileformat)
        return SequenceReader(files[0], fileformat)
    elif mode == "w":
        writers = []
        for f in files:
            fmt = _writer_format(f, fileformat, qualities)
            writers.append(FastqWriter(f) if fmt == "fastq" else FastaWriter(f))
        if len(files) == 2:
            return PairedSequenceWriter(writers[0], writers[1])
        if interleaved:
            return InterleavedSequenceWriter(writers[0])
        return writers[0]
    raise ValueError("mode must be 'r' or 'w'")


# ---------------------------------------------------------------------------
# Record-boundary chunking (for the parallel runner)


def _complete_records_end(buf: bytes, fmt: str, eof: bool) -> Tuple[int, int]:
    """Return (end_offset, n_records) for the complete records in buf."""
    if fmt == "fastq":
        # One memchr-speed pass counts the lines; the cut position is
        # then found by stepping back over the few surplus lines from
        # the end (each rfind scans only one line).
        n_complete_lines = buf.count(b"\n")
        n_records = n_complete_lines // 4
        surplus_lines = n_complete_lines - n_records * 4
        if n_records:
            end = buf.rfind(b"\n") + 1
            for _ in range(surplus_lines):
                end = buf.rfind(b"\n", 0, end - 1) + 1
        else:
            end = 0
        if eof and surplus_lines:
            # trailing partial record at EOF: let the parser report it
            end = len(buf)
            n_records += 1
        elif eof and end < len(buf) and buf[end:].strip():
            end = len(buf)
            n_records += 1
        return end, n_records
    elif fmt == "fasta":
        if eof:
            arr = np.frombuffer(buf, dtype=np.uint8)
            starts = np.flatnonzero(arr == ord(">"))
            # count record starts at line beginnings
            n = sum(
                1
                for s in starts
                if s == 0 or buf[s - 1 : s] == b"\n"
            )
            return len(buf), n
        pos = buf.rfind(b"\n>")
        if pos == -1:
            return 0, 0
        end = pos + 1
        n = 0
        idx = 0
        while True:
            idx = buf.find(b">", idx, end)
            if idx == -1:
                break
            if idx == 0 or buf[idx - 1 : idx] == b"\n":
                n += 1
            idx += 1
        return end, n
    elif fmt in ("bam", "bam_no_header"):
        offset = 0
        n = 0
        total = len(buf)
        while offset + 4 <= total:
            (block_size,) = struct.unpack_from("<i", buf, offset)
            if offset + 4 + block_size > total:
                break
            offset += 4 + block_size
            n += 1
        return offset, n
    raise ValueError(f"Unknown format {fmt}")


class _ChunkState:
    def __init__(self, file: BinaryIO, fmt: str, buffer_size: int):
        self.file = file
        self.fmt = fmt
        self.buffer_size = buffer_size
        self.leftover = b""
        self.eof = False

    def fill(self) -> bytes:
        parts = [self.leftover]
        size = len(self.leftover)
        while not self.eof and size < self.buffer_size:
            more = self.file.read(self.buffer_size - size)
            if not more:
                self.eof = True
                break
            parts.append(more)
            size += len(more)
        return parts[0] if len(parts) == 1 else b"".join(parts)


def read_chunks(
    file: BinaryIO, buffer_size: int = 4 * 1024 * 1024
) -> Iterator[memoryview]:
    """Yield chunks of complete records from a FASTA/FASTQ/BAM file."""
    fmt = detect_format_from_content(file)
    if fmt is None:
        raise UnknownFileFormat("Input file format not recognized")
    if fmt == "bam":
        read_bam_header(file)
        fmt = "bam_no_header"
    state = _ChunkState(file, fmt, buffer_size)
    while True:
        span = tracing.begin("read", cpu=True)
        try:
            data = state.fill()
            if not data:
                return
            end, n = _complete_records_end(data, fmt, state.eof)
            if end == 0 and not state.eof:
                raise ValueError(
                    "The first record does not fit into the buffer; "
                    "increase --buffer-size"
                )
            state.leftover = data[end:]
        finally:
            tracing.end(span)
        if end:
            yield memoryview(data)[:end]
        if state.eof and not state.leftover.strip():
            return


def read_paired_chunks(
    file1: BinaryIO,
    file2: BinaryIO,
    buffer_size: int = 4 * 1024 * 1024,
) -> Iterator[Tuple[memoryview, memoryview]]:
    """Yield pairs of chunks containing the same number of records."""
    fmt1 = detect_format_from_content(file1)
    fmt2 = detect_format_from_content(file2)
    if fmt1 is None or fmt2 is None:
        raise UnknownFileFormat("Input file format not recognized")
    if fmt1 == "bam":
        read_bam_header(file1)
        fmt1 = "bam_no_header"
    if fmt2 == "bam":
        read_bam_header(file2)
        fmt2 = "bam_no_header"
    s1 = _ChunkState(file1, fmt1, buffer_size)
    s2 = _ChunkState(file2, fmt2, buffer_size)
    while True:
        span = tracing.begin("read", cpu=True)
        try:
            d1 = s1.fill()
            d2 = s2.fill()
            if not d1 and not d2:
                return
            end1, n1 = _complete_records_end(d1, fmt1, s1.eof)
            end2, n2 = _complete_records_end(d2, fmt2, s2.eof)
            n = min(n1, n2)
            if n == 0:
                if (d1 and not s1.eof) or (d2 and not s2.eof):
                    raise ValueError(
                        "The first record does not fit into the buffer; "
                        "increase --buffer-size"
                    )
                # One side exhausted or only partial data at EOF: emit
                # what is left so the parser reports improper pairing.
                s1.leftover = b""
                s2.leftover = b""
                pair = (memoryview(d1), memoryview(d2)) if d1 or d2 else None
            else:
                end1 = _end_of_n_records(d1, fmt1, n, end1, n1)
                end2 = _end_of_n_records(d2, fmt2, n, end2, n2)
                s1.leftover = d1[end1:]
                s2.leftover = d2[end2:]
                pair = memoryview(d1[:end1]), memoryview(d2[:end2])
        finally:
            tracing.end(span)
        if pair is not None:
            yield pair
        if n == 0:
            return


def _end_of_n_records(buf: bytes, fmt: str, n: int, end_all: int, n_all: int) -> int:
    """Offset just after the n-th record (n <= n_all)."""
    if n == n_all:
        return end_all
    if fmt == "fastq":
        arr = np.frombuffer(buf, dtype=np.uint8)
        newlines = np.flatnonzero(arr == 0x0A)
        return int(newlines[n * 4 - 1]) + 1
    elif fmt == "fasta":
        count = 0
        idx = 0
        while True:
            idx = buf.find(b">", idx)
            if idx == -1:
                return len(buf)
            if idx == 0 or buf[idx - 1 : idx] == b"\n":
                count += 1
                if count == n + 1:
                    return idx
            idx += 1
    elif fmt in ("bam", "bam_no_header"):
        offset = 0
        for _ in range(n):
            (block_size,) = struct.unpack_from("<i", buf, offset)
            offset += 4 + block_size
        return offset
    raise ValueError(f"Unknown format {fmt}")


def file_basename_format(path) -> Optional[str]:
    return detect_format_from_name(fspath(path))
