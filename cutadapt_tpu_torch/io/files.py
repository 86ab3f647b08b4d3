"""
File management: input paths/files, on-demand output files, and the
proxy writers that carry output across process boundaries.

Proxy writers are the multicore transport: workers write records into
in-memory buffers, ``drain()`` hands the accumulated bytes to the main
process (which writes them in chunk-index order), and pickling a proxy
re-creates an empty one in the worker — so the same pipeline object
graph works serial and parallel.

Capability parity: cutadapt:src/cutadapt/files.py:22-333
(incl. the open-files rlimit bump and magic-byte format detection).
"""

import errno
import io
import os
import sys
from abc import ABC
from enum import Enum
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, TextIO

from ..utils import logger
from .compressed import xopen
from .fastq import open_sequence_file
from .records import UnknownFileFormat

try:
    import resource as _resource
except ImportError:  # Windows
    _resource = None  # type: ignore


def raise_open_files_limit(n: int) -> None:
    """Raise the soft open-files rlimit by n (capped at the hard limit)."""
    if _resource is None:
        return
    lim = _resource.getrlimit(_resource.RLIMIT_NOFILE)
    bumped = min(lim[0] + n, lim[1])
    _resource.setrlimit(_resource.RLIMIT_NOFILE, (bumped, lim[1]))


def open_raise_limit(func, *args, **kwargs):
    """Call an open()-like function; on EMFILE bump the rlimit and retry."""
    for attempt in (0, 1):
        try:
            return func(*args, **kwargs)
        except OSError as e:
            if attempt or e.errno != errno.EMFILE:
                raise  # either a different error, or the retry failed too
            logger.debug(
                "Too many open files, attempting to raise soft limit"
            )
            raise_open_files_limit(8)


def xopen_rb_raise_limit(path: str):
    """Open a (possibly compressed) file for binary reading, raising
    the open-files limit if needed."""
    f = open_raise_limit(xopen, path, "rb", threads=0)
    logger.debug("Opening '%s', mode 'rb' resulted in %s", path, f)
    return f


class FileOpener:
    """Carries the output compression settings (level, background
    compression threads) applied to every opened output file."""

    def __init__(self, compression_level: int = 1, threads: Optional[int] = None):
        self.compression_level = compression_level
        self.threads = threads

    def xopen(self, path, mode):
        writing = "w" in mode
        return open_raise_limit(
            xopen,
            path,
            mode,
            compresslevel=self.compression_level,
            threads=self.threads if writing else 0,
        )

    def sequence_open(self, *args, **kwargs):
        return open_sequence_file(*args, **kwargs)


class InputFiles:
    """One or two open input streams plus their read-mode settings."""

    def __init__(
        self,
        *files: BinaryIO,
        interleaved: bool = False,
        fileformat: Optional[str] = None,
    ):
        assert None not in files
        self._files = files
        self.interleaved = interleaved
        self.fileformat = fileformat

    def open(self):
        opts = dict(
            interleaved=self.interleaved,
            mode="r",
            fileformat=self.fileformat,
        )
        return open_sequence_file(*self._files, **opts)

    def close(self) -> None:
        for f in self._files:
            f.close()


class InputPaths:
    def __init__(self, *paths: str, interleaved: bool = False):
        self.paths = paths
        self.interleaved = interleaved

    def open(self) -> InputFiles:
        # multi-process input sharding: this process reads only its
        # record-aligned byte range of each input (see
        # parallel/multihost.py for the plan/merge contract)
        from ..parallel.multihost import maybe_range_readers

        opened = maybe_range_readers(
            [xopen_rb_raise_limit(p) for p in self.paths],
            os.environ.get("CUTADAPT_TPU_TORCH_BYTE_RANGE"),
        )
        return InputFiles(*opened, interleaved=self.interleaved)


class ProxyWriter(ABC):
    """A writer over in-memory buffers whose bytes are periodically
    drained and shipped elsewhere. Pickling resets the buffers."""

    _buffers: List[io.BytesIO]

    def _flush(self) -> None:
        pass

    @staticmethod
    def _take(buf: io.BytesIO) -> bytes:
        blob = buf.getvalue()
        buf.seek(0)
        buf.truncate()
        return blob

    def drain(self) -> List[bytes]:
        """Return and clear the accumulated bytes, one blob per
        underlying output."""
        self._flush()
        return [self._take(b) for b in self._buffers]


class ProxyTextFile(ProxyWriter):
    """A text-mode file object backed by an in-memory buffer."""

    def __init__(self):
        backing = io.BytesIO()
        self._buffers = [backing]
        self._file = io.TextIOWrapper(backing)

    def write(self, text):
        self._file.write(text)

    def _flush(self) -> None:
        self._file.flush()

    def __getstate__(self):
        return True  # ensure __setstate__ is called

    def __setstate__(self, state):
        self.__init__()


def _named_buffer(path) -> io.BytesIO:
    buf = io.BytesIO()
    buf.name = os.fspath(path)  # format detection reads .name
    return buf


class ProxyRecordWriter(ProxyWriter):
    """A record writer backed by in-memory buffers (one per output
    path); the path names only determine the output format."""

    def __init__(self, paths: List[Path], **kwargs):
        self._paths = paths
        self._kwargs = kwargs
        self._buffers = [_named_buffer(p) for p in paths]
        self._writer = open_raise_limit(
            open_sequence_file, *self._buffers, mode="w", **kwargs
        )

    def write(self, *args, **kwargs):
        self._writer.write(*args, **kwargs)

    def __getstate__(self):
        return (self._paths, self._kwargs)

    def __setstate__(self, state):
        self.__init__(state[0], **state[1])


# tags for the OutputFiles registry below
_BINARY, _BINARY_KEEP_OPEN, _TEXT, _WRITER, _PROXY = range(5)


class OutputFiles:
    """
    Open output files on demand. In "proxied" (multicore) mode each
    open returns a proxy writing into memory; the real binary files
    stay in the main process, which writes drained proxy bytes to them
    in chunk-index order.

    Everything opened lands in one tagged registry; the accessors and
    close() select from it, which keeps binary files (incl. stdout,
    which must never be closed) and proxies in their creation order.
    """

    def __init__(
        self,
        *,
        proxied: bool,
        qualities: bool,
        interleaved: bool,
        file_opener: Optional[FileOpener] = None,
    ):
        self._file_opener = file_opener or FileOpener()
        self._registry: List[Any] = []  # (tag, object) pairs
        self._proxied = proxied
        self._qualities = qualities
        self._interleaved = interleaved

    def _add(self, tag: int, obj):
        self._registry.append((tag, obj))
        return obj

    def _select(self, *tags: int) -> List[Any]:
        return [obj for tag, obj in self._registry if tag in tags]

    def _open_binary(self, path) -> BinaryIO:
        return self._add(_BINARY, self._file_opener.xopen(path, "wb"))

    def open_text(self, path):
        if self._proxied:
            self._open_binary(path)
            return self._add(_PROXY, ProxyTextFile())
        return self._add(_TEXT, self._file_opener.xopen(path, "wt"))

    def _record_kwargs(self, interleaved: bool, fasta: bool) -> Dict[str, Any]:
        kwargs: Dict[str, Any] = dict(
            qualities=self._qualities, interleaved=interleaved
        )
        if fasta:
            kwargs["fileformat"] = "fasta"
        return kwargs

    def open_record_writer(
        self, *paths, interleaved: bool = False, force_fasta: bool = False
    ):
        if len(paths) not in (1, 2):
            raise ValueError("Expected one or two paths")
        if interleaved and len(paths) != 1:
            raise ValueError("Cannot write to two files when interleaved is True")
        # force_fasta only affects the '-' (stdout-like) single output
        kwargs = self._record_kwargs(
            interleaved,
            force_fasta and len(paths) == 1 and paths[0] == "-",
        )
        if paths == (None,):
            paths = ("-",)
        assert None not in paths
        streams = [self._open_binary(path) for path in paths]
        if self._proxied:
            return self._add(
                _PROXY, ProxyRecordWriter([Path(p) for p in paths], **kwargs)
            )
        return self._add(
            _WRITER,
            self._file_opener.sequence_open(*streams, mode="w", **kwargs),
        )

    def open_stdout_record_writer(
        self, interleaved: bool = False, force_fasta: bool = False
    ):
        self._add(_BINARY_KEEP_OPEN, sys.stdout.buffer)
        kwargs = self._record_kwargs(interleaved, force_fasta)
        if self._proxied:
            return self._add(_PROXY, ProxyRecordWriter([Path("-")], **kwargs))
        return self._add(
            _WRITER,
            self._file_opener.sequence_open(
                sys.stdout.buffer, mode="w", **kwargs
            ),
        )

    def binary_files(self) -> List[BinaryIO]:
        return self._select(_BINARY, _BINARY_KEEP_OPEN)

    def proxy_files(self) -> List[ProxyWriter]:
        return self._select(_PROXY)

    def close(self) -> None:
        """Close all output files that are not stdout."""
        closable = [_BINARY] if self._proxied else [_BINARY, _TEXT, _WRITER]
        # note order: in non-proxied mode text/record writers flush
        # into their binary files as they close, before those close
        for tag in (_TEXT, _WRITER, _BINARY):
            if tag in closable:
                for obj in self._select(tag):
                    obj.close()


class FileFormat(Enum):
    FASTA = 1
    FASTQ = 2
    BAM = 3

    def has_qualities(self) -> bool:
        return self is not FileFormat.FASTA


# first bytes -> detected format; '@' doubles as the empty-input default
_MAGIC_PREFIXES = (
    (b"@", FileFormat.FASTQ),
    (b">", FileFormat.FASTA),
    (b"#", FileFormat.FASTA),  # some FASTA variants allow comments
    (b"BAM\x01", FileFormat.BAM),
)


def _peek_magic(file: BinaryIO, n: int = 4) -> bytes:
    if not file.seekable():
        return file.peek(n)[:n]  # type: ignore[attr-defined]
    pos = file.tell()
    head = file.read(n)
    file.seek(pos)
    return head


def detect_file_format(file: BinaryIO) -> FileFormat:
    magic = _peek_magic(file)
    if magic == b"":
        # pretend FASTQ for empty input
        return FileFormat.FASTQ
    for prefix, fileformat in _MAGIC_PREFIXES:
        if magic.startswith(prefix):
            return fileformat
    raise UnknownFileFormat(
        f"Input file format not recognized. The file starts with {magic!r}, "
        "but files in supported formats start with '>' (FASTA), '@' (FASTQ) "
        "or 'BAM'"
    )
