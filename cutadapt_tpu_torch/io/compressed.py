"""
Transparent compressed-file opening (own equivalent of the reference's
external ``xopen`` dependency; usage mirrored from
cutadapt:src/cutadapt/files.py:22-92).

Reading detects the compression format from the file content (magic
bytes), so e.g. BGZF-compressed BAM works regardless of extension.
Writing picks the format from the file name extension. '-' means
stdin/stdout.

``threads > 0`` enables pigz-style parallel gzip writing: input is cut
into fixed-size blocks, each block is deflated on a worker thread as
an independent gzip member (zlib releases the GIL, so worker threads
compress truly in parallel), and members are written out in submission
order. Concatenated members are themselves a valid gzip stream, the
block boundaries are deterministic, and the main thread never blocks
on compression — matching the role of the reference's xopen
compression threads (cutadapt:src/cutadapt/cli.py:1359-1360,
CHANGES.rst notes compression as a dominant cost).
"""

import bz2
import gzip
import io
import lzma
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional


class _DeterministicGzipFile(gzip.GzipFile):
    """GzipFile with fixed mtime and no filename for reproducible output."""

    def __init__(self, fileobj, mode, compresslevel=1):
        super().__init__(
            filename="",
            mode=mode,
            compresslevel=compresslevel,
            fileobj=fileobj,
            mtime=0,
        )
        self._outer_fileobj = fileobj

    def close(self):
        super().close()
        if not self._outer_fileobj.closed:
            self._outer_fileobj.close()


class ThreadedGzipWriter(io.RawIOBase):
    """File-like gzip writer that compresses fixed-size blocks on a
    thread pool and emits them as independent gzip members in order."""

    BLOCK_SIZE = 128 * 1024

    def __init__(self, fileobj, compresslevel: int = 1, threads: int = 1):
        self._raw = fileobj
        self._level = compresslevel
        self._pool = ThreadPoolExecutor(max_workers=max(1, threads))
        # in-flight compressed blocks, oldest first
        self._pending: deque = deque()
        self._max_pending = max(1, threads) * 4
        self._buffer = bytearray()

    def writable(self) -> bool:
        return True

    def _submit(self, block: bytes) -> None:
        self._pending.append(
            self._pool.submit(gzip.compress, block, self._level, mtime=0)
        )
        while len(self._pending) > self._max_pending:
            self._raw.write(self._pending.popleft().result())

    def write(self, data) -> int:
        self._buffer += data
        # opportunistically retire finished blocks to bound memory
        while self._pending and self._pending[0].done():
            self._raw.write(self._pending.popleft().result())
        while len(self._buffer) >= self.BLOCK_SIZE:
            block = bytes(self._buffer[: self.BLOCK_SIZE])
            del self._buffer[: self.BLOCK_SIZE]
            self._submit(block)
        return len(data)

    def flush(self) -> None:
        if self._buffer:
            self._submit(bytes(self._buffer))
            self._buffer.clear()
        while self._pending:
            self._raw.write(self._pending.popleft().result())
        self._raw.flush()

    def close(self) -> None:
        if self.closed:
            return
        self.flush()
        self._pool.shutdown(wait=True)
        super().close()
        if not self._raw.closed:
            self._raw.close()


def _open_for_reading(name: str, binary: bool):
    raw = open(name, "rb")
    magic = raw.read(4)
    raw.seek(0)
    if magic[:2] == b"\x1f\x8b":
        f = gzip.open(raw, "rb")
    elif magic[:3] == b"BZh":
        f = bz2.open(raw, "rb")
    elif magic[:4] == b"\xfd7zX":
        f = lzma.open(raw, "rb")
    else:
        f = raw
    if binary:
        return f
    return io.TextIOWrapper(f)


def xopen(
    path,
    mode: str = "rb",
    compresslevel: int = 1,
    threads: Optional[int] = None,
):
    """Open a possibly-compressed file.

    mode may be 'rb', 'wb', 'rt', 'wt', 'ab', 'r', 'w'.

    threads -- number of background compression threads for gzip
    writing (0 or None: compress in-process on the calling thread).
    """
    if mode in ("r", "w", "a"):
        mode += "t"
    binary = "b" in mode
    base_mode = mode.replace("t", "").replace("b", "") + "b"

    if not isinstance(path, (str, os.PathLike)):
        # Already a file-like object
        fileobj = path
        if binary:
            return fileobj
        return io.TextIOWrapper(fileobj)
    name = os.fspath(path)

    if name == "-":
        if "r" in mode:
            raw = sys.stdin.buffer
        else:
            raw = sys.stdout.buffer
        if binary:
            return raw
        return io.TextIOWrapper(raw, write_through=True)

    if "r" in mode:
        return _open_for_reading(name, binary)

    lowered = name.lower()
    if lowered.endswith(".gz"):
        if threads and "a" not in mode:
            f = ThreadedGzipWriter(
                open(name, base_mode),
                compresslevel=compresslevel,
                threads=threads,
            )
        else:
            f = _DeterministicGzipFile(
                fileobj=open(name, base_mode),
                mode=base_mode,
                compresslevel=compresslevel,
            )
    elif lowered.endswith(".bz2"):
        f = bz2.open(name, base_mode, compresslevel=compresslevel)
    elif lowered.endswith((".xz", ".lzma")):
        f = lzma.open(name, base_mode)
    else:
        f = open(name, base_mode)

    if binary:
        return f
    return io.TextIOWrapper(f)
