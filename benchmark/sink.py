"""Outputs that never reach the disk: a FIFO per output file, drained by
a thread that digests what the program writes into it.

The FIFO's read end is opened first, without blocking, and a write end
of the sink's own is held open until :meth:`DigestSink.close`, so the
reader sees end-of-file only after the program has closed its end and
the sink has closed its own: the program may open, write and close the
path at any time in between, or never.
"""

import fcntl
import hashlib
import os
import threading
import zlib

from benchmark.generate import DIGEST_BLOCK

# Linux's F_SETPIPE_SZ; a larger pipe means fewer wake-ups per file
_F_SETPIPE_SZ = 1031
_PIPE_BYTES = 1 << 20


class DigestSink:
    """A FIFO at ``path`` and a thread that reads it to its end, hashing
    each DIGEST_BLOCK bytes (generate.block_digests of the same bytes);
    with ``gunzip``, of what the gzip stream written there holds (one or
    more members)."""

    def __init__(self, path: str, gunzip: bool = False):
        self.path = path
        os.mkfifo(path)
        self._fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        self._hold = os.open(path, os.O_WRONLY)
        fl = fcntl.fcntl(self._fd, fcntl.F_GETFL)
        fcntl.fcntl(self._fd, fcntl.F_SETFL, fl & ~os.O_NONBLOCK)
        try:
            fcntl.fcntl(self._fd, _F_SETPIPE_SZ, _PIPE_BYTES)
        except OSError:
            pass  # the pipe keeps its default size
        self.digests = []
        self.nbytes = 0
        self.error = None
        self._hash = hashlib.sha256()
        self._filled = 0
        self._inflate = _Gunzip() if gunzip else None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _digest(self, data):
        view = memoryview(data)
        while view:
            take = min(len(view), DIGEST_BLOCK - self._filled)
            self._hash.update(view[:take])
            self._filled += take
            self.nbytes += take
            view = view[take:]
            if self._filled == DIGEST_BLOCK:
                self.digests.append(self._hash.hexdigest())
                self._hash, self._filled = hashlib.sha256(), 0

    def _drain(self):
        try:
            while True:
                data = os.read(self._fd, _PIPE_BYTES)
                if not data:
                    break
                self._digest(self._inflate(data) if self._inflate else data)
            if self._inflate is not None:
                self._inflate.finish()
            if self._filled:
                self.digests.append(self._hash.hexdigest())
        except (OSError, zlib.error) as e:
            self.error = e
        finally:
            os.close(self._fd)

    def close(self, timeout: float = 120.0) -> list:
        """End the stream, wait for the reader and remove the FIFO;
        returns the block digests."""
        os.close(self._hold)
        self._thread.join(timeout)
        os.unlink(self.path)
        if self._thread.is_alive():  # a write end left open elsewhere
            raise RuntimeError(f"the reader of {self.path} did not finish")
        if self.error is not None:
            raise self.error
        return self.digests


class _Gunzip:
    """Inflates a gzip stream of one or more members, piece by piece."""

    def __init__(self):
        self._z = zlib.decompressobj(31)
        self._open = False  # inside a member that has not ended

    def __call__(self, data: bytes) -> bytes:
        out = []
        while data:
            out.append(self._z.decompress(data))
            self._open = not self._z.eof
            data = b""
            if self._z.eof:
                data = self._z.unused_data
                self._z = zlib.decompressobj(31)
        return b"".join(out)

    def finish(self):
        if self._open:
            raise zlib.error("the gzip stream ends inside a member")
