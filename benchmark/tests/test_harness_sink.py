import os
import threading

import pytest

from benchmark.generate import DIGEST_BLOCK, block_digests
from benchmark.sink import DigestSink


@pytest.mark.parametrize("size", [0, 1000, DIGEST_BLOCK, 3 * DIGEST_BLOCK + 17])
def test_digests_what_is_written(tmp_path, size):
    data = os.urandom(size)
    sink = DigestSink(str(tmp_path / "out.fastq"))

    def writer():
        with open(sink.path, "wb") as f:  # as the program opens an output
            for i in range(0, len(data), 65537):
                f.write(data[i:i + 65537])

    t = threading.Thread(target=writer)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert sink.close() == block_digests(data)
    assert sink.nbytes == size
    assert not os.path.exists(sink.path)


def test_a_path_never_opened_reads_as_empty(tmp_path):
    sink = DigestSink(str(tmp_path / "out.fastq"))
    assert sink.close() == [] == block_digests(b"")


def test_nothing_reaches_the_disk(tmp_path):
    sink = DigestSink(str(tmp_path / "out.fastq"))
    with open(sink.path, "wb") as f:
        f.write(b"@r0\nACGT\n+\nIIII\n" * 1000)
        assert os.stat(sink.path).st_size == 0  # a FIFO holds no bytes
    sink.close()


@pytest.mark.parametrize("members", [1, 3])
def test_a_gzip_stream_is_digested_uncompressed(tmp_path, members):
    import gzip

    data = os.urandom(DIGEST_BLOCK + 5000) + b"ACGT" * 100000
    cuts = [len(data) * k // members for k in range(members + 1)]
    stream = b"".join(gzip.compress(data[a:b]) for a, b in zip(cuts, cuts[1:]))
    sink = DigestSink(str(tmp_path / "out.fastq.gz"), gunzip=True)
    with open(sink.path, "wb") as f:
        for i in range(0, len(stream), 70001):
            f.write(stream[i:i + 70001])
    assert sink.close() == block_digests(data)
    assert sink.nbytes == len(data)


def test_a_truncated_gzip_stream_is_an_error(tmp_path):
    import gzip

    stream = gzip.compress(os.urandom(100000))
    sink = DigestSink(str(tmp_path / "out.fastq.gz"), gunzip=True)
    with open(sink.path, "wb") as f:
        f.write(stream[:-100])
    with pytest.raises(Exception):
        sink.close()
