import numpy as np
import pytest

from benchmark import generate

TRAFFIC = ("se100_bulk", "se100_short", "pe150_bulk")


def small(name, n=3000):
    return dict(generate.load_traffic(name), reads_per_file=n)


@pytest.mark.parametrize("name", TRAFFIC)
def test_deterministic_per_seed(name):
    tr = small(name)
    a, b = generate.make(tr, 2**33 + 5), generate.make(tr, 2**33 + 5)
    c = generate.make(tr, 2**33 + 6)
    for x, y, z in zip(a, b, c):
        assert generate.fastq_bytes(x) == generate.fastq_bytes(y)
        assert generate.fastq_bytes(x) != generate.fastq_bytes(z)


def test_seeds_are_any_integer():
    seeds = {generate.seed64(s, 0) for s in (-1, 0, 1, 2**31 + 3, 2**70)}
    assert len(seeds) == 5
    assert generate.seed64(7, 0) != generate.seed64(7, 1)


@pytest.mark.parametrize("name", TRAFFIC)
def test_shapes(name):
    n = 6000
    tr = small(name, n)
    mates = generate.make(tr, 11)
    L = tr["read_length"]
    inserts = generate._tiled(tr["inserts"], n)
    for reads, adapter in zip(mates, tr["adapters"]):
        assert reads.seqs.shape == (n, L) and (reads.lens == L).all()
        # N in exactly the share of reads, 1-3 each
        n_count = (reads.seqs == ord("N")).sum(1)
        assert (n_count > 0).sum() == round(tr["n_read_share"] * n)
        assert n_count.max() <= 3
        qual = reads.quals.astype(int) - 33
        q = tr["quality"]
        assert qual.min() >= q["lo"] and qual.max() <= q["hi"]
    # the share of reads (pairs) with an adapter: inserts shorter than the
    # read, whose adapter starts at the insert's end
    with_adapter = (inserts < L).sum()
    share = {"se100_bulk": 0.25, "se100_short": 1.0, "pe150_bulk": 1 / 3}[name]
    assert with_adapter == pytest.approx(share * n, abs=1)


def test_insert_lengths_tile_their_ranges():
    ins = generate._tiled([[0.25, 10, 96], [0.75, 100, 100]], 8700)
    assert (ins[ins < 100] >= 10).all() and ins[ins < 100].max() == 96
    counts = np.bincount(ins[ins < 100])[10:97]
    assert counts.min() == counts.max() == 25  # 2175 reads over 87 lengths
    assert generate._tiled([[1.0, 20, 90]], 71 * 3).tolist() == sorted(
        list(range(20, 91)) * 3)


def test_adapter_follows_the_insert():
    n = 4000
    tr = small("se100_short", n)
    tr["substitution_rate"] = 0.0
    tr["n_read_share"] = 0.0
    reads, = generate.make(tr, 3)
    ad = np.frombuffer(tr["adapters"][0].encode(), np.uint8)
    # every read holds the adapter right after an insert of 20-90 (at
    # least its first 10 bases, in a read of 100)
    text = [bytes(s) for s in reads.seqs]
    pos = np.array([t.find(ad[:10].tobytes()) for t in text])
    assert (pos >= 20).all() and (pos <= 90).all()
    assert sorted(np.bincount(pos)[20:91]) == sorted(np.bincount(
        generate._tiled(tr["inserts"], n))[20:91])


def test_substitution_rate():
    tr = small("se100_short", 5000)
    clean = dict(tr, substitution_rate=0.0, n_read_share=0.0)
    a, = generate.make(clean, 9)
    b, = generate.make(dict(tr, n_read_share=0.0), 9)
    # the same stream up to the substitutions: they change at most the
    # drawn count, and about three quarters of it (a quarter keep the base)
    drawn = round(0.01 * a.seqs.size)
    changed = int((a.seqs != b.seqs).sum())
    assert 0.6 * drawn < changed <= drawn


def test_paired_mates_read_the_same_insert():
    tr = small("pe150_bulk", 2000)
    tr["substitution_rate"] = 0.0
    tr["n_read_share"] = 0.0
    r1, r2 = generate.make(tr, 5)
    ins = None
    comp = generate.COMPLEMENT
    for i in range(50):
        s1, s2 = bytes(r1.seqs[i]), bytes(r2.seqs[i])
        k = s1.find(tr["adapters"][0].encode()[:15])
        if 0 < k:  # a short insert: R2 starts with its reverse complement
            ins = s1[:k]
            rc = bytes(comp[np.frombuffer(ins, np.uint8)][::-1])
            assert s2.startswith(rc)
            assert s2[k:].startswith(tr["adapters"][1].encode()[: 150 - k][:15])
    assert ins is not None
    assert r1.names[0].tobytes().endswith(b"/1")
    assert r2.names[0].tobytes().endswith(b"/2")


def test_each_timed_file_is_a_stream_of_its_own():
    streams = [generate.file_stream(i) for i in range(5)]
    assert streams[0] == generate.TIMED
    assert len(set(streams) | {generate.WARMUP}) == 6
    tr = small("se100_bulk", 500)
    a, = generate.make(tr, 4, generate.file_stream(1))
    b, = generate.make(tr, 4, generate.file_stream(2))
    assert generate.fastq_bytes(a) != generate.fastq_bytes(b)


def test_compressed_input_holds_the_same_records():
    import gzip

    tr = small("se100_bulk", 500)
    reads, = generate.make(tr, 4)
    assert generate.suffix(tr) == ".fastq"
    assert generate.file_bytes(tr, reads) == generate.fastq_bytes(reads)
    gz = dict(tr, compression="gzip")
    assert generate.suffix(gz) == ".fastq.gz"
    data = generate.file_bytes(gz, reads)
    assert data[:2] == b"\x1f\x8b"
    assert gzip.decompress(data) == generate.fastq_bytes(reads)
    with pytest.raises(ValueError):
        generate.suffix(dict(tr, compression="bz2"))
