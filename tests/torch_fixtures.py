"""
Fixtures of the PyTorch port's tests and of chip_smoke.py: the flagship
workload, the CLI's golden cases and the aligner's parity matrix. Nothing here is part of the
port's package; it imports the port and numpy only, so chip_smoke.py can
load it on a machine without JAX (``sys.path`` gets this directory).

The flagship workload is single-end 3' trimming of the TruSeq adapter
(``-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCA -e 0.1``, minimum overlap 3) on
100 bp reads, the configuration the JAX package benchmarks (bench.py:26-95):

- :func:`make_dataset`: synthetic FASTQ from a seed (uniform ACGT, a
  quarter of the reads carry an adapter prefix at position 10-96);
- :func:`add_ns`: puts N bytes into a share of the reads, so that the
  aligner's 4-bit lane and the scalar tail run;
- :func:`make_engine`: the engine the JAX package's CLI fast path builds
  for ``-a ADAPTER``;
- :func:`host_trim`: the per-read host path (``BackAdapter.match_to`` +
  ``Match.trimmed``), the oracle the engine's output is held to.

The golden cases of the CLI: :func:`golden_cases` reads the JAX package's
list of single-end golden cases without importing its test module,
:data:`ENGINE_NOT_YET` names the cases the port's engine refuses yet, and
:data:`NO_ALIGNER_RUN` those it accepts but gives the aligner no work;
:func:`paired_golden_cases` and :data:`ENGINE_NOT_YET_PAIRED` do the same
for the paired-end cases, and :func:`accel_configs` reads the CLI
configurations of ``tests/test_accel.py`` (:func:`accel_reads` copies
its reads).

:func:`load_host_pickle` loads a shard run's statistics pickle and
refuses any torch object in it.

Paired and revcomp workloads: :func:`make_pairs` makes Illumina TruSeq
read pairs, :func:`make_amplicons` with ``rc_share`` amplicons of either
orientation. The device mesh's check: :func:`write_mesh_pairs` and
:func:`mesh_shape_args`, the four pipeline shapes of
``__graft_entry__.py:_dryrun_real_pipeline``.

The parity matrix holds the batched aligner to other forms of the same
contract: 13 adapter specs spanning the adapter kinds and flag sets, and
a generator of random read batches with spliced, mutated adapter copies,
both those of the JAX package's on-device check
(tools/verify_pallas_tpu.py:18-78). :func:`block_edge_specs` adds adapters
whose DP rows end at, just before and just after the flagship layout's
lane blocks, :func:`variant_specs` one adapter for each register variant
of the kernel, :func:`long_specs` adapters of 200 bp (a 32-lane register
variant) and 300 bp (rows in shared memory), :func:`very_long_spec` one
whose rows live in device scratch. Results compare as ``found``
everywhere and query start/stop, errors and score where found: the other
fields are undefined where nothing was found.
"""

import ast
import contextlib
import os
from typing import List, Optional

import numpy as np

from cutadapt_tpu_torch import accel, batch_pipeline, modifiers, parser
from cutadapt_tpu_torch.adapters import BackAdapter, Where
from cutadapt_tpu_torch.batch_pipeline import (
    AdapterStage,
    AdapterTask,
    BatchPipelineEngine,
)
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk
from cutadapt_tpu_torch.io.records import SequenceRecord
# encode_rows: read bytes as a lane takes them; scalar_locate: the C++
# scalar aligner over a batch; first_difference: the comparison rule of
# two unpacked results
from cutadapt_tpu_torch.ops.align_cuda import (  # noqa: F401
    encode_rows,
    first_difference,
    kernel_layout,
    scalar_locate,
)
from cutadapt_tpu_torch.ops.align_batch import (
    AlignerSpec,
    query_class_info,
)

ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # TruSeq
NEXTERA = "CTGTCTCTTATACACATCT"
READ_LEN = 100
CHUNK_RECORDS = 131072
ADAPTER_FRACTION = 0.25


# --- the flagship workload ---------------------------------------------------


def make_adapter() -> BackAdapter:
    return BackAdapter(ADAPTER, max_errors=0.1, min_overlap=3)


def make_engine(device=None, **kwargs) -> BatchPipelineEngine:
    return BatchPipelineEngine(
        [AdapterStage([AdapterTask(make_adapter(), "back", 0)])],
        device=device, **kwargs,
    )


def make_dataset(n_reads: int, read_len: int = READ_LEN,
                 seed: int = 12345) -> bytes:
    """FASTQ records ``@r<i>`` with random bases and qualities."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = bases[rng.randint(0, 4, size=(n_reads, read_len))]
    ad = np.frombuffer(ADAPTER.encode(), dtype=np.uint8)
    has_adapter = rng.rand(n_reads) < ADAPTER_FRACTION
    positions = rng.randint(10, read_len - 3, size=n_reads)
    for i in np.flatnonzero(has_adapter):
        pos = positions[i]
        take = min(len(ad), read_len - pos)
        seqs[i, pos : pos + take] = ad[:take]
    quals = rng.randint(33 + 2, 33 + 41, size=(n_reads, read_len)).astype(
        np.uint8
    )
    names = [f"@r{i}\n".encode() for i in range(n_reads)]
    name_lens = np.array([len(x) for x in names], dtype=np.int64)
    rec_lens = name_lens + read_len + 1 + 2 + read_len + 1
    out = np.empty(int(rec_lens.sum()), dtype=np.uint8)
    pos = np.cumsum(rec_lens) - rec_lens
    for i, nm in enumerate(names):
        out[pos[i] : pos[i] + name_lens[i]] = np.frombuffer(nm, np.uint8)
    pos = pos + name_lens
    out[pos[:, None] + np.arange(read_len)[None, :]] = seqs
    pos = pos + read_len
    out[pos] = ord("\n")
    out[pos + 1] = ord("+")
    out[pos + 2] = ord("\n")
    pos = pos + 3
    out[pos[:, None] + np.arange(read_len)[None, :]] = quals
    out[pos + read_len] = ord("\n")
    return out.tobytes()


def flagship_rows(n_reads: int):
    """The sequences of the first ``n_reads`` flagship reads as a (n, 100)
    uint8 array, and their lengths: a fixed batch for the aligner."""
    chunk = parse_fastq_chunk(make_dataset(n_reads))
    buf = np.frombuffer(bytes(chunk.buf), np.uint8)
    raw = buf[chunk.seq_start[:, None] + np.arange(READ_LEN)[None, :]]
    return raw, chunk.seq_len.astype(np.int32)


def make_reads(n, seed, adapters, frac=0.3, polya=False) -> bytes:
    """A copy of ``bench_configs.make_reads`` (that module imports the JAX
    package): FASTQ records ``@r<i>/1 c`` of 40-100 random bases with
    phred 2-40 qualities; ``frac`` of them carry one of ``adapters`` at
    position 10 or later, and with ``polya`` 30% end in an A tail of
    3-19 bases. The workload of the repo's configuration ``-q 20 -a
    ADAPTER --poly-a -m 10`` (bench_configs.py:132-135)."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        L = int(rng.randint(40, READ_LEN + 1))
        s = bytearray(bases[rng.randint(0, 4, L)].tobytes())
        if adapters and rng.rand() < frac:
            ad = adapters[rng.randint(len(adapters))].encode()
            p = int(rng.randint(10, max(11, L - 4)))
            take = min(len(ad), L - p)
            s[p : p + take] = ad[:take]
        if polya and rng.rand() < 0.3:
            tail = min(int(rng.randint(3, 20)), L - 1)
            s[L - tail :] = b"A" * tail
        q = rng.randint(35, 74, L).astype(np.uint8).tobytes()
        out.append(b"@r%d/1 c\n%s\n+\n%s\n" % (i, bytes(s), q))
    return b"".join(out)


# Earth Microbiome Project 16S V4 primers: 515F (Parada) and the reverse
# complement of 806R (Apprill), as a linked adapter trims them from
# merged amplicon reads (cutadapt user guide, "Linked adapters")
PRIMER_515F = "GTGYCAGCMGCCGCGGTAA"
PRIMER_806R_RC = "ATTAGAWACCCBNGTAGTCC"
LINKED_PRIMERS = f"^{PRIMER_515F}...{PRIMER_806R_RC}"
_IUPAC_BASES = {"A": "A", "C": "C", "G": "G", "T": "T", "Y": "CT",
                "M": "AC", "W": "AT", "B": "CGT", "N": "ACGT"}


def _draw_primer(rng: np.random.RandomState, primer: str, n: int):
    """(n, len(primer)) bytes: each IUPAC position drawn per read."""
    return np.stack([
        np.frombuffer(_IUPAC_BASES[c].encode(), np.uint8)[
            rng.randint(len(_IUPAC_BASES[c]), size=n)]
        for c in primer
    ], axis=1)


def fastq_records(seqs: np.ndarray, seq_len: np.ndarray, quals: np.ndarray,
                  mate: str = "", comment: str = "") -> bytes:
    """FASTQ records ``@r<i>`` (``@r<i>/1`` with ``mate="/1"``, then
    `` comment`` where one is given) from row-padded (n, W) sequence and
    quality bytes, read i holding the first seq_len[i] of its row."""
    n = len(seq_len)
    comment = f" {comment}" if comment else ""
    names = [f"@r{i}{mate}{comment}\n".encode() for i in range(n)]
    name_lens = np.array([len(x) for x in names], np.int64)
    lens = seq_len.astype(np.int64)
    rec_lens = name_lens + 2 * lens + 4
    out = np.empty(int(rec_lens.sum()), np.uint8)
    pos = np.cumsum(rec_lens) - rec_lens
    out[np.repeat(pos, name_lens) + _ragged_offsets(name_lens)] = \
        np.frombuffer(b"".join(names), np.uint8)
    in_read = np.arange(seqs.shape[1])[None, :] < lens[:, None]
    seq_pos = pos + name_lens
    idx = np.repeat(seq_pos, lens) + _ragged_offsets(lens)
    out[idx] = seqs[in_read]
    out[seq_pos + lens] = ord("\n")
    out[seq_pos + lens + 1] = ord("+")
    out[seq_pos + lens + 2] = ord("\n")
    out[idx + (lens + 3).repeat(lens)] = quals[in_read]
    out[pos + rec_lens - 1] = ord("\n")
    return out.tobytes()


def _ragged_offsets(lens: np.ndarray) -> np.ndarray:
    """0..lens[i]-1 for each i, concatenated."""
    total = int(lens.sum())
    return np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)


_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN",
                                                               np.uint8)


def _reverse_rows(rows: np.ndarray, lens: np.ndarray, which: np.ndarray,
                  table: Optional[np.ndarray] = None) -> np.ndarray:
    """rows with the first lens[i] bytes of each row i in ``which``
    reversed (and mapped through ``table``)."""
    out = rows.copy()
    j = np.arange(rows.shape[1])[None, :]
    src = np.where(j < lens[:, None], lens[:, None] - 1 - j, j)
    flipped = np.take_along_axis(rows, src, axis=1)
    if table is not None:
        flipped = np.where(j < lens[:, None], table[flipped], flipped)
    out[which] = flipped[which]
    return out


def make_amplicons(n_reads: int, seed: int = 515,
                   rc_share: float = 0.0) -> bytes:
    """Synthetic merged 16S V4 amplicon reads: the 515F primer (IUPAC
    positions drawn per read; missing from 5% of the reads), a 240-260 bp
    random insert, the reverse complement of 806R, then a substitution at
    1% of the bases; 260-299 bp per read, phred 20-40. A seeded
    ``rc_share`` of the reads is then reverse-complemented (qualities
    reversed), as reads of unknown orientation are; its draw comes after
    every other, so the other reads' bytes do not depend on it."""
    rng = np.random.RandomState(seed)
    n = n_reads
    fwd = _draw_primer(rng, PRIMER_515F, n)
    rev = _draw_primer(rng, PRIMER_806R_RC, n)
    has_fwd = rng.rand(n) >= 0.05
    f_len = np.where(has_fwd, len(PRIMER_515F), 0)
    rev_start = f_len + rng.randint(240, 261, n)
    seq_len = rev_start + len(PRIMER_806R_RC)
    width = int(seq_len.max())
    codes = rng.randint(0, 4, (n, width)).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[codes]
    seqs[:, : len(PRIMER_515F)] = np.where(
        has_fwd[:, None], fwd, seqs[:, : len(PRIMER_515F)])
    rows = np.repeat(np.arange(n), len(PRIMER_806R_RC))
    cols = (rev_start[:, None] + np.arange(len(PRIMER_806R_RC))).ravel()
    seqs[rows, cols] = rev.ravel()
    sub = rng.randint(0, 100, (n, width), dtype=np.uint8) == 0
    code_of = np.zeros(256, np.uint8)
    code_of[bases] = np.arange(4)
    shifted = (code_of[seqs] + rng.randint(1, 4, (n, width))) % 4
    seqs = np.where(sub, bases[shifted], seqs)
    quals = rng.randint(33 + 20, 33 + 41, (n, width)).astype(np.uint8)
    flip = rng.rand(n) < rc_share
    if flip.any():
        seqs = _reverse_rows(seqs, seq_len, flip, _COMPLEMENT)
        quals = _reverse_rows(quals, seq_len, flip)
    return fastq_records(seqs, seq_len, quals)


# TruSeq read 1 and read 2 adapters (cutadapt user guide, "Illumina
# TruSeq"; "Trimming paired-end reads")
TRUSEQ_R1 = ADAPTER
TRUSEQ_R2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
PAIR_READ_LEN = 150


def make_pairs(n_pairs: int, seed: int = 150) -> tuple:
    """Synthetic 2 x 150 bp Illumina TruSeq read pairs (FASTQ bytes of R1
    and of R2, names ``r<i>/1`` and ``r<i>/2``): a random insert of
    60-149 bp in a third of the pairs and 150-500 bp in the rest; R1 reads
    the insert, R2 its reverse complement, each followed by its adapter
    (TRUSEQ_R1, TRUSEQ_R2) and random bases, so that a third of the pairs
    read through into the adapter on both mates at the insert length.
    Then a substitution at 1% of the bases and 1-3 N in 2% of each
    mate's reads; phred about 37 falling to about 10 toward the 3' end."""
    rng = np.random.RandomState(seed)
    n, L = n_pairs, PAIR_READ_LEN
    short = rng.rand(n) < 1 / 3
    insert = np.where(short, rng.randint(60, L, n), rng.randint(L, 501, n))
    bases = np.frombuffer(b"ACGT", np.uint8)
    width = 500 + L
    frag = bases[rng.randint(0, 4, (n, width))]
    mates = []
    for mate, adapter in ((1, TRUSEQ_R1), (2, TRUSEQ_R2)):
        # the mate's view of the fragment: R2 reads the reverse complement
        seq = frag if mate == 1 else _reverse_rows(
            frag, insert, np.ones(n, bool), _COMPLEMENT)
        tail = bases[rng.randint(0, 4, (n, L))]
        ad = np.frombuffer(adapter.encode(), np.uint8)
        tail[:, : len(ad)] = ad
        col = np.arange(L)[None, :]
        read = np.where(col < insert[:, None], seq[:, :L],
                        tail[np.arange(n)[:, None],
                             np.clip(col - insert[:, None], 0, L - 1)])
        sub = rng.rand(n, L) < 0.01
        read = np.where(sub, bases[rng.randint(0, 4, (n, L))], read)
        dirty = np.flatnonzero(rng.rand(n) < 0.02)
        for k in range(3):
            rows = dirty[(rng.rand(len(dirty)) < 0.5) | (k == 0)]
            read[rows, rng.randint(0, L, len(rows))] = ord("N")
        decay = 27 * (np.arange(L) / (L - 1)) ** 3
        phred = np.clip(np.rint(37 - decay[None, :]
                                + rng.normal(0, 3, (n, L))), 2, 41)
        quals = (33 + phred).astype(np.uint8)
        mates.append(fastq_records(read.astype(np.uint8), np.full(n, L),
                                   quals, mate=f"/{mate}"))
    return tuple(mates)


# --- long reads and the output side (chip_smoke.py phases 10 and 11) --------

# read lengths of PacBio HiFi and Oxford Nanopore runs, which commonly
# run 10-30 kb
LONG_READ_LENGTHS = (8000, 32000)


def make_long_reads(n_reads: int, seed: int = 16384,
                    lengths=LONG_READ_LENGTHS) -> bytes:
    """FASTQ records ``@r<i>`` of lengths uniform in ``lengths`` (about two
    thirds of them 2**14 bp or more at the default), random bases, phred
    2-40: a quarter carry the flagship adapter at a uniform position (many
    past 2**14), and 3% carry one to three N, so that the aligner's 4-bit
    lane runs too."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(lengths[0], lengths[1] + 1, n_reads)
    width = int(lens.max(initial=0))
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[rng.randint(0, 4, (n_reads, width), dtype=np.uint8)]
    ad = np.frombuffer(ADAPTER.encode(), np.uint8)
    for i in np.flatnonzero(rng.rand(n_reads) < ADAPTER_FRACTION):
        pos = rng.randint(0, lens[i] - 3)
        take = min(len(ad), lens[i] - pos)
        seqs[i, pos : pos + take] = ad[:take]
    for i in np.flatnonzero(rng.rand(n_reads) < 0.03):
        seqs[i, rng.randint(0, lens[i], rng.randint(1, 4))] = ord("N")
    quals = rng.randint(35, 74, (n_reads, width), dtype=np.uint8)
    return fastq_records(seqs, lens, quals)


def long_batch(spec: AlignerSpec, rng: np.random.RandomState, B: int,
               lengths, pack2: Optional[bool]):
    """(raw bytes, packed class ids, lengths) of B reads of lengths uniform
    in ``lengths``, random ACGT (a third with one N in the 4-bit and the
    byte lane), a third with a copy of the spec's reference at a uniform
    position."""
    lens = rng.randint(lengths[0], lengths[1] + 1, B).astype(np.int32)
    width = -(-int(lens.max()) // 4) * 4
    raw = np.frombuffer(b"ACGT", np.uint8)[
        rng.randint(0, 4, (B, width), dtype=np.uint8)]
    ad = np.frombuffer(spec.reference.encode(), np.uint8)
    for i in range(0, B, 3):
        pos = rng.randint(0, lens[i] - len(ad))
        raw[i, pos : pos + len(ad)] = ad
        if not pack2:
            raw[i + 1 if i + 1 < B else i, rng.randint(0, lens[i])] = ord("N")
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    return raw, encode_rows(spec, raw, pack2), lens


UMI_LEN = 8


def make_umi_reads(n_reads: int, seed: int = 108) -> bytes:
    """The flagship reads (make_dataset's draw) behind a random 8-bp UMI:
    108 bp records ``@r<i> 1:N:0:ATCACG``, as ``-u 8 --rename
    '{id}_{cut_prefix} {comment}'`` moves the UMI into the name (the
    "--rename" section of cutadapt's user guide)."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[rng.randint(0, 4, (n_reads, UMI_LEN + READ_LEN),
                             dtype=np.uint8)]
    ad = np.frombuffer(ADAPTER.encode(), np.uint8)
    for i in np.flatnonzero(rng.rand(n_reads) < ADAPTER_FRACTION):
        pos = UMI_LEN + rng.randint(10, READ_LEN - 3)
        take = min(len(ad), UMI_LEN + READ_LEN - pos)
        seqs[i, pos : pos + take] = ad[:take]
    quals = rng.randint(35, 74, seqs.shape, dtype=np.uint8)
    return fastq_records(seqs, np.full(n_reads, UMI_LEN + READ_LEN), quals,
                         comment="1:N:0:ATCACG")


N_BARCODES = 16
BARCODE_LEN = 8


def make_barcoded_pairs(n_pairs: int, seed: int = 16) -> tuple:
    """make_pairs' pairs with one of 16 seeded 8-bp barcodes before R1 in
    95% of them: (R1, R2, the barcodes' FASTA ``>bc<k>``), the input of
    ``-g ^file:barcodes.fasta`` demultiplexing ("Demultiplexing
    paired-end reads" in cutadapt's user guide)."""
    r1, r2 = make_pairs(n_pairs, seed)
    rng = np.random.RandomState(seed)
    codes = set()
    while len(codes) < N_BARCODES:
        codes.add(bytes(np.frombuffer(b"ACGT", np.uint8)[
            rng.randint(0, 4, BARCODE_LEN)]))
    codes = sorted(codes)
    chunk = parse_fastq_chunk(r1)
    buf = np.frombuffer(r1, np.uint8)
    L = PAIR_READ_LEN
    seqs = buf[chunk.seq_start[:, None] + np.arange(L)]
    quals = buf[chunk.qual_start[:, None] + np.arange(L)]
    has = rng.rand(n_pairs) < 0.95
    bc = np.frombuffer(b"".join(codes), np.uint8).reshape(N_BARCODES, -1)[
        rng.randint(N_BARCODES, size=n_pairs)]
    pad = np.zeros((n_pairs, BARCODE_LEN), np.uint8)
    seqs = np.where(has[:, None], np.concatenate([bc, seqs], axis=1),
                    np.concatenate([seqs, pad], axis=1))
    bq = np.full((n_pairs, BARCODE_LEN), ord("I"), np.uint8)
    quals = np.where(has[:, None], np.concatenate([bq, quals], axis=1),
                     np.concatenate([quals, pad], axis=1))
    r1 = fastq_records(seqs, np.where(has, L + BARCODE_LEN, L), quals,
                       mate="/1")
    fasta = b"".join(b">bc%02d\n%s\n" % (k, c) for k, c in enumerate(codes))
    return r1, r2, fasta


def add_ns(data: bytes, fraction: float, seed: int = 5) -> bytes:
    """Copy of a FASTQ buffer in which ``fraction`` of the reads carry
    one to three N bases at random positions."""
    chunk = parse_fastq_chunk(data)
    buf = np.frombuffer(data, np.uint8).copy()
    rng = np.random.RandomState(seed)
    reads = np.flatnonzero(rng.rand(chunk.n_records) < fraction)
    for _ in range(3):
        keep = reads[rng.rand(len(reads)) < 0.6]
        off = (rng.rand(len(keep)) * chunk.seq_len[keep]).astype(np.int64)
        buf[chunk.seq_start[keep] + off] = ord("N")
    first = reads[chunk.seq_len[reads] > 0]
    buf[chunk.seq_start[first] + rng.randint(0, 4, len(first))] = ord("N")
    return buf.tobytes()


def edit_reads(data: bytes, seed: int) -> bytes:
    """The hard cases of the host stages: 3% of the reads with every
    quality at phred 2 (``-q`` trims them to nothing), 8% starting and
    8% ending in a run of 1-4 N, and N bases inside 10% (add_ns)."""
    chunk = parse_fastq_chunk(data)
    buf = np.frombuffer(data, np.uint8).copy()
    rng = np.random.RandomState(seed)
    n = chunk.n_records
    for i in np.flatnonzero(rng.rand(n) < 0.03):
        q = chunk.qual_start[i]
        buf[q : q + chunk.seq_len[i]] = ord("#")
    for at_end in (False, True):
        for i in np.flatnonzero(rng.rand(n) < 0.08):
            k = rng.randint(1, 5)
            s = chunk.seq_start[i] + (chunk.seq_len[i] - k if at_end else 0)
            buf[s : s + k] = ord("N")
    return add_ns(buf.tobytes(), 0.1, seed=seed + 1)


def split_records(data: bytes, records_per_chunk: int):
    """Split a FASTQ byte buffer at record boundaries; returns (chunks,
    number of records)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(buf == 10)
    n_records = len(nl) // 4
    bounds = [0]
    for r in range(records_per_chunk, n_records, records_per_chunk):
        bounds.append(int(nl[r * 4 - 1]) + 1)
    bounds.append(len(data))
    return [data[a:b] for a, b in zip(bounds[:-1], bounds[1:])], n_records


def host_trim(data: bytes, n_records: int):
    """The first ``n_records`` reads trimmed one by one on the host.
    Returns (FASTQ bytes, number of reads with an adapter match)."""
    chunk = parse_fastq_chunk(data)
    adapter = make_adapter()
    raw = bytes(chunk.buf)
    out = []
    matched = 0
    for i in range(min(n_records, chunk.n_records)):
        s, n, q = chunk.seq_start[i], chunk.seq_len[i], chunk.qual_start[i]
        rec = SequenceRecord(
            raw[chunk.head_start[i] : chunk.head_end[i]].decode("ascii"),
            raw[s : s + n].decode("ascii"),
            raw[q : q + n].decode("ascii"),
        )
        match = adapter.match_to(rec.sequence)
        if match is not None:
            matched += 1
            rec = match.trimmed(rec)
        out.append(rec.fastq_bytes())
    return b"".join(out), matched


def assert_same(got, want, path="stats"):
    """Nested dicts, lists and arrays (engine statistics) equal, key for
    key and element for element; ``path`` names the first difference."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


# the port's modules that build an adapter stage from adapter specs, in
# the order cutter_stage takes them
PORT_MODULES = (parser, modifiers, accel, batch_pipeline)


def cutter_stage(pkg, specs, action="trim", times=1, **params):
    """The adapter stage a package's CLI builds for adapter specs
    [(type, spec)]: parser, AdapterCutter (indexed regrouping) and the
    translation of its adapters into tasks. ``pkg`` holds the package's
    modules as PORT_MODULES does; returns (stage, tasks)."""
    pkg_parser, pkg_modifiers, pkg_accel, pkg_bp = pkg
    search = dict(max_errors=0.1, min_overlap=3, read_wildcards=False,
                  adapter_wildcards=True, indels=True)
    search.update(params)
    adapters = pkg_parser.make_adapters_from_specifications(specs, search)
    cutter = pkg_modifiers.AdapterCutter(adapters, times=times, action=action)
    tasks = pkg_accel._translate_tasks(cutter)
    assert tasks is not None
    stage = pkg_bp.AdapterStage(tasks, times=times, action=action,
                                modifier=cutter)
    return stage, tasks


# --- the golden cases of the CLI ---------------------------------------------

TESTS = os.path.dirname(os.path.abspath(__file__))

# Golden cases whose pipeline the port's engine does not express yet, each
# with the reason its translation gives (a substring of the require-mode
# error). A case leaves this dict when a later slice ports what it names.
ENGINE_NOT_YET = {}
# Paired golden cases (tests/test_paired.py) the port's engine refuses
# yet, each with the reason its translation gives
ENGINE_NOT_YET_PAIRED = {}
# Accepted cases in which the aligner has nothing to do
NO_ALIGNER_RUN = {
    "fasta_no_trim": "no adapter",
    "empty_wildcard": "no reads",
    "trim_n": "host stage only",
    "quality_trim_only": "host stage only",
    "polya": "host stage only",
    "cut_front": "host stage only",
    "cut_back": "host stage only",
    "cut_both": "host stages only",
    "nextseq": "host stage only",
    "length": "host stage only",
    "negative_length": "host stage only",
    "qualtrim": "the k-mer prefilter passes no read for XXXXXX",
    "qualbase": "the k-mer prefilter passes no read for XXXXXX",
    "strip_suffix": "the k-mer prefilter passes no read for XXXXXXX",
    "anchored_back_no_indels": "comparer (host) task only",
    "anchored_no_indels": "comparer (host) task only",
    "anchored_no_indels_wildcard_read": "comparer (host) task only",
    "anchored_no_indels_wildcard_adapt": "comparer (host) task only",
    "multiple_prefix": "indexed (host) task only",
    "multiple_prefix_noindels": "indexed (host) task only",
    "multiple_suffix_noindels": "indexed (host) task only",
}


def _assignment(module: str, name: str):
    """The value node of ``name = ...`` in a test module of this
    directory, read without importing the module (which imports the JAX
    package)."""
    path = os.path.join(TESTS, module)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return node.value
    raise LookupError(f"no {name} assignment in {path}")


def golden_cases():
    """The (id, params, expected, input) tuples of
    ``tests/test_commandline.py:GOLDEN_CASES`` (``ast.literal_eval``)."""
    return ast.literal_eval(_assignment("test_commandline.py",
                                        "GOLDEN_CASES"))


def paired_golden_cases():
    """The (id, params, in1, in2, expected1, expected2) tuples of
    ``tests/test_paired.py:PAIRED_GOLDEN_CASES``."""
    return ast.literal_eval(_assignment("test_paired.py",
                                        "PAIRED_GOLDEN_CASES"))


def accel_configs() -> dict:
    """``tests/test_accel.py:CONFIGS`` as {id: (args, paired)}: the list
    is evaluated with only its adapter constants A3 and A5 in scope."""
    names = {k: ast.literal_eval(_assignment("test_accel.py", k))
             for k in ("A3", "A5")}
    node = ast.Expression(_assignment("test_accel.py", "CONFIGS"))
    configs = eval(compile(node, "test_accel.py", "eval"),
                   {"__builtins__": {}}, names)
    return {name: (args, paired) for name, args, paired in configs}


def accel_reads(path, n=800, seed=1, paired=False):
    """A copy of ``tests/test_accel.py:make_reads`` (single-end or two
    files): reads of 20-90 random bases, half of them with the adapter
    A3 (R1) or A5 (R2) spliced in. Returns the input paths."""
    import random

    names = {k: ast.literal_eval(_assignment("test_accel.py", k))
             for k in ("A3", "A5")}
    rng = random.Random(seed)

    def rec(i, tag, adapter):
        L = rng.randint(20, 90)
        s = "".join(rng.choice("ACGT") for _ in range(L))
        if rng.random() < 0.5 and L > 25:
            p = rng.randint(5, L - 10)
            s = (s[:p] + adapter + s[p:])[:L]
        q = "".join(chr(rng.randint(35, 72)) for _ in s)
        return f"@x{i}{tag}\n{s}\n+\n{q}\n"

    if paired:
        p2 = str(path) + ".2"
        with open(path, "w") as f1, open(p2, "w") as f2:
            for i in range(n):
                f1.write(rec(i, "/1", names["A3"]))
                f2.write(rec(i, "/2", names["A5"]))
        return [path, p2]
    with open(path, "w") as f:
        for i in range(n):
            f.write(rec(i, "", names["A3"]))
    return [path]


def golden_args(params, out: str, inpath: str) -> List[str]:
    """The command line of one golden case writing to ``out``."""
    params = params.split() if isinstance(params, str) else list(params)
    return params + ["-o", out, os.path.join(TESTS, "data", inpath)]


def paired_golden_args(params, out1: str, out2: str, in1: str,
                       in2: str) -> List[str]:
    """The command line of one paired golden case (tests/conftest.py's
    run_paired) writing to ``out1`` and ``out2``."""
    params = params.split() if isinstance(params, str) else list(params)
    return params + ["--buffer-size=512", "-o", out1, "-p", out2,
                     os.path.join(TESTS, "data", in1),
                     os.path.join(TESTS, "data", in2)]


# keys of the --json report that differ between two packages' runs of
# one configuration
VOLATILE_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


def json_report(path) -> dict:
    """A --json report without its volatile keys."""
    import json

    with open(path) as f:
        report = json.load(f)
    for key in VOLATILE_REPORT_KEYS:
        report.pop(key, None)
    return report


def load_host_pickle(path):
    """The object pickled at ``path``; raises pickle.UnpicklingError if
    it holds any object of a ``torch`` module (a tensor, on the card or
    the CPU)."""
    import pickle

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch" or module.startswith("torch."):
                raise pickle.UnpicklingError(
                    f"the pickle holds a torch object: {module}.{name}")
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return Unpickler(f).load()


def golden_path(expected: str) -> str:
    return os.path.join(TESTS, "cut", expected)


@contextlib.contextmanager
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread. The plain aligner issues many
    small tensor ops per DP column; where several test processes share the
    host's cores, a pool of threads per op spends far longer waiting at
    its barriers than computing (the CLI tests ran hundreds of times
    slower that way)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# --- the aligner's parity matrix ---------------------------------------------


def _specs(cases) -> List[AlignerSpec]:
    # (reference, wildcard_ref, flags, rate, indel_cost, min_overlap)
    return [
        AlignerSpec(reference=ref, max_error_rate=rate, flags=flags.value,
                    wildcard_ref=wc, indel_cost=ic, min_overlap=mo)
        for ref, wc, flags, rate, ic, mo in cases
    ]


def parity_specs() -> List[AlignerSpec]:
    return _specs([
        (ADAPTER, False, Where.BACK, 0.1, 1, 3),
        (ADAPTER, False, Where.BACK, 0.2, 1, 3),
        (ADAPTER, False, Where.BACK, 0.0, 1, 3),
        (NEXTERA, False, Where.FRONT, 0.1, 1, 3),
        (NEXTERA, False, Where.ANYWHERE, 0.15, 1, 3),
        ("ANGNTCGGANGCT", True, Where.BACK, 0.2, 1, 3),
        ("ACGTNNNACGT", True, Where.FRONT, 0.1, 1, 3),
        (NEXTERA, False, Where.BACK_NOT_INTERNAL, 0.1, 1, 3),
        (NEXTERA, False, Where.FRONT_NOT_INTERNAL, 0.1, 1, 3),
        ("TTAGACATAT", False, Where.PREFIX, 0.2, 1, 10),
        ("TTAGACATAT", False, Where.SUFFIX, 0.2, 1, 10),
        (ADAPTER, False, Where.BACK, 0.1, 100000, 3),  # --no-indels
        (ADAPTER, False, Where.BACK, 0.1, 1, 12),  # high min_overlap
    ])


def _with_adapter_tail(rng: np.random.RandomState, m: int) -> str:
    """A reference of length m: random bases, then the TruSeq adapter."""
    return "".join(rng.choice(list("ACGT"), m - len(ADAPTER))) + ADAPTER


def block_edge_specs() -> List[AlignerSpec]:
    """Adapters of lanes * rows - 1, lanes * rows and lanes * rows + 1 DP
    rows for the flagship adapter's kernel layout: the last lane's block
    one row short, full, and one row over (the next layout). Each as a
    3' adapter, a prefix and a suffix (the suffix starts its reads'
    columns at min_n > 0)."""
    lay = kernel_layout(len(ADAPTER))
    rng = np.random.RandomState(40)
    cases = []
    for rows in (lay.lanes * lay.rows + d for d in (-1, 0, 1)):
        ref = _with_adapter_tail(rng, rows - 1)
        cases += [(ref, False, where, 0.1, 1, 3)
                  for where in (Where.BACK, Where.PREFIX, Where.SUFFIX)]
    return _specs(cases)


def variant_specs() -> List[AlignerSpec]:
    """One adapter per register variant of the kernel (lanes, rows):
    lanes * rows DP rows, every lane's block full. A 3' adapter, and in
    turn a prefix, a suffix or an anywhere adapter, so that each variant
    also resolves a band of another kind. An error rate of 0.15 allows an
    error from 7 bp on."""
    rng = np.random.RandomState(41)
    kinds = (Where.PREFIX, Where.SUFFIX, Where.ANYWHERE)
    variants = sorted({(lay.lanes, lay.rows) for lay in map(
        kernel_layout, range(1, 256)) if lay.mode == "registers"})
    cases = []
    for v, (lanes, rows) in enumerate(variants):
        m = lanes * rows - 1
        ref = ADAPTER[-m:] if m <= len(ADAPTER) else _with_adapter_tail(rng, m)
        cases += [(ref, False, where, 0.15, 1, 3)
                  for where in (Where.BACK, kinds[v % 3])]
    return _specs(cases)


def placement(spec: AlignerSpec) -> dict:
    """Where random_batch puts the adapter copies so that ``spec`` can
    find them: at the read's start where the query start is fixed, at its
    end where the query stop is."""
    return dict(at_start=not spec.start_in_query,
                at_end=spec.start_in_query and not spec.stop_in_query)


def variant_read_length(spec: AlignerSpec) -> int:
    """Reads for a variant adapter: at least twice its length, so that
    every row runs full columns and suffix reads start at min_n > 0."""
    return max(128, -(-2 * (len(spec.reference) + 1) // 4) * 4)


def long_specs() -> List[AlignerSpec]:
    """200 bp adapters (32 lanes of 7 rows, the widest register variant)
    and a 300 bp one (301 DP rows: each lane's rows in shared memory)."""
    rng = np.random.RandomState(200)
    ref = _with_adapter_tail(rng, 200)
    wild = ref[:60] + "NN" + ref[62:]
    return _specs([
        (ref, False, Where.BACK, 0.1, 1, 3),
        (ref, False, Where.ANYWHERE, 0.1, 1, 3),
        (wild, True, Where.BACK, 0.1, 1, 3),
        (_with_adapter_tail(rng, 300), False, Where.BACK, 0.1, 1, 3),
    ])


def very_long_spec() -> AlignerSpec:
    """A 4,000 bp adapter: a block of lanes' rows does not fit in shared
    memory, so they live in the wrapper's device scratch buffer."""
    return _specs([(_with_adapter_tail(np.random.RandomState(4000), 4000),
                    False, Where.BACK, 0.1, 1, 3)])[0]




# --- the byte lane: adapters of more than 16 query classes ------------------

# 16 distinct letters compared as ASCII (-N): with "any other byte", 17
# query classes, past what the 4-bit lane's class ids hold
BYTE_LANE_LETTERS = "ACGTRYKMXSWBDHVN"
# chip_smoke.py's byte-lane CLI phase: a 20 bp adapter of 17 classes
BYTE_LANE_ADAPTER = BYTE_LANE_LETTERS + "ACGT"


def _byte_lane_reference(rng: np.random.RandomState, m: int) -> str:
    """m >= 16 bases: the 16 letters in a seeded order, then repeats."""
    letters = list(BYTE_LANE_LETTERS)
    head = "".join(rng.permutation(letters))
    return head + "".join(rng.choice(letters, m - len(letters)))


def byte_lane_specs() -> List[AlignerSpec]:
    """Byte-lane specs of each kernel task kind's flags (3' and 5'
    adapters, anchored prefix and suffix, non-internal and anywhere), all
    compared as ASCII with more than 16 query classes."""
    rng = np.random.RandomState(17)
    return _specs([
        (BYTE_LANE_ADAPTER, False, Where.BACK, 0.1, 1, 3),
        (_byte_lane_reference(rng, 24), False, Where.FRONT, 0.1, 1, 3),
        (_byte_lane_reference(rng, 20), False, Where.PREFIX, 0.15, 1, 10),
        (_byte_lane_reference(rng, 20), False, Where.SUFFIX, 0.15, 1, 10),
        (BYTE_LANE_ADAPTER, False, Where.BACK_NOT_INTERNAL, 0.1, 1, 3),
        (BYTE_LANE_ADAPTER, False, Where.ANYWHERE, 0.1, 1, 3),
        (BYTE_LANE_ADAPTER, False, Where.BACK, 0.1, 100000, 3),
    ])


def byte_variant_specs() -> List[AlignerSpec]:
    """One byte-lane adapter per instantiation of the byte lane: lanes x
    rows - 1 bp for each register variant that an adapter of 16 bp or
    more reaches (every lane's block full), a 300 bp one (rows in shared
    memory) and a 4,000 bp one (device scratch); 3' adapters, and in turn
    a prefix, a suffix or an anywhere adapter for the register
    variants."""
    rng = np.random.RandomState(18)
    kinds = (Where.PREFIX, Where.SUFFIX, Where.ANYWHERE)
    variants = sorted({(lay.lanes, lay.rows) for lay in map(
        kernel_layout, range(len(BYTE_LANE_LETTERS), 256))
        if lay.mode == "registers"})
    cases = [(_byte_lane_reference(rng, lanes * rows - 1), False,
              Where.BACK if v % 2 == 0 else kinds[v // 2 % 3], 0.15, 1, 3)
             for v, (lanes, rows) in enumerate(variants)]
    cases += [(_byte_lane_reference(rng, m), False, Where.BACK, 0.1, 1, 3)
              for m in (300, 4000)]
    return _specs(cases)


def byte_variant_batch(spec: AlignerSpec, rng: np.random.RandomState):
    """A parity batch for a byte_variant_specs adapter: 1,024 reads of at
    least twice its length for a register variant, 512 (64 past 1,000
    bp, where the scalar check is the slow part) of 512 bp beyond."""
    m = len(spec.reference)
    if m < 256:
        return random_batch(spec, rng, 1024, variant_read_length(spec), None,
                            **placement(spec))
    return random_batch(spec, rng, 64 if m > 1000 else 512, 512, None)


def make_byte_lane_reads(n_reads: int, seed: int = 17,
                         read_len: int = READ_LEN) -> bytes:
    """FASTQ records ``@r<i>`` of ``read_len`` random ACGT bases, phred
    2-40: a quarter carry a prefix of BYTE_LANE_ADAPTER (at least 3 bp,
    the run's minimum overlap) at a uniform position with up to 2
    substitutions, and 3% carry one to three N."""
    rng = np.random.RandomState(seed)
    n, L = n_reads, read_len
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[rng.randint(0, 4, (n, L), dtype=np.uint8)]
    ad = np.frombuffer(BYTE_LANE_ADAPTER.encode(), np.uint8)
    for i in np.flatnonzero(rng.rand(n) < ADAPTER_FRACTION):
        pos = rng.randint(0, L - 3)
        take = min(len(ad), L - pos)
        seqs[i, pos : pos + take] = ad[:take]
        for _ in range(rng.randint(0, 3)):
            seqs[i, pos + rng.randint(take)] = bases[rng.randint(4)]
    for i in np.flatnonzero(rng.rand(n) < 0.03):
        seqs[i, rng.randint(0, L, rng.randint(1, 4))] = ord("N")
    quals = rng.randint(35, 74, (n, L), dtype=np.uint8)
    return fastq_records(seqs, np.full(n, L), quals)


def random_batch(spec: AlignerSpec, rng: np.random.RandomState, B: int,
                 L: int, pack2: Optional[bool], at_start: bool = False,
                 at_end: bool = False):
    """(raw bytes (B, L), packed class ids (B, L/4 or L/2) or, in the byte
    lane (pack2 None), query codes (B, L), lengths (B,)).

    Reads draw from ``ACGTNacgt`` (and, in the byte lane, also from the
    IUPAC letters of BYTE_LANE_ADAPTER); a third of them carry a spliced
    adapter copy with one substitution, at the read's start if
    ``at_start`` (as a prefix adapter needs it), at its end, the read
    L bp long, if ``at_end`` (as a suffix adapter needs it). For the 2-bit
    lane every byte whose class id does not fit in 2 bits becomes 'A', so
    the batch is what the engine's clean-window split would send there."""
    alphabet = b"ACGTNacgt" + (b"RYKMSWX" if pack2 is None else b"")
    raw = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
    ad = np.frombuffer(spec.reference.encode(), np.uint8)
    for i in range(0, B, 3):
        if at_end:
            pos = max(0, L - len(ad))
        else:
            pos = 0 if at_start else rng.randint(0, L - 4)
        take = min(len(ad), L - pos)
        raw[i, pos : pos + take] = ad[:take]
        if spec.max_error_rate > 0 and take > 4:
            raw[i, pos + rng.randint(take)] = ord("T")
    lens = rng.randint(0, L + 1, B).astype(np.int32)
    if at_end:
        lens[::3] = L
    if pack2:
        raw[query_class_info(spec)[0][raw] > 3] = ord("A")
    raw[np.arange(L)[None, :] >= lens[:, None]] = 0
    return raw, encode_rows(spec, raw, pack2), lens


# --- the pipeline shapes of the mesh check -----------------------------------

# the four shapes of __graft_entry__.py:_dryrun_real_pipeline: paired
# -a/-A with -q, -m and --discard-untrimmed; paired demultiplexing by a
# 5' barcode; a linked adapter beside an indexed anchored set; paired
# --revcomp with --rename
MESH_SHAPES = ("flagship", "demux", "linked_indexed", "revcomp_rename")
MESH_BARCODES = ("AACCGGTT", "CGTATGCA", "TTGACCAA")


def write_mesh_pairs(directory: str, n_pairs: int = 700,
                     seed: int = 11) -> dict:
    """The read pairs of the four mesh shapes, as _dryrun_real_pipeline
    makes them (random ACGT of 20-90 bp, half with the side's adapter
    inside, a barcode before three quarters of the barcoded R1 reads;
    the revcomp pairs carry the R1 adapter on either read), written to
    ``directory``. Returns {"plain" | "barcoded" | "rc": [R1, R2] paths}."""
    import random

    rng = random.Random(seed)
    a1, a2 = ADAPTER, NEXTERA

    def rand(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def quals(s):
        return "".join(chr(rng.randint(35, 72)) for _ in s)

    def side(adapter, barcoded=False):
        recs = []
        for i in range(n_pairs):
            L = rng.randint(20, 90)
            s = rand(L)
            if rng.random() < 0.5 and L > 25:
                p = rng.randint(10, L - 10)
                s = (s[:p] + adapter + s[p:])[:L]
            if barcoded and rng.random() < 0.75:
                s = rng.choice(MESH_BARCODES) + s
            recs.append(f"@p{i}/x\n{s}\n+\n{quals(s)}\n")
        return "".join(recs)

    def rc_sides():
        r1, r2 = [], []
        for i in range(n_pairs):
            L = rng.randint(25, 90)
            s1, s2 = rand(L), rand(L)
            p = rng.randint(10, max(11, L - 10))
            if rng.random() < 0.5:
                s1 = (s1[:p] + a1 + s1[p:])[:L]
            else:
                s2 = (s2[:p] + a1 + s2[p:])[:L]
            r1.append(f"@rc{i}/x\n{s1}\n+\n{quals(s1)}\n")
            r2.append(f"@rc{i}/x\n{s2}\n+\n{quals(s2)}\n")
        return "".join(r1), "".join(r2)

    files = {}
    for stem, sides in (("plain", (side(a1), side(a2))),
                        ("barcoded", (side(a1, barcoded=True), side(a2))),
                        ("rc", rc_sides())):
        files[stem] = []
        for k, text in enumerate(sides):
            files[stem].append(os.path.join(directory, f"{stem}.{k + 1}.fastq"))
            with open(files[stem][-1], "w") as f:
                f.write(text)
    return files


def mesh_shape_args(shape: str, files: dict, out: str) -> List[str]:
    """The CLI arguments of one mesh shape, outputs under ``out``. Every
    adapter is named: unnamed ones are numbered per process."""
    a1, a2 = ADAPTER, NEXTERA
    o = ["-o", os.path.join(out, "o.1.fastq"),
         "-p", os.path.join(out, "o.2.fastq")]
    if shape == "flagship":
        return ["--quiet", "-a", f"ad1={a1}", "-A", f"ad2={a2}", "-q", "15",
                "-m", "25", "--discard-untrimmed"] + o + files["plain"]
    if shape == "demux":
        gs = [x for i, b in enumerate(MESH_BARCODES)
              for x in ("-g", f"bc{i}=^{b}")]
        return gs + ["--quiet", "--no-indels", "-e", "0",
                     "-o", os.path.join(out, "dm-{name}.1.fastq"),
                     "-p", os.path.join(out, "dm-{name}.2.fastq")] \
            + files["barcoded"]
    if shape == "linked_indexed":
        gs = [x for i, b in enumerate(
            MESH_BARCODES + ("GGTTAACC", "ACACGTGT", "GTCAGTCA"))
            for x in ("-g", f"ix{i}=^{b}")]
        return gs + ["--quiet", "-a", f"lnk={a2}...{a1}", "-m", "20"] + o \
            + files["barcoded"]
    if shape == "revcomp_rename":
        return ["--quiet", "--revcomp", "-a", f"ad1={a1}", "-A", f"ad2={a2}",
                "--rename", "{id} a={adapter_name}", "-m", "20"] + o \
            + files["rc"]
    raise ValueError(f"unknown mesh shape {shape!r}")
