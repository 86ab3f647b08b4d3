"""The benchmark's one traffic generator: FASTQ reads, or read pairs,
made from ``--seed`` and the parameters of a traffic file
(``traffic/<name>.json``).

Every read (or pair) is a random insert followed by the adapter and
random bases, cut to the read length; R2 reads the insert's reverse
complement followed by its own adapter. An insert at least as long as
the read leaves no adapter in it. Then a substitution by a random base
at ``substitution_rate`` of the bases (a random place each, so a few
coincide and a quarter keep their base), and N at 1-3 positions in a share
of each mate's reads; qualities from the traffic's model.

The work a file needs does not change with the seed: the insert lengths
are an even tiling of each range, the substitutions and the reads with
N exact counts (1, 2 and 3 N in turn), and only their order, places
and the random bases come from the seed. The arrays are made on the
device a run generates on (the card) in a few large calls.

Traffic parameters (all required):

- ``layout``: ``single`` or ``paired``;
- ``reads_per_file``: reads (pairs) in the timed file;
- ``warmup_reads``: reads (pairs) of the warm-up file;
- ``read_length``: bases per read;
- ``inserts``: ``[[share, lo, hi], ...]``, shares summing to 1, lengths
  inclusive;
- ``adapters``: the sequence following the insert, one per mate;
- ``substitution_rate``, ``n_read_share``;
- ``quality``: ``{"model": "uniform", "lo": 2, "hi": 40}`` or
  ``{"model": "decay", "start": 37, "drop": 27, "power": 3, "sd": 3,
  "lo": 2, "hi": 41}`` (phred ``start - drop * x**power`` plus normal
  noise at the relative position ``x``, clipped).

Optional, for traffic of another shape:

- ``generator``: a file ``generators/<name>.py`` whose ``make(traffic,
  seed, stream, device)`` returns the mates (a list of :class:`Reads`,
  whose ``lens`` may differ from read to read) in place of this model;
  it reads whatever further keys its traffic files give it;
- ``files``: how many input files (pairs of files) a run makes, each a
  stream of the seed; the window calls main on them in turn (default 1);
- ``compression``: ``"gzip"`` for ``.fastq.gz`` in (at gzip's level
  6) and out (at the program's own level), digested uncompressed;
  absent or null for plain ``.fastq``.
"""

import gzip
import hashlib
import importlib.util
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GENERATORS = os.path.join(HERE, "generators")
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)
# the streams of one seed: the (first) timed file and the warm-up file
TIMED, WARMUP = 0, 1
# gzip's own default level, for compressed input files
INPUT_GZIP_LEVEL = 6


@dataclass
class Reads:
    """One FASTQ file as arrays: record i is ``@names[i]``, the first
    ``lens[i]`` bytes of ``seqs[i]``, ``+`` and as many of ``quals[i]``."""

    names: np.ndarray  # (N, w) uint8, without '@' and newline
    seqs: np.ndarray  # (N, W) uint8
    quals: np.ndarray  # (N, W) uint8, phred + 33
    lens: np.ndarray  # (N,) int64

    def __len__(self):
        return len(self.lens)


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def file_stream(index: int) -> int:
    """The stream of the seed that makes timed file ``index``."""
    return TIMED if index == 0 else WARMUP + index


def suffix(traffic: dict) -> str:
    """The file name suffix of the traffic's inputs and outputs."""
    compression = traffic.get("compression")
    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    return ".fastq.gz" if compression == "gzip" else ".fastq"


def file_bytes(traffic: dict, reads: Reads) -> bytes:
    """One input file as the traffic stores it on disk."""
    data = fastq_bytes(reads)
    if traffic.get("compression") == "gzip":
        return gzip.compress(data, INPUT_GZIP_LEVEL, mtime=0)
    return data


def make(traffic: dict, seed: int, stream: int = TIMED,
         device: str = "cpu") -> list:
    """The mates of one file of the traffic: from the generator that the
    traffic names (``generators/<name>.py``), or this module's model."""
    name = traffic.get("generator")
    if name is None:
        return make_reads(traffic, seed, stream, device)
    path = os.path.join(GENERATORS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_generator_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make(traffic, seed, stream, device)


def seed64(seed: int, stream: int) -> int:
    """A 64-bit seed for ``stream`` of ``seed``; any integer seed,
    negative or beyond 64 bits included."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def _tiled(ranges, n: int) -> np.ndarray:
    """n integers: each [share, lo, hi] range gets its share of n (the
    largest remainders rounded up) as an even tiling of lo..hi."""
    shares = np.array([r[0] for r in ranges], np.float64)
    if not np.isclose(shares.sum(), 1.0):
        raise ValueError(f"insert shares sum to {shares.sum()}, not 1")
    exact = shares * n
    counts = np.floor(exact).astype(np.int64)
    short = n - int(counts.sum())
    counts[np.argsort(counts - exact)[:short]] += 1
    parts = [lo + (np.arange(c) * (hi - lo + 1)) // max(c, 1)
             for (_, lo, hi), c in zip(ranges, counts)]
    return np.concatenate(parts).astype(np.int64)


def _names(n: int, suffix: bytes) -> np.ndarray:
    """(n, w) names ``r<i>`` with i zero-padded to one width, then
    ``suffix``."""
    width = len(str(max(n - 1, 0)))
    digits = (np.arange(n, dtype=np.int64)[:, None]
              // 10 ** np.arange(width - 1, -1, -1)[None, :]) % 10
    out = np.empty((n, 1 + width + len(suffix)), np.uint8)
    out[:, 0] = ord("r")
    out[:, 1 : 1 + width] = 48 + digits
    if suffix:
        out[:, 1 + width :] = np.frombuffer(suffix, np.uint8)
    return out


def _bases(r: torch.Tensor) -> torch.Tensor:
    """Codes 0..3 (uint8) as the letters A, C, G, T."""
    u8 = torch.uint8
    return r * 2 + 65 + (r >= 2).to(u8) * 2 + (r == 3).to(u8) * 11


def _qualities(q: dict, n: int, L: int, g, dev) -> torch.Tensor:
    if q["model"] == "uniform":
        phred = torch.randint(q["lo"], q["hi"] + 1, (n, L), generator=g,
                              device=dev, dtype=torch.uint8)
    elif q["model"] == "decay":
        x = torch.arange(L, device=dev, dtype=torch.float32) / max(L - 1, 1)
        mean = q["start"] - q["drop"] * x ** q["power"]
        noise = torch.randn((n, L), generator=g, device=dev) * q["sd"]
        phred = (mean[None, :] + noise).round_().clamp_(q["lo"], q["hi"])
        phred = phred.to(torch.uint8)
    else:
        raise ValueError(f"unknown quality model {q['model']!r}")
    return phred + 33


def make_reads(traffic: dict, seed: int, stream: int = TIMED,
               device: str = "cpu") -> list:
    """The model's timed file (``TIMED`` or ``file_stream(i)``) or
    warm-up file (``WARMUP``) for ``seed``, made on ``device`` from a
    torch.Generator there (one seed gives other bases on another device,
    the same shapes and counts): one :class:`Reads` per mate."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed64(seed, stream))
    n = traffic["warmup_reads" if stream == WARMUP else "reads_per_file"]
    L = traffic["read_length"]
    paired = traffic["layout"] == "paired"
    adapters = traffic["adapters"]
    if len(adapters) != (2 if paired else 1):
        raise ValueError("one adapter per mate")

    def rand_bases(shape):
        return _bases(torch.randint(0, 4, shape, generator=g, device=dev,
                                    dtype=torch.uint8))

    order = torch.randperm(n, generator=g, device=dev)
    insert = torch.from_numpy(_tiled(traffic["inserts"], n)).to(dev)[order]
    width = max(L, int(insert.max())) if paired and n else L
    frag = rand_bases((n, width))
    col = torch.arange(L, device=dev)[None, :]
    mates = []
    for mate, adapter in enumerate(adapters):
        if mate == 0:
            view = frag[:, :L]
        else:  # R2 reads the reverse complement of the insert
            src = (insert[:, None] - 1 - col).clamp(0, width - 1)
            view = torch.from_numpy(COMPLEMENT).to(dev)[
                torch.gather(frag, 1, src).long()]
        ad = torch.tensor(list(adapter.encode()), dtype=torch.uint8,
                          device=dev)
        rel = col - insert[:, None]
        seqs = torch.where(
            rel < 0, view,
            torch.where(rel < len(ad), ad[rel.clamp(0, len(ad) - 1)],
                        rand_bases((n, L))))
        flat = seqs.view(-1)
        n_sub = int(round(traffic["substitution_rate"] * n * L))
        # one value per place: a place drawn twice would take either
        where = torch.unique(torch.randint(0, max(n * L, 1), (n_sub,),
                                           generator=g, device=dev))
        flat[where] = rand_bases((len(where),))
        n_dirty = int(round(traffic["n_read_share"] * n))
        dirty = torch.randperm(n, generator=g, device=dev)[:n_dirty]
        per_read = 1 + torch.arange(n_dirty, device=dev) % 3
        for k in range(3):
            hit = dirty[per_read > k]
            at = torch.randint(0, L, (len(hit),), generator=g, device=dev)
            seqs[hit, at] = ord("N")
        quals = _qualities(traffic["quality"], n, L, g, dev)
        mates.append(Reads(_names(n, f"/{mate + 1}".encode() if paired else b""),
                           seqs.cpu().numpy(), quals.cpu().numpy(),
                           np.full(n, L, np.int64)))
    return mates


def fastq_bytes(reads: Reads, keep=None) -> bytes:
    """The FASTQ text of ``reads`` (only the records where ``keep`` is
    true, if given): ``@name``, sequence, ``+``, qualities."""
    names, seqs, quals, lens = reads.names, reads.seqs, reads.quals, reads.lens
    if keep is not None:
        names, seqs, quals, lens = names[keep], seqs[keep], quals[keep], lens[keep]
    n, w = names.shape
    W = seqs.shape[1]
    lens = lens.astype(np.int64)
    if n and (lens == W).all():  # one record length: a (n, len) array
        rec = np.empty((n, w + 2 * W + 6), np.uint8)
        rec[:, 0] = ord("@")
        rec[:, 1 : w + 1] = names
        rec[:, w + 1] = 10
        rec[:, w + 2 : w + 2 + W] = seqs
        rec[:, w + 2 + W : w + 5 + W] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, w + 5 + W : w + 5 + 2 * W] = quals
        rec[:, -1] = 10
        return rec.tobytes()
    rec_len = w + 2 * lens + 6
    start = np.cumsum(rec_len) - rec_len
    out = np.empty(int(rec_len.sum()), np.uint8)
    out[start] = ord("@")
    out[start[:, None] + 1 + np.arange(w)[None, :]] = names
    out[start + w + 1] = 10
    inside = np.arange(W)[None, :] < lens[:, None]
    seq_at = start[:, None] + w + 2 + np.arange(W)[None, :]
    out[seq_at[inside]] = seqs[inside]
    mid = start + w + 2 + lens
    out[mid] = 10
    out[mid + 1] = ord("+")
    out[mid + 2] = 10
    out[(seq_at + lens[:, None] + 3)[inside]] = quals[inside]
    out[start + rec_len - 1] = 10
    return out.tobytes()


# outputs are digested in blocks of this many bytes, so that a mismatch
# says where in the file it starts
DIGEST_BLOCK = 1 << 22


def block_digests(data: bytes) -> list:
    """sha256 of each DIGEST_BLOCK-byte block of ``data`` (what
    sink.DigestSink gives for the same bytes)."""
    view = memoryview(data)
    return [hashlib.sha256(view[i : i + DIGEST_BLOCK]).hexdigest()
            for i in range(0, len(data), DIGEST_BLOCK)]
