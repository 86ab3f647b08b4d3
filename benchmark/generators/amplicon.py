"""Paired amplicon reads with a primer at each end of the amplicon, as
cutadapt's recipe for amplicon primers on paired-end reads expects.

The amplicon is the forward primer, a random insert and the reverse
complement of the reverse primer. R1 reads it from its start and R2
reads its reverse complement (the reverse primer, the insert's reverse
complement, the forward primer's reverse complement); past the
amplicon's end both read random bases, cut to the read length. Besides
these pairs, a share of pairs carries no primer (random bases on both
mates) and a share carries the forward primer on R1 only (R1 the
primer then random bases, R2 random bases), as off-target products and
primer dimers give.

The work a file needs does not change with the seed: the insert lengths
of the pairs with both primers are an even tiling of their ranges, the
pairs of each kind, the substitutions and the reads with N exact counts
(1, 2 and 3 N in turn), and only their order, places and the random
bases come from the seed.

Traffic keys besides the model's ``layout`` (``paired``),
``reads_per_file``, ``warmup_reads``, ``read_length``, ``inserts``,
``substitution_rate``, ``n_read_share`` and ``quality``:

- ``primers``: the forward and the reverse primer, 5' to 3';
- ``no_primer_share``: pairs with no primer;
- ``one_primer_share``: pairs with the forward primer on R1 only.
"""

import numpy as np
import torch

from benchmark import generate

# what each pair carries
BOTH, FORWARD_ONLY, NONE = 0, 1, 2


def _with_errors(seqs, traffic, g, dev):
    """Substitutions at ``substitution_rate`` of the bases (a random
    place each) and 1-3 N in ``n_read_share`` of the reads, in place."""
    n, L = seqs.shape
    flat = seqs.view(-1)
    n_sub = int(round(traffic["substitution_rate"] * n * L))
    where = torch.unique(torch.randint(0, max(n * L, 1), (n_sub,),
                                       generator=g, device=dev))
    flat[where] = generate._bases(torch.randint(
        0, 4, (len(where),), generator=g, device=dev, dtype=torch.uint8))
    n_dirty = int(round(traffic["n_read_share"] * n))
    dirty = torch.randperm(n, generator=g, device=dev)[:n_dirty]
    per_read = 1 + torch.arange(n_dirty, device=dev) % 3
    for k in range(3):
        hit = dirty[per_read > k]
        at = torch.randint(0, L, (len(hit),), generator=g, device=dev)
        seqs[hit, at] = ord("N")


def make(traffic: dict, seed: int, stream: int = generate.TIMED,
         device: str = "cpu") -> list:
    """The R1 and R2 reads (one generate.Reads each) of one file."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(generate.seed64(seed, stream))
    n = traffic["warmup_reads" if stream == generate.WARMUP
                else "reads_per_file"]
    L = traffic["read_length"]
    fwd, rev = (torch.tensor(list(p.encode()), dtype=torch.uint8, device=dev)
                for p in traffic["primers"])
    comp = torch.from_numpy(generate.COMPLEMENT).to(dev)
    n_none = int(round(traffic["no_primer_share"] * n))
    n_one = int(round(traffic["one_primer_share"] * n))
    n_both = n - n_none - n_one
    kind = torch.tensor([BOTH] * n_both + [FORWARD_ONLY] * n_one
                        + [NONE] * n_none, dtype=torch.int64, device=dev)
    insert = torch.zeros(n, dtype=torch.int64, device=dev)
    insert[:n_both] = torch.from_numpy(
        generate._tiled(traffic["inserts"], n_both)).to(dev)
    order = torch.randperm(n, generator=g, device=dev)
    kind, insert = kind[order], insert[order]

    def rand_bases(shape):
        return generate._bases(torch.randint(0, 4, shape, generator=g,
                                             device=dev, dtype=torch.uint8))

    # the amplicon of every pair, the insert's bases random: the forward
    # primer, the insert, the reverse primer's reverse complement
    width = max(L, len(fwd) + int(insert.max()) + len(rev)) if n else L
    amp = rand_bases((n, width))
    col = torch.arange(width, device=dev)[None, :]
    amp[:, : len(fwd)] = torch.where((kind != NONE)[:, None], fwd,
                                     amp[:, : len(fwd)])
    rc_rev = comp[rev.flip(0).long()]
    rel = col - (len(fwd) + insert)[:, None]
    at_rev = (kind == BOTH)[:, None] & (rel >= 0) & (rel < len(rev))
    amp = torch.where(at_rev, rc_rev[rel.clamp(0, len(rev) - 1)], amp)
    amp_len = torch.where(kind == BOTH, len(fwd) + insert + len(rev), 0)
    # R1 reads past the forward primer of a forward-only pair at random
    r1_len = torch.where(kind == FORWARD_ONLY, len(fwd), amp_len)
    cols = col[:, :L]
    r1 = torch.where(cols < r1_len[:, None], amp[:, :L], rand_bases((n, L)))
    src = (amp_len[:, None] - 1 - cols).clamp(0, width - 1)
    r2 = torch.where(cols < amp_len[:, None],
                     comp[torch.gather(amp, 1, src).long()],
                     rand_bases((n, L)))
    mates = []
    for mate, seqs in enumerate((r1, r2)):
        _with_errors(seqs, traffic, g, dev)
        quals = generate._qualities(traffic["quality"], n, L, g, dev)
        mates.append(generate.Reads(
            generate._names(n, f"/{mate + 1}".encode()), seqs.cpu().numpy(),
            quals.cpu().numpy(), np.full(n, L, np.int64)))
    return mates
