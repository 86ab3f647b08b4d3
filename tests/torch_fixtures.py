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
list of single-end golden cases without importing its test module, and
:data:`ENGINE_NOT_YET` names the cases the port's engine refuses yet.

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

from cutadapt_tpu_torch import native
from cutadapt_tpu_torch.adapters import BackAdapter, Where
from cutadapt_tpu_torch.batch_pipeline import (
    AdapterStage,
    AdapterTask,
    BatchPipelineEngine,
)
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk
from cutadapt_tpu_torch.io.records import SequenceRecord
from cutadapt_tpu_torch.ops.align_cuda import kernel_layout
from cutadapt_tpu_torch.ops.align_batch import (
    AlignerSpec,
    effective_length,
    encode_reference,
    n_counts,
    query_class_info,
    query_lut,
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


# --- the golden cases of the CLI ---------------------------------------------

TESTS = os.path.dirname(os.path.abspath(__file__))

# Golden cases whose pipeline the port's engine does not express yet, each
# with the reason its translation gives (a substring of the require-mode
# error). A case leaves this dict when a later slice ports what it names.
ENGINE_NOT_YET = {
    "length_tag": "modifier LengthTagModifier",
    "trim_n": "modifier NEndTrimmer",
    "qualtrim": "modifier QualityTrimmer",
    "qualbase": "modifier QualityTrimmer",
    "quality_trim_only": "modifier QualityTrimmer",
    "polya": "modifier PolyATrimmer",
    "anchored_back_no_indels": "anchored suffix adapters without indels",
    "strip_suffix": "modifier SuffixRemover",
    "anchored_no_indels": "anchored prefix adapters without indels",
    "anchored_no_indels_wildcard_read":
        "anchored prefix adapters without indels",
    "anchored_no_indels_wildcard_adapt":
        "anchored prefix adapters without indels",
    "cut_front": "modifier UnconditionalCutter",
    "cut_back": "modifier UnconditionalCutter",
    "cut_both": "modifier UnconditionalCutter",
    "multiple_fake_anchored": "indexed_prefix adapters",
    "multiple_prefix": "indexed_prefix adapters",
    "multiple_prefix_noindels": "indexed_prefix adapters",
    "multiple_suffix_noindels": "indexed_suffix adapters",
    "nextseq": "modifier NextseqQualityTrimmer",
    "linked_anchored": "linked adapters",
    "linked_multiple": "linked adapters",
    "linked_both_anchored": "linked adapters",
    "linked_5p_not_anchored": "linked adapters",
    "linked_discard_untrimmed": "linked adapters",
    "linked_discard_untrimmed_g": "linked adapters",
    "linked_lowercase": "linked adapters",
    "length": "modifier Shortener",
    "negative_length": "modifier Shortener",
}
# Accepted cases in which the aligner has nothing to do
NO_ALIGNER_RUN = {"fasta_no_trim": "no adapter", "empty_wildcard": "no reads"}


def golden_cases():
    """The (id, params, expected, input) tuples of
    ``tests/test_commandline.py:GOLDEN_CASES``, read with
    ``ast.literal_eval`` on that one assignment, without importing the
    module (which imports the JAX package)."""
    path = os.path.join(TESTS, "test_commandline.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "GOLDEN_CASES"
            for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise LookupError(f"no GOLDEN_CASES assignment in {path}")


def golden_args(params, out: str, inpath: str) -> List[str]:
    """The command line of one golden case writing to ``out``."""
    params = params.split() if isinstance(params, str) else list(params)
    return params + ["-o", out, os.path.join(TESTS, "data", inpath)]


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


def random_batch(spec: AlignerSpec, rng: np.random.RandomState, B: int,
                 L: int, pack2: bool, at_start: bool = False,
                 at_end: bool = False):
    """(raw bytes (B, L), packed class ids (B, L/4 or L/2), lengths (B,)).

    Reads draw from ``ACGTNacgt``; a third of them carry a spliced
    adapter copy with one substitution, at the read's start if
    ``at_start`` (as a prefix adapter needs it), at its end, the read
    L bp long, if ``at_end`` (as a suffix adapter needs it). For the 2-bit
    lane every byte whose class id does not fit in 2 bits becomes 'A', so
    the batch is what the engine's clean-window split would send there."""
    cls_lut, _ = query_class_info(spec)
    raw = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=(B, L))
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
        raw[cls_lut[raw] > 3] = ord("A")
    raw[np.arange(L)[None, :] >= lens[:, None]] = 0
    cls = cls_lut[raw]
    if pack2:
        enc = (cls[:, 0::4] | (cls[:, 1::4] << 2) | (cls[:, 2::4] << 4)
               | (cls[:, 3::4] << 6))
    else:
        enc = cls[:, 0::2] | (cls[:, 1::2] << 4)
    return raw, enc.astype(np.uint8), lens


def scalar_locate(spec: AlignerSpec, raw: np.ndarray, lens: np.ndarray):
    """The C++ scalar aligner over each read: (found, qstart, qstop,
    errors, score), the sequential form of the same contract."""
    aligner = native.ScalarAligner(
        encode_reference(spec).tobytes(), n_counts(spec),
        effective_length(spec), spec.max_error_rate, spec.flags,
        not (spec.wildcard_ref or spec.wildcard_query), spec.wildcard_ref,
        spec.indel_cost, spec.min_overlap,
    )
    lut = query_lut(spec)
    B = len(lens)
    out = [np.zeros(B, bool)] + [np.zeros(B, np.int32) for _ in range(4)]
    for i in range(B):
        r = aligner.locate(lut[raw[i, : lens[i]]].tobytes())
        if r is not None:
            out[0][i] = True
            _, _, out[1][i], out[2][i], out[4][i], out[3][i] = r
    return tuple(out)


def first_difference(got, want) -> Optional[str]:
    """None if two (found, qstart, qstop, errors, score) results agree
    under the comparison rule, else the first field that differs."""
    if not np.array_equal(got[0], want[0]):
        return f"found ({int((got[0] != want[0]).sum())} reads)"
    f = want[0]
    for name, g, w in zip(("qstart", "qstop", "errors", "score"),
                          got[1:], want[1:]):
        if not np.array_equal(g[f], w[f]):
            return f"{name} ({int((g[f] != w[f]).sum())} reads)"
    return None
