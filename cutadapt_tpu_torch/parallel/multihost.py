"""
Multi-host data parallelism: per-process input shards, ordered output,
a statistics merge across processes.

The engine is data-parallel over read chunks; several processes add
one more level of the same thing. Every process takes a CONTIGUOUS
record-aligned byte range of the input, drives its own chunk pipeline
on its own device, and writes its own output shard. Because the ranges
are contiguous in input order, concatenating the output shards in shard
order reproduces the single-process byte stream exactly: the
multi-process form of the ordered chunk writer's invariant (cutadapt's
runners.py:224-245).

Statistics reduce on two rails, as within one process:
- device counters are binned per shard of each process's own mesh and
  summed there (parallel/stats.DeviceStatsReducer). The processes are
  independent by design: no collective runs across them during
  processing, so a straggler never stalls the others' device queues.
  (An opt-in ``torch.distributed`` group exists for runtimes that
  require every process to join one, accel._maybe_init_distributed,
  driven by CUTADAPT_TPU_TORCH_DIST_COORDINATOR; the statistics
  contract stays per-process-then-merge either way.)
- the host-side Statistics objects merge with the same ``+=`` chain
  cutadapt sends over worker pipes (runners.py:203-211), here pickled
  per process (CUTADAPT_TPU_TORCH_STATS_PICKLE) and folded by
  ``merge_statistics``.

Shard planning makes one streaming pass over the input to find exact
record boundaries (the same cost class as cutadapt's single reader
process, which also streams every byte through one process). BAM
inputs shard at alignment-record boundaries; every non-first shard's
reader replays the BAM header in front of its byte range so each shard
is a complete, parseable BAM stream. Compressed single-file inputs are
not byte-addressable; shard them by file instead (``plan_file_shards``)
or decompress ahead.

Driving it, lowest level first:
- CUTADAPT_TPU_TORCH_BYTE_RANGE="start:end[,start2:end2]" limits a CLI
  run to the given range of each input file;
- ``cutadapt-tpu-torch --shard INDEX/COUNT`` computes the plan
  internally, sets the range for this run, and writes the statistics
  pickle next to its output;
- ``tools/multihost_run_torch.py`` is the coordinator: it launches one
  ``--shard`` process per shard, concatenates the output shards in
  shard order, merges statistics, and prints the merged report.
"""

import io as io_mod
import pickle
from typing import BinaryIO, List, Optional, Sequence, Tuple

import numpy as np

_SCAN_BLOCK = 8 * 1024 * 1024


def _record_start_blocks(path: str, fmt: str):
    """Yield (block_base_offset, record_start_offsets_in_block) numpy
    batches for one streaming pass, then a final (file_size, None)
    sentinel — per-block vectorized, never one Python object per
    record."""
    nl = 10
    offset = 0
    line_count = 0  # lines seen (fastq: record starts at line % 4 == 0)
    at_line_start = True
    with open(path, "rb") as f:
        while True:
            block = f.read(_SCAN_BLOCK)
            if not block:
                break
            buf = np.frombuffer(block, np.uint8)
            # line starts in this block: after every newline, plus the
            # block start when the previous block ended a line
            line_starts = np.flatnonzero(buf == nl) + 1
            if at_line_start:
                line_starts = np.concatenate(([0], line_starts))
            line_starts = line_starts[line_starts < len(buf)]
            if fmt == "fastq":
                recs = line_starts[
                    (line_count + np.arange(len(line_starts))) % 4 == 0
                ]
            else:  # fasta: records start at '>' in column 0
                recs = line_starts[buf[line_starts] == ord(">")]
            yield offset, recs
            line_count += len(line_starts)
            at_line_start = bool(len(buf)) and buf[-1] == nl
            offset += len(buf)
    yield offset, None


def _count_records(path: str, fmt: str) -> Tuple[int, int]:
    """(record count, file size) in one streaming pass, O(1) memory."""
    n = 0
    for base, recs in _record_start_blocks(path, fmt):
        if recs is None:
            return n, base
        n += len(recs)
    return n, 0


def _offsets_at(path: str, fmt: str, targets: Sequence[int]) -> List[int]:
    """Byte offsets of the record starts at the given (sorted) record
    indexes — one streaming pass holding only the current block."""
    out = []
    pos = 0
    seen = 0
    for base, recs in _record_start_blocks(path, fmt):
        if recs is None or pos >= len(targets):
            break
        while pos < len(targets) and targets[pos] < seen + len(recs):
            out.append(base + int(recs[targets[pos] - seen]))
            pos += 1
        seen += len(recs)
    return out


def plan_shards(
    path: str, n_hosts: int, fmt: str = "fastq", group: int = 1
) -> List[Tuple[int, int]]:
    """Contiguous record-aligned byte ranges splitting `path` into
    n_hosts near-equal record counts. Two vectorized streaming passes
    (count, then the n_hosts boundary offsets) with O(n_hosts) memory:
    inputs of any size never materialize per-record state.

    group > 1 aligns every boundary to a multiple of `group` records
    (interleaved paired input must never split an R1/R2 pair)."""
    if fmt == "bam":
        return plan_bam_shards(path, n_hosts)
    n, size = _count_records(path, fmt)
    if n == 0:
        bounds = [0] * n_hosts + [size]
    else:
        targets = [
            (n * h) // n_hosts // group * group for h in range(n_hosts)
        ]
        bounds = _offsets_at(path, fmt, targets) + [size]
    return [(bounds[h], bounds[h + 1]) for h in range(n_hosts)]


def plan_bam_shards(path: str, n_hosts: int) -> List[Tuple[int, int]]:
    """Record-aligned byte ranges for an (uncompressed) BAM file: one
    buffered walk of the block_size-prefixed alignment records
    (io/fastq.py:191-241 defines the record layout). Shard 0's range
    includes the header; every other shard starts at a record boundary
    and relies on the reader-side header replay
    (``maybe_range_readers``) to present a complete BAM stream."""
    from ..io.fastq import BamFormatError, read_bam_header

    starts: List[int] = []
    with open(path, "rb") as f:
        read_bam_header(f)
        pos = f.tell()
        data = f.read(_SCAN_BLOCK)
        idx = 0
        while True:
            if idx + 4 > len(data):
                data = bytes(data[idx:]) + f.read(_SCAN_BLOCK)
                idx = 0
                if len(data) == 0:
                    break
                if len(data) < 4:
                    raise BamFormatError("Truncated BAM record", line=None)
            bs = int.from_bytes(data[idx : idx + 4], "little")
            starts.append(pos)
            pos += 4 + bs
            idx += 4 + bs
            if idx > len(data):
                f.seek(idx - len(data), 1)  # skip the record tail
                data = b""
                idx = 0
        size = pos
    n = len(starts)
    if n == 0:
        bounds = [0] * n_hosts + [size]
    else:
        bounds = [starts[(n * h) // n_hosts] for h in range(n_hosts)]
        bounds[0] = 0  # shard 0 carries the real header
        bounds.append(size)
    return [(bounds[h], bounds[h + 1]) for h in range(n_hosts)]


def plan_file_shards(
    paths: Sequence[str], n_hosts: int
) -> List[List[str]]:
    """Whole-file sharding for inputs that are not byte-addressable
    (compressed streams): host h processes every n_hosts-th file,
    balanced by file size (largest first onto the least-loaded host,
    ties broken by host index so the plan is deterministic)."""
    import os as _os

    sized = sorted(
        ((_os.path.getsize(p), i, p) for i, p in enumerate(paths)),
        key=lambda t: (-t[0], t[1]),
    )
    load = [0] * n_hosts
    out: List[List[Tuple[int, str]]] = [[] for _ in range(n_hosts)]
    for sz, i, p in sized:
        h = min(range(n_hosts), key=lambda j: (load[j], j))
        load[h] += sz
        out[h].append((i, p))
    # each host keeps its files in original input order
    return [[p for _, p in sorted(files)] for files in out]


def plan_paired_shards(
    path1: str, path2: str, n_hosts: int, fmt: str = "fastq"
) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Per-host ((start1, end1), (start2, end2)) ranges with EQUAL
    record counts on both sides (required for pair synchronization)."""
    counts = [_count_records(p, fmt) for p in (path1, path2)]
    n = min(c[0] for c in counts)
    # boundary record indexes 0..n (index n maps to file size)
    targets = [(n * h) // n_hosts for h in range(n_hosts + 1)]
    sides = []
    for path, (n_side, size) in zip((path1, path2), counts):
        inner = [t for t in targets if t < n_side]
        offs = _offsets_at(path, fmt, inner)
        offs += [size] * (len(targets) - len(inner))
        sides.append(offs)
    return [
        ((sides[0][h], sides[0][h + 1]), (sides[1][h], sides[1][h + 1]))
        for h in range(n_hosts)
    ]


class RangeReader:
    """A binary file restricted to [start, end) — the per-host input
    shard view the chunk readers consume. Supports every access
    pattern the readers use: block ``read`` (chunk pipeline),
    ``readline``/iteration (per-read host parser), ``readinto``.

    `prefix` bytes, when given, are served before the range — BAM
    shards replay the file header so every shard parses as a complete
    BAM stream. With a prefix, tell/seek present the LOGICAL stream
    (offset 0 is the first prefix byte; the range bytes follow), so
    format sniffers that read-then-seek-back work unchanged. The
    prefix path supports read/readinto/seek/tell; the BAM parser
    never uses readline."""

    def __init__(self, file: BinaryIO, start: int, end: int,
                 prefix: bytes = b""):
        self._file = file
        self._start = start
        self._end = end
        self._prefix = prefix
        self._ppos = 0  # logical position within the prefix
        file.seek(start)

    def _remaining(self) -> int:
        return self._end - self._file.tell()

    def _in_prefix(self) -> bool:
        return self._ppos < len(self._prefix)

    def read(self, n: int = -1) -> bytes:
        if self._in_prefix():
            if n is None or n < 0:
                take = len(self._prefix) - self._ppos
            else:
                take = min(n, len(self._prefix) - self._ppos)
            head = self._prefix[self._ppos : self._ppos + take]
            self._ppos += take
            if n is not None and 0 <= n == take:
                return head
            return head + self.read(
                -1 if (n is None or n < 0) else n - take
            )
        remaining = self._remaining()
        if remaining <= 0:
            return b""
        if n is None or n < 0 or n > remaining:
            n = remaining
        return self._file.read(n)

    def readline(self, limit: int = -1) -> bytes:
        if self._in_prefix():
            raise io_mod.UnsupportedOperation(
                "readline on a header-replay (BAM) shard reader"
            )
        remaining = self._remaining()
        if remaining <= 0:
            return b""
        if limit is None or limit < 0 or limit > remaining:
            limit = remaining
        return self._file.readline(limit)

    def readinto(self, b) -> int:
        if self._in_prefix():
            head = self.read(len(b))
            memoryview(b)[: len(head)] = head
            return len(head)
        remaining = self._remaining()
        if remaining <= 0:
            return 0
        if len(b) > remaining:
            b = memoryview(b)[:remaining]
        return self._file.readinto(b)

    def tell(self) -> int:
        if self._prefix:
            if self._in_prefix():
                return self._ppos
            return len(self._prefix) + (self._file.tell() - self._start)
        return self._file.tell()

    def seek(self, pos: int, whence: int = 0) -> int:
        if not self._prefix:
            return self._file.seek(pos, whence)
        if whence == 1:
            pos += self.tell()
        elif whence != 0:
            raise io_mod.UnsupportedOperation(
                "seek from end on a header-replay shard reader"
            )
        if pos < len(self._prefix):
            self._ppos = pos
            self._file.seek(self._start)
        else:
            self._ppos = len(self._prefix)
            self._file.seek(self._start + pos - len(self._prefix))
        return pos

    def __iter__(self):
        # iteration must respect the range end: type-level special
        # method lookup would bypass __getattr__ delegation, so the
        # host parser's `for line in file` needs this explicitly
        return iter(self.readline, b"")

    def close(self):
        self._file.close()

    def __getattr__(self, name):
        return getattr(self._file, name)


def maybe_range_readers(files, env_value: Optional[str]):
    """Wrap open input streams in their CUTADAPT_TPU_TORCH_BYTE_RANGE
    shard views when the env is set; pass through otherwise. Every input
    opener (in-process and the reader process) must go through this so
    the shard contract holds on all execution paths.

    A BAM input whose range starts past 0 gets the file header
    replayed in front of the range (see RangeReader)."""
    if not env_value:
        return files
    out = []
    for f, rng in zip(files, parse_byte_range_env(env_value)):
        start, end = rng
        prefix = b""
        if start > 0 and getattr(f, "seekable", lambda: False)():
            magic = f.read(4)
            f.seek(0)
            if magic == b"BAM\x01":
                from ..io.fastq import read_bam_header

                prefix = read_bam_header(f)
        out.append(RangeReader(f, start, end, prefix=prefix))
    return out


def _sniff_input(path: str) -> str:
    """'fastq' | 'fasta' | 'bam', or raise ValueError for inputs that
    cannot be byte-range sharded (compressed streams, pipes)."""
    from ..io.fastq import detect_format_from_content, detect_format_from_name

    if path == "-":
        raise ValueError("--shard requires seekable file inputs, not stdin")
    with open(path, "rb") as f:
        magic = f.read(4)
    if (
        magic[:2] == b"\x1f\x8b"
        or magic[:3] == b"BZh"
        or magic[:4] == b"\xfd7zX"
        or magic[:4] == b"\x28\xb5\x2f\xfd"
    ):
        raise ValueError(
            f"--shard cannot byte-range a compressed input ({path}); "
            "decompress it first or shard by file "
            "(tools/multihost_run_torch.py, plan_file_shards)"
        )
    fmt = detect_format_from_name(path)
    if fmt is None:
        with open(path, "rb") as f:
            fmt = detect_format_from_content(f)
    if fmt not in ("fastq", "fasta", "bam"):
        raise ValueError(f"--shard: cannot determine the format of {path}")
    return fmt


def shard_byte_range_env(
    paths: Sequence[str], index: int, count: int,
    interleaved: bool = False,
) -> str:
    """The CUTADAPT_TPU_TORCH_BYTE_RANGE value selecting shard `index` of
    `count` over the given input path(s) — what `--shard INDEX/COUNT`
    computes. Paired inputs get record-synchronized ranges; an
    interleaved single input is boundary-aligned to whole pairs."""
    if not 0 <= index < count:
        raise ValueError(f"--shard: index {index} not in [0, {count})")
    fmts = [_sniff_input(p) for p in paths]
    if len(paths) == 2:
        if "bam" in fmts:
            raise ValueError("--shard: paired BAM input is not supported")
        ranges = plan_paired_shards(paths[0], paths[1], count, fmt=fmts[0])
        (s1, e1), (s2, e2) = ranges[index]
        return f"{s1}:{e1},{s2}:{e2}"
    group = 2 if interleaved else 1
    start, end = plan_shards(paths[0], count, fmt=fmts[0], group=group)[index]
    return f"{start}:{end}"


def parse_byte_range_env(value: str) -> List[Tuple[int, int]]:
    """'start:end[,start2:end2]' -> per-input-file ranges."""
    ranges = []
    for part in value.split(","):
        start, _, end = part.partition(":")
        ranges.append((int(start), int(end)))
    return ranges


def merge_statistics(paths: Sequence[str]):
    """Fold per-shard pickled Statistics
    (CUTADAPT_TPU_TORCH_STATS_PICKLE) into one, in shard order: the cross-process form of cutadapt's
    worker-pipe statistics merge. The pickles name cutadapt_tpu_torch
    classes; unpickle only files that shard runs of this package
    wrote."""
    total = None
    for path in paths:
        with open(path, "rb") as f:
            stats = pickle.load(f)
        if total is None:
            total = stats
        else:
            total += stats
    return total
