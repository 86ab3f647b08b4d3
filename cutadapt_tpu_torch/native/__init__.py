"""
ctypes loader for the native host-ops library.

The C++ source is compiled on first import (g++, ~1 s) and cached next
to the source keyed by a content hash, so repeated runs and the test
suite never recompile. If no compiler is available, ``AVAILABLE`` stays
False. The batch engine then does not run: ``accel.try_run_accelerated``
sends the run to the host path (an error under
CUTADAPT_TPU_TORCH_BATCH=require), and ``BatchPipelineEngine`` refuses
to be built (:func:`require`). The host path's callers keep their
Python or numpy forms: ``io.chunks`` (parse and assembly of a chunk),
``align.Aligner`` (the per-read DP) and ``kmer_finder.KmerFinder`` (the
k-mer scan).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostops.cpp")

AVAILABLE = False
_lib = None


def require(what: str) -> None:
    """Raise RuntimeError, naming ``what``, where the library did not
    build."""
    if not AVAILABLE:
        raise RuntimeError(f"{what} needs the native host library "
                           "(native/hostops.cpp), which did not build")


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"_hostops-{tag}.so")


def _build(so: str) -> bool:
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
        os.close(fd)
        subprocess.run(
            [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-o", tmp, _SRC,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic under concurrent builders
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except Exception:
            pass
        return False


def _load():
    global _lib, AVAILABLE
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return

    i64 = ctypes.c_int64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)

    lib.fastq_count.restype = i64
    lib.fastq_count.argtypes = [p_u8, i64]
    lib.fastq_parse.restype = i64
    lib.fastq_parse.argtypes = [
        p_u8, i64, i64, p_i64, p_i64, p_i64, p_i32, p_i64, p_i32,
    ]
    _i32 = ctypes.c_int32
    lib.kmer_prefilter.restype = None
    lib.kmer_prefilter.argtypes = [
        p_u8, p_i64, p_i32, i64, i64, p_i64, p_i64, p_u64, p_u64, p_u64,
        _i32, p_u8,
    ]
    lib.pad_encode.restype = None
    lib.pad_encode.argtypes = [
        p_u8, p_i64, p_i32, p_i64, i64, i64, p_u8, _i32, p_u8,
    ]
    lib.pad_encode_pack4.restype = None
    lib.pad_encode_pack4.argtypes = [
        p_u8, p_i64, p_i32, p_i64, i64, i64, p_u8, _i32, p_u8,
    ]
    lib.pad_encode_pack2.restype = None
    lib.pad_encode_pack2.argtypes = [
        p_u8, p_i64, p_i32, p_i64, i64, i64, p_u8, _i32, p_u8,
    ]
    lib.stage_select.restype = i64
    lib.stage_select.argtypes = [
        p_u8, p_i64, p_i32, i64, i64, p_i64, p_i32, p_i64, p_i64, p_u64,
        p_u64, p_u64, p_u8, _i32, i64, _i32, _i32, p_i64, p_i64, p_i32,
        p_i64,
    ]
    lib.stage_encode.restype = None
    lib.stage_encode.argtypes = [
        p_u8, p_i64, p_i32, i64, p_i64, p_u8, _i32, p_u8,
    ]
    lib.assemble_fastq.restype = i64
    lib.assemble_fastq.argtypes = [
        p_u8, i64, p_i64, p_i64, p_i64, p_i64, p_i64, p_u8,
    ]
    i32 = ctypes.c_int32
    lib.quality_trim.restype = None
    lib.quality_trim.argtypes = [
        p_u8, p_i64, p_i32, p_i32, i64, i32, i32, i32, p_i32, p_i32,
    ]
    lib.nextseq_trim.restype = None
    lib.nextseq_trim.argtypes = [
        p_u8, p_i64, p_i64, p_i32, p_i32, i64, i32, i32, p_i32,
    ]
    lib.poly_a_trim.restype = None
    lib.poly_a_trim.argtypes = [p_u8, p_i64, p_i32, p_i32, i64, i32, p_i32]
    lib.assemble_fastq_window.restype = i64
    lib.assemble_fastq_window.argtypes = [
        p_u8, i64, p_i64, p_i64, p_i64, p_i64, p_i32, p_i32, p_u8, p_u8,
    ]
    lib.check_pair_names.restype = i64
    lib.check_pair_names.argtypes = [p_u8, p_i64, p_i64, p_u8, p_i64, p_i64, i64]
    p_f64 = ctypes.POINTER(ctypes.c_double)
    c_char_p = ctypes.c_char_p
    lib.aligner_locate.restype = ctypes.c_int32
    lib.aligner_locate.argtypes = [
        c_char_p, i64, p_i32, i64, ctypes.c_double, _i32, _i32, _i32,
        _i32, _i32, c_char_p, i64, p_i64, p_i32,
    ]
    lib.kmers_present_one.restype = ctypes.c_int32
    lib.kmers_present_one.argtypes = [
        c_char_p, i64, i64, p_i64, p_i64, p_u64, p_u64, p_u64,
    ]
    lib.expected_errors_win.restype = None
    lib.expected_errors_win.argtypes = [
        p_u8, p_i64, p_i32, p_i32, i64, _i32, p_f64, p_f64,
    ]
    lib.count_n.restype = None
    lib.count_n.argtypes = [p_u8, p_i64, p_i32, p_i32, i64, p_i32]
    lib.casava_filtered.restype = None
    lib.casava_filtered.argtypes = [p_u8, p_i64, p_i64, i64, p_u8]
    lib.trim_n_ends.restype = None
    lib.trim_n_ends.argtypes = [p_u8, p_i64, p_i32, p_i32, i64, p_i32, p_i32]
    lib.assemble_fastq_transform.restype = i64
    lib.assemble_fastq_transform.argtypes = [
        p_u8, i64, p_i64, p_i64, p_i64, p_i64, p_i32, p_i32, p_i32,
        p_i32, p_u8, _i32, p_u8,
    ]
    lib.reverse_complement_records.restype = None
    lib.reverse_complement_records.argtypes = [
        p_u8, i64, p_i64, p_i32, p_i64, p_u8,
    ]
    lib.assemble_fastq_window_rc.restype = i64
    lib.assemble_fastq_window_rc.argtypes = [
        p_u8, p_u8, i64, p_i64, p_i64, p_i64, p_i64, p_i32, p_i32,
        p_u8, p_u8, p_u8, i64, p_u8,
    ]
    _lib = lib
    AVAILABLE = True


_load()


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


_pyapi = ctypes.pythonapi
_pyapi.PyBytes_FromStringAndSize.restype = ctypes.py_object
_pyapi.PyBytes_FromStringAndSize.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
_pyapi.PyBytes_AsString.restype = ctypes.c_void_p
_pyapi.PyBytes_AsString.argtypes = [ctypes.py_object]


def _fresh_bytes(total: int):
    """Uninitialized `bytes` of length `total` plus a writable uint8
    view aliasing its buffer. The assemblers below fill every byte via
    the view before the object is returned, so the one allocation IS
    the result — no np.empty + .tobytes() memcpy (which profiled as
    the largest host-side assembly cost at ~440 ns/read). Safe because
    the object is private until returned and CPython does not intern
    NULL-initialized bytes of nonzero length.

    The view aliases the bytes object's buffer by raw address, so it
    is only valid while the returned object is alive: the view's
    ``.base`` chain is anchored to the object to make dropping it safe
    for any caller."""
    if total <= 0:
        raise ValueError(f"_fresh_bytes needs total > 0, got {total}")
    obj = _pyapi.PyBytes_FromStringAndSize(None, total)
    addr = _pyapi.PyBytes_AsString(obj)
    carr = (ctypes.c_uint8 * total).from_address(addr)
    # from_address() keeps no reference to the owning object; pin it on
    # the ctypes array so the view's .base chain keeps `obj` alive even
    # if a caller drops its own reference before the last write.
    carr._owner = obj
    view = np.frombuffer(carr, np.uint8)
    return obj, view


def fastq_parse(buf: np.ndarray):
    """Parse a record-aligned FASTQ chunk.

    Returns (head_start, head_end, seq_start, seq_len, qual_start,
    has_cr). Raises ValueError on malformed chunks, matching
    batch.parse_fastq_chunk.
    """
    n = len(buf)
    n_records = _lib.fastq_count(_ptr(buf, ctypes.c_uint8), n)
    if n_records < 0:
        raise ValueError("FASTQ chunk does not contain whole records")
    head_start = np.empty(n_records, np.int64)
    head_end = np.empty(n_records, np.int64)
    seq_start = np.empty(n_records, np.int64)
    seq_len = np.empty(n_records, np.int32)
    qual_start = np.empty(n_records, np.int64)
    flags = np.zeros(1, np.int32)
    rc = _lib.fastq_parse(
        _ptr(buf, ctypes.c_uint8), n, n_records,
        _ptr(head_start, ctypes.c_int64), _ptr(head_end, ctypes.c_int64),
        _ptr(seq_start, ctypes.c_int64), _ptr(seq_len, ctypes.c_int32),
        _ptr(qual_start, ctypes.c_int64), _ptr(flags, ctypes.c_int32),
    )
    if rc == -2:
        raise ValueError("Length of sequence and qualities differ")
    if rc < 0:
        raise ValueError("FASTQ chunk does not contain whole records")
    return head_start, head_end, seq_start, seq_len, qual_start, bool(flags[0])


class ScalarAligner:
    """Per-read C++ aligner bound to one reference (the host path's
    hot loop). Same results as align.py Aligner.locate.

    Thread-safe: the output and DP work buffers live in thread-local
    storage, so one instance may be shared by the batch driver's
    worker pool (each call gets its own scratch)."""

    __slots__ = ("_args", "_m", "_tls")

    def __init__(self, reference: bytes, n_counts, effective_length: int,
                 max_error_rate: float, flags: int, compare_ascii: bool,
                 wildcard_ref: bool, indel_cost: int, min_overlap: int):
        import threading

        m = len(reference)
        nc = (ctypes.c_int32 * (m + 1))(*n_counts)
        self._m = m
        self._tls = threading.local()
        self._args = (
            reference, m, nc, effective_length,
            float(max_error_rate), int(flags), int(compare_ascii),
            int(wildcard_ref), int(indel_cost), int(min_overlap),
        )

    def locate(self, query: bytes):
        tls = self._tls
        try:
            out, work = tls.buffers
        except AttributeError:
            out = (ctypes.c_int64 * 6)()
            work = (ctypes.c_int32 * (3 * (self._m + 1)))()
            tls.buffers = (out, work)
        found = _lib.aligner_locate(
            *self._args, query, len(query), out, work
        )
        if not found:
            return None
        return (out[0], out[1], out[2], out[3], out[4], out[5])


class ScalarKmerMatcher:
    """Per-read C++ shift-and scan bound to one KmerFinder's tables."""

    __slots__ = ("_tables", "_args")

    def __init__(self, tables: "PrefilterTables"):
        self._tables = tables  # keep the arrays alive
        self._args = (
            tables.n_entries,
            _ptr(tables.starts, ctypes.c_int64),
            _ptr(tables.stops, ctypes.c_int64),
            _ptr(tables.init_masks, ctypes.c_uint64),
            _ptr(tables.found_masks, ctypes.c_uint64),
            _ptr(tables.masks, ctypes.c_uint64),
        )

    def kmers_present(self, seq: bytes) -> bool:
        return bool(_lib.kmers_present_one(seq, len(seq), *self._args))


class PrefilterTables:
    """Flat-array form of a KmerFinder's search entries for C."""

    __slots__ = ("n_entries", "starts", "stops", "init_masks",
                 "found_masks", "masks")

    def __init__(self, kmer_finder):
        entries = kmer_finder._entries
        self.n_entries = len(entries)
        self.starts = np.array([e.start for e in entries], np.int64)
        self.stops = np.array([e.stop for e in entries], np.int64)
        self.init_masks = np.array(
            [e.init_mask for e in entries], np.uint64
        )
        self.found_masks = np.array(
            [e.found_mask for e in entries], np.uint64
        )
        masks = np.zeros((max(self.n_entries, 1), 128), np.uint64)
        for i, e in enumerate(entries):
            masks[i, :] = e.masks
        self.masks = masks


class PrefilterSet:
    """The prefilter tables of several tasks as one set of flat arrays
    for :func:`stage_select`: the entries of task t are rows
    ``task_entries[t]`` to ``task_entries[t + 1]``, scanned back to front
    where ``task_reverse[t]``; a window passes if any task's scan hits.
    The ctypes pointers are made once, here."""

    __slots__ = ("n_tasks", "_arrays", "_args")

    def __init__(self, tables: "list[PrefilterTables]", reverse: "list[bool]"):
        self.n_tasks = len(tables)
        entries = np.zeros(self.n_tasks + 1, np.int64)
        entries[1:] = np.cumsum([t.n_entries for t in tables])
        rev = np.array([int(r) for r in reverse], np.int32)
        cat = [np.concatenate([getattr(t, k)[: t.n_entries] for t in tables]
                              or [np.zeros(0, dt)]).astype(dt)
               for k, dt in (("starts", np.int64), ("stops", np.int64),
                             ("init_masks", np.uint64),
                             ("found_masks", np.uint64))]
        masks = np.zeros((max(int(entries[-1]), 1), 128), np.uint64)
        for t, e0 in zip(tables, entries):
            masks[e0 : e0 + t.n_entries] = t.masks[: t.n_entries]
        self._arrays = (entries, rev, *cat, masks)  # alive while pointed to
        self._args = (
            self.n_tasks, _ptr(entries, ctypes.c_int64),
            _ptr(rev, ctypes.c_int32), _ptr(cat[0], ctypes.c_int64),
            _ptr(cat[1], ctypes.c_int64), _ptr(cat[2], ctypes.c_uint64),
            _ptr(cat[3], ctypes.c_uint64), _ptr(masks, ctypes.c_uint64),
        )


def stage_select(buf, starts, lens, prefilter, clean_lut, clean_reverse,
                 width: int, host_tail_ok: bool, sort_desc: bool):
    """The candidates of one dispatch, split into lanes and ordered (one
    C++ call, hostops.cpp:stage_select): the windows (``starts`` int64,
    ``lens`` int32) that pass ``prefilter`` (a :class:`PrefilterSet`, or
    None for every window); with ``clean_lut``, the 2-bit-clean ones
    first, the others after them or, where ``host_tail_ok`` and few, a
    host tail; with ``sort_desc`` each lane longest first. Returns
    (positions into the windows, their starts, their lengths, (clean
    rows, other rows, other rows are a host tail, longest length))."""
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    n = len(starts)
    if len(lens) != n:
        raise ValueError("starts and lens differ in length")
    sel = np.empty(n, np.int64)
    c_starts = np.empty(n, np.int64)
    c_lens = np.empty(n, np.int32)
    counts = np.zeros(4, np.int64)
    pf = prefilter._args if prefilter is not None else (
        0, None, None, None, None, None, None, None)
    lut = (None if clean_lut is None
           else _ptr(np.ascontiguousarray(clean_lut, np.uint8),
                     ctypes.c_uint8))
    n_sel = _lib.stage_select(
        _ptr(buf, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32), n, *pf, lut, int(clean_reverse), width,
        int(host_tail_ok), int(sort_desc), _ptr(sel, ctypes.c_int64),
        _ptr(c_starts, ctypes.c_int64), _ptr(c_lens, ctypes.c_int32),
        _ptr(counts, ctypes.c_int64),
    )
    return (sel[:n_sel], c_starts[:n_sel], c_lens[:n_sel],
            tuple(int(c) for c in counts))


def stage_encode(buf, c_starts, c_lens, layout: np.ndarray, lut,
                 reverse: bool, arena: np.ndarray) -> None:
    """Every dispatch batch of ``layout`` (rows of 8 int64, as
    hostops.cpp:stage_encode reads them) into the uint8 ``arena``, in
    one C++ call. The caller checks that every offset fits."""
    _lib.stage_encode(
        _ptr(buf, ctypes.c_uint8), _ptr(c_starts, ctypes.c_int64),
        _ptr(c_lens, ctypes.c_int32), len(layout),
        _ptr(layout, ctypes.c_int64), _ptr(lut, ctypes.c_uint8),
        int(reverse), _ptr(arena, ctypes.c_uint8),
    )


def kmer_prefilter(
    buf: np.ndarray, seq_start: np.ndarray, seq_len: np.ndarray,
    tables: PrefilterTables, reverse: bool = False,
) -> np.ndarray:
    """1 for each record whose window any k-mer of ``tables`` hits (back to
    front where ``reverse``), else 0. The engine's prefilter is
    :func:`stage_select`; this one-table scan is kept as the independent
    oracle of tests/test_torch_dispatch_modes.py's
    test_group_members_reject_each_others_candidates."""
    n_records = len(seq_start)
    out = np.empty(n_records, np.uint8)
    _lib.kmer_prefilter(
        _ptr(buf, ctypes.c_uint8),
        _ptr(seq_start, ctypes.c_int64), _ptr(seq_len, ctypes.c_int32),
        n_records, tables.n_entries,
        _ptr(tables.starts, ctypes.c_int64),
        _ptr(tables.stops, ctypes.c_int64),
        _ptr(tables.init_masks, ctypes.c_uint64),
        _ptr(tables.found_masks, ctypes.c_uint64),
        _ptr(tables.masks, ctypes.c_uint64),
        int(reverse),
        _ptr(out, ctypes.c_uint8),
    )
    return out


def pad_encode(
    buf, seq_start, seq_len, sel, width: int, lut,
    pack4: bool = False, out: np.ndarray = None, reverse: bool = False,
    pack2: bool = False,
) -> np.ndarray:
    """Gather+encode selected reads into a padded row matrix
    (back-to-front when ``reverse``). pack4 packs two 4-bit codes per
    byte; pack2 packs four 2-bit codes per byte (callers must route
    windows containing class ids > 3 elsewhere: stage_select's lanes).

    When ``out`` is given it may have more rows than len(sel); only the
    first len(sel) rows are written (extra rows serve as batch padding
    and must be pre-zeroed by the caller)."""
    n_sel = len(sel)
    sel = np.ascontiguousarray(sel, np.int64)
    lut = np.ascontiguousarray(lut, np.uint8)
    if pack2:
        assert width % 4 == 0
        if out is None:
            out = np.empty((n_sel, width // 4), np.uint8)
        fn = _lib.pad_encode_pack2
    elif pack4:
        assert width % 2 == 0
        if out is None:
            out = np.empty((n_sel, width // 2), np.uint8)
        fn = _lib.pad_encode_pack4
    else:
        if out is None:
            out = np.empty((n_sel, width), np.uint8)
        fn = _lib.pad_encode
    fn(
        _ptr(buf, ctypes.c_uint8),
        _ptr(seq_start, ctypes.c_int64), _ptr(seq_len, ctypes.c_int32),
        _ptr(sel, ctypes.c_int64), n_sel, width,
        _ptr(lut, ctypes.c_uint8), int(reverse), _ptr(out, ctypes.c_uint8),
    )
    return out


def check_pair_names(buf1, hs1, he1, buf2, hs2, he2) -> int:
    """First index whose read IDs do not match, or -1 if all match."""
    n = min(len(hs1), len(hs2))
    return int(_lib.check_pair_names(
        _ptr(buf1, ctypes.c_uint8), _ptr(hs1, ctypes.c_int64),
        _ptr(he1, ctypes.c_int64),
        _ptr(buf2, ctypes.c_uint8), _ptr(hs2, ctypes.c_int64),
        _ptr(he2, ctypes.c_int64), n,
    ))


def quality_trim(
    buf, qual_start, win_start, win_stop,
    cutoff_front: int, cutoff_back: int, base: int = 33,
):
    """Window-relative BWA quality trim; negative cutoff disables that
    end. Returns (rel_start, rel_stop) int32 arrays."""
    n = len(qual_start)
    out_start = np.empty(n, np.int32)
    out_stop = np.empty(n, np.int32)
    _lib.quality_trim(
        _ptr(buf, ctypes.c_uint8), _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, cutoff_front, cutoff_back, base,
        _ptr(out_start, ctypes.c_int32), _ptr(out_stop, ctypes.c_int32),
    )
    return out_start, out_stop


def nextseq_trim(buf, seq_start, qual_start, win_start, win_stop,
                 cutoff: int, base: int = 33):
    n = len(qual_start)
    out_stop = np.empty(n, np.int32)
    _lib.nextseq_trim(
        _ptr(buf, ctypes.c_uint8), _ptr(seq_start, ctypes.c_int64),
        _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, cutoff, base, _ptr(out_stop, ctypes.c_int32),
    )
    return out_stop


def poly_a_trim(buf, seq_start, win_start, win_stop, revcomp: bool = False):
    n = len(seq_start)
    out = np.empty(n, np.int32)
    _lib.poly_a_trim(
        _ptr(buf, ctypes.c_uint8), _ptr(seq_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, int(revcomp), _ptr(out, ctypes.c_int32),
    )
    return out


def expected_errors_win(
    buf, qual_start, win_start, win_stop, table, base: int = 33
) -> np.ndarray:
    """Expected errors per window (-1.0 marks invalid phred values)."""
    n = len(qual_start)
    out = np.empty(n, np.float64)
    table = np.ascontiguousarray(table, np.float64)
    _lib.expected_errors_win(
        _ptr(buf, ctypes.c_uint8), _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, base, _ptr(table, ctypes.c_double), _ptr(out, ctypes.c_double),
    )
    return out


def count_n(buf, seq_start, win_start, win_stop) -> np.ndarray:
    n = len(seq_start)
    out = np.empty(n, np.int32)
    _lib.count_n(
        _ptr(buf, ctypes.c_uint8), _ptr(seq_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, _ptr(out, ctypes.c_int32),
    )
    return out


def casava_filtered(buf, head_start, head_end) -> np.ndarray:
    n = len(head_start)
    out = np.empty(n, np.uint8)
    _lib.casava_filtered(
        _ptr(buf, ctypes.c_uint8), _ptr(head_start, ctypes.c_int64),
        _ptr(head_end, ctypes.c_int64), n, _ptr(out, ctypes.c_uint8),
    )
    return out


def assemble_fastq_window(
    buf, head_start, head_end, seq_start, qual_start,
    win_start, win_stop, keep,
) -> bytes:
    win_start = np.ascontiguousarray(win_start, np.int32)
    win_stop = np.ascontiguousarray(win_stop, np.int32)
    keep = np.ascontiguousarray(keep, np.uint8)
    n_records = len(win_start)
    head_len = (head_end - head_start) * keep.astype(np.int64)
    lens = (win_stop - win_start).astype(np.int64) * keep
    total = int(6 * int(keep.sum()) + head_len.sum() + 2 * lens.sum())
    if total == 0:
        return b""
    out_obj, out = _fresh_bytes(total)
    written = _lib.assemble_fastq_window(
        _ptr(buf, ctypes.c_uint8), n_records,
        _ptr(head_start, ctypes.c_int64), _ptr(head_end, ctypes.c_int64),
        _ptr(seq_start, ctypes.c_int64), _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        _ptr(keep, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
    )
    assert written == total
    return out_obj


def trim_n_ends(buf, seq_start, win_start, win_stop):
    """Window-relative (start, stop) after stripping 'N' runs from
    both ends."""
    n = len(seq_start)
    out_start = np.empty(n, np.int32)
    out_stop = np.empty(n, np.int32)
    _lib.trim_n_ends(
        _ptr(buf, ctypes.c_uint8), _ptr(seq_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        n, _ptr(out_start, ctypes.c_int32), _ptr(out_stop, ctypes.c_int32),
    )
    return out_start, out_stop


def assemble_fastq_transform(
    buf, head_start, head_end, seq_start, qual_start,
    win_start, win_stop, rem_start, rem_stop, keep, mode: int,
) -> bytes:
    """Windowed records with the mask (1) / lowercase (2) transform
    applied outside the remainder interval [rem_start, rem_stop)
    (all coordinates absolute within each read)."""
    win_start = np.ascontiguousarray(win_start, np.int32)
    win_stop = np.ascontiguousarray(win_stop, np.int32)
    rem_start = np.ascontiguousarray(rem_start, np.int32)
    rem_stop = np.ascontiguousarray(rem_stop, np.int32)
    keep = np.ascontiguousarray(keep, np.uint8)
    n_records = len(win_start)
    head_len = (head_end - head_start) * keep.astype(np.int64)
    lens = (win_stop - win_start).astype(np.int64) * keep
    total = int(6 * int(keep.sum()) + head_len.sum() + 2 * lens.sum())
    if total == 0:
        return b""
    out_obj, out = _fresh_bytes(total)
    written = _lib.assemble_fastq_transform(
        _ptr(buf, ctypes.c_uint8), n_records,
        _ptr(head_start, ctypes.c_int64), _ptr(head_end, ctypes.c_int64),
        _ptr(seq_start, ctypes.c_int64), _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        _ptr(rem_start, ctypes.c_int32), _ptr(rem_stop, ctypes.c_int32),
        _ptr(keep, ctypes.c_uint8), mode, _ptr(out, ctypes.c_uint8),
    )
    assert written == total
    return out_obj


def reverse_complement_records(buf_copy, seq_start, seq_len, qual_start,
                               comp_table) -> None:
    """In-place per-record reverse-complement of seqs + reversal of
    quals (call on a copy of the chunk buffer)."""
    comp_table = np.ascontiguousarray(comp_table, np.uint8)
    _lib.reverse_complement_records(
        _ptr(buf_copy, ctypes.c_uint8), len(seq_start),
        _ptr(seq_start, ctypes.c_int64),
        _ptr(np.ascontiguousarray(seq_len, np.int32), ctypes.c_int32),
        _ptr(qual_start, ctypes.c_int64),
        _ptr(comp_table, ctypes.c_uint8),
    )


def assemble_fastq_window_rc(
    buf, rc_buf, head_start, head_end, seq_start, qual_start,
    win_start, win_stop, keep, is_rc, suffix: bytes,
) -> bytes:
    win_start = np.ascontiguousarray(win_start, np.int32)
    win_stop = np.ascontiguousarray(win_stop, np.int32)
    keep = np.ascontiguousarray(keep, np.uint8)
    is_rc = np.ascontiguousarray(is_rc, np.uint8)
    n_records = len(win_start)
    head_len = (head_end - head_start) * keep.astype(np.int64)
    lens = (win_stop - win_start).astype(np.int64) * keep
    n_suffixed = int((keep & is_rc).sum())
    total = int(
        6 * int(keep.sum()) + head_len.sum() + 2 * lens.sum()
        + n_suffixed * len(suffix)
    )
    if total == 0:
        return b""
    out_obj, out = _fresh_bytes(total)
    sfx = np.frombuffer(suffix, np.uint8) if suffix else np.zeros(0, np.uint8)
    written = _lib.assemble_fastq_window_rc(
        _ptr(buf, ctypes.c_uint8), _ptr(rc_buf, ctypes.c_uint8), n_records,
        _ptr(head_start, ctypes.c_int64), _ptr(head_end, ctypes.c_int64),
        _ptr(seq_start, ctypes.c_int64), _ptr(qual_start, ctypes.c_int64),
        _ptr(win_start, ctypes.c_int32), _ptr(win_stop, ctypes.c_int32),
        _ptr(keep, ctypes.c_uint8), _ptr(is_rc, ctypes.c_uint8),
        _ptr(sfx, ctypes.c_uint8), len(sfx), _ptr(out, ctypes.c_uint8),
    )
    assert written == total
    return out_obj


def assemble_fastq(
    buf, head_start, head_end, seq_start, qual_start, stops
) -> bytes:
    stops = np.ascontiguousarray(stops, np.int64)
    n_records = len(stops)
    head_len = head_end - head_start
    total = int(6 * n_records + head_len.sum() + 2 * stops.sum())
    if total == 0:
        return b""
    out_obj, out = _fresh_bytes(total)
    written = _lib.assemble_fastq(
        _ptr(buf, ctypes.c_uint8), n_records,
        _ptr(head_start, ctypes.c_int64), _ptr(head_end, ctypes.c_int64),
        _ptr(seq_start, ctypes.c_int64), _ptr(qual_start, ctypes.c_int64),
        _ptr(stops, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
    )
    assert written == total
    return out_obj
