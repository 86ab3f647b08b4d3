"""Submit's staged pass (cutadapt_tpu_torch/staging.py,
``BatchPipelineEngine._stage``) against an oracle made of the port's
Python pieces: ``KmerFinder.kmers_present`` per window for the
prefilter, a numpy lane split and length order, and the numpy encoding
of one batch with its wire lengths, composed as submit composed them
before the pass (one call per piece and batch). That composition is
kept here only as the oracle.

- The parity cases compare the candidates, their order, the lanes, the
  host tail, the scalar-aligner remainders and every batch's encoded
  bytes, lengths, packing and wide flag, byte for byte.
- The launch-capture cases patch ``batch_pipeline.launch_batch`` as the
  benchmark's traced run does (benchmark/trace.py:instrumented) and run
  the same chunks through ``submit`` on the oracle's composition and on
  the pass: the same launches in the same order; with a fake event on
  the CPU, no slot of the arena written again before its event has
  passed, and no allocation after the first chunk.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as bp
from cutadapt_tpu_torch import native, staging
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk
from cutadapt_tpu_torch.parallel.mesh import Mesh

import torch_fixtures as fx

SIZES = dict(min_dp_batch=64, max_dp_batch=512)
ILLUMINA = (fx.ADAPTER, fx.NEXTERA, "TGGAATTCTCGGGTGCCAAGG")

pytestmark = pytest.mark.skipif(not native.AVAILABLE,
                                reason="the native library did not build")


# --- the oracle: the composition before the staged pass ----------------------


def _window(chunk, start, length, reverse) -> bytes:
    win = bytes(chunk.buf[start : start + length])
    return win[::-1] if reverse else win


def oracle_candidates(tasks, chunk, starts, lens) -> np.ndarray:
    """The windows that any task's KmerFinder admits (every window
    without tables)."""
    if any(t.pf_tables is None for t in tasks):
        return np.arange(len(starts))
    keep = [i for i in range(len(starts))
            if any(t.adapter.kmer_finder.kmers_present(
                _window(chunk, starts[i], lens[i], t.reverse).decode())
                for t in tasks)]
    return np.array(keep, np.int64)


def oracle_lanes(engine, task, chunk, c_starts, c_lens, width,
                 host_tail_ok):
    """(order, lanes, host_tail) as the lane split composed them: clean
    windows (every byte the encoding emits maps below 4) first, the
    host tail for a few dirty ones, each lane longest first in
    exact-wire mode."""
    n = len(c_starts)
    order = np.arange(n)
    lanes = [(n, None if task.byte else False)]
    host_tail = 0
    if not task.byte:
        clean = np.array([
            (task.lut[np.frombuffer(_window(chunk, s, length, task.reverse)
                                    [:width], np.uint8)] < 4).all()
            for s, length in zip(c_starts, c_lens)], bool)
        n_clean = int(clean.sum())
        n_dirty = n - n_clean
        if n_dirty == 0:
            lanes = [(n, True)]
        elif n_clean > 0:
            order = np.concatenate([np.flatnonzero(clean),
                                    np.flatnonzero(~clean)])
            if host_tail_ok and n_dirty <= max(64, n >> 6):
                lanes = [(n_clean, True)]
                host_tail = n_dirty
            else:
                lanes = [(n_clean, True), (n_dirty, False)]
    if bp._exact_wire_on(engine.device) and n > 1:
        o_lens = c_lens[order]
        parts, seg_base = [], 0
        for count, _ in lanes:
            seg = np.arange(seg_base, seg_base + count)
            parts.append(seg[np.argsort(-o_lens[seg], kind="stable")])
            seg_base += count
        if seg_base < n:
            parts.append(np.arange(seg_base, n))
        order = order[np.concatenate(parts)]
    return order, lanes, host_tail


def oracle_encode(task, chunk, starts, lens, sel, rows, width, pack2):
    """One batch in numpy: each window through the task's LUT, padded
    with zeros to ``width`` bases and ``rows`` rows, then packed."""
    e = np.zeros((len(sel), width), np.uint8)
    for pos, i in enumerate(sel):
        win = np.frombuffer(_window(chunk, starts[i], lens[i], task.reverse),
                            np.uint8)
        e[pos, : min(len(win), width)] = task.lut[win[:width]]
    if pack2:
        e = (e[:, 0::4] | (e[:, 1::4] << 2)
             | (e[:, 2::4] << 4) | (e[:, 3::4] << 6))
    elif pack2 is False:
        e = e[:, 0::2] | (e[:, 1::2] << 4)
    out = np.zeros((rows, e.shape[1]), np.uint8)
    out[: len(sel)] = e
    return out


def oracle_wire_lengths(vals, size, wide, width=None):
    dt = (np.int32 if wide
          else np.uint8 if width is not None and width < 256 else np.int16)
    out = np.zeros(size, dt)
    out[: len(vals)] = vals
    return out


def oracle_batches(engine, tasks, chunk, c_starts, c_lens, lanes, width,
                   wide, tail_max):
    """The batches ((first row, rows taken, pack2, enc, lengths)) and the
    scalar-aligner remainders ((first row, end)) of the lanes."""
    exact = bp._exact_wire_on(engine.device)
    batches, tails = [], []
    base = 0
    for count, p2 in lanes:
        dev_count = count
        if 0 < tail_max < count:
            covered = 0
            for size in engine._dp_sizes(count):
                if covered + size <= count:
                    covered += size
                else:
                    break
            if covered and 0 < count - covered <= tail_max:
                dev_count = covered
        off = 0
        for size in engine._dp_sizes(dev_count):
            take = min(size, dev_count - off)
            if take <= 0:
                break
            rows = slice(base + off, base + off + take)
            b_w = (bp._eff_width(int(c_lens[rows].max()), width, p2)
                   if exact else width)
            enc = oracle_encode(tasks[0], chunk, c_starts, c_lens,
                                np.arange(rows.start, rows.stop), size, b_w,
                                p2)
            lengths = oracle_wire_lengths(c_lens[rows], size, wide,
                                          b_w if exact else None)
            batches.append((rows.start, take, p2, enc, lengths))
            off += size
        if dev_count < count:
            tails.append((base + dev_count, base + count))
        base += count
    return batches, tails


def oracle_stage(engine, tasks, chunk, starts, lens, width, host_tail_ok,
                 tail_max) -> dict:
    sel = oracle_candidates(tasks, chunk, starts, lens)
    out = dict(sel=sel, lanes=[], host_tail=0, wide=False, batches=[],
               tails=[])
    if len(sel) == 0:
        return out
    c_starts, c_lens = starts[sel], lens[sel]
    wide = int(c_lens.max()) >= (1 << bp._QS_BITS) or engine.want_ref_coords
    order, lanes, host_tail = oracle_lanes(engine, tasks[0], chunk, c_starts,
                                           c_lens, width, host_tail_ok)
    sel, c_starts, c_lens = sel[order], c_starts[order], c_lens[order]
    batches, tails = oracle_batches(engine, tasks, chunk, c_starts, c_lens,
                                    lanes, width, wide, tail_max)
    out.update(sel=sel, lanes=lanes, host_tail=host_tail, wide=wide,
               batches=batches, tails=tails, c_starts=c_starts,
               c_lens=c_lens)
    return out


class OracleSubmit:
    """The engine's two dispatch methods as they were composed before the
    staged pass, over the oracle's pieces: patched onto an engine, its
    ``submit`` launches what the old composition launched."""

    def __init__(self, engine):
        self.engine = engine

    def dispatch_windows(self, task, chunk, starts, lens, width):
        return self._dispatch([task], chunk, starts, lens, width, True,
                              bp._SCALAR_TAIL, per_task=True)

    def dispatch_group(self, key, tasks, chunk, starts, lens, width):
        tail_max = bp._SCALAR_TAIL if key[0] == "cls" else 0
        return self._dispatch(tasks, chunk, starts, lens, width, False,
                              tail_max, per_task=False)

    def _dispatch(self, tasks, chunk, starts, lens, width, host_tail_ok,
                  tail_max, per_task):
        eng = self.engine
        st = oracle_stage(eng, tasks, chunk, starts, lens, width,
                          host_tail_ok, tail_max)
        futures = [[] for _ in tasks]
        for row0, take, p2, enc, lengths in st["batches"]:
            bp._xfer_add(h2d=enc.nbytes + lengths.nbytes, candidates=take,
                         dp_rows=len(lengths) * len(tasks))
            results = bp.launch_batch(tasks, torch.from_numpy(enc),
                                      torch.from_numpy(lengths), eng.device,
                                      p2, st["wide"])
            for futs, fut in zip(futures, results):
                futs.append((row0, take, fut, st["wide"]))
        for s0, s1 in st["tails"]:
            bp._xfer_add(candidates=s1 - s0)
            for t, futs in zip(tasks, futures):
                futs.append(("host_range", s0) + t.run_scalar(
                    chunk, st["c_starts"][s0:s1], st["c_lens"][s0:s1]))
        if st["host_tail"]:
            base = len(st["sel"]) - st["host_tail"]
            futures[0].append(("host_range", base) + tasks[0].run_scalar(
                chunk, st["c_starts"][base:], st["c_lens"][base:]))
        if per_task:
            return st["sel"], futures[0]
        return st["sel"], futures

    def patch(self, monkeypatch):
        monkeypatch.setattr(self.engine, "_dispatch_windows",
                            self.dispatch_windows)
        monkeypatch.setattr(self.engine, "_dispatch_group",
                            self.dispatch_group)


# --- the cases ---------------------------------------------------------------


def _engine(tasks_or_stage, **kwargs):
    stage = (tasks_or_stage if isinstance(tasks_or_stage, bp.AdapterStage)
             else bp.AdapterStage(tasks_or_stage))
    return bp.BatchPipelineEngine([stage], device="cpu",
                                  **{**SIZES, **kwargs})


def _back(adapter, **params):
    stage, tasks = fx.cutter_stage(fx.PORT_MODULES, [("back", adapter)],
                                   **params)
    return stage, tasks


def _whole(chunk):
    return (chunk.seq_start.astype(np.int64),
            chunk.seq_len.astype(np.int32))


def case_se_truseq_100():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(fx.make_dataset(900, seed=3))


def case_paired_r1_150():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(fx.make_pairs(500, seed=7)[0])


def case_paired_r2_150():
    stage, tasks = _back(fx.TRUSEQ_R2)
    return stage, tasks, parse_fastq_chunk(fx.make_pairs(500, seed=7)[1])


def case_n_host_tail():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(
        fx.add_ns(fx.make_dataset(900, seed=4), 0.01))


def case_n_4bit_lane():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(
        fx.add_ns(fx.make_dataset(900, seed=5), 0.3))


def case_revcomp():
    stage, tasks = _back(fx.PRIMER_515F)
    chunk = parse_fastq_chunk(fx.add_ns(fx.make_amplicons(600), 0.1))
    return stage, tasks, bp.reverse_complement_chunk(chunk)


def case_rightmost_reversed():
    task = bp.AdapterTask(tad.RightmostBackAdapter(
        fx.ADAPTER, max_errors=0.1, min_overlap=3), "rightmost_back", 0)
    assert task.reverse
    return bp.AdapterStage([task]), [task], parse_fastq_chunk(
        fx.add_ns(fx.make_dataset(700, seed=8), 0.5))


def case_three_adapters_group():
    stage, tasks = fx.cutter_stage(fx.PORT_MODULES,
                                   [("back", ad) for ad in ILLUMINA])
    return stage, tasks, parse_fastq_chunk(fx.add_ns(fx.make_reads(
        900, 9, list(ILLUMINA)), 0.05))


def case_linked_front_phase():
    stage, tasks = _back(fx.LINKED_PRIMERS)
    assert tasks[0].kind == "linked"
    return stage, [tasks[0].front_task], parse_fastq_chunk(
        fx.make_amplicons(700))


def case_linked_back_phase():
    stage, tasks = _back(fx.LINKED_PRIMERS)
    return stage, [tasks[0].back_task], parse_fastq_chunk(
        fx.add_ns(fx.make_amplicons(700, seed=6), 0.05))


def case_byte_lane():
    stage, tasks = _back(fx.BYTE_LANE_ADAPTER, adapter_wildcards=False)
    assert tasks[0].byte
    return stage, tasks, parse_fastq_chunk(fx.make_byte_lane_reads(700))


def case_longer_than_width():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(
        fx.add_ns(fx.make_dataset(600, seed=11), 0.2))


def case_long_reads_wide():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(fx.make_long_reads(40))


def case_empty_chunk():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(b"")


def case_no_candidates():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(
        b"".join(b"@r%d\n%s\n+\n%s\n" % (i, b"C" * 100, b"I" * 100)
                 for i in range(300)))


def case_mesh_4_shards():
    stage, tasks = _back(fx.ADAPTER)
    return stage, tasks, parse_fastq_chunk(fx.make_dataset(900, seed=13))


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture
def env(monkeypatch):
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_EXACT_WIRE", raising=False)
    # remainders past 16 rows take a padded batch: both rules run
    monkeypatch.setattr(bp, "_SCALAR_TAIL", 16)
    yield monkeypatch
    bp.set_shard_mesh(None)


def _setup(env, case, exact):
    env.setenv("CUTADAPT_TPU_TORCH_EXACT_WIRE", exact)
    if case == "mesh_4_shards":
        bp.set_shard_mesh(Mesh(["cpu"] * 4))
    return CASES[case]()


@pytest.mark.parametrize("exact", ["1", "0"], ids=["exact", "bucketed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_matches_oracle(env, case, exact):
    stage, tasks, chunk = _setup(env, case, exact)
    engine = _engine(stage)
    starts, lens = _whole(chunk)
    width = 64 if case == "longer_than_width" else (
        engine._bucket_length(int(lens.max())) if len(lens) else 64)
    group = len(tasks) > 1
    if group:
        key = bp._upload_key(tasks[0])
        assert all(bp._upload_key(t) == key for t in tasks)
        tail_max = bp._SCALAR_TAIL if key[0] == "cls" else 0
    else:
        tail_max = bp._SCALAR_TAIL
    want = oracle_stage(engine, tasks, chunk, starts, lens, width,
                        not group, tail_max)
    got = engine._stage(tasks, chunk, starts, lens, width,
                        host_tail_ok=not group, tail_max=tail_max)
    try:
        assert np.array_equal(got.sel, want["sel"])
        if case in ("empty_chunk", "no_candidates"):
            assert len(got.sel) == 0 and got.slot is None
            return
        assert np.array_equal(got.c_starts, starts[want["sel"]])
        assert np.array_equal(got.c_lens, lens[want["sel"]])
        assert got.lanes == want["lanes"]
        assert got.host_tail == want["host_tail"]
        assert got.wide == want["wide"]
        assert got.tails == want["tails"]
        assert len(got.batches) == len(want["batches"]) > 0
        for (g_row0, g_take, g_p2, g_enc, g_len), (row0, take, p2, enc,
                                                   lengths) in zip(
                got.batches, want["batches"]):
            assert (g_row0, g_take, g_p2) == (row0, take, p2)
            assert g_enc.dtype == torch.uint8
            assert g_enc.shape == enc.shape
            assert np.array_equal(g_enc.numpy(), enc)
            assert g_len.numpy().dtype == lengths.dtype
            assert np.array_equal(g_len.numpy(), lengths)
    finally:
        if got.slot is not None:
            engine._arena.release(got.slot)
    # what each case is there for
    lanes = [p2 for _, p2 in got.lanes]
    if case == "n_host_tail":
        assert got.host_tail > 0 and lanes == [True]
    if case in ("n_4bit_lane", "rightmost_reversed", "three_adapters_group"):
        assert lanes == [True, False]
    if case == "byte_lane":
        assert lanes == [None]
    if case == "long_reads_wide":
        assert got.wide
    if case == "longer_than_width":
        assert int(lens.max()) > width
    if case == "linked_back_phase":
        # every amplicon carries the 3' primer, whose IUPAC bases still
        # leave the reads' clean windows on the 2-bit lane
        assert len(got.sel) == len(lens) and lanes[0] is True
    if case == "mesh_4_shards":
        assert all(len(b[4]) % 4 == 0 for b in got.batches)


# --- the launches through submit ---------------------------------------------


class FakeEvent:
    """An event on the CPU: passed once the test says the device got
    there, or once someone waits for it."""

    def __init__(self):
        self.passed = False

    def query(self) -> bool:
        return self.passed

    def synchronize(self) -> None:
        self.passed = True


def _stage_of(kind):
    if kind == "se":
        return _back(fx.ADAPTER)[0], lambda i: fx.add_ns(
            fx.make_dataset(500, seed=20 + i), 0.1)
    if kind == "three_shared":
        return fx.cutter_stage(fx.PORT_MODULES,
                               [("back", ad) for ad in ILLUMINA])[0], (
            lambda i: fx.add_ns(fx.make_reads(500, 30 + i, list(ILLUMINA)),
                                0.05))
    if kind == "revcomp":
        stage, tasks = _back(fx.PRIMER_515F)
        return bp.RevcompStage(tasks, modifier=stage.modifier), (
            lambda i: fx.make_amplicons(400, seed=40 + i))
    if kind == "linked":
        return _back(fx.LINKED_PRIMERS)[0], (
            lambda i: fx.make_amplicons(400, seed=50 + i))
    if kind == "mesh":
        return _back(fx.ADAPTER)[0], lambda i: fx.make_dataset(500,
                                                               seed=60 + i)
    raise ValueError(kind)


def _capture(monkeypatch, into):
    real = bp.launch_batch

    def captured(tasks, enc, lengths, device, pack2, wide=False):
        into.append((tuple(id(t) for t in tasks), enc.numpy().copy(),
                     lengths.numpy().copy(), pack2, wide))
        return real(tasks, enc, lengths, device, pack2, wide)

    monkeypatch.setattr(bp, "launch_batch", captured)


@pytest.mark.parametrize("kind", ["se", "three_shared", "revcomp", "linked",
                                  "mesh"])
def test_submit_launches_as_before(env, kind, monkeypatch):
    """The same chunks through submit (and collect, whose linked 3' phase
    launches too) on the old composition and on the staged pass: the same
    launches in the same order and the same results; with a fake event,
    no slot written again before its event has passed, and the arena's
    allocations flat after the first chunk."""
    env.setenv("CUTADAPT_TPU_TORCH_EXACT_WIRE", "1")
    if kind == "mesh":
        bp.set_shard_mesh(Mesh(["cpu"] * 4))
    stage, data = _stage_of(kind)
    chunks = [parse_fastq_chunk(data(i)) for i in range(3)]

    old, new = [], []
    results = {}
    for name, into in (("old", old), ("new", new)):
        engine = _engine(stage)
        with monkeypatch.context() as m:
            _capture(m, into)
            if name == "old":
                OracleSubmit(engine).patch(m)
            else:
                arena = engine._arena
                events, last = [], {}

                def record():
                    events.append(FakeEvent())
                    return events[-1]

                real_release, real_encode = arena.release, staging.encode

                def release(slot, event=None):
                    real_release(slot, event)
                    last[slot.array.ctypes.data] = slot.event

                def encode(buf, c_starts, c_lens, rows, lut, reverse, arr):
                    ev = last.get(arr.ctypes.data)
                    assert ev is None or ev.passed, "slot written early"
                    return real_encode(buf, c_starts, c_lens, rows, lut,
                                       reverse, arr)

                m.setattr(engine, "_record_uploads", record)
                m.setattr(arena, "release", release)
                m.setattr(staging, "encode", encode)
                allocs = []
            out = []
            for chunk in chunks:
                pending = engine.submit(chunk)
                out.append(engine.collect(pending)[:3])
                if name == "new":
                    allocs.append(bp.XFER["pinned_allocs"])
                    for ev in events:  # the device done by the next chunk
                        ev.passed = True
        results[name] = out
    assert len(new) == len(old) > 0
    for a, b in zip(old, new):
        assert a[0] == b[0] and a[3:] == b[3:]
        assert a[1].dtype == b[1].dtype and np.array_equal(a[1], b[1])
        assert a[2].dtype == b[2].dtype and np.array_equal(a[2], b[2])
    for (ws0, we0, keep0), (ws1, we1, keep1) in zip(results["old"],
                                                     results["new"]):
        assert np.array_equal(ws0, ws1) and np.array_equal(we0, we1)
        assert np.array_equal(keep0, keep1)
    assert events and len(set(allocs)) == 1, allocs  # none after chunk 0


def test_xfer_counts_the_staged_rows(env):
    """Every candidate of a run goes through the pass (``staged_rows``
    equals ``candidates``), the arena allocates its slots once, and the
    wire counters are those of the old composition."""
    stage, data = _stage_of("se")
    got = {}
    for name in ("old", "new"):
        engine = _engine(stage)
        bp.reset_xfer_counters()
        with pytest.MonkeyPatch.context() as m:
            if name == "old":
                OracleSubmit(engine).patch(m)
            for i in range(3):
                engine.collect(engine.submit(parse_fastq_chunk(data(i))))
        got[name] = bp.xfer_counters()
    new, old = got["new"], got["old"]
    assert new["candidates"] > 0 and new["staged_rows"] == new["candidates"]
    assert new["pinned_allocs"] == bp.PIPELINE_DEPTH + 1  # chunk 0 only
    for k in ("h2d_bytes", "d2h_bytes", "candidates", "dp_rows"):
        assert new[k] == old[k], k


def test_arena_reuses_a_slot_only_after_its_event():
    """The first pass allocates every slot; then the arena hands out the
    newest released slot whose event has passed, else waits for the
    oldest that fits; it grows a slot only for a pass larger than it
    holds."""
    allocs = []
    arena = staging.StagingArena(2, pinned=False,
                                 on_alloc=lambda: allocs.append(1))
    a = arena.take(1000)
    assert len(allocs) == 2 and a.capacity >= 1000
    arena.release(a, FakeEvent())
    b = arena.take(1000)  # a's uploads pending: the other slot
    assert b is not a and len(allocs) == 2
    arena.release(b, FakeEvent())
    a.event.passed = True
    assert arena.take(900) is a  # passed, and fits
    arena.release(a, FakeEvent())
    c = arena.take(1000)  # none passed: the oldest, waited for
    assert c is b and c.event is None and len(allocs) == 2
    arena.release(c)
    d = arena.take(10 ** 6)  # more than any slot holds: grown
    assert d.capacity >= 10 ** 6 and len(allocs) == 3
