"""
The engine's two dispatch modes in the port, held to the JAX package's:
the shared upload of a stage's task groups
(``CUTADAPT_TPU_TORCH_SHARED_UPLOAD``, on by default; the reference's
``CUTADAPT_TPU_SHARED_UPLOAD``) and the device-side prefilter
(``CUTADAPT_TPU_TORCH_DEVICE_PREFILTER=1``; ``CUTADAPT_TPU_DEVICE_PREFILTER``).

Each option set runs through the port's CLI on its engine under require
on the CPU (the aligner's plain version) and through the JAX CLI on its
engine (``CUTADAPT_TPU_BATCH=1``, one device), with the switch on and
off in both, on the same seeded reads; both engines dispatch batches of
64 to 256 rows, so lanes take several batches and scalar tails. Every
output file and the ``--json`` report must be byte-identical across the
four runs, and the port's transfer counters (``xfer_counters``: H2D and
D2H bytes, candidates, DP rows) equal to the JAX engine's in each mode.
Tolerance: exact.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

import cutadapt_tpu.accel as jaccel
import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.io.chunks import parse_fastq_chunk

import torch_fixtures as fx

SIZES = dict(min_dp_batch=64, max_dp_batch=256)
# the TruSeq, Nextera and small-RNA 3' adapters
ILLUMINA = (fx.ADAPTER, fx.NEXTERA, "TGGAATTCTCGGGTGCCAAGG")
THREE_ILLUMINA = ["-e", "0.1", "-O", "3"] + [
    x for ad in ILLUMINA for x in ("-a", ad)]
# a second adapter of 17 query classes beside fx.BYTE_LANE_ADAPTER
BYTE_LANE_FRONT = "GGTTRYKMXSWBDHVNCA"


@pytest.fixture(autouse=True)
def one_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture
def engines(monkeypatch):
    """Both CLIs on their engines (the port on the CPU under require, the
    JAX package on one device), each engine dispatching 64-256 rows."""
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_CHUNK_BYTES",
                 "CUTADAPT_TPU_WORKERS", "CUTADAPT_TPU_TORCH_DEVICE_STATS",
                 "CUTADAPT_TPU_DEVICE_STATS", "CUTADAPT_TPU_TORCH_PACK2",
                 "CUTADAPT_TPU_PACK2", "CUTADAPT_TPU_TORCH_EXACT_WIRE",
                 "CUTADAPT_TPU_EXACT_WIRE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICES", "1")
    monkeypatch.setenv("CUTADAPT_TPU_BATCH", "1")
    monkeypatch.setenv("CUTADAPT_TPU_DEVICES", "1")
    for bp in (jbp, tbp):
        monkeypatch.setattr(
            bp.BatchPipelineEngine, "__init__", functools.partialmethod(
                bp.BatchPipelineEngine.__init__, **SIZES))
    return monkeypatch


class GroupSpy:
    """Counts the port's shared-upload group dispatches."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tbp.BatchPipelineEngine._dispatch_group

        def spy(engine, *args, **kwargs):
            self.calls += 1
            return real(engine, *args, **kwargs)

        monkeypatch.setattr(tbp.BatchPipelineEngine, "_dispatch_group", spy)


def _run(monkeypatch, package, tmp_path, tag, args, inputs, outputs,
         switches):
    """One CLI run of ``package`` ("port" or "jax") with ``switches``
    ({"SHARED_UPLOAD": "1", ...}) set under its prefix: its files, its
    report and its transfer counters."""
    prefix = "CUTADAPT_TPU_TORCH_" if package == "port" else "CUTADAPT_TPU_"
    for name, value in switches.items():
        monkeypatch.setenv(prefix + name, value)
    main, bp, accel, adapters = (
        (port_cli.main, tbp, taccel, tad) if package == "port"
        else (jax_cli.main, jbp, jaccel, jad))
    d = tmp_path / f"{package}-{tag}"
    d.mkdir()
    # adapters without a name are numbered per process
    monkeypatch.setattr(adapters, "_adapter_counter", [0])
    fallbacks = accel.FALLBACK_COUNT
    bp.reset_xfer_counters()
    main(["--quiet"] + [a.format(out=d) for a in args]
         + ["--json", str(d / "report.json")]
         + [a for flag, out in outputs for a in (flag, str(d / out))]
         + [str(p) for p in inputs])
    assert accel.FALLBACK_COUNT == fallbacks, accel.LAST_FALLBACK
    xfer = bp.xfer_counters()
    if package == "port":
        # the staged pass's counters beside the reference's: every
        # candidate went through the pass
        assert xfer.pop("staged_rows") == xfer["candidates"]
        assert xfer.pop("pinned_allocs") >= 0
        # and the linked phases' counters: the 3' rows are of its windows
        # past its prefilter, and only a linked adapter's 3' phase runs
        linked = any("..." in a for a in args)
        assert 0 <= xfer.pop("linked_back_rows") <= xfer.pop(
            "linked_back_windows")
        assert (xfer.pop("linked_back_ns") > 0) == linked
        assert (xfer.pop("linked_front_rows") > 0) <= linked
        # each first round's 3' phase from the worker: emit's wait for it
        assert (xfer.pop("linked_back_wait_ns") > 0) == linked
        assert (xfer.pop("linked_back_ready") > 0) <= linked
    files = {p.name: p.read_bytes() for p in sorted(d.iterdir())
             if p.name != "report.json"}
    return files, fx.json_report(d / "report.json"), xfer


def _same_results(got) -> None:
    """Every run's files and report equal the first's."""
    first = next(iter(got.values()))
    assert any(first[0].values())
    for key, run in got.items():
        assert sorted(run[0]) == sorted(first[0]), key
        for name, data in first[0].items():
            assert run[0][name] == data, (key, name)
        assert run[1] == first[1], key


def _write(tmp_path, name, data) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _revcomp_some(data: bytes) -> bytes:
    """Every second record reverse-complemented (qualities reversed)."""
    lines = data.split(b"\n")
    table = bytes.maketrans(b"ACGTN", b"TGCAN")
    for r in range(0, len(lines) // 4, 2):
        lines[4 * r + 1] = lines[4 * r + 1].translate(table)[::-1]
        lines[4 * r + 3] = lines[4 * r + 3][::-1]
    return b"\n".join(lines)


def _case_inputs(case, tmp_path):
    """(arguments, inputs, outputs) of an option set."""
    out = [("-o", "out.1.fastq")]
    if case == "paired":
        r1 = fx.make_reads(900, 31, [fx.ADAPTER, fx.NEXTERA])
        r2 = fx.make_reads(900, 32, [ILLUMINA[2], "AGATCGGAAGAGCGTCGTGTAG"])
        return (["-a", fx.ADAPTER, "-a", fx.NEXTERA, "-A", ILLUMINA[2],
                 "-A", "AGATCGGAAGAGCGTCGTGTAG", "-q", "20", "-m", "20"],
                [_write(tmp_path, "in.1.fastq", r1),
                 _write(tmp_path, "in.2.fastq", r2)],
                out + [("-p", "out.2.fastq")])
    if case == "byte lane":
        data = fx.add_ns(fx.make_reads(
            900, 37, [fx.BYTE_LANE_ADAPTER, BYTE_LANE_FRONT]), 0.03)
        return (["-N", "-e", "0.1", "-a", fx.BYTE_LANE_ADAPTER,
                 "-a", BYTE_LANE_FRONT],
                [_write(tmp_path, "in.fastq", data)], out)
    args, adapters = {
        "three illumina": (THREE_ILLUMINA, ILLUMINA),
        "group and single": (
            ["-a", fx.ADAPTER, "-a", fx.NEXTERA, "-g", "^" + fx.PRIMER_515F],
            (fx.ADAPTER, fx.NEXTERA)),
        "back and anywhere": (["-a", fx.ADAPTER, "-b", fx.NEXTERA],
                              (fx.ADAPTER, fx.NEXTERA)),
        "revcomp": (["--revcomp", "-g", fx.NEXTERA, "-g", ILLUMINA[2]],
                    (fx.NEXTERA, ILLUMINA[2])),
        "times 2": (["-n", "2", "-a", fx.ADAPTER, "-a", fx.NEXTERA],
                    (fx.ADAPTER, fx.NEXTERA)),
        "wildcard file": (["-a", fx.ADAPTER, "-a", fx.NEXTERA,
                           "--wildcard-file", "{out}/wildcards.txt"],
                          (fx.ADAPTER, fx.NEXTERA)),
    }[case]
    data = fx.make_reads(1200, 30 + len(case), list(adapters))
    if case == "group and single":
        # a third of the reads start with the primer
        data = fx.make_reads(1200, 33, list(adapters))
        lines = data.split(b"\n")
        for r in range(0, len(lines) // 4, 3):
            seq = (fx.PRIMER_515F.replace("Y", "C").replace("M", "A")
                   .encode() + lines[4 * r + 1])[:len(lines[4 * r + 1])]
            lines[4 * r + 1] = seq
        data = b"\n".join(lines)
    elif case == "revcomp":
        data = _revcomp_some(data)
    data = fx.add_ns(data, 0.05)
    return args, [_write(tmp_path, "in.fastq", data)], out


# option set -> (reads, {switch: value} of both packages, of the port
# alone); the expectation differs for the last two
CASES = {
    "three illumina": ("three illumina", {}, {}),
    "group and single": ("group and single", {}, {}),
    "back and anywhere": ("back and anywhere", {}, {}),
    "revcomp": ("revcomp", {}, {}),
    "paired": ("paired", {}, {}),
    "times 2": ("times 2", {}, {}),
    "byte lane": ("byte lane", {}, {}),
    "wildcard file": ("wildcard file", {}, {}),
    # the 4-bit groups of a run without the 2-bit lane: candidates and
    # DP rows as the reference's byte group, half its H2D bytes
    "pack2 off": ("three illumina", {"PACK2": "0"}, {}),
    # a mesh of two CPU shards: every task dispatches on its own, so the
    # counters do not depend on the switch
    "two shards": ("three illumina", {}, {"DEVICES": "2"}),
}


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", sorted(CASES))
def test_shared_upload_matches_jax_engine(engines, tmp_path, case):
    """Files and report of the port equal the JAX CLI's with the shared
    upload on and off, and its transfer counters the JAX engine's in each
    mode; on, the groups dispatch together, off, none does."""
    reads, both, port_only = CASES[case]
    args, inputs, outputs = _case_inputs(reads, tmp_path)
    spy = GroupSpy(engines)
    got, groups = {}, {}
    for value in ("1", "0"):
        before = spy.calls
        for package in ("port", "jax"):
            switches = {"SHARED_UPLOAD": value, **both}
            if package == "port":
                switches.update(port_only)
            got[package, value] = _run(engines, package, tmp_path,
                                       f"shared{value}", args, inputs,
                                       outputs, switches)
        groups[value] = spy.calls - before
    _same_results(got)
    assert groups["0"] == 0
    port = {v: got["port", v][2] for v in ("1", "0")}
    jax = {v: got["jax", v][2] for v in ("1", "0")}
    if case == "two shards":
        assert tbp.get_shard_mesh().size == 2
        assert groups["1"] == 0 and port["1"] == port["0"]
        assert port["0"]["candidates"] == jax["0"]["candidates"]
        return
    assert groups["1"] > 0
    assert port["0"] == jax["0"]
    if case == "pack2 off":
        for key in ("candidates", "dp_rows", "d2h_bytes"):
            assert port["1"][key] == jax["1"][key], key
        # half a byte per base against the reference's byte per base
        assert port["1"]["h2d_bytes"] < jax["1"]["h2d_bytes"]
    else:
        assert port["1"] == jax["1"]


def _prefilter_inputs(case, tmp_path):
    """(arguments, inputs, outputs) of a device-prefilter case."""
    out = [("-o", "out.1.fastq")]
    if case == "flagship":
        # tests/test_accel.py:test_fastpath_device_prefilter_parity
        data = fx.make_reads(1000, 7, [fx.ADAPTER])
        return (["-a", "a1=" + fx.ADAPTER, "-q", "10"],
                [_write(tmp_path, "in.fastq", data)], out)
    if case == "three illumina":
        data = fx.make_reads(1000, 8, list(ILLUMINA))
        return THREE_ILLUMINA, [_write(tmp_path, "in.fastq", data)], out
    if case == "linked":
        data = fx.make_amplicons(300, rc_share=0.0)
        return (["-a", fx.LINKED_PRIMERS, "--discard-untrimmed"],
                [_write(tmp_path, "in.fastq", data)], out)
    # --pair-adapters: each pair's adapters on their side's engine
    r1 = fx.make_reads(600, 41, [fx.ADAPTER, fx.NEXTERA])
    r2 = fx.make_reads(600, 42, [ILLUMINA[2], fx.NEXTERA])
    return (["--pair-adapters", "-a", "p1=" + fx.ADAPTER,
             "-a", "q1=" + fx.NEXTERA, "-A", "p2=" + ILLUMINA[2],
             "-A", "q2=" + fx.NEXTERA],
            [_write(tmp_path, "in.1.fastq", r1),
             _write(tmp_path, "in.2.fastq", r2)],
            out + [("-p", "out.2.fastq")])


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", ("flagship", "three illumina", "linked",
                                  "pair adapters"))
def test_device_prefilter_matches_jax_engine(engines, tmp_path, case,
                                             monkeypatch):
    """With the device-side prefilter every window is a candidate: the
    files and report equal the runs without it and the JAX CLI's with
    CUTADAPT_TPU_DEVICE_PREFILTER=1, and the port's transfer counters the
    JAX engine's with the switch on and off; the host's k-mer scan runs
    only with it off."""
    import cutadapt_tpu_torch.native as tnative

    args, inputs, outputs = _prefilter_inputs(case, tmp_path)
    scans = []
    real = tnative.stage_select

    def scan(buf, starts, lens, prefilter, *a, **kw):
        if prefilter is not None:
            scans.append(1)
        return real(buf, starts, lens, prefilter, *a, **kw)

    monkeypatch.setattr(tnative, "stage_select", scan)
    got, port_scans = {}, {}
    for value in ("1", "0"):
        before = len(scans)
        for package in ("port", "jax"):
            got[package, value] = _run(engines, package, tmp_path,
                                       f"prefilter{value}", args, inputs,
                                       outputs, {"DEVICE_PREFILTER": value})
        port_scans[value] = len(scans) - before
    _same_results(got)
    for value in ("1", "0"):
        assert got["port", value][2] == got["jax", value][2], value
    assert port_scans["1"] == 0 and port_scans["0"] > 0
    on, off = got["port", "1"][2], got["port", "0"][2]
    assert on["candidates"] > off["candidates"]
    if case in ("flagship", "three illumina"):
        # one round over one group: every read shipped once
        assert on["candidates"] == 1000 and off["candidates"] < 1000


def test_group_members_reject_each_others_candidates(monkeypatch):
    """In a group of the three Illumina adapters each member's kernel
    runs over the union of the members' prefilter candidates: the reads
    only another member's prefilter admits come back found=False, and on
    its own candidates each member's results equal its per-task
    dispatch."""
    from cutadapt_tpu_torch import native

    monkeypatch.delenv("CUTADAPT_TPU_TORCH_PACK2", raising=False)
    monkeypatch.delenv("CUTADAPT_TPU_TORCH_DEVICE_PREFILTER", raising=False)
    stage, tasks = fx.cutter_stage(
        fx.PORT_MODULES, [("back", ad) for ad in ILLUMINA])
    engine = tbp.BatchPipelineEngine([stage], device="cpu", **SIZES)
    chunk = parse_fastq_chunk(fx.add_ns(fx.make_reads(
        800, 9, list(ILLUMINA)), 0.05))
    n = chunk.n_records
    ws = np.zeros(n, np.int32)
    we = chunk.seq_len.astype(np.int32)
    width = engine._bucket_length(int(we.max()))
    subset = np.arange(n)
    results = {}
    for value in ("1", "0"):
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_SHARED_UPLOAD", value)
        disp = engine._dispatch_stage(stage, chunk, subset, ws, we, width)
        results[value] = []
        for task, (kind, sel, futures) in zip(tasks, disp):
            assert kind == "single"
            found, qs, qe, er, sc = engine._fetch_task(len(sel), futures)[:5]
            results[value].append((sel, found, qs, qe, er, sc))
    starts = chunk.seq_start.astype(np.int64)
    others = 0
    for i, task in enumerate(tasks):
        own = native.kmer_prefilter(chunk.buf, starts, we, task.pf_tables,
                                    reverse=task.reverse).astype(bool)
        sel, found = results["1"][i][:2]
        assert np.array_equal(sel, results["1"][0][0])  # one shared sel
        assert not found[~own[sel]].any()
        others += int((~own[sel]).sum())
        # on the task's own candidates, the per-task dispatch's results
        sel0 = results["0"][i][0]
        assert np.array_equal(np.sort(sel0), np.flatnonzero(own))
        pos = {s: j for j, s in enumerate(sel)}
        idx = np.array([pos[s] for s in sel0])
        for got, want in zip(results["1"][i][1:], results["0"][i][1:]):
            f = results["0"][i][1]
            assert np.array_equal(got[idx][f], want[f])
        assert np.array_equal(found[idx], results["0"][i][1])
    assert others > 0
