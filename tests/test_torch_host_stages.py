"""
The port's host stages and its comparer, indexed and linked adapter
tasks (device="cpu", the aligner's plain PyTorch version) against the
JAX package's engine (JAX on the CPU) on the same parsed chunk: windows,
keep-mask, statistics (per-stage keys included) and assembled FASTQ
bytes are equal. Then the two configurations of chip_smoke.py's phases
6 and 7 through the port's main in require mode against the JAX
package's main: output file and JSON report equal. Tolerance: exact.
"""

import json
import os
import sys
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

import cutadapt_tpu.accel as jaccel
import cutadapt_tpu.adapters as jad
import cutadapt_tpu.batch_pipeline as jbp
import cutadapt_tpu.cli as jax_cli
import cutadapt_tpu.modifiers as jmod
import cutadapt_tpu.parser as jparser
from cutadapt_tpu.io.chunks import assemble_window as jax_assemble
from cutadapt_tpu.io.chunks import parse_fastq_chunk as jax_parse
import cutadapt_tpu_torch.accel as taccel
import cutadapt_tpu_torch.adapters as tad
import cutadapt_tpu_torch.batch_pipeline as tbp
import cutadapt_tpu_torch.cli as port_cli
from cutadapt_tpu_torch.io.chunks import assemble_window, parse_fastq_chunk
from cutadapt_tpu_torch.ops import align_cuda

import torch_fixtures as fx

# small dispatch batches, so that a few thousand reads run the binary
# decomposition, the scalar tail and both kernel lanes
SIZES = dict(min_dp_batch=256, max_dp_batch=1024)
PREFIXES = ("GTACGGATTGTTCAGTA", "TATTAAGCTCATTC")
SUFFIXES = ("CGTGATTATCTTGC", "CCTATTAGTGGTTGAAC")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


def _anchored(rng, n, affixes):
    """n affixes drawn from ``affixes``, a third of them with one
    substitution."""
    out = []
    for i in range(n):
        a = bytearray(affixes[rng.randint(len(affixes))].encode())
        if rng.rand() < 1 / 3:
            a[rng.randint(len(a))] = ord("ACGT"[rng.randint(4)])
        out.append(bytes(a))
    return out


def _anchored_reads(n: int, seed: int) -> bytes:
    """Reads of 30-80 random bases; 40% start with one of PREFIXES, 40%
    end with one of SUFFIXES (a third of those with a substitution,
    some cut short), and 10% carry N bases."""
    rng = np.random.RandomState(seed)
    seqs, lens = [], []
    heads = _anchored(rng, n, PREFIXES)
    tails = _anchored(rng, n, SUFFIXES)
    for i in range(n):
        s = "".join(rng.choice(list("ACGT"), rng.randint(30, 81))).encode()
        if rng.rand() < 0.4:
            s = heads[i][: rng.randint(8, len(heads[i]) + 1)] + s
        if rng.rand() < 0.4:
            s = s + tails[i][rng.randint(0, 6):]
        seqs.append(s)
        lens.append(len(s))
    width = max(lens)
    mat = np.zeros((n, width), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    quals = rng.randint(33 + 20, 33 + 41, (n, width)).astype(np.uint8)
    return fx.add_ns(
        fx.fastq_records(mat, np.array(lens), quals), 0.1, seed=seed
    )


@pytest.fixture(scope="module")
def reads():
    return fx.edit_reads(fx.make_reads(2000, 7, [fx.ADAPTER], polya=True), 8)


@pytest.fixture(scope="module")
def anchored_reads():
    return _anchored_reads(1500, 21)


@pytest.fixture(scope="module")
def amplicons():
    return fx.make_amplicons(600, seed=33)


def _run_both(jax_stages, port_stages, filters, data):
    """The same chunk through both engines; asserts equal windows,
    keep-mask, statistics and assembled bytes. Returns the port's
    statistics."""
    jax_engine = jbp.BatchPipelineEngine(
        jax_stages, [jbp.FilterSpec(k, t) for k, t in filters], **SIZES
    )
    port_engine = tbp.BatchPipelineEngine(
        port_stages, [tbp.FilterSpec(k, t) for k, t in filters], **SIZES,
        device="cpu",
    )
    jax_chunk = jax_parse(data)
    chunk = parse_fastq_chunk(data)
    jws, jwe, jkeep, jstats = jax_engine.process_parsed(jax_chunk)
    ws, we, keep, stats = port_engine.process_parsed(chunk)
    np.testing.assert_array_equal(ws, jws)
    np.testing.assert_array_equal(we, jwe)
    np.testing.assert_array_equal(keep, jkeep)
    fx.assert_same(stats, jstats)
    assert assemble_window(chunk, ws, we, keep) == jax_assemble(
        jax_chunk, jws, jwe, jkeep
    )
    return stats


HOST_STAGES = {
    "cut_front": lambda bp: bp.CutStage(5),
    "cut_back": lambda bp: bp.CutStage(-7),
    "quality_back": lambda bp: bp.QualityStage(0, 20),
    "quality_both": lambda bp: bp.QualityStage(15, 25),
    "nextseq": lambda bp: bp.NextseqStage(20),
    "poly_a": lambda bp: bp.PolyAStage(),
    "poly_t_revcomp": lambda bp: bp.PolyAStage(revcomp=True),
    "n_ends": lambda bp: bp.NEndStage(),
    "shorten": lambda bp: bp.ShortenStage(60),
    "shorten_negative": lambda bp: bp.ShortenStage(-60),
}


def _back_stage(bp, ad):
    return bp.AdapterStage([bp.AdapterTask(
        ad.BackAdapter(fx.ADAPTER, max_errors=0.1, min_overlap=3), "back", 0
    )])


@pytest.mark.parametrize("around", ["alone", "around_adapter"])
@pytest.mark.parametrize("name", sorted(HOST_STAGES))
def test_host_stage_matches_jax(reads, name, around):
    """One host stage alone, or before and after a 3' adapter stage (the
    kernel then sees windows that start past 0 or are empty, and the
    stage's statistics are keyed 0 and 2)."""
    make = HOST_STAGES[name]
    if around == "alone":
        jax_stages, port_stages = [make(jbp)], [make(tbp)]
    else:
        jax_stages = [make(jbp), _back_stage(jbp, jad), make(jbp)]
        port_stages = [make(tbp), _back_stage(tbp, tad), make(tbp)]
    runs = sum(align_cuda.PLAIN_RUNS.values())
    stats = _run_both(jax_stages, port_stages, [("too_short", 10)], reads)
    ran = sum(align_cuda.PLAIN_RUNS.values()) - runs
    assert (ran > 0) == (around == "around_adapter")
    if name.startswith(("quality", "nextseq")):
        expected = {0} if around == "alone" else {0, 2}
        assert set(stats["quality_trimmed"]) == expected
        assert all(v > 0 for v in stats["quality_trimmed"].values())
    if name.startswith("poly"):
        assert max(v.max() for v in stats["poly_a_removed"].values()) > 0


def test_quality_trims_reads_to_nothing(reads):
    """-q 20 before a 3' adapter leaves empty windows, whose rows the
    kernel gets with length 0, and windows that start past 0."""
    port_engine = tbp.BatchPipelineEngine(
        [tbp.QualityStage(20, 20)], device="cpu"
    )
    ws, we, _, _ = port_engine.process_parsed(parse_fastq_chunk(reads))
    assert (ws == we).sum() > 30
    assert (ws > 0).sum() > 100
    _run_both([jbp.QualityStage(20, 20), _back_stage(jbp, jad)],
              [tbp.QualityStage(20, 20), _back_stage(tbp, tad)], [], reads)


JAX = (jparser, jmod, jaccel, jbp)
PORT = fx.PORT_MODULES
LINKED_FRONT_BACK = f"{fx.PRIMER_515F}...{fx.PRIMER_806R_RC}"

# (id, data fixture, adapter specs, search parameters, action, times,
# filters, kinds of the port's tasks)
KIND_CASES = [
    ("prefix_cmp", "anchored_reads", [("front", "^" + PREFIXES[0])],
     dict(indels=False), "trim", 1, (), ["prefix_cmp"]),
    ("prefix_cmp_wildcards", "anchored_reads",
     [("front", "^GTACGGANTGTTCAGTA")],
     dict(indels=False, read_wildcards=True), "trim", 1, (),
     ["prefix_cmp"]),
    ("suffix_cmp", "anchored_reads", [("back", SUFFIXES[0] + "$")],
     dict(indels=False), "trim", 1, (("too_short", 20),), ["suffix_cmp"]),
    ("suffix_cmp_wildcards", "anchored_reads",
     [("back", "CGTGATTNTCTTGC$")],
     dict(indels=False, read_wildcards=True), "retain", 1, (),
     ["suffix_cmp"]),
    ("indexed_prefix", "anchored_reads",
     [("front", "^" + a) for a in PREFIXES], {}, "trim", 1, (),
     ["indexed_prefix"]),
    ("indexed_prefix_noindels", "anchored_reads",
     [("front", "^" + a) for a in PREFIXES], dict(indels=False), "trim", 1,
     (("discard_untrimmed", None),), ["indexed_prefix"]),
    ("indexed_suffix_and_back", "anchored_reads",
     [("back", a + "$") for a in SUFFIXES] + [("back", PREFIXES[1])],
     dict(indels=False), "trim", 2, (), ["back", "indexed_suffix"]),
    ("linked_front_required", "amplicons",
     [("back", fx.LINKED_PRIMERS)], {}, "trim", 1,
     (("discard_untrimmed", None),), ["linked"]),
    ("linked_both_required", "amplicons",
     [("front", LINKED_FRONT_BACK)], {}, "trim", 1, (), ["linked"]),
    ("linked_retain", "amplicons", [("back", fx.LINKED_PRIMERS)], {},
     "retain", 1, (), ["linked"]),
    ("linked_lowercase", "amplicons", [("back", fx.LINKED_PRIMERS)], {},
     "lowercase", 2, (), ["linked"]),
    ("linked_anchored_no_indels", "amplicons",
     [("back", f"^{fx.PRIMER_515F}...{fx.PRIMER_806R_RC}$")],
     dict(indels=False), "trim", 1, (), ["linked"]),
]


@pytest.mark.parametrize(
    "case", KIND_CASES, ids=[c[0] for c in KIND_CASES],
)
def test_adapter_kinds_match_jax(request, case):
    _, data_name, specs, params, action, times, filters, kinds = case
    data = request.getfixturevalue(data_name)
    jax_stage, _ = fx.cutter_stage(JAX, specs, action, times, **params)
    port_stage, tasks = fx.cutter_stage(PORT, specs, action, times, **params)
    assert [t.kind for t in tasks] == kinds
    stats = _run_both([jax_stage], [port_stage], filters, data)
    assert stats["with_adapters"] > 0
    events = stats["adapter_events"]
    if kinds == ["linked"]:
        suffixes = {ev["suffix"] for ev in events}
        assert suffixes == {";1", ";2"}
    for t_i, kind in enumerate(kinds):
        if kind.startswith("indexed"):
            # reads credited to each adapter of the index
            subs = np.concatenate(
                [ev["sub"] for ev in events if ev["task"] == t_i])
            assert set(np.unique(subs)) == {0, 1}


def test_linked_launches_both_phases(amplicons, monkeypatch):
    """A linked task launches the aligner in submit (the 5' phase, a
    PREFIX flag set) and on the engine's worker thread (the 3' phase,
    BACK, on the remainders), which close stops."""
    flags = []
    real = tbp.locate_packed
    monkeypatch.setattr(
        tbp, "locate_packed",
        lambda enc, lens, tables, pack2, **kw: flags.append(
            (tables.spec.flags, threading.current_thread().name))
        or real(enc, lens, tables, pack2, **kw),
    )
    stage, _ = fx.cutter_stage(PORT, [("back", fx.LINKED_PRIMERS)])
    before = set(threading.enumerate())
    engine = tbp.BatchPipelineEngine([stage], **SIZES, device="cpu")
    try:
        engine.collect(engine.submit(parse_fastq_chunk(amplicons)))
    finally:
        engine.close()
    here = threading.current_thread().name
    assert {f for f, name in flags if name == here} == {
        jad.Where.PREFIX.value}
    assert {f for f, name in flags if name != here} == {jad.Where.BACK.value}
    assert all(name.startswith("linked") for _, name in flags
               if name != here)
    assert not _linked_threads(before)


def _linked_threads(before) -> list:
    """The live linked workers that were not alive at ``before`` (a set
    of threads): those an engine of the test left running."""
    return [t for t in threading.enumerate()
            if t.name.startswith("linked") and t not in before]


# the configurations of chip_smoke.py's phases 6 and 7, at small scale
MAIN_CONFIGS = {
    "quality_polya": (
        ["-q", "20", "-a", fx.ADAPTER, "--poly-a", "-m", "10"],
        lambda: fx.make_reads(1500, 1, [fx.ADAPTER], polya=True),
    ),
    "linked_primers": (
        ["-a", fx.LINKED_PRIMERS, "--discard-untrimmed"],
        lambda: fx.make_amplicons(500, seed=34),
    ),
}
IGNORED_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


@pytest.mark.parametrize("config", sorted(MAIN_CONFIGS))
def test_main_matches_jax_cli(monkeypatch, tmp_path, config):
    """Through the port's main in require mode (no fallback, the aligner
    ran) and the JAX package's main: the same output file and the same
    JSON report, quality-trimmed and poly-A bases included."""
    args, make = MAIN_CONFIGS[config]
    inp = tmp_path / "in.fastq"
    inp.write_bytes(make())
    for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_BATCH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    got = {}
    fallbacks = taccel.FALLBACK_COUNT
    runs = sum(align_cuda.PLAIN_RUNS.values())
    for which, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        for module in (tad, jad):
            monkeypatch.setattr(module, "_adapter_counter", [0])
        out, rep = tmp_path / f"{which}.fastq", tmp_path / f"{which}.json"
        main(args + ["--quiet", "-o", str(out), "--json", str(rep),
                     str(inp)])
        report = json.loads(rep.read_text())
        for key in IGNORED_REPORT_KEYS:
            report.pop(key)
        got[which] = (out.read_bytes(), report)
    assert taccel.FALLBACK_COUNT == fallbacks
    assert sum(align_cuda.PLAIN_RUNS.values()) > runs
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    report = got["port"][1]
    assert report["read_counts"]["read1_with_adapter"] > 0
    if config == "quality_polya":
        assert report["basepair_counts"]["quality_trimmed"] > 0
        assert report["basepair_counts"]["poly_a_trimmed"] > 0


_IUPAC_COMPLEMENT = str.maketrans("ACGTRYKMSWBDHVN", "TGCAYRMKSWVHDBN")


def _revcomp(seq: str) -> str:
    return seq.translate(_IUPAC_COMPLEMENT)[::-1]


def _mates(data: bytes) -> bytes:
    """The reverse-complemented mates of FASTQ ``data``: same names,
    qualities reversed."""
    lines = data.decode().split("\n")
    out = []
    for i in range(0, len(lines) - 3, 4):
        out += [lines[i], _revcomp(lines[i + 1]), "+", lines[i + 3][::-1]]
    return ("\n".join(out) + "\n").encode()


FWD, REV = fx.PRIMER_515F, _revcomp(fx.PRIMER_806R_RC)
# -a and -A of linked primers over many chunks, 5' parts anchored or not
# (R1's anchored, R2's not where paired)
LINKED_CONFIGS = {
    "single_anchored": ["-a", f"^{FWD}...{_revcomp(REV)}",
                        "--discard-untrimmed"],
    "single_unanchored": ["-a", f"{FWD}...{_revcomp(REV)}"],
    "paired": ["-a", f"^{FWD}...{_revcomp(REV)}",
               "-A", f"{REV}...{_revcomp(FWD)}", "--discard-untrimmed"],
}


def _main_both(monkeypatch, tmp_path, args, inputs, env=()):
    """``args`` over ``inputs`` through the port's main (require mode, the
    environment ``env``) and the JAX package's: each one's output files
    and JSON report."""
    got = {}
    for which, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        with monkeypatch.context() as m:
            for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES",
                         "CUTADAPT_TPU_BATCH"):
                m.delenv(name, raising=False)
            m.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
            m.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
            for k, v in env:
                m.setenv(k, v)
            for module in (tad, jad):
                m.setattr(module, "_adapter_counter", [0])
            outs = [tmp_path / f"{which}.{i}.fastq"
                    for i in range(len(inputs))]
            rep = tmp_path / f"{which}.json"
            paired = ["-p", str(outs[1])] if len(outs) > 1 else []
            main(args + ["--quiet", "-o", str(outs[0]), *paired, "--json",
                         str(rep)] + [str(p) for p in inputs])
        report = json.loads(rep.read_text())
        for key in IGNORED_REPORT_KEYS:
            report.pop(key)
        got[which] = ([o.read_bytes() for o in outs], report)
    return got


@pytest.mark.parametrize("config", sorted(LINKED_CONFIGS))
def test_linked_over_many_chunks_matches_jax_cli(monkeypatch, tmp_path,
                                                 config):
    """Linked primers over six chunks, each chunk's 3' phase on the
    engine's worker while submit runs ahead, the threads switching often:
    the port's outputs and JSON report byte for byte the JAX package's;
    no fallback, the worker stopped when main returns."""
    before = set(threading.enumerate())
    data = fx.make_amplicons(150, seed=35)
    inputs = [tmp_path / "in.1.fastq"]
    inputs[0].write_bytes(data)
    if config.startswith("paired"):
        inputs.append(tmp_path / "in.2.fastq")
        inputs[1].write_bytes(_mates(data))
    fallbacks = taccel.FALLBACK_COUNT
    queued = []
    real = tbp.BatchPipelineEngine._resolve_queued
    monkeypatch.setattr(
        tbp.BatchPipelineEngine, "_resolve_queued",
        lambda self, *a: queued.append(threading.current_thread().name)
        or real(self, *a))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _main_both(monkeypatch, tmp_path, LINKED_CONFIGS[config],
                         inputs,
                         env=[("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "16000")])
    finally:
        sys.setswitchinterval(interval)
    assert taccel.FALLBACK_COUNT == fallbacks
    # one 3' phase per chunk and engine, each on a worker
    assert len(queued) == 6 * len(inputs)
    assert all(name.startswith("linked") for name in queued)
    assert got["port"] == got["jax"]
    report = got["port"][1]
    assert report["read_counts"]["read1_with_adapter"] > 0
    if config.startswith("paired"):
        assert report["read_counts"]["read2_with_adapter"] > 0
    assert not _linked_threads(before)


def test_linked_worker_failure_leaves_main(monkeypatch, tmp_path):
    """An exception in a 3' phase on the linked worker comes out of the
    port's main, and the worker is stopped."""
    inp = tmp_path / "in.fastq"
    inp.write_bytes(fx.make_amplicons(150, seed=36))
    before = set(threading.enumerate())
    real = tbp.BatchPipelineEngine._resolve_linked
    failed = []

    def failing(self, *args):
        if threading.current_thread().name.startswith("linked"):
            failed.append(True)
            raise RuntimeError("3' phase failed")
        return real(self, *args)

    monkeypatch.setattr(tbp.BatchPipelineEngine, "_resolve_linked", failing)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "16000")
    with pytest.raises(RuntimeError, match="3' phase failed"):
        port_cli.main(["--quiet", "-a", fx.LINKED_PRIMERS,
                       "--discard-untrimmed", "-o",
                       str(tmp_path / "out.fastq"), str(inp)])
    assert failed and not _linked_threads(before)
