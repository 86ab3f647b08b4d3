"""
The paired-end pieces of the port's engine against the JAX package's,
on the CPU (the aligner's plain PyTorch version):

- the ``pe_*`` configurations of ``tests/test_accel.py`` through the
  port's main in require mode and through the JAX package's main: the
  same output files and the same ``--json`` report;
- ``accel._pair_match`` (--pair-adapters) and ``accel._run_rc_pair``
  (paired --revcomp) on the same numpy-made chunks: windows, matched
  masks, winning ids, slot bytes and the modifiers' statistics.

Tolerance: exact.
"""

import json
import os

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

IGNORED_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


@pytest.fixture(autouse=True)
def port_env(monkeypatch):
    with fx.one_torch_thread():
        for name in ("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_BATCH"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("CUTADAPT_TPU_TORCH_BATCH", "require")
        yield monkeypatch


PE_CONFIGS = ["pe_basic", "pe_pair_adapters", "pe_revcomp", "pe_poly_a",
              "pe_revcomp_one_sided"]


@pytest.mark.parametrize("name", PE_CONFIGS)
def test_pe_config_matches_jax_cli(port_env, tmp_path, name):
    """tests/test_accel.py's paired configurations through the port's
    engine and the JAX package's CLI: the same files and --json report."""
    args, paired = fx.accel_configs()[name]
    assert paired
    inputs = fx.accel_reads(tmp_path / "in.fastq", n=400, paired=True)
    got = {}
    for which, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        for module in (tad, jad):
            port_env.setattr(module, "_adapter_counter", [0])
        o1, o2 = tmp_path / f"{which}.1.fastq", tmp_path / f"{which}.2.fastq"
        rep = tmp_path / f"{which}.json"
        argv = ["--quiet", "--json", str(rep)] + list(args)
        argv += ["-o", str(o1), "-p", str(o2)] + [str(p) for p in inputs]
        fallbacks = taccel.FALLBACK_COUNT
        runs = sum(align_cuda.PLAIN_RUNS.values())
        main(argv)
        if which == "port":
            assert taccel.FALLBACK_COUNT == fallbacks
            assert sum(align_cuda.PLAIN_RUNS.values()) > runs
        report = json.loads(rep.read_text())
        for key in IGNORED_REPORT_KEYS:
            report.pop(key)
        got[which] = (o1.read_bytes(), o2.read_bytes(), report)
    assert got["port"] == got["jax"]
    counts = got["port"][2]["read_counts"]
    assert counts["read1_with_adapter"] or counts["read2_with_adapter"]
    if "revcomp" in name:
        assert counts["reverse_complemented"] > 0


# --- the pair helpers against the JAX package's ----------------------------

JAX = (jparser, jmod, jaccel, jbp)
PORT = fx.PORT_MODULES
SIZES = dict(min_dp_batch=256, max_dp_batch=1024)
SEARCH = dict(max_errors=0.1, min_overlap=3, read_wildcards=False,
              adapter_wildcards=True, indels=True)


def _stats_dict(astats):
    """An AdapterStatistics as plain values."""
    def end(e):
        if e is None:
            return None
        return ({k: dict(v) for k, v in e.errors.items()},
                dict(e.adjacent_bases))

    return (astats.name, astats.kind, astats.reverse_complemented,
            end(astats.front), end(astats.back))


def _pairs(n, seed, swap_share=0.0):
    """make_pairs chunks with N reads, parsed by both packages; a seeded
    ``swap_share`` of the pairs has R1 and R2 exchanged (as the paired
    --revcomp must detect). Returns ((jax1, jax2), (port1, port2))."""
    r1, r2 = fx.make_pairs(n, seed)
    if swap_share:
        rec1, rec2 = r1.split(b"\n")[:-1], r2.split(b"\n")[:-1]
        swap = np.random.RandomState(seed).rand(n) < swap_share
        for i in np.flatnonzero(swap):
            for k in (1, 3):
                rec1[4 * i + k], rec2[4 * i + k] = (rec2[4 * i + k],
                                                    rec1[4 * i + k])
        r1, r2 = b"\n".join(rec1) + b"\n", b"\n".join(rec2) + b"\n"
    return ((jax_parse(r1), jax_parse(r2)),
            (parse_fastq_chunk(r1), parse_fastq_chunk(r2)))


def _windows(chunks, seed):
    """Windows that start past 0 and end before the read end."""
    rng = np.random.RandomState(seed)
    out = []
    for c in chunks:
        ws = rng.randint(0, 4, c.n_records).astype(np.int32)
        we = np.maximum(ws, c.seq_len.astype(np.int32)
                        - rng.randint(0, 12, c.n_records)).astype(np.int32)
        out.append((ws, we))
    return out


def _pair_stage(pkg, specs1, specs2, action="trim"):
    pkg_parser, pkg_modifiers, _, pkg_bp = pkg
    ad1 = pkg_parser.make_adapters_from_specifications(specs1, SEARCH)
    ad2 = pkg_parser.make_adapters_from_specifications(specs2, SEARCH)
    mod = pkg_modifiers.PairedAdapterCutter(ad1, ad2, action=action)
    tasks = [[pkg_bp.AdapterTask(a, pkg_bp.adapter_kind(a), i)
              for i, a in enumerate(ads)] for ads in (ad1, ad2)]
    return tasks[0], tasks[1], mod


def _engines(bp, **kw):
    return tuple(bp.BatchPipelineEngine([], **SIZES, **kw) for _ in (1, 2))


@pytest.fixture
def adapter_names(monkeypatch):
    """Unnamed adapters are numbered per process: restart both packages'
    counters so that the statistics carry the same names."""
    for module in (tad, jad):
        monkeypatch.setattr(module, "_adapter_counter", [0])
    return lambda: [module._adapter_counter.__setitem__(0, 0)
                    for module in (tad, jad)]


@pytest.mark.parametrize("action", ["trim", "retain"])
def test_pair_match_matches_jax(adapter_names, action):
    """--pair-adapters over two adapter pairs (the second a prefix of the
    first, so that scores tie and the errors or the pair order decide)."""
    jchunks, chunks = _pairs(800, 5)
    specs1 = [("back", fx.TRUSEQ_R1), ("back", fx.TRUSEQ_R1[:20])]
    specs2 = [("back", fx.TRUSEQ_R2), ("back", fx.TRUSEQ_R2[:20])]
    out = {}
    for name, pkg, pkg_accel, bp, cks, kw in (
        ("jax", JAX, jaccel, jbp, jchunks, {}),
        ("port", PORT, taccel, tbp, chunks, dict(device="cpu")),
    ):
        adapter_names()
        stage = _pair_stage(pkg, specs1, specs2, action)
        windows = _windows(cks, 6)
        stats = ({}, {})
        matched = pkg_accel._pair_match(_engines(bp, **kw), cks, windows,
                                        stage, stats_pair=stats)
        mod = stage[2]
        out[name] = dict(
            matched=matched, windows=windows,
            gid=[s["last_adapter_gid"] for s in stats],
            with_adapters=mod.with_adapters,
            statistics=[[_stats_dict(s) for s in side.values()]
                        for side in mod.adapter_statistics],
        )
    fx.assert_same(out["port"], out["jax"])
    gid = out["port"]["gid"][0]
    assert out["port"]["with_adapters"] > 150 and (gid == 1).any()


@pytest.mark.parametrize("action", ["trim", "lowercase"])
@pytest.mark.parametrize("sides", ["both", "r1_only"])
def test_run_rc_pair_matches_jax(adapter_names, action, sides):
    """Paired --revcomp on pairs of which a third have R1 and R2 swapped:
    the slot chunks' bytes, windows, matched masks, winning ids,
    remainders and the modifiers' statistics equal the JAX package's."""
    jchunks, chunks = _pairs(600, 8, swap_share=1 / 3)
    out = {}
    for name, pkg, pkg_accel, bp, asm, cks, kw in (
        ("jax", JAX, jaccel, jbp, jax_assemble, jchunks, {}),
        ("port", PORT, taccel, tbp, assemble_window, chunks,
         dict(device="cpu")),
    ):
        adapter_names()
        st1 = fx.cutter_stage(pkg, [("back", fx.TRUSEQ_R1)], action)[0]
        st2 = (fx.cutter_stage(pkg, [("back", fx.TRUSEQ_R2)], action)[0]
               if sides == "both" else None)
        mod = pkg[1].PairedReverseComplementer(
            st1.modifier, st2.modifier if st2 else None, rc_suffix=" rc")
        res = pkg_accel._run_rc_pair(_engines(bp, **kw), (st1, st2, mod),
                                     cks, _windows(cks, 9))
        slots, windows, matched = res[:2], res[2:6], res[6:8]
        gids = (res[8][0], res[9][0])
        rc_action, rem1, rem2 = res[10]
        keep = np.ones(slots[0].n_records, bool)
        out[name] = dict(
            bytes=[asm(slot, windows[2 * i], windows[2 * i + 1], keep)
                   for i, slot in enumerate(slots)],
            windows=list(windows), matched=list(matched), gids=list(gids),
            geometry=[res[8][1], res[9][1]],
            action=rc_action, remainders=[rem1, rem2],
            reverse_complemented=mod.reverse_complemented,
            cutters=[(s.modifier.with_adapters,
                      [_stats_dict(a) for a in
                       s.modifier.adapter_statistics.values()])
                     for s in (st1, st2) if s is not None],
        )
    fx.assert_same(out["port"], out["jax"])
    assert 100 < out["port"]["reverse_complemented"] < 300
