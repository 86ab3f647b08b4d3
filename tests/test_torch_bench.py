"""
The port's measurement programs on the CPU: bench_torch.py (the
counterpart of bench.py), bench_configs_torch.py (of bench_configs.py),
tools/verify_cuda_torch.py (of tools/verify_pallas_tpu.py) and
tools/gen_cli_reference_torch.py (of tools/gen_cli_reference.py), held
to the JAX package's programs where both make the same thing: the same
datasets byte for byte, the same parity specs, the same reference
document, the same output files. The aligner's bound
(ops/align_cuda.py:dp_work, bound_of) against a direct count. Their
device figures come only from runs on the card (chip_smoke.py phase 17).
"""

import importlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_fixtures as fx
from cutadapt_tpu_torch.ops import align_cuda
from cutadapt_tpu_torch.ops.align_batch import query_class_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# a CPU rehearsal of bench_torch.py: small, one torch thread
CPU_ENV = {"BENCH_READS": "4096", "BENCH_BASELINE_READS": "512",
           "OMP_NUM_THREADS": "1"}
# bench_torch.py's JSON keys: bench.py's, with kernel_parity for
# pallas_parity and link_* for tunnel_* and without pack2 (a switch the
# port does not have), then the port's own
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "vs_8core_equiv",
    "kernel_parity", "backend", "device", "power_limit_w", "n_reads",
    "parity_reads", "host_baseline_reads_per_sec", "cold_reads_per_sec",
    "best_reads_per_sec", "steady_passes", "n_passes", "link_pre",
    "link_post", "device_kernel", "x_bound", "idle_share", "profiler",
    "pipelined_pass", "assemble_micro_ns_per_read", "cli_reads_per_sec",
    "cli_best_reads_per_sec", "chunks_in_flight_max", "pooled_drive",
    "bytes_per_read_h2d", "bytes_per_read_d2h",
    "candidates_per_read", "dp_rows_per_read", "stage_ns_per_read",
    "sequential_reads_per_sec", "roofline",
}
DEVICE_FIELDS = ("device_kernel", "link_pre", "link_post", "idle_share",
                 "x_bound", "profiler", "roofline", "power_limit_w")
# what a fresh interpreter must not have loaded after a run
LEAK_CHECK = (
    "bad = sorted(m for m in sys.modules if m == 'jax'\n"
    "             or m.startswith('jax.') or m == 'cutadapt_tpu'\n"
    "             or m.startswith('cutadapt_tpu.')\n"
    "             or m in ('torch_fixtures', 'torch_as_jax'))\n"
    "print('LEAKED', bad, file=sys.stderr)\n"
    "sys.exit(1 if bad else rc)\n"
)


def _fresh(code, env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUTADAPT_TPU", "BENCH_"))}
    env.update(env_extra)
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def _run_script(path, args, cuda_available=None):
    """Run the script at ``path`` as __main__ in a fresh interpreter and
    report its exit code after the leak check; with cuda_available
    False, torch.cuda.is_available() answers False there."""
    patch = ("import torch\ntorch.cuda.is_available = lambda: False\n"
             if cuda_available is False else "")
    return (
        "import runpy, sys\n" + patch
        + f"sys.argv = [{path!r}] + {list(args)!r}\n"
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_path({path!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
    ) + LEAK_CHECK


@pytest.fixture
def bench_configs_jax(monkeypatch):
    """bench_configs.py imported with an argv of its own (it reads
    sys.argv[1] as its read count at import)."""
    monkeypatch.setattr(sys, "argv", ["bench_configs.py"])
    return importlib.import_module("bench_configs")


@pytest.mark.parametrize("n", [1, 777, 3000])
def test_make_dataset_is_bench_py_s(n):
    import bench
    import bench_torch

    assert bench_torch.make_dataset(n, 100) == bench.make_dataset(n, 100)


@pytest.mark.parametrize("per_chunk", [1, 500, 4096])
def test_split_records_agrees_with_bench_py(per_chunk):
    import bench
    import bench_torch

    data = bench.make_dataset(2000, 100)
    assert bench_torch.split_records(data, per_chunk) == \
        bench.split_records(data, per_chunk)


@pytest.mark.parametrize("case", ["single_and_r1", "r2", "polya"])
def test_make_reads_is_bench_configs_py_s(bench_configs_jax, case):
    """The reads of each configuration: seed 1 with the 3' adapter (the
    single-end configurations and R1), seed 2 with R2's, seed 1 with
    poly-A tails."""
    import bench_configs_torch as bct

    seed, adapters, polya = {
        "single_and_r1": (1, [bct.A3], False),
        "r2": (2, [bct.A3_R2], False), "polya": (1, [bct.A3], True),
    }[case]
    assert bct.make_reads(1500, seed, adapters, polya=polya) == \
        bench_configs_jax.make_reads(1500, seed, adapters, polya=polya)
    for name in ("A3", "A5", "AW", "A3_R2", "READ_LEN"):
        assert getattr(bct, name) == getattr(bench_configs_jax, name)


def test_bench_torch_cpu_rehearsal():
    """bench_torch.py --device cpu at 4,096 reads in a fresh interpreter:
    exit 0, the last line one JSON object with the agreed keys, device
    "cpu" and every device field null; no JAX and nothing of the JAX
    package or of tests/ loaded."""
    r = _fresh(_run_script("bench_torch.py", ["--device", "cpu"]), CPU_ENV)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "LEAKED []" in r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "reads_per_sec_se_3p_adapter_trim"
    assert out["unit"] == "reads/s" and out["value"] > 0
    assert out["device"] == "cpu" and out["backend"] == "cpu"
    for key in DEVICE_FIELDS:
        assert out[key] is None, key
    assert out["kernel_parity"] == "skipped"
    assert out["n_reads"] == 4096 and out["parity_reads"] == 512
    assert out["n_passes"] >= 3 and len(out["steady_passes"]) >= 3
    assert set(out["stage_ns_per_read"]) == {"parse", "dispatch", "collect",
                                             "assemble"}
    # a quarter of the reads carry the adapter: about 0.3 candidates/read
    assert 0.2 < out["candidates_per_read"] < 0.4
    assert out["pooled_drive"]["drive"] == "pipelined"
    assert out["pooled_drive"]["workers2"]["reads_per_sec"] > 0
    assert out["cli_reads_per_sec"] > 0
    # on the CPU no kernel launches and no time is taken
    passed = out["pipelined_pass"]
    assert passed["launches"] == {"pack2": 0, "pack4": 0, "byte": 0}
    assert passed["per_shape"] and all(
        d["ms"] is None and d["bound_ms"] is None
        for d in passed["per_shape"])
    assert "parity OK on 512 reads" in r.stderr


def test_bench_torch_without_a_card_reports_nothing():
    """Without a card and without --device cpu it exits non-zero and
    prints no reads/s: there is no fallback to the CPU."""
    r = _fresh(_run_script("bench_torch.py", [], cuda_available=False),
               CPU_ENV)
    assert r.returncode != 0
    assert "metric" not in r.stdout and "reads/s" not in r.stdout
    assert "is_available() is False" in r.stderr


def test_bench_torch_exits_1_on_a_parity_difference(monkeypatch, capsys):
    """A difference between the engine's assembled output and the host
    path's on the subset exits 1 before any reads/s is reported."""
    import bench_torch
    from cutadapt_tpu_torch.io import chunks

    real = chunks.assemble_window

    def flipped(*args, **kwargs):
        out = bytearray(real(*args, **kwargs))
        out[5] ^= 0x20  # a byte of the first read's sequence
        return bytes(out)

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(chunks, "assemble_window", flipped)
    monkeypatch.setattr(bench_torch, "N_READS", 1024)
    monkeypatch.setattr(bench_torch, "SUBSET", 256)
    with fx.one_torch_thread(), pytest.raises(SystemExit) as e:
        bench_torch.main(["--device", "cpu"])
    assert e.value.code == 1
    captured = capsys.readouterr()
    assert "differs from host engine" in captured.err
    assert "metric" not in captured.out


def test_bench_configs_cpu_parity_equals_the_jax_cli(monkeypatch, tmp_path,
                                                      capsys):
    """bench_configs_torch.py at 2,000 reads on the CPU: every
    configuration reports parity, and each output file of the engine
    (the demultiplexed files too) equals what cutadapt_tpu.cli.main
    writes for the same arguments and input on its host path."""
    import bench_configs_torch as bct
    from cutadapt_tpu.cli import main as jax_main

    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    with fx.one_torch_thread():
        rc = bct.main(["2000", "--work-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert line["device"] == "cpu" and line["n_reads"] == 2000
    assert line["parity"] is True
    assert [c["name"] for c in line["configs"]] == [
        name for name, _, _ in bct.configs()] + [bct.DEMUX_NAME]
    assert all(c["parity"] and c["host"] > 0 and c["engine"] > 0
               for c in line["configs"])
    assert [c["unit"] for c in line["configs"]] == [
        "reads/s", "reads/s", "pairs/s", "reads/s", "reads/s"]
    assert sum("parity OK" in ln for ln in out[:-1]) == 5

    monkeypatch.setenv("CUTADAPT_TPU_BATCH", "0")
    compared = 0
    for i, (name, args_fn, paired) in enumerate(bct.configs()):
        d = tmp_path / f"c{i}"
        inputs = ([str(d / "r1.fastq"), str(d / "r2.fastq")] if paired
                  else [str(d / "in.fastq")])
        jax_main(["--quiet"] + args_fn(str(d), "jax") + inputs)
        logging.root.handlers.clear()
        for side in ("out", "out2")[: 1 + paired]:
            assert (d / f"{side}-jax.fastq").read_bytes() == \
                (d / f"{side}-engine.fastq").read_bytes(), (name, side)
            compared += 1
    d = tmp_path / "demux"
    (d / "jax").mkdir()
    jax_main(["--quiet"] + bct.demux_args(str(d), "jax")
             + [str(d / "in.fastq")])
    logging.root.handlers.clear()
    names = sorted(os.listdir(d / "jax"))
    assert names == sorted(os.listdir(d / "engine")) and len(names) > 2
    for f in names:
        assert (d / "jax" / f).read_bytes() == (d / "engine" / f).read_bytes()
        compared += 1
    assert compared == 5 + len(names)


def test_verify_parity_cases_are_the_jax_tool_s():
    sys.path.insert(0, TOOLS)
    try:
        import verify_cuda_torch
        import verify_pallas_tpu
    finally:
        sys.path.remove(TOOLS)

    def plain(cases):
        return [(ref, wc, flags.name, flags.value, rate, ic, mo)
                for ref, wc, flags, rate, ic, mo in cases]

    assert plain(verify_cuda_torch.parity_cases()) == \
        plain(verify_pallas_tpu.parity_cases())


def test_verify_cpu_run_has_no_failures():
    """The tool's CPU run (the plain version, which the wrapper runs for
    CPU tensors, against the scalar aligner) at 64 reads per spec."""
    sys.path.insert(0, TOOLS)
    try:
        import verify_cuda_torch
    finally:
        sys.path.remove(TOOLS)
    with fx.one_torch_thread():
        assert verify_cuda_torch.run(block_b=64, verbose=False,
                                     device="cpu") == []


def test_gen_cli_reference_torch_renders_the_committed_doc():
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "gen_cli_reference_torch.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(REPO, "docs", "reference.md")) as f:
        assert r.stdout == f.read()


def _flagship_batch(n=4096):
    raw, lens = fx.flagship_rows(n)
    tables = align_cuda.make_tables(
        fx.make_engine(device="cpu").stages[-1].tasks[0].spec)
    return raw, fx.encode_rows(tables.spec, raw, True), lens, tables


def test_dp_work_counts_a_fixed_flagship_batch_directly():
    """align_cuda.dp_work on 16 flagship reads (lengths cut to 0-100)
    equals a direct count, column by column, of their active columns,
    cells and cells whose class matches the row; bound_of is the larger
    of those operations at the int32 rate and the bytes at the memory
    rate."""
    raw, enc, lens, tables = _flagship_batch(16)
    lens = np.array([0, 1, 2, 3, 20, 35, 36, 37, 50, 64, 70, 90, 97, 98, 99,
                     100], np.int32)
    spec, m, k = tables.spec, tables.m, tables.k
    cls_lut, row_masks = query_class_info(spec)
    cols = eq = 0
    for r, n in enumerate(lens):
        max_n = n if spec.start_in_query else min(n, m + k)
        min_n = 0 if spec.stop_in_query else max(0, n - m - k)
        for j in range(min_n + 1, min(max_n, 100) + 1):
            cols += 1
            c = int(cls_lut[raw[r, j - 1]])
            eq += sum(int(rm >> c) & 1 for rm in row_masks)
    ops = (cols * align_cuda.OPS_PER_COLUMN + cols * m * align_cuda.OPS_PER_CELL
           + (cols * m - eq) * align_cuda.OPS_PER_MISMATCH)
    assert align_cuda.dp_work(enc, lens, tables, True) == (cols, cols * m, eq,
                                                            ops)
    ms, by, work = align_cuda.bound_of(enc, lens, tables, True, 1.5e9, 100)
    ops_s = ops / (100 * align_cuda.INT32_LANES_PER_SM * 1.5e9)
    nbytes = enc.size + 4 * 16 + 4 * len(tables.table) + 8 * 16
    assert ms == pytest.approx(max(ops_s, nbytes / 3.35e12) * 1e3, rel=1e-12)
    assert by == "operations" and work[3] == ops


def test_bound_of_gives_chip_smoke_s_figures_on_a_flagship_batch():
    """The moved bound_of on 4,096 flagship reads (4,096 x 25 B, the
    2-bit lane) at 132 SMs and 1980 MHz gives what chip_smoke.py's
    bound_of gave before the move."""
    _, enc, lens, tables = _flagship_batch()
    assert enc.shape == (4096, 25)
    ms, by, work = align_cuda.bound_of(enc, lens, tables, True, 1980e6, 132)
    assert (by, work) == ("operations", (409600, 13516800, 3398563,
                                         406987496))
    assert ms == pytest.approx(0.024331112737220693, rel=1e-12)
