"""
The port's measurement tools (tools/*_torch.py) run to the end on the
CPU at a tiny size (``--device cpu``: the plain aligner, the host
clock), exit 0 and print their numbers as a parseable JSON line. Their
device numbers come only from runs on the card (chip_smoke.py phase 15).
"""

import json
import os
import random
import subprocess
import sys

import pytest

import torch_fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, *args):
    """Run tools/<name>.py with ``args`` in a fresh interpreter on one
    torch thread; returns the JSON object of its ``<name> {...}`` line."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CUTADAPT_TPU")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{name}.py"), *args],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines()[::-1]
                if ln.startswith(name + " {"))
    return json.loads(line.split(" ", 1)[1]), r


def test_fuzz_parity_runs_without_mismatch():
    out, r = _tool("fuzz_parity_torch", "3", "2000", "--device", "cpu")
    assert out["iterations"] == 3 and out["mismatches"] == 0
    assert "done: 3 iterations, 0 mismatches" in r.stdout


def test_profile_batch_splits_submit():
    out, _ = _tool("profile_batch_torch", "--reads", "1000",
                   "--device", "cpu")
    assert out["reads"] == 1000 and out["device"] == "cpu"
    assert set(out["stage_ms"]) == {"parse", "submit", "collect", "assemble"}
    split = out["submit_split_ms"]
    for part in ("kmer_prefilter", "windows_clean", "pad_encode",
                 "pinned allocations", "upload", "launch", "copy back",
                 "rest"):
        assert part in split
    assert split["launch"] > 0 and split["kmer_prefilter"] > 0
    # the parts sum to submit's time
    assert sum(split.values()) == pytest.approx(out["stage_ms"]["submit"])
    assert out["pipelined_reads_per_sec"] > 0
    # the profiled pass: on the CPU it records no device time
    assert out["profiler"]["seconds"] > 0
    assert out["profiler"]["device_ms"] == 0
    assert out["profiler"]["kernel_ms"] == 0
    assert out["profiler"]["by_name"] == []


def test_profile_xfer_times_every_size():
    out, _ = _tool("profile_xfer_torch", "--max-bytes", str(1 << 16),
                   "--reps", "2", "--device", "cpu")
    assert [c["bytes"] for c in out["copies"]] == [1 << 10, 1 << 16]
    assert all(c["h2d_ms"] > 0 and c["d2h_ms"] > 0 for c in out["copies"])
    assert out["result_fetch_round_trip_ms"] > 0


def test_kernel_bench_takes_the_engines_lane_and_width():
    out, _ = _tool("kernel_bench_torch", "256", "2", "2", "--device", "cpu")
    # the flagship task's 2-bit lane at the engine's CPU width (128
    # columns, 4 per byte), not fixed in the tool
    assert out["lane"] == "pack2" and out["row_bytes"] == 32
    assert len(out["passes"]) == 2
    assert all(p["rows_per_sec"] > 0 for p in out["passes"])


def test_fuzz_parity_draws_the_dispatch_modes(monkeypatch):
    """A seed that draws the JAX tool's DEVICE_PREFILTER=1 runs the
    port's device-side prefilter on the engine run (and never on the
    host run), with the SHARED_UPLOAD of the tool's second generator."""
    import importlib.util

    import cutadapt_tpu_torch.batch_pipeline as bp

    spec = importlib.util.spec_from_file_location(
        "fuzz_parity_torch", os.path.join(REPO, "tools",
                                          "fuzz_parity_torch.py"))
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    seed = next(s for s in range(2000, 2100)
                if fuzz.draw(s)[4]["CUTADAPT_TPU_TORCH_DEVICE_PREFILTER"]
                == "1")
    knobs = fuzz.draw(seed)[4]
    # the JAX tool's draws, in its order (tools/fuzz_parity.py:158-167),
    # leave its generator where this tool's is left
    rng = random.Random(seed)
    if rng.random() < 0.45:
        rng.random()
    rng.random()
    for choices in (["0", "1"], ["0", "1"], ["1", "2", "3"], ["0", "1"],
                    ["0", "0", "1"], ["", "3000", "12000"]):
        rng.choice(choices)
    assert fuzz.draw(seed)[0].getstate() == rng.getstate()
    seen = []
    real = bp._device_prefilter_on

    def spy():
        seen.append((os.environ.get("CUTADAPT_TPU_TORCH_BATCH"),
                     os.environ.get("CUTADAPT_TPU_TORCH_SHARED_UPLOAD")))
        return real()

    monkeypatch.setattr(bp, "_device_prefilter_on", spy)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    for key in fuzz.KNOBS + ("CUTADAPT_TPU_TORCH_BATCH",):
        monkeypatch.delenv(key, raising=False)
    with fx.one_torch_thread():
        assert fuzz.main_fuzz(["1", str(seed), "--device", "cpu"]) == 0
    assert seen and set(seen) == {
        ("1", knobs["CUTADAPT_TPU_TORCH_SHARED_UPLOAD"])}
