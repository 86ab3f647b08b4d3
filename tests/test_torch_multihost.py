"""
The port's input sharding over several processes
(``cutadapt_tpu_torch/parallel/multihost.py``, ``--shard``, the
statistics pickle, ``tools/multihost_run_torch.py`` and the opt-in
process group) against the JAX package's:

- every test of tests/test_multihost.py, with the port's variable
  names (``CUTADAPT_TPU_TORCH_BYTE_RANGE``, ``_STATS_PICKLE``,
  ``_DIST_*``), the engine on the CPU (the plain aligner) where the JAX
  test ran its engine;
- the same plans as the JAX package's ``plan_shards``,
  ``plan_paired_shards`` and ``plan_bam_shards`` on the same files;
- each shard's output byte-identical to ``cutadapt_tpu.cli.main --shard
  i/3`` on the same argv (FASTQ, FASTA, paired, interleaved, BAM), and
  the merged text and --json reports equal to the JAX package's merged
  reports (both packages' pickles are loaded by their own
  ``merge_statistics``; reports are compared rendered, never as
  pickles, whose classes name each package);
- the JAX package's ``CUTADAPT_TPU_BYTE_RANGE`` leaves the port alone;
- a two-process gloo group of two ``--shard i/2`` processes, and a
  pickle of a run with the statistics reducer on 8 CPU shards that
  holds no torch object and merges to the one-device report.

Tolerance everywhere: exact.
"""

import gzip
import json
import logging
import os
import pickle
import random
import socket
import subprocess
import sys

import pytest

from cutadapt_tpu import adapters as jax_adapters
from cutadapt_tpu import cli as jax_cli
from cutadapt_tpu import report as jax_report
from cutadapt_tpu.parallel import multihost as jax_multihost
from cutadapt_tpu_torch import accel, cli
from cutadapt_tpu_torch import adapters as port_adapters
from cutadapt_tpu_torch import report as port_report
from cutadapt_tpu_torch.parallel import multihost
from cutadapt_tpu_torch.parallel.multihost import (
    merge_statistics,
    plan_paired_shards,
    plan_shards,
)
from torch_fixtures import load_host_pickle, one_torch_thread
from utils import datapath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = "AGATCGGAAGAGCACACGTC"
ADAPTER2 = "CTGTCTCTTATACACATCT"
PORT_ENV = (
    "CUTADAPT_TPU_TORCH_BATCH", "CUTADAPT_TPU_TORCH_DEVICE",
    "CUTADAPT_TPU_TORCH_CHUNK_BYTES", "CUTADAPT_TPU_TORCH_DEVICES",
    "CUTADAPT_TPU_TORCH_DEVICE_STATS", "CUTADAPT_TPU_TORCH_BYTE_RANGE",
    "CUTADAPT_TPU_TORCH_STATS_PICKLE", "CUTADAPT_TPU_TORCH_DIST_COORDINATOR",
    "CUTADAPT_TPU_TORCH_DIST_NPROCS", "CUTADAPT_TPU_TORCH_DIST_PID",
    "CUTADAPT_TPU_BATCH", "CUTADAPT_TPU_BYTE_RANGE",
    "CUTADAPT_TPU_STATS_PICKLE",
)
# report keys that name the program, its caller or the interpreter
VOLATILE_REPORT_KEYS = (
    "cutadapt_version", "command_line_arguments", "python_version",
)


@pytest.fixture(autouse=True)
def port_env(monkeypatch):
    """The port on the CPU (the plain aligner), one torch thread, no
    variable of either package's left over."""
    for name in PORT_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CUTADAPT_TPU_TORCH_DEVICE", "cpu")
    with one_torch_thread():
        yield monkeypatch


def _write_fastq(path, n, rng, adapter):
    with open(path, "w") as f:
        for i in range(n):
            L = rng.randint(8, 90)
            s = "".join(rng.choice("ACGT") for _ in range(L))
            if rng.random() < 0.5 and L > 25:
                p = rng.randint(0, L - 20)
                s = (s[:p] + adapter + s[p:])[:L]
            q = "".join(chr(rng.randint(35, 72)) for _ in s)
            f.write(f"@r{i} c\n{s}\n+\n{q}\n")


def _write_fasta(path, n, rng):
    with open(path, "w") as f:
        for i in range(n):
            L = rng.randint(5, 80)
            s = "".join(rng.choice("ACGT") for _ in range(L))
            if rng.random() < 0.5 and L > 25:
                p = rng.randint(0, L - 20)
                s = (s[:p] + ADAPTER + s[p:])[:L]
            if rng.random() < 0.4:  # multi-line records
                s = s[:5] + "\n" + s[5:]
            f.write(f">r{i}\n{s}\n")


def _write_interleaved(path, n, rng):
    with open(path, "w") as f:
        for i in range(n):
            for side, ad in ((1, ADAPTER), (2, ADAPTER2)):
                L = rng.randint(20, 60)
                s = "".join(rng.choice("ACGT") for _ in range(L))
                if rng.random() < 0.5:
                    p = rng.randint(0, L - 15)
                    s = (s[:p] + ad + s[p:])[:L]
                f.write(f"@p{i}/{side}\n{s}\n+\n{'I' * L}\n")


def _write_raw_bam(path):
    with open(path, "wb") as f:
        f.write(gzip.open(datapath("small.bam"), "rb").read())


def _run(main, argv, env=None):
    """One call of a package's main under ``env``, restored after."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    handlers = list(logging.root.handlers)
    os.environ.update(env)
    for module in (port_adapters, jax_adapters):
        module._adapter_counter = [0]
    try:
        return main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # drop the handlers main added; keep pytest's
        logging.root.handlers[:] = handlers


def _port(argv, env=None, batch="require"):
    """The port's main, on the engine unless ``batch`` says otherwise."""
    return _run(cli.main, argv,
                {"CUTADAPT_TPU_TORCH_BATCH": batch, **(env or {})})


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _json(package_cli, stats, paired):
    """The --json report a package's CLI writes for ``stats``, without
    the keys that name the program or the interpreter."""
    d = package_cli.json_report(stats, ["-"], "in", "in2" if paired else None,
                                1, paired, 0.5)
    for key in VOLATILE_REPORT_KEYS:
        d.pop(key)
    return json.loads(package_cli.json_dumps(d))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- tests/test_multihost.py, with the port's names -------------------------


def test_single_end_shards_concatenate(tmp_path, port_env):
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 3001, random.Random(5), ADAPTER)
    # small chunks: every shard's range is read in several engine chunks
    port_env.setenv("CUTADAPT_TPU_TORCH_CHUNK_BYTES", "30000")

    base = ["--quiet", "-a", f"ad={ADAPTER}", "-q", "12", "-m", "10"]
    full_out = os.fspath(tmp_path / "full.fastq")
    full_json = os.fspath(tmp_path / "full.json")
    fallbacks = accel.FALLBACK_COUNT
    stats_full = _port(base + ["-o", full_out, "--json", full_json, inp])

    n_hosts = 3
    shards = plan_shards(inp, n_hosts, "fastq")
    assert shards[0][0] == 0 and shards[-1][1] == os.path.getsize(inp)
    assert all(a[1] == b[0] for a, b in zip(shards, shards[1:]))

    parts = []
    pickles = []
    for h, (start, end) in enumerate(shards):
        out = os.fspath(tmp_path / f"part{h}.fastq")
        pkl = os.fspath(tmp_path / f"part{h}.stats")
        _port(base + ["-o", out, inp], {
            "CUTADAPT_TPU_TORCH_BYTE_RANGE": f"{start}:{end}",
            "CUTADAPT_TPU_TORCH_STATS_PICKLE": pkl,
        })
        parts.append(out)
        pickles.append(pkl)
    assert accel.FALLBACK_COUNT == fallbacks

    merged_bytes = b"".join(read(p) for p in parts)
    assert merged_bytes == read(full_out)
    assert merged_bytes  # not vacuous

    merged = merge_statistics(pickles)
    assert port_report.full_report(merged, 0.0, 0.5) == \
        port_report.full_report(stats_full, 0.0, 0.5)
    assert merged.as_json() == stats_full.as_json()


def test_paired_shards_concatenate(tmp_path):
    r1 = os.fspath(tmp_path / "r1.fastq")
    r2 = os.fspath(tmp_path / "r2.fastq")
    rng = random.Random(9)
    _write_fastq(r1, 2000, rng, ADAPTER)
    _write_fastq(r2, 2000, rng, ADAPTER2)

    base = ["--quiet", "-a", f"a1={ADAPTER}", "-A", f"a2={ADAPTER2}",
            "-m", "12"]
    fo1 = os.fspath(tmp_path / "f1.fastq")
    fo2 = os.fspath(tmp_path / "f2.fastq")
    stats_full = _port(base + ["-o", fo1, "-p", fo2, r1, r2])

    shards = plan_paired_shards(r1, r2, 2, "fastq")
    parts1, parts2, pickles = [], [], []
    for h, ((s1, e1), (s2, e2)) in enumerate(shards):
        o1 = os.fspath(tmp_path / f"p1-{h}.fastq")
        o2 = os.fspath(tmp_path / f"p2-{h}.fastq")
        pkl = os.fspath(tmp_path / f"p{h}.stats")
        _port(base + ["-o", o1, "-p", o2, r1, r2], {
            "CUTADAPT_TPU_TORCH_BYTE_RANGE": f"{s1}:{e1},{s2}:{e2}",
            "CUTADAPT_TPU_TORCH_STATS_PICKLE": pkl,
        })
        parts1.append(o1)
        parts2.append(o2)
        pickles.append(pkl)

    for full, parts in ((fo1, parts1), (fo2, parts2)):
        assert b"".join(read(p) for p in parts) == read(full)
    merged = merge_statistics(pickles)
    assert merged.as_json() == stats_full.as_json()


def test_plan_shards_fasta(tmp_path):
    inp = os.fspath(tmp_path / "in.fasta")
    rng = random.Random(3)
    with open(inp, "w") as f:
        for i in range(101):
            s = "".join(rng.choice("ACGT") for _ in range(rng.randint(5, 60)))
            if rng.random() < 0.4:  # multi-line records
                s = s[:5] + "\n" + s[5:]
            f.write(f">r{i}\n{s}\n")
    shards = plan_shards(inp, 4, "fasta")
    assert shards[0][0] == 0 and shards[-1][1] == os.path.getsize(inp)
    data = read(inp)
    for start, end in shards[1:]:
        # every boundary is a record start
        assert data[start:start + 1] == b">"
        assert data[start - 1:start] == b"\n"


@pytest.mark.parametrize("mode", ["host_serial", "host_multiproc"])
def test_shards_on_fallback_paths(tmp_path, mode):
    """The byte-range shard contract holds on every execution path, not
    only the engine: the per-read host path (engine off) and the
    multiprocessing runner (-j 2, whose reader process re-opens the raw
    paths) both respect the range and concatenate to the single-run
    byte stream."""
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 1501, random.Random(7), ADAPTER)

    base = ["--quiet", "-a", f"ad={ADAPTER}", "-q", "12", "-m", "10"]
    if mode == "host_multiproc":
        base = ["-j", "2"] + base
    full_out = os.fspath(tmp_path / "full.fastq")
    _port(base + ["-o", full_out, inp], batch="0")

    parts = []
    for h, (start, end) in enumerate(plan_shards(inp, 3, "fastq")):
        out = os.fspath(tmp_path / f"fb{h}.fastq")
        _port(base + ["-o", out, inp],
              {"CUTADAPT_TPU_TORCH_BYTE_RANGE": f"{start}:{end}"}, batch="0")
        parts.append(out)

    merged = b"".join(read(p) for p in parts)
    assert merged == read(full_out)
    assert merged  # not vacuous


def test_shard_option_single_end(tmp_path):
    """--shard INDEX/COUNT computes the byte range itself and writes a
    mergeable statistics pickle next to its output."""
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 1201, random.Random(11), ADAPTER)
    base = ["--quiet", "-a", f"ad={ADAPTER}", "-m", "5"]
    full_out = os.fspath(tmp_path / "full.fastq")
    stats_full = _port(base + ["-o", full_out, inp])

    parts, pickles = [], []
    for h in range(3):
        out = os.fspath(tmp_path / f"s{h}.fastq")
        _port(base + ["-o", out, "--shard", f"{h}/3", inp])
        parts.append(out)
        pickles.append(f"{out}.shard-stats.pickle")
        assert os.path.exists(pickles[-1])
    merged = b"".join(read(p) for p in parts)
    assert merged == read(full_out)
    assert merge_statistics(pickles).as_json() == stats_full.as_json()
    assert "CUTADAPT_TPU_TORCH_BYTE_RANGE" not in os.environ  # restored


def test_shard_option_paired(tmp_path):
    r1 = os.fspath(tmp_path / "r1.fastq")
    r2 = os.fspath(tmp_path / "r2.fastq")
    rng = random.Random(13)
    _write_fastq(r1, 900, rng, ADAPTER)
    _write_fastq(r2, 900, rng, ADAPTER2)
    base = ["--quiet", "-a", ADAPTER, "-A", ADAPTER2, "-m", "8"]
    fo1 = os.fspath(tmp_path / "f1.fastq")
    fo2 = os.fspath(tmp_path / "f2.fastq")
    _port(base + ["-o", fo1, "-p", fo2, r1, r2])
    parts1, parts2 = [], []
    for h in range(2):
        o1 = os.fspath(tmp_path / f"s1-{h}.fastq")
        o2 = os.fspath(tmp_path / f"s2-{h}.fastq")
        _port(base + ["-o", o1, "-p", o2, "--shard", f"{h}/2", r1, r2])
        parts1.append(o1)
        parts2.append(o2)
    for full, parts in ((fo1, parts1), (fo2, parts2)):
        assert b"".join(read(p) for p in parts) == read(full)


def test_shard_option_interleaved_keeps_pairs(tmp_path):
    """Interleaved input boundaries never split an R1/R2 pair."""
    inp = os.fspath(tmp_path / "il.fastq")
    _write_interleaved(inp, 301, random.Random(17))
    base = ["--quiet", "--interleaved", "-a", ADAPTER, "-A", ADAPTER]
    full_out = os.fspath(tmp_path / "full.fastq")
    _port(base + ["-o", full_out, inp])
    parts = []
    for h in range(3):
        out = os.fspath(tmp_path / f"il{h}.fastq")
        _port(base + ["-o", out, "--shard", f"{h}/3", inp])
        parts.append(read(out))
    assert b"".join(parts) == read(full_out)


def test_shard_option_bam(tmp_path):
    """BAM sharding: record-aligned byte ranges and the header replayed
    in front of every non-first shard, read by the engine's format
    detection and chunk reader."""
    inp = os.fspath(tmp_path / "small_raw.bam")
    _write_raw_bam(inp)
    base = ["--quiet", "-a", "TTAGACATAT"]
    full_out = os.fspath(tmp_path / "full.fastq")
    fallbacks = accel.FALLBACK_COUNT
    _port(base + ["-o", full_out, inp])
    parts = []
    for h in range(2):
        out = os.fspath(tmp_path / f"b{h}.fastq")
        _port(base + ["-o", out, "--shard", f"{h}/2", inp])
        parts.append(read(out))
    assert accel.FALLBACK_COUNT == fallbacks
    assert all(parts)  # both shards got records
    assert b"".join(parts) == read(full_out)


def test_shard_option_rejects_compressed(tmp_path):
    inp = os.fspath(tmp_path / "in.fastq.gz")
    with gzip.open(inp, "wb") as f:
        f.write(b"@r0\nACGT\n+\nIIII\n")
    with pytest.raises(SystemExit) as e:
        _port(["--quiet", "-a", ADAPTER, "-o",
               os.fspath(tmp_path / "o.fastq"), "--shard", "0/2", inp])
    assert e.value.code == 2


def test_plan_file_shards_balances_by_size(tmp_path):
    paths = []
    for i, size in enumerate([100, 90, 10, 9, 8, 1]):
        p = os.fspath(tmp_path / f"f{i}.fastq.gz")
        with open(p, "wb") as f:
            f.write(b"x" * size)
        paths.append(p)
    plan = multihost.plan_file_shards(paths, 2)
    assert sorted(sum(plan, [])) == sorted(paths)  # partition
    loads = [sum(os.path.getsize(p) for p in host) for host in plan]
    assert abs(loads[0] - loads[1]) <= 10  # balanced
    assert plan == multihost.plan_file_shards(paths, 2)  # deterministic
    assert plan == jax_multihost.plan_file_shards(paths, 2)


def _coordinator(args, tmp_path, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_run_torch.py"),
         *args],
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env={**os.environ, "CUTADAPT_TPU_TORCH_DEVICE": "cpu"},
    )


def test_coordinator_tool(tmp_path):
    """tools/multihost_run_torch.py end to end: gz output shards
    concatenate to a valid multi-member gzip identical (decompressed) to
    the unsharded run, and the merged report is printed."""
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 800, random.Random(23), ADAPTER)
    serial_out = os.fspath(tmp_path / "serial.fastq.gz")
    stats = _port(["--quiet", "-a", ADAPTER, "-o", serial_out, inp])

    coord_out = os.fspath(tmp_path / "coord.fastq.gz")
    r = _coordinator(["-n", "2", "--sequential", "--",
                      "-a", ADAPTER, "-o", coord_out, inp], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "Summary" in r.stdout  # merged report
    assert r.stdout.strip() == port_report.full_report(stats, 0, 0.5).strip()
    assert gzip.open(coord_out, "rb").read() == gzip.open(
        serial_out, "rb").read()
    assert not [p for p in os.listdir(tmp_path) if "shard" in p]
    timing = json.loads(r.stderr.splitlines()[-1].split(" ", 1)[1])
    assert timing["shards"] == 2 and len(timing["shard_seconds"]) == 2


def test_coordinator_stops_at_a_failed_shard(tmp_path):
    """Shards that fail (a compressed input, refused by --shard) end the
    run with the shard's exit code and no output; a demultiplexing
    template is refused before any shard starts."""
    inp = os.fspath(tmp_path / "in.fastq.gz")
    with gzip.open(inp, "wb") as f:
        f.write(b"@r0\nACGT\n+\nIIII\n")
    out = os.fspath(tmp_path / "out.fastq")
    r = _coordinator(["-n", "2", "--", "-a", ADAPTER, "-o", out, inp],
                     tmp_path)
    assert r.returncode == 2
    assert "failed (exit 2)" in r.stderr
    assert not os.path.exists(out)
    r = _coordinator(["-n", "2", "--", "-g", "file:x.fasta", "-o",
                      os.fspath(tmp_path / "{name}.fastq"), inp], tmp_path)
    assert r.returncode == 2 and "demultiplexing" in r.stderr


def test_distributed_init_single_process(port_env):
    """CUTADAPT_TPU_TORCH_DIST_COORDINATOR joins a gloo process group
    (idempotent, failure-tolerant). Exercised as a 1-process world."""
    import torch.distributed as dist

    port_env.setenv("CUTADAPT_TPU_TORCH_DIST_COORDINATOR",
                    f"127.0.0.1:{_free_port()}")
    port_env.setenv("CUTADAPT_TPU_TORCH_DIST_NPROCS", "1")
    port_env.setenv("CUTADAPT_TPU_TORCH_DIST_PID", "0")
    try:
        accel._maybe_init_distributed()
        accel._maybe_init_distributed()  # a second call must not raise
        assert dist.is_initialized()
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --- the port against the JAX package ---------------------------------------


def _plan_inputs(tmp_path):
    rng = random.Random(29)
    files = {}
    files["fastq"] = os.fspath(tmp_path / "in.fastq")
    _write_fastq(files["fastq"], 1003, rng, ADAPTER)
    files["fasta"] = os.fspath(tmp_path / "in.fasta")
    _write_fasta(files["fasta"], 507, rng)
    files["interleaved"] = os.fspath(tmp_path / "il.fastq")
    _write_interleaved(files["interleaved"], 401, rng)
    files["r2"] = os.fspath(tmp_path / "r2.fastq")
    _write_fastq(files["r2"], 1003, rng, ADAPTER2)
    files["bam"] = os.fspath(tmp_path / "raw.bam")
    _write_raw_bam(files["bam"])
    return files


@pytest.mark.parametrize("count", [1, 2, 3, 7])
def test_plans_equal_the_jax_plans(tmp_path, count):
    """plan_shards (FASTQ, FASTA, interleaved pairs), plan_paired_shards,
    plan_bam_shards and the --shard byte-range value of every index equal
    the JAX package's on the same files."""
    f = _plan_inputs(tmp_path)
    for fmt, path, group in (("fastq", f["fastq"], 1),
                             ("fasta", f["fasta"], 1),
                             ("fastq", f["interleaved"], 2)):
        got = plan_shards(path, count, fmt, group=group)
        assert got == jax_multihost.plan_shards(path, count, fmt, group=group)
    assert plan_paired_shards(f["fastq"], f["r2"], count) == \
        jax_multihost.plan_paired_shards(f["fastq"], f["r2"], count)
    assert multihost.plan_bam_shards(f["bam"], count) == \
        jax_multihost.plan_bam_shards(f["bam"], count)
    for paths, interleaved in (([f["fastq"]], False), ([f["fasta"]], False),
                               ([f["interleaved"]], True),
                               ([f["fastq"], f["r2"]], False),
                               ([f["bam"]], False)):
        for i in range(count):
            assert multihost.shard_byte_range_env(paths, i, count,
                                                  interleaved) == \
                jax_multihost.shard_byte_range_env(paths, i, count,
                                                   interleaved)


KINDS = {
    # kind: (argv before the outputs, the outputs' names, input keys)
    "fastq": (["-a", f"ad={ADAPTER}", "-q", "12", "-m", "10"],
              ["o.fastq"], ["fastq"]),
    "fasta": (["-a", f"ad={ADAPTER}", "-m", "4"], ["o.fasta"], ["fasta"]),
    "paired": (["-a", f"a1={ADAPTER}", "-A", f"a2={ADAPTER2}", "-m", "12"],
               ["o1.fastq", "o2.fastq"], ["fastq", "r2"]),
    "interleaved": (["--interleaved", "-a", f"a1={ADAPTER}",
                     "-A", f"a2={ADAPTER2}"], ["o.fastq"], ["interleaved"]),
    "bam": (["-a", "ad=TTAGACATAT"], ["o.fastq"], ["bam"]),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_shards_equal_the_jax_shards(tmp_path, kind):
    """Each --shard i/3 output of the port (its engine, the plain
    aligner) byte-identical to the JAX package's --shard i/3 output for
    the same argv; the concatenation equal to the port's unsharded run;
    the merged text and --json reports equal to the JAX package's merged
    reports and to the unsharded run's."""
    f = _plan_inputs(tmp_path)
    args, outs, keys = KINDS[kind]
    inputs = [f[k] for k in keys]
    paired = len(outs) == 2 or kind == "interleaved"

    def argv(tag, shard=None):
        d = tmp_path / tag
        d.mkdir()
        o = ["-o", os.fspath(d / outs[0])]
        if len(outs) == 2:
            o += ["-p", os.fspath(d / outs[1])]
        extra = ["--shard", shard] if shard else []
        return ["--quiet", *args, *o, *extra, *inputs], d

    a, d_full = argv("full")
    fallbacks = accel.FALLBACK_COUNT
    stats_full = _port(a)
    merged = {}
    for name, run in (("port", _port), ("jax", lambda a: _run(jax_cli.main,
                                                               a))):
        pickles = []
        for h in range(3):
            a, d = argv(f"{name}{h}", f"{h}/3")
            run(a)
            pickles.append(os.fspath(d / outs[0]) + ".shard-stats.pickle")
        merged[name] = (jax_multihost if name == "jax" else
                        multihost).merge_statistics(pickles)
    assert accel.FALLBACK_COUNT == fallbacks
    for out in outs:
        whole = b""
        for h in range(3):
            got = read(tmp_path / f"port{h}" / out)
            assert got == read(tmp_path / f"jax{h}" / out), (out, h)
            whole += got
        assert whole == read(d_full / out)
        assert whole  # not vacuous
    assert port_report.full_report(merged["port"], 0.0, 0.5) == \
        jax_report.full_report(merged["jax"], 0.0, 0.5)
    assert port_report.full_report(merged["port"], 0.0, 0.5) == \
        port_report.full_report(stats_full, 0.0, 0.5)
    assert _json(cli, merged["port"], paired) == \
        _json(jax_cli, merged["jax"], paired)
    assert merged["port"].as_json() == stats_full.as_json()


@pytest.mark.parametrize("shard", ["x/2", "1/", "2/2", "0/0", "3/2"])
def test_shard_option_errors_equal_the_jax_errors(tmp_path, caplog, shard):
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 10, random.Random(1), ADAPTER)
    messages = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        caplog.clear()
        with pytest.raises(SystemExit) as e:
            _run(main, ["--quiet", "-a", ADAPTER, "--shard", shard, "-o",
                        os.fspath(tmp_path / f"{name}.fastq"), inp])
        assert e.value.code == 2
        messages[name] = [r.getMessage() for r in caplog.records
                          if r.levelno >= logging.ERROR]
    assert messages["port"] == messages["jax"]
    assert any("--shard" in m for m in messages["port"])


def test_paired_bam_shard_is_refused_as_by_jax(tmp_path, caplog):
    bam = os.fspath(tmp_path / "raw.bam")
    _write_raw_bam(bam)
    messages = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        caplog.clear()
        with pytest.raises(SystemExit) as e:
            _run(main, ["--quiet", "-a", ADAPTER, "-A", ADAPTER, "--shard",
                        "0/2", "-o", os.fspath(tmp_path / "1.fastq"), "-p",
                        os.fspath(tmp_path / "2.fastq"), bam, bam])
        assert e.value.code == 2
        messages[name] = [r.getMessage() for r in caplog.records
                          if r.levelno >= logging.ERROR]
    assert messages["port"] == messages["jax"]
    assert "paired BAM" in messages["port"][0]


def test_jax_byte_range_leaves_the_port_alone(tmp_path):
    """CUTADAPT_TPU_BYTE_RANGE and CUTADAPT_TPU_STATS_PICKLE (the JAX
    package's variables) neither cut the port's input nor make it write
    a pickle."""
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 300, random.Random(31), ADAPTER)
    base = ["--quiet", "-a", f"ad={ADAPTER}"]
    full = os.fspath(tmp_path / "full.fastq")
    _port(base + ["-o", full, inp])
    pkl = os.fspath(tmp_path / "jax.pickle")
    for batch in ("require", "0"):
        out = os.fspath(tmp_path / f"out{batch}.fastq")
        _port(base + ["-o", out, inp], {
            "CUTADAPT_TPU_BYTE_RANGE": "0:200",
            "CUTADAPT_TPU_STATS_PICKLE": pkl,
        }, batch=batch)
        assert read(out) == read(full)
    assert not os.path.exists(pkl)


def test_two_process_gloo_group_of_shards(tmp_path):
    """Two `--shard i/2` processes of the port's CLI on the CPU join one
    gloo group through CUTADAPT_TPU_TORCH_DIST_COORDINATOR, both exit 0
    and their outputs concatenate to the unsharded run's."""
    inp = os.fspath(tmp_path / "in.fastq")
    _write_fastq(inp, 400, random.Random(37), ADAPTER)
    base = ["-a", f"ad={ADAPTER}"]
    full = os.fspath(tmp_path / "full.fastq")
    _port(["--quiet"] + base + ["-o", full, inp])
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO,
           "CUTADAPT_TPU_TORCH_DEVICE": "cpu",
           "CUTADAPT_TPU_TORCH_BATCH": "require",
           "CUTADAPT_TPU_TORCH_DIST_COORDINATOR": coord,
           "CUTADAPT_TPU_TORCH_DIST_NPROCS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cutadapt_tpu_torch", "--debug", *base,
         "--shard", f"{i}/2", "-o", os.fspath(tmp_path / f"s{i}.fastq"), inp],
        env={**env, "CUTADAPT_TPU_TORCH_DIST_PID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=tmp_path) for i in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, err
        # --debug's lines go to stdout when the report does
        assert f"process group: rank {i} of 2 (gloo" in out + err
        assert "init_process_group failed" not in out + err
    assert read(tmp_path / "s0.fastq") + read(tmp_path / "s1.fastq") == \
        read(full)


def test_reducer_pickles_on_8_cpu_shards_merge_to_one_device(tmp_path):
    """--shard runs with the statistics reducer on 8 shards of the CPU
    pickle host objects only (no torch class in the pickle), and the
    merged report equals the unsharded one-device run's."""
    r1 = os.fspath(tmp_path / "r1.fastq")
    r2 = os.fspath(tmp_path / "r2.fastq")
    rng = random.Random(41)
    _write_fastq(r1, 700, rng, ADAPTER)
    _write_fastq(r2, 700, rng, ADAPTER2)
    base = ["--quiet", "-a", f"a1={ADAPTER}", "-A", f"a2={ADAPTER2}",
            "-q", "15", "-m", "12"]
    d = tmp_path
    stats_one = _port(base + ["-o", os.fspath(d / "f1.fastq"), "-p",
                              os.fspath(d / "f2.fastq"), r1, r2],
                      {"CUTADAPT_TPU_TORCH_DEVICES": "1"})
    pickles = []
    for h in range(2):
        out = os.fspath(d / f"s{h}.1.fastq")
        _port(base + ["-o", out, "-p", os.fspath(d / f"s{h}.2.fastq"),
                      "--shard", f"{h}/2", r1, r2],
              {"CUTADAPT_TPU_TORCH_DEVICES": "8",
               "CUTADAPT_TPU_TORCH_DEVICE_STATS": "1"})
        pickles.append(out + ".shard-stats.pickle")
    parts = [load_host_pickle(p) for p in pickles]  # refuses torch classes
    merged = parts[0]
    merged += parts[1]
    assert merged.as_json() == stats_one.as_json()
    assert port_report.full_report(merged, 0.0, 0.5) == \
        port_report.full_report(stats_one, 0.0, 0.5)
    for side in (1, 2):
        assert read(d / f"s0.{side}.fastq") + read(d / f"s1.{side}.fastq") \
            == read(d / f"f{side}.fastq")


def test_load_host_pickle_refuses_torch_objects(tmp_path):
    import torch

    path = tmp_path / "t.pickle"
    with open(path, "wb") as f:
        pickle.dump({"bins": torch.zeros(3)}, f)
    with pytest.raises(pickle.UnpicklingError, match="torch"):
        load_host_pickle(path)
