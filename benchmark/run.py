#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on cutadapt_tpu_torch and print one
JSON line as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up: import the port and load its kernel library (built once into
cutadapt_tpu_torch/csrc/build/ of this checkout), make the cell's input
file(s) from the seed into a directory under TMPDIR, and warm up with
one call of the cell's arguments on a smaller file of the same traffic.
The window then calls ``cutadapt_tpu_torch.cli.main`` in this process
on one whole input file (or pair of files) after another, again and
again, until ``--seconds`` have passed; it counts whole calls only, all
their reads over all their time. Every
call runs the engine (CUTADAPT_TPU_TORCH_BATCH=require); one that fell
back to the host path or launched no aligner kernel has failed. Outputs
go to FIFOs and are digested (sink.py), never written to disk; each
call's ``--json`` report is a small file.

Once the window has closed, the plain reference (reference/) works out
every output file and the report's counts and statistics from the same
reads, on the card, and every call's digests and report are held to
them: ``correct`` needs all of them equal. ``--trace 1`` runs the window
under torch.profiler with the harness's spans (trace.py) and prints the
cell's per-layer metrics (metrics/<name>.py) and a breakdown; ``--trace
0`` prints its end-to-end metrics.

Exits 1 without a result when there is no CUDA card, or fewer than the
cell asks for, and when JAX or the JAX package is loaded by the time the
result would be printed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# kernel and build caches of the libraries under the port, at fixed
# paths in this checkout (the port builds its own into its csrc/build/)
CACHE = os.path.join(ROOT, ".bench_cache")
# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "cutadapt_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_cell(workload: str, bench_path: str):
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    with open(os.path.join(HERE, "configs", f"{cell['config']}.json")) as f:
        cfg = json.load(f)
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return cell, cfg, end_to_end, per_layer


def load_file_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_environment(device: str, chips: int):
    os.environ["CUTADAPT_TPU_TORCH_BATCH"] = "require"
    os.environ["CUTADAPT_TPU_TORCH_DEVICES"] = str(chips)
    if device == "cpu":
        os.environ["CUTADAPT_TPU_TORCH_DEVICE"] = "cpu"
    else:
        os.environ.pop("CUTADAPT_TPU_TORCH_DEVICE", None)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


class Call:
    """One call of main in the window, on timed file ``file``: the block
    digests of its outputs and the summary of its report
    (compare.report_summary)."""

    def __init__(self, file=0, digests=None, summary=None, launches=0):
        self.file = file
        self.error = None
        self.digests = digests or []
        self.summary = summary
        self.fallbacks = 0
        self.launches = launches
        self.startup_ms = None
        self.seconds = None

    @property
    def failed(self) -> bool:
        return (self.error is not None or self.fallbacks > 0
                or self.launches == 0)


def launch_count(device: str) -> int:
    from cutadapt_tpu_torch.ops import align_cuda

    counts = align_cuda.PLAIN_RUNS if device == "cpu" else align_cuda.LAUNCHES
    return sum(counts.values())


def call_main(args, inputs, n_out, tmp, device, spans=None, file=0,
              suffix=".fastq") -> Call:
    """One call of cutadapt_tpu_torch.cli.main on ``inputs`` (timed file
    ``file``), its ``n_out`` outputs into digest sinks (gzip streams
    where ``suffix`` ends in .gz) and its report into ``tmp``."""
    from cutadapt_tpu_torch import accel, cli

    from benchmark import compare
    from benchmark.sink import DigestSink

    call = Call(file)
    report = os.path.join(tmp, "report.json")
    sinks = [DigestSink(os.path.join(tmp, f"out{i + 1}{suffix}"),
                        gunzip=suffix.endswith(".gz"))
             for i in range(n_out)]
    outs = ["-o", sinks[0].path] + (["-p", sinks[1].path] if n_out > 1 else [])
    fallbacks, launches = accel.FALLBACK_COUNT, launch_count(device)
    wall, t0 = time.time_ns(), time.perf_counter()
    try:
        cli.main(list(args) + outs + ["--json", report] + list(inputs))
    except SystemExit as e:  # main reports its errors by exiting
        call.error = f"main exited with {e.code}"
    except Exception as e:  # noqa: BLE001 - a failed call, reported
        call.error = repr(e)
    call.seconds = time.perf_counter() - t0
    if call.error is not None:
        gc.collect()  # closes output files that a failed call left open
    if spans is not None:
        spans.calls.append((wall, int(call.seconds * 1e9)))
    for sink in sinks:
        try:
            call.digests.append(sink.close(120 if call.error is None else 5))
        except (OSError, RuntimeError) as e:
            call.error = call.error or repr(e)
    call.fallbacks = accel.FALLBACK_COUNT - fallbacks
    call.launches = launch_count(device) - launches
    rt = accel.RUN_TIMES
    if rt["start"] is not None and rt["first_submit"] is not None:
        call.startup_ms = (rt["first_submit"] - rt["start"]) * 1e3
    if call.error is None:
        try:
            with open(report) as f:
                call.summary = compare.report_summary(json.load(f))
        except (OSError, ValueError, KeyError, TypeError) as e:
            call.error = f"report: {e!r}"
    with contextlib.suppress(FileNotFoundError):
        os.unlink(report)
    return call


def write_inputs(traffic, mates, tmp, tag):
    from benchmark.generate import file_bytes, suffix

    paths = []
    for i, reads in enumerate(mates):
        path = os.path.join(tmp, f"{tag}{i + 1}{suffix(traffic)}")
        with open(path, "wb") as f:
            f.write(file_bytes(traffic, reads))
            f.flush()
            # written back now, in set-up, and not in the window
            os.fsync(f.fileno())
        paths.append(path)
    return paths


def load_reference(cfg):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return load_file_module(os.path.join(HERE, "reference",
                                         f"{cfg['reference']}.py"))


def reference_output(ref, cfg, mates, device) -> dict:
    """What the plain reference wants of a call on ``mates``: the block
    digests of each output file and the summary of the report."""
    from benchmark import generate

    outputs, summary = ref.run(cfg, mates, device)
    return {"digests": [generate.block_digests(generate.fastq_bytes(r, keep))
                        for r, keep in outputs],
            "summary": summary}


def judge(calls, wants) -> tuple:
    """Hold every call to what the reference wants of its timed file
    (``wants[call.file]``): (checks, notes). The checks are the numbers
    that decide ``correct``, each with its limit."""
    from benchmark import compare

    notes = {"output_blocks_differing": 0, "report_fields_differing": 0}
    out_bad = report_bad = 0
    for call in calls:
        if call.failed:
            continue
        want = wants[call.file]
        bad = {i: compare.first_difference(got, w) for i, (got, w) in
               enumerate(zip(call.digests, want["digests"])) if got != w}
        if bad:
            out_bad += 1
            for got, w in zip(call.digests, want["digests"]):
                notes["output_blocks_differing"] += abs(len(got) - len(w)) + sum(
                    g != x for g, x in zip(got, w))
            notes.setdefault("first_output_mismatch", {
                f"file{i + 1}": f"block {b}" for i, b in bad.items()})
        diff = compare.differences(call.summary, want["summary"])
        if diff:
            report_bad += 1
            notes["report_fields_differing"] += len(diff)
            notes.setdefault("first_report_mismatch", diff[:8])
    checks = {
        "failed_calls": {"value": sum(c.failed for c in calls), "limit": 0},
        "output_mismatch_calls": {"value": out_bad, "limit": 0},
        "report_mismatch_calls": {"value": report_bad, "limit": 0},
    }
    return checks, notes


def passes(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def check_reference(cfg, files, calls, device):
    """Hold every call to the plain reference of its timed file (``files``
    holds each file's mates): (checks, notes)."""
    ref = load_reference(cfg)
    t = time.perf_counter()
    wants = [reference_output(ref, cfg, mates, device) for mates in files]
    checks, notes = judge(calls, wants)
    notes["reference_s"] = time.perf_counter() - t
    return checks, notes


def forbidden_loaded() -> list:
    """The top-level names of FORBIDDEN loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", reads: int = None, t0: float = None,
        import_torch_s: float = 0.0) -> dict:
    """One run of a cell; returns the result (the line's object).
    ``t0`` is when set-up began and ``import_torch_s`` what importing
    torch took before it was called. ``device="cpu"`` and ``reads`` (a
    smaller file) serve the tests: the port then runs its plain aligner
    and nothing is timed on a card."""
    t0 = time.perf_counter() if t0 is None else t0
    cell, cfg, end_to_end, per_layer = load_cell(
        workload, os.path.join(ROOT, "BENCHMARK.json"))
    set_environment(device, cell["chips"])
    t = time.perf_counter()
    import torch

    parts = {"import_torch_s": time.perf_counter() - t + import_torch_s}
    t = time.perf_counter()
    import cutadapt_tpu_torch.cli  # noqa: F401
    from cutadapt_tpu_torch.ops import align_cuda

    from benchmark import generate, trace as tr

    parts["import_port_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device != "cpu":
        align_cuda._library()  # from the build cache after the first run
        torch.cuda.init()
    parts["kernel_library_s"] = time.perf_counter() - t
    if not logging.root.handlers:  # main then leaves logging alone
        handler = logging.StreamHandler(sys.stderr)
        handler.setLevel(logging.ERROR)
        logging.root.addHandler(handler)

    traffic = generate.load_traffic(cell["traffic"])
    if reads is not None:
        traffic = dict(traffic, reads_per_file=reads,
                       warmup_reads=max(reads // 4, 1))
    tmp = tempfile.mkdtemp(prefix="cutadapt-bench-")
    try:
        t = time.perf_counter()
        gen_device = "cpu" if device == "cpu" else "cuda"
        files = [generate.make(traffic, seed, generate.file_stream(i),
                               device=gen_device)
                 for i in range(traffic.get("files", 1))]
        inputs = [write_inputs(traffic, mates, tmp, f"in{i}.")
                  for i, mates in enumerate(files)]
        warm = write_inputs(traffic, generate.make(
            traffic, seed, generate.WARMUP, device=gen_device), tmp, "warm")
        parts["generate_s"] = time.perf_counter() - t
        if device != "cpu":  # the peak is the program's, not the generator's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        n_out = len(files[0])
        suffix = generate.suffix(traffic)
        t = time.perf_counter()
        warm_call = call_main(cfg["args"], warm, n_out, tmp, device,
                              suffix=suffix)
        parts["warmup_s"] = time.perf_counter() - t
        if warm_call.failed:
            log("warm-up call failed:", warm_call.error)
        if device != "cpu":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        spans = tr.Spans()
        launches = []
        xfer_before = dict(_xfer())
        prof = None
        if trace and device != "cpu":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        calls = []
        lo_ns = time.time_ns()
        w0 = time.perf_counter()
        ctx = (tr.instrumented(spans, launches) if trace
               else contextlib.nullcontext())
        with ctx:
            while True:
                i = len(calls) % len(inputs)
                calls.append(call_main(cfg["args"], inputs[i], n_out, tmp,
                                       device, spans if trace else None,
                                       file=i, suffix=suffix))
                if time.perf_counter() - w0 >= seconds:
                    break
            if device != "cpu":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        hi_ns = lo_ns + int(window_s * 1e9)
        if prof is not None:
            prof.stop()
        xfer = {k: v - xfer_before[k] for k, v in _xfer().items()}

        good = [c for c in calls if not c.failed]
        n_reads = sum(len(files[c.file][0]) for c in good)
        dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                    "kind": (torch.cuda.get_device_name(0)
                             if device != "cpu" else "cpu"),
                    "count": cell["chips"] if device != "cpu" else 0,
                    "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                          if device != "cpu" else 0)}
        result = {"correct": False, "attempted": len(calls),
                  "failed": len(calls) - len(good), "metrics": {},
                  "device": dev_info}
        if not trace:
            values = {"reads_per_s": n_reads / window_s,
                      "setup_s": setup_s}
            for m in end_to_end:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        else:
            reader_ctx = _reader_context(good, n_reads, spans, launches,
                                         xfer, prof, lo_ns, hi_ns, window_s)
            for m in per_layer:
                reader = load_file_module(
                    os.path.join(HERE, "metrics", f"{m['name']}.py"))
                value = reader.read(reader_ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            if prof is not None:
                dev_info["busy_s"] = reader_ctx["busy_ns"] / 1e9
                dev_info["window_s"] = window_s
                result["breakdown"] = reader_ctx["breakdown"]
            del prof, reader_ctx
        del launches, spans

        # the program's state is freed before the reference runs
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        checks, notes = check_reference(cfg, files, calls, device)
        result["correct"] = bool(calls) and passes(checks)
        for c in calls:
            if c.failed:
                notes.setdefault("first_failure", c.error or (
                    f"{c.fallbacks} fallbacks, {c.launches} launches"))
        notes.update(parts, window_s=window_s, calls=len(calls),
                     call_s=[round(c.seconds, 4) for c in calls],
                     startup_ms=[round(c.startup_ms or 0, 2) for c in calls])
        log("run:", json.dumps(notes))
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _xfer() -> dict:
    from cutadapt_tpu_torch.batch_pipeline import XFER

    return dict(XFER)


def _reader_context(good, n_reads, spans, launches, xfer, prof, lo_ns,
                    hi_ns, window_s) -> dict:
    """What the per-layer readers (metrics/<name>.py) read."""
    from benchmark import roofline, trace as tr

    # call start-up: from a call's start to its first submit
    submits = sorted(s for s, _ in spans.of("submit"))
    for start, dur in spans.calls:
        i = bisect.bisect_left(submits, start)
        if i < len(submits) and submits[i] < start + dur:
            spans.add("call start-up", start, submits[i] - start)
    ctx = {"reads": n_reads, "calls": good, "spans": spans,
           "xfer": xfer, "launches": launches, "window_s": window_s,
           "roofline": roofline}
    if prof is not None:
        events = tr.device_events(prof)
        busy = tr.busy_intervals(events, lo_ns, hi_ns)
        ctx["busy_ns"] = sum(e - s for s, e in busy)
        ctx["kernel_ns"] = {}
        for name, s, e in events:
            if e > lo_ns and s < hi_ns:
                ctx["kernel_ns"][name] = ctx["kernel_ns"].get(name, 0) + (e - s)
        ctx["clock"] = roofline.card_clock()
        import torch

        ctx["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
        ctx["card"] = torch.cuda.get_device_name(0)
        ctx["breakdown"] = {
            "device_ops": tr.top_device_ops(events, lo_ns, hi_ns),
            "idle_gaps": tr.idle_gaps(busy, lo_ns, hi_ns, spans),
        }
    return ctx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell, _, _, _ = load_cell(a.workload, os.path.join(ROOT, "BENCHMARK.json"))
    t = time.perf_counter()
    import torch

    import_torch_s = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), t0=T0,
                 import_torch_s=import_torch_s)
    return finish(result)


def finish(result: dict) -> int:
    """Print the result as the last line of standard output, each number
    compared beside its limit last on standard error; unless JAX or the
    JAX package is loaded in this process by now, after the reference
    and every metric reader ran: then exit code 1 and no result."""
    loaded = forbidden_loaded()
    if loaded:
        log("loaded in the reporting process:", ", ".join(loaded))
        return 1
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
