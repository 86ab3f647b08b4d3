"""kernel (csrc/align_locate.cu): the aligner's share of its roofline,
in percent. The numerator is the least time the card needs for the DP
that the rows handed to the kernel in the window need (roofline.py's
frozen arithmetic over their real lengths: integer operations at 132
SMs x 64 int32 lanes x the card's maximum SM clock, or bytes at the HBM
rate, whichever is longer); the denominator the aligner's kernel time
summed from the trace."""

from benchmark.trace import ALIGN_KERNEL


def read(ctx):
    launches = ctx["launches"]
    kernel_ns = sum(ns for name, ns in ctx.get("kernel_ns", {}).items()
                    if ALIGN_KERNEL in name)
    peaks = ctx["roofline"].PEAKS.get(ctx.get("card"))
    if not launches or not kernel_ns or peaks is None:
        return None
    clock = ctx["clock"]["sm_clock_hz"] or peaks["max_sm_clock_hz"]
    ops = nbytes = 0
    for launch in launches:
        for tables in launch["tables"]:
            spec = tables.spec
            o, b = ctx["roofline"].launch_work(
                launch["enc"], launch["lengths"], tables.table, tables.m,
                tables.k, spec.start_in_query, spec.stop_in_query,
                launch["pack2"], launch["wide"])
            ops += o
            nbytes += b
    least_s = max(ops / (ctx["sms"] * peaks["int32_lanes_per_sm"] * clock),
                  nbytes / peaks["bytes_per_s"])
    return 100.0 * least_s / (kernel_ns / 1e9)
