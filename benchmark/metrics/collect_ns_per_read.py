"""collect and emit (the drive's emit in accel: each engine's collect,
the assembly of the output records, the writes, the statistics): the
harness's spans around each emit, summed over the window, per read."""


def read(ctx):
    ns = ctx["spans"].total_ns("emit")
    return ns / ctx["reads"] if ns and ctx["reads"] else None
