"""linked adapters: collect's wall time blocked on the 3' phases that the
engine's worker ran (batch_pipeline.XFER["linked_back_wait_ns"], the
program's own clock around each wait), over the window, per read (a pair
is one read); None where the program has no such counter."""


def read(ctx):
    ns = ctx["xfer"].get("linked_back_wait_ns")
    return ns / ctx["reads"] if ns is not None and ctx["reads"] else None
