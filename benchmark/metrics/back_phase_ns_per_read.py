"""linked adapters: the emit thread's wall time in the 3' phase, from the
remainders through their dispatch to the fetched results
(batch_pipeline.XFER["linked_back_ns"], the program's own clock at the
phase's two ends), over the window, per read (a pair is one read); None
where the program has no such counter."""


def read(ctx):
    ns = ctx["xfer"].get("linked_back_ns")
    return ns / ctx["reads"] if ns is not None and ctx["reads"] else None
