"""submit's prefilter: the reads (mates) it passes to the aligner,
batch_pipeline.XFER["candidates"] over the window, per read."""


def read(ctx):
    return ctx["xfer"]["candidates"] / ctx["reads"] if ctx["reads"] else None
