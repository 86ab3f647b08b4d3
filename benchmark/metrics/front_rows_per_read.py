"""linked adapters: the rows of the 5' phase that submit hands to the
aligner (batch_pipeline.XFER["linked_front_rows"], the windows past its
prefilter) over the window, per read (a pair is one read); None where
the program has no such counter."""


def read(ctx):
    rows = ctx["xfer"].get("linked_front_rows")
    return rows / ctx["reads"] if rows is not None and ctx["reads"] else None
