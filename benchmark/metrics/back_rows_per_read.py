"""linked adapters: the remainders that the 3' phase hands to the
aligner on the emit thread (batch_pipeline.XFER["linked_back_rows"],
those past its prefilter) over the window, per read (a pair is one
read); None where the program has no such counter."""


def read(ctx):
    rows = ctx["xfer"].get("linked_back_rows")
    return rows / ctx["reads"] if rows is not None and ctx["reads"] else None
