"""transfer: bytes uploaded to the card for the aligner,
batch_pipeline.XFER["h2d_bytes"] over the window, per read."""


def read(ctx):
    return ctx["xfer"]["h2d_bytes"] / ctx["reads"] if ctx["reads"] else None
