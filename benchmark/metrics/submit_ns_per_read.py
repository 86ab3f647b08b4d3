"""submit (batch_pipeline.BatchPipelineEngine.submit: host stages,
prefilter, lane split, encode, upload, launch): the harness's spans
around each engine's submit, summed over the window, per read."""


def read(ctx):
    ns = ctx["spans"].total_ns("submit")
    return ns / ctx["reads"] if ns and ctx["reads"] else None
