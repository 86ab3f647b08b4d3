"""parse (io/chunks.parse_fastq_chunk): the harness's spans around each
chunk parsed, summed over the window, per read (a pair is one read)."""


def read(ctx):
    ns = ctx["spans"].total_ns("parse")
    return ns / ctx["reads"] if ns and ctx["reads"] else None
