"""kernel (csrc/align_locate.cu) under linked adapters: the aligner's
share of its roofline over the launches of both phases, in percent, by
the yardstick of align_locate_roofline (the same reader, imported
unchanged)."""

from benchmark.metrics.align_locate_roofline import read  # noqa: F401
