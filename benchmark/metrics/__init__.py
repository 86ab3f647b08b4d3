"""Per-layer metric readers, one file per metric of BENCHMARK.json's
``per_layer``: ``read(ctx)`` returns the metric's value from what the
traced run recorded (run.py:_reader_context), or None where there is
nothing to read, and the metric is then left out of the result."""
