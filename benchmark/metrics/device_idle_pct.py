"""device: the share of the window in which no kernel, copy or set ran
on the card (the union of their intervals in the profiler's trace), in
percent."""


def read(ctx):
    if "busy_ns" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / 1e9 / ctx["window_s"])
