"""CLI and drive (cli, accel): the mean over the window's calls of the
time from the engine run's start to its first chunk submitted
(accel.RUN_TIMES), in ms."""


def read(ctx):
    ms = [c.startup_ms for c in ctx["calls"] if c.startup_ms is not None]
    return sum(ms) / len(ms) if ms else None
