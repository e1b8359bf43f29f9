"""The share of the traced assemble() call in which the device ran
nothing: 1 - (union of the trace's kernel, copy and set spans) / the
call's traced wall (benchmark/trace.py)."""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
