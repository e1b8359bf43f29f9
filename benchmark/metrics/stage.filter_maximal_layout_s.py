"""Seconds in the filter, maximal and layout stages, whose decisions run as
device ops (ops/coverage, ops/hinge_call, ops/classify).

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("filter", "maximal", "layout")


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
