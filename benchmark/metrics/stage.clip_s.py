"""Seconds in clip: the G0-G3 graphs and their graphml files.

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("clip",)


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
