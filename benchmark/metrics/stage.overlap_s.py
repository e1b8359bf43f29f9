"""Seconds in the built-in overlapper (the device join and K4): only where
a cell's input is FASTA alone.

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("overlap",)


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
