"""Seconds in the draft-path and draft stages: ladder building, the ladder
aligner (K1/K2 on CUDA), the vote and row emission on the host.

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("draft_path", "draft")


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
