"""Seconds in consensus (stages/consensus with the device vote,
ops/consensus_vote) and in writing the GFA from it.

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("consensus", "gfa")


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
