"""Seconds of the traced assemble() call outside every stage wall: input
reading, correct_head, logging and the pipeline's own glue.

The call's wall (host clock, ended by a CUDA synchronisation) less the
sum of its stage walls (`hinge_tpu_torch.utils.log.timings()`)."""


def read(ctx):
    if not ctx["stages"]:
        return None
    return ctx["wall_s"] - sum(ctx["stages"].values())
