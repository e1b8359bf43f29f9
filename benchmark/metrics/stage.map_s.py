"""Seconds in mapping the reads to the draft contigs
(overlap/mapper.map_reads_to_targets).

Read from the port's own stage walls (`hinge_tpu_torch.utils.log.
timings()`, the traced call's share); None when none of them ran."""

STAGES = ("map",)


def read(ctx):
    got = [ctx["stages"][s] for s in STAGES if s in ctx["stages"]]
    return sum(got) if got else None
