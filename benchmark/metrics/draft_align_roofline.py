"""The draft's ladder aligner's share of its roofline, in %: the least
time one H100 needs for the ladder pairs it was given (benchmark/
roofline.py::draft_align_work: the pairs' bases read once, their rows
written once, the banded fill of each pair that is not identical at the
call's band), over the CUDA-synchronised walls of the calls of
`stages.draft._align_ladder_pairs`.  The count does not depend on which
aligner runs; None when the op was never called."""

from benchmark import roofline


def read(ctx):
    return roofline.share_pct(ctx["ops"]["draft_align"])
