"""The device join's p3 thinning's share of its roofline, in %: the least
time one H100 needs for the anchors in, anchors kept and rows of each
block (benchmark/roofline.py::join_thin_work), over the
CUDA-synchronised walls of the calls of `overlap.device_join.
thin_rows`.  None when the op was never called."""

from benchmark import roofline


def read(ctx):
    return roofline.share_pct(ctx["ops"]["join_thin"])
