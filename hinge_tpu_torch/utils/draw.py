"""Copied from hinge_tpu/utils/draw.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Pile-o-gram visualization of one read's overlaps (reference
scripts/draw2.py / draw2_pileup.py: alignment pile + coverage + QV panels,
one arrow-shaped patch per B-read group, groups sorted by leftmost match
start).  Matplotlib Agg only; intended for debugging, like the reference's
`parallel_draw.sh` batch plots."""

from __future__ import annotations

from typing import Optional

import numpy as np

from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore


def plot_pileup(
    ov: OverlapStore,
    rs: ReadStore,
    read_id: int,
    out_path: str,
    coverage: Optional[np.ndarray] = None,
    reso: int = 40,
) -> int:
    """Render read `read_id`'s pileup to `out_path` (png). Returns the
    number of B-read groups drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = np.nonzero(ov.a_id == read_id)[0]
    length = int(rs.length[read_id])
    # group by B read, like draw2.py:69-82
    order = rows[np.argsort(ov.b_id[rows], kind="stable")]
    groups = []
    cur_b, cur = None, []
    for r in order:
        b = int(ov.b_id[r])
        if b != cur_b and cur:
            groups.append(cur)
            cur = []
        cur_b = b
        cur.append(r)
    if cur:
        groups.append(cur)
    # sort groups by their leftmost A-start (draw2.py:88)
    groups.sort(key=lambda g: min(int(ov.a_start[r]) for r in g))
    num = max(len(groups), 1)

    fig = plt.figure(figsize=(15, 10))
    ax1 = plt.subplot2grid((6, 6), (0, 0), colspan=6, rowspan=4)
    ax2 = plt.subplot2grid((6, 6), (4, 0), colspan=6, rowspan=1, sharex=ax1)
    ax3 = plt.subplot2grid((6, 6), (5, 0), colspan=6, rowspan=1, sharex=ax1)
    tip = length / 200.0
    ax1.set_xlim(-2000, length + 2000)
    ax1.set_ylim(-5, num + 2)
    # the A read as an arrow polygon at y=0 (draw2.py:105-116)
    pts = [[0, 0], [length, 0], [length + tip, 0.25], [length, 0.5], [0, 0.5]]
    ax1.add_patch(plt.Polygon(pts, fc="r", ec="none", alpha=0.6))
    ax1.add_line(plt.Line2D((0, 0), (0, num), ls="-."))
    ax1.add_line(plt.Line2D((length, length), (0, num), ls="-."))
    for y, grp in enumerate(groups, start=1):
        for r in grp:
            a0, a1 = int(ov.a_start[r]), int(ov.a_end[r])
            rc = int(ov.rc[r])
            color = "b" if rc == 0 else "g"
            if rc == 0:
                pts = [[a0, y], [a1, y], [a1 + tip, y + 0.25], [a1, y + 0.5],
                       [a0, y + 0.5]]
            else:
                pts = [[a0, y], [a0 - tip, y + 0.25], [a0, y + 0.5],
                       [a1, y + 0.5], [a1, y]]
            ax1.add_patch(plt.Polygon(pts, fc=color, ec="none", alpha=0.6))
    ax1.set_title(f"read {read_id} pileup ({len(groups)} partners)")

    # coverage panel (draw2.py coverage subplot)
    if coverage is None:
        nb = length // reso + 2
        cov = np.zeros(nb + 1, dtype=np.int64)
        sb = np.clip(ov.a_start[rows] // reso + 1, 0, nb)
        eb = np.clip(ov.a_end[rows] // reso + 1, 0, nb)
        np.add.at(cov, sb, 1)
        np.add.at(cov, eb, -1)
        coverage = np.cumsum(cov[:nb])
    ax2.plot(np.arange(len(coverage)) * reso, coverage, "b-")
    ax2.set_ylabel("coverage")

    # QV panel when the store carries a qual track (draw2.py QV subplot)
    if rs.has_qv():
        qv = rs.qv_val[rs.qv_off[read_id]: rs.qv_off[read_id + 1]]
        ax3.plot(np.arange(len(qv)) * 100, qv, "r-")
        ax3.set_ylabel("QV")
    ax3.set_xlabel("A-read position (bp)")
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return len(groups)
