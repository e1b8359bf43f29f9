"""The least time an op could take on one NVIDIA H100 SXM, counted from
the op's inputs and outputs alone, frozen here so that it reads the same
work whatever implements the op.

A bound is max(bytes / HBM bandwidth, operations / the peak of their
type): each input byte read once, each output byte written once, the
operations the problem needs (not what an implementation issues).  A
share is 100 x (sum of bounds) / (sum of CUDA-synchronised walls) over
an op's calls; the card's power limit is printed beside it.
"""

from __future__ import annotations

#: published peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s, and
#: 32-bit integer operations/s (132 SMs x 64 INT32 lanes x 1.98 GHz)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9

#: integer operations of one cell of a banded edit-distance fill: the
#: base compare, the diagonal add, the min of up and left, the move
ALIGN_OPS_PER_CELL = 4
#: bytes of an alignment row written per base of the longer sequence
#: (the q row and the t row, a byte a column, at least that long)
ALIGN_ROW_BYTES = 2
#: p3: q and t (int64) of every anchor read; a kept anchor's q, t, row
#: (int64) written; a row's start read (int64) and its fr_start, fr_end,
#: Q0, Q1, T0, T1, nb (int64) and ok flag (byte) written
THIN_BYTES_PER_ANCHOR = 16
THIN_BYTES_PER_KEPT = 24
THIN_BYTES_PER_ROW = 8 + 7 * 8 + 1
#: p3's operations: the greedy gap test of an anchor (subtract, compare)
#: and of the t filter on it; the span arithmetic of a row
THIN_OPS_PER_ANCHOR = 4
THIN_OPS_PER_ROW = 16


def bound_s(nbytes: float, nops: float) -> float:
    """The least seconds for `nbytes` moved and `nops` 32-bit integer
    operations."""
    return max(nbytes / HBM_BYTES_S, nops / INT32_OPS_S)


def draft_align_work(lens_q, lens_t, identical, band: int) -> tuple:
    """(bytes, operations) of the draft's ladder alignment: for each pair
    its q and t read once and its two rows written (at least as long as
    the longer); for each pair that is not identical, the banded fill of
    its cells, (len(q) + 1) x min(len(t) + 1, 2 x band + 1) of them.
    The lengths, the identical flags and the band are the op's inputs."""
    nbytes = ops = 0
    w = 2 * int(band) + 1
    for lq, lt, same in zip(lens_q, lens_t, identical):
        nbytes += lq + lt + ALIGN_ROW_BYTES * max(lq, lt)
        if not same:
            ops += ALIGN_OPS_PER_CELL * (lq + 1) * min(lt + 1, w)
    return nbytes, ops


def join_thin_work(n_a: int, n_f: int, n_rows: int) -> tuple:
    """(bytes, operations) of the join's p3 on one block of n_a anchors,
    n_f of them kept, in n_rows rows."""
    nbytes = (THIN_BYTES_PER_ANCHOR * n_a + THIN_BYTES_PER_KEPT * n_f
              + THIN_BYTES_PER_ROW * n_rows)
    ops = THIN_OPS_PER_ANCHOR * n_a + THIN_OPS_PER_ROW * n_rows
    return nbytes, ops


def share_pct(calls) -> "float | None":
    """100 x the summed bound over the summed wall of `calls`, a list of
    (bytes, operations, seconds); None when there is no call."""
    if not calls:
        return None
    bound = sum(bound_s(b, o) for b, o, _ in calls)
    wall = sum(s for _, _, s in calls)
    return 100.0 * bound / wall
