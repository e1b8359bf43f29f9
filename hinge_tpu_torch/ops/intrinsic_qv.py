"""Copied from hinge_tpu/ops/intrinsic_qv.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Intrinsic quality values from overlap pileups (DASqv equivalent).

The reference pipeline's QV track comes from DASCRUBBER's DASqv, which
scores each tspace segment of a read by the alignment-difference rates of
the overlaps covering it (SURVEY.md L0; the track is consumed via
LAInterface::getQV, LAInterface.cpp:4369-4494).  This module computes the
same kind of per-segment quality directly from the `.las` trace points —
pair k of an overlap's trace carries (diffs, b-displacement) for one
A-segment (align.h:88-125) — so fasta+las pipelines get a usable QV track
without external tools.

qv[read, seg] = round(50 * mean(diffs) / tspace) over covering overlaps,
clipped to [0, 50]; uncovered segments get 51 (treated as bad by the
filter's <40 binarization, filter.cpp:311).
"""

from __future__ import annotations

import numpy as np

from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore


def compute_intrinsic_qv(
    ov: OverlapStore,
    read_len: np.ndarray,
    tspace: int = 100,
    scale: int = 50,
    uncovered: int = 51,
):
    """Returns (qv_off int64 [n+1], qv_val uint8 flat) per-tspace-segment QVs."""
    n_reads = len(read_len)
    nseg = (read_len.astype(np.int64) + tspace - 1) // tspace
    qv_off = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(nseg, out=qv_off[1:])
    total = int(qv_off[-1])
    dsum = np.zeros(total, dtype=np.int64)
    dcnt = np.zeros(total, dtype=np.int64)

    sel = ov.a_id != ov.b_id
    idx = np.nonzero(sel)[0]
    if len(idx):
        npairs = (ov.tlen[idx] // 2).astype(np.int64)
        tot_pairs = int(npairs.sum())
        # flat per-pair arrays (same layout as classify.build_trace_walk)
        pair_base = np.zeros(len(idx), dtype=np.int64)
        np.cumsum(npairs[:-1], out=pair_base[1:])
        k = np.arange(tot_pairs, dtype=np.int64)
        k -= np.repeat(pair_base, npairs)
        src = (k << 1) + np.repeat(ov.trace_off[idx], npairs)
        diffs = ov.trace[src].astype(np.int64)  # even positions = diffs
        # A segment index per pair: seg0 = a_start // tspace, then +k
        seg0 = np.repeat((ov.a_start[idx] // tspace).astype(np.int64), npairs)
        seg = seg0 + k
        read = np.repeat(ov.a_id[idx].astype(np.int64), npairs)
        flat = qv_off[read] + seg
        ok = seg < np.repeat(nseg[ov.a_id[idx]], npairs)
        np.add.at(dsum, flat[ok], diffs[ok])
        np.add.at(dcnt, flat[ok], 1)

    qv = np.full(total, uncovered, dtype=np.int64)
    covered = dcnt > 0
    qv[covered] = np.clip(
        np.round(scale * (dsum[covered] / dcnt[covered]) / tspace).astype(np.int64),
        0, scale,
    )
    return qv_off, qv.astype(np.uint8)


def attach_intrinsic_qv(rs: ReadStore, ov: OverlapStore, tspace: int = 100) -> ReadStore:
    """Fill rs.qv_off/qv_val in place when no qual track is present."""
    if rs.has_qv():
        return rs
    qv_off, qv_val = compute_intrinsic_qv(ov, rs.length, tspace)
    rs.qv_off = qv_off
    rs.qv_val = qv_val
    return rs
