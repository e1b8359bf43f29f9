"""Device-side consensus column vote as torch ops.

Port of `hinge_tpu/ops/consensus_vote.py` (consensus.cpp:162-230): every
read's alignment rows are one flat column vector per chunk, and

  * chop_end's leading-gap skip is a rank query into the running non-gap
    count (`torch.searchsorted`),
  * each read's kept column range is a +1/-1 boundary scatter and a
    cumulative sum,
  * contig positions are a second cumulative sum plus a per-segment affine
    offset rethreaded through a difference scatter,
  * the vote tables take four `index_add_`s on int32 tables, with the
    out-of-range columns masked out first.

Integer-exact: the tables equal `stages/consensus.py::_vote_tallies` and
hinge_tpu's device vote bit for bit.  Shapes are dynamic, so there are no
pow2 buckets; chunks of whole reads keep the device working set bounded.
The multi-chip `sharded_vote_tallies` is not ported (ROADMAP queue item 6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hinge_tpu_torch.device import to_device

GAP = 4

#: device launches of vote_chunk, read by chip_smoke.py to prove the
#: consensus stage went through this module
launches = {"vote_chunk": 0}


def vote_chunk(scores, cov, ins_score, ins_scores, flat_a, flat_b, seg_off,
               pos0, alen: int, chop: int) -> None:
    """One chunk's vote, accumulated in place into the running tables.

    scores/ins_scores int32 [alen*5]; cov/ins_score int32 [alen]; flat_a,
    flat_b uint8 [C]; seg_off int64 [NSEG+1] (column starts, last = C);
    pos0 int64 [NSEG].  Mirrors hinge_tpu's `_vote_chunk_kernel`."""
    if flat_a.is_cuda:
        launches["vote_chunk"] += 1
    chunk = flat_a.shape[0]
    dev = flat_a.device
    i64 = torch.int64
    a_nogap = flat_a != GAP
    # P[j] = non-gaps strictly before column j (exclusive prefix)
    P = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                   torch.cumsum(a_nogap, 0)])
    seg_start = seg_off[:-1]
    seg_len = seg_off[1:] - seg_start

    # chop_end: first column >= chop with A non-gap, else seg_len
    s = seg_start + torch.clamp(seg_len, max=chop)
    j = torch.searchsorted(P[1:], P[s] + 1, right=False)
    hit = j < seg_off[1:]
    first_k = torch.where(hit, j - seg_start, seg_len)
    big = seg_len >= 2 * chop + 10
    start_k = torch.where(big, first_k, 0)
    end_k = torch.where(big, seg_len - chop, seg_len)
    offset = P[seg_start + start_k] - P[seg_start]

    # kept range per segment -> boundary scatter + cumsum
    lo = seg_start + start_k
    hi = seg_start + torch.maximum(end_k, start_k)
    d = torch.zeros(chunk + 1, dtype=i64, device=dev)
    d.index_add_(0, lo, torch.ones_like(lo))
    d.index_add_(0, hi, torch.full_like(hi, -1))
    keep = torch.cumsum(d[:chunk], 0) > 0

    x = a_nogap & keep
    C = torch.cat([torch.zeros(1, dtype=i64, device=dev), torch.cumsum(x, 0)])
    A = pos0 + offset - C[seg_start]  # affine constant per segment
    Aprev = torch.cat([A.new_zeros(1), A[:-1]])
    # empty trailing segments start at `chunk`: their difference is dropped
    inb = seg_start < chunk
    da = torch.zeros(chunk, dtype=i64, device=dev)
    da.index_add_(0, seg_start[inb], (A - Aprev)[inb])
    # pos[j] = segment's affine constant + kept non-gaps strictly before j
    pos = torch.cumsum(da, 0) + C[:-1]

    in_range = keep & (pos < alen)
    b = flat_b.to(i64)
    m_match = x & in_range
    m_ins = ~a_nogap & (flat_b != GAP) & in_range
    pm, bm = pos[m_match], b[m_match]
    pi, bi = pos[m_ins], b[m_ins]
    scores.index_add_(0, pm * 5 + bm, torch.ones_like(pm, dtype=torch.int32))
    cov.index_add_(0, pm, torch.ones_like(pm, dtype=torch.int32))
    ins_score.index_add_(0, pi, torch.ones_like(pi, dtype=torch.int32))
    ins_scores.index_add_(0, pi * 5 + bi, torch.ones_like(pi, dtype=torch.int32))


def vote_tallies_device(
    flat_a: np.ndarray, flat_b: np.ndarray, seg_len: np.ndarray,
    pos0: np.ndarray, alen: int, chop: int = 100,
    chunk_cols: int = 1 << 23, *, device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vote tables (scores[alen,5], cov, ins_score, ins_scores) accumulated
    on `device`; the contract of stages/consensus._vote_tallies.  Whole
    reads stream through vote_chunk in chunks of ~chunk_cols columns (a
    read longer than that gets a chunk of its own)."""
    dev = torch.device(device)
    n = int(seg_len.size)
    z = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)  # noqa: E731
    scores, cov, ins_score, ins_scores = z(alen * 5), z(alen), z(alen), z(alen * 5)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.asarray(seg_len, np.int64), out=seg_off[1:])
    pos0 = np.asarray(pos0, np.int64)
    s0 = 0
    while s0 < n:
        s1 = int(np.searchsorted(seg_off, seg_off[s0] + chunk_cols, "right")) - 1
        s1 = min(max(s1, s0 + 1), n)
        lo, hi = int(seg_off[s0]), int(seg_off[s1])
        vote_chunk(scores, cov, ins_score, ins_scores,
                   to_device(flat_a[lo:hi], dev), to_device(flat_b[lo:hi], dev),
                   to_device(seg_off[s0 : s1 + 1] - lo, dev),
                   to_device(pos0[s0:s1], dev), alen, chop)
        s0 = s1
    return (scores.cpu().numpy().reshape(alen, 5), cov.cpu().numpy(),
            ins_score.cpu().numpy(), ins_scores.cpu().numpy().reshape(alen, 5))
