"""Pileup coverage / mask / repeat-annotation ops as torch tensor code.

Port of `hinge_tpu/ops/coverage.py` (same names, same semantics, int32
throughout); see that module for the reference derivations.  Differences
from the jnp versions that matter for exactness:

- `jnp.floor_divide` floors negative values: `torch.div(...,
  rounding_mode="floor")` does the same (`//` on tensors also floors, but
  spelling it out keeps the intent visible).
- jax scatters with mode="drop" silently ignore out-of-range indices;
  torch raises.  The grids carry a real padding row (read index n_reads)
  and slice it off, exactly as the jnp versions do.
- `torch.cumsum` of int32 returns int64 unless dtype=torch.int32.
- `jax.lax.associative_scan(jnp.maximum)` is `torch.cummax(...).values`.
- `torch.argmax` returns the first maximal index, like `jnp.argmax`.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def _fdiv(x: torch.Tensor, d) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def event_bins(values: torch.Tensor, reso: int, nb: int) -> torch.Tensor:
    """Bin index b such that bins >= b see this event: floor(value/reso)+1,
    clipped to [0, nb] (floor division, negatives ok)."""
    return torch.clamp(_fdiv(values, reso) + 1, 0, nb)


def profile_coverage(a_rel, a_start, a_end, cutoff: int, *, n_reads: int,
                     nb: int, reso: int) -> torch.Tensor:
    """Coverage counts per (read, bin), int32 [n_reads, nb]: count at bin
    b = #events < b*reso, each overlap contributing +1 at a_start+cutoff
    and -1 at a_end-cutoff.  a_rel in [0, n_reads]; n_reads is the padding
    row."""
    sb = event_bins(a_start + cutoff, reso, nb)
    eb = event_bins(a_end - cutoff, reso, nb)
    grid = torch.zeros((n_reads + 1) * (nb + 1), dtype=I32,
                       device=a_rel.device)
    row = a_rel.long() * (nb + 1)
    ones = torch.ones(a_rel.shape[0], dtype=I32, device=a_rel.device)
    grid.index_add_(0, row + sb.long(), ones)
    grid.index_add_(0, row + eb.long(), -ones)
    grid = grid.view(n_reads + 1, nb + 1)[:n_reads, :nb]
    return torch.cumsum(grid, dim=1, dtype=I32)


def pileup_stats(a_rel, a_start, a_end, *, n_reads: int):
    """(max a_end, max a_start, overlap count) per read, int32 [n_reads]."""
    dev = a_rel.device
    idx = a_rel.long()
    maxend = torch.zeros(n_reads + 1, dtype=I32, device=dev)
    maxend.scatter_reduce_(0, idx, a_end, reduce="amax")
    maxstart = torch.full((n_reads + 1,), np.iinfo(np.int32).min, dtype=I32,
                          device=dev)
    maxstart.scatter_reduce_(0, idx, a_start, reduce="amax")
    counts = torch.zeros(n_reads + 1, dtype=I32, device=dev)
    counts.index_add_(0, idx, torch.ones_like(a_rel, dtype=I32))
    return maxend[:n_reads], maxstart[:n_reads], counts[:n_reads]


def n_entries_from_max_event(max_event, counts, reso: int) -> torch.Tensor:
    """profileCoverage bin count: floor(max_event/reso)+2 when the pileup is
    nonempty, else 0."""
    ne = _fdiv(max_event, reso) + 2
    return torch.where(counts > 0, ne, 0).to(I32)


def coverage_mask(cov_cut, n_entries, *, reso: int):
    """Longest positive run with the reference's bookkeeping
    (filter.cpp:696-755).  Returns (maxstart, maxend, max_start_coord,
    max_end_coord), int32 [reads]."""
    reads, nb = cov_cut.shape
    dev = cov_cut.device
    bin_pos = torch.arange(nb, dtype=I32, device=dev)[None, :]
    valid = bin_pos < n_entries[:, None]
    pos = (cov_cut > 0) & valid
    prev_pos = torch.zeros_like(pos)
    prev_pos[:, 1:] = pos[:, :-1]
    is_start = pos & ~prev_pos
    start_idx = torch.where(is_start, bin_pos, 0)
    b0 = torch.cummax(torch.where(pos, start_idx, -1), dim=1).values
    flush = ~pos & prev_pos
    b1 = (bin_pos - 1).expand(reads, nb)
    b0f = torch.where(flush, torch.roll(b0, 1, dims=1), 0)
    b0_eff = torch.clamp(b0f, min=1)
    cand_len = torch.where(flush, (b1 - b0_eff) * reso, -1)
    ok = torch.where(flush & (b0f == 0), b1 > 0, flush)
    cand_len = torch.where(ok, cand_len, -1)
    best = torch.argmax(cand_len, dim=1, keepdim=True)
    best_len = cand_len.gather(1, best)[:, 0]
    found = best_len > 0
    bs = b0_eff.gather(1, best)[:, 0]
    be = b1.gather(1, best)[:, 0]
    maxstart = torch.where(found, bs * reso, 0).to(I32)
    maxend = torch.where(found, be * reso, 0).to(I32)
    msc = torch.where(found, bs, 0).to(I32)
    mec = torch.where(found, be, 0).to(I32)
    return maxstart, maxend, msc, mec


def qv_mask_np(good: np.ndarray, n_segs: np.ndarray, *, tspace: int):
    """Longest run of good-QV segments, last segment excluded
    (filter.cpp:343-369); returns (maxs, maxe) in base pairs.

    Host numpy, carried over unchanged from
    `hinge_tpu/ops/coverage.py::qv_mask_np` (that module imports jax)."""
    reads, nseg = good.shape
    seg = np.arange(nseg, dtype=np.int32)
    eligible = good & (seg[None, :] < (n_segs[:, None].astype(np.int64) - 1))
    prev = np.zeros_like(eligible)
    prev[:, 1:] = eligible[:, :-1]
    is_start = eligible & ~prev
    start_idx = np.where(is_start, seg[None, :], 0)
    s0 = np.maximum.accumulate(np.where(eligible, start_idx, -1), axis=1)
    pe = np.concatenate([eligible, np.zeros((reads, 1), bool)], axis=1)
    ppos = np.concatenate([np.zeros((reads, 1), bool), eligible], axis=1)
    flush = ~pe & ppos
    s0x = np.concatenate([np.full((reads, 1), -1, s0.dtype), s0], axis=1)
    e = np.arange(nseg + 1, dtype=np.int64)[None, :]
    cand = np.where(flush, e - np.maximum(s0x, 0), -1)
    best = np.argmax(cand, axis=1)
    rows = np.arange(reads)
    found = cand[rows, best] > 0
    maxs = np.where(found, np.maximum(s0x[rows, best], 0), 0)
    maxe = np.where(found, best, 0)
    return (maxs * tspace).astype(np.int32), (maxe * tspace).astype(np.int32)


def coverage_gradient(cov: torch.Tensor) -> torch.Tensor:
    """cg[j] = cov[j+1] - cov[j] (filter.cpp:604-609)."""
    return cov[:, 1:] - cov[:, :-1]


def repeat_annotation_mask(cov, n_entries, mask_start, mask_end, min_cov: int,
                           *, reso: int, coverage_fraction: int,
                           min_thresh: int, max_thresh: int,
                           no_hinge_region: int) -> torch.Tensor:
    """Gradient-threshold repeat annotations (filter.cpp:796-813): int8
    [reads, nb-1], +1 rising, -1 falling, 0 none."""
    cg = coverage_gradient(cov)
    nbm1 = cg.shape[1]
    j = torch.arange(nbm1, dtype=I32, device=cov.device)[None, :]
    pos = j * reso
    in_range = j < (n_entries[:, None] - 2)
    in_window = ((pos >= mask_start[:, None] + no_hinge_region)
                 & (pos <= mask_end[:, None] - no_hinge_region))
    thresh = torch.clamp(_fdiv(cov[:, :nbm1] + min_cov, coverage_fraction),
                         min=min_thresh, max=max_thresh)
    ann = torch.where(cg > thresh, 1, torch.where(cg < -thresh, -1, 0))
    return torch.where(in_range & in_window, ann, 0).to(torch.int8)
