"""Overlap classification and trace-point coordinate walks.

Port of `hinge_tpu/ops/classify.py`.  `matching_position` and the trim
lattice (`lattice_points`, `trim_overlaps`, `add_types_asymmetric`, which
`ops/pairs.process_alignments` runs when the native trim library is
missing) are torch ops on the tensors' device; the host helpers and
constants are carried over unchanged because their module imports jax.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# MatchType enum (LAInterface.h:30-32)
FORWARD = 0
BACKWARD = 1
ACOVERB = 2
BCOVERA = 3
UNDEFINED = 4
#: the reference walks the trace lattice on a hardcoded 100-base grid
#: whatever the file's trace spacing (see hinge_tpu/ops/classify.py)
TRIM_GRID = 100
INTERNAL = 5
NOT_ACTIVE = 6
FORWARD_INTERNAL = 12
BACKWARD_INTERNAL = 13


class TraceWalk(NamedTuple):
    """Host-prepped flat lattice arrays for a batch of overlaps."""

    npairs: np.ndarray  # int32 [n_ov] trace pairs per overlap (tlen//2)
    pair_off: np.ndarray  # int64 [n_ov] first pair index in disp/cum arrays
    disp: np.ndarray  # int32 [total_pairs] b-displacement per pair
    cum: np.ndarray  # int32 [total_pairs] inclusive prefix sum within overlap


def build_trace_walk(ov) -> TraceWalk:
    """Displacement prefix-sums from an OverlapStore (host, one pass);
    carried over unchanged from hinge_tpu.ops.classify."""
    npairs = (ov.tlen // 2).astype(np.int32)
    pair_off = np.zeros(ov.n, dtype=np.int64)
    np.cumsum(npairs[:-1], out=pair_off[1:])
    total = int(npairs.sum())
    src = np.arange(total, dtype=np.int64)
    src -= np.repeat(pair_off, npairs)  # local pair index k
    src <<= 1
    src += 1
    src += np.repeat(ov.trace_off, npairs)
    disp = ov.trace[src].astype(np.int32)
    csum = np.cumsum(disp, dtype=np.int64)
    seg_start = csum[pair_off] - disp[pair_off]
    cum = csum
    cum -= np.repeat(seg_start, npairs)
    return TraceWalk(npairs=npairs, pair_off=pair_off, disp=disp, cum=cum.astype(np.int32))


def make_point_index(npairs: np.ndarray):
    """Flat (seg_id, k_local, point_off) for npairs+1 points per overlap;
    carried over unchanged from hinge_tpu.ops.classify for the trim
    lattice."""
    npts = npairs.astype(np.int64) + 1
    point_off = np.zeros(len(npairs), dtype=np.int64)
    np.cumsum(npts[:-1], out=point_off[1:])
    total = int(npts.sum())
    seg_id = np.repeat(np.arange(len(npairs), dtype=np.int32), npts)
    k_local = np.arange(total, dtype=np.int64)
    k_local -= np.repeat(point_off, npts)
    return seg_id, k_local.astype(np.int32), point_off


def add_types_asymmetric_np(
    eff_a_match_start, eff_a_match_end, eff_b_match_start, eff_b_match_end,
    eff_a_read_start, eff_a_read_end, eff_b_read_start, eff_b_read_end,
    rc, max_overhang, min_overhang,
):
    """Batched LOverlap::AddTypesAsymmetric (LAInterface.cpp:4721-4806) in
    numpy; carried over unchanged from hinge_tpu.ops.classify."""
    oal = eff_a_match_start - eff_a_read_start
    oar = eff_a_read_end - eff_a_match_end
    obl0 = eff_b_match_start - eff_b_read_start
    obr0 = eff_b_read_end - eff_b_match_end
    obl = np.where(rc == 1, obr0, obl0)
    obr = np.where(rc == 1, obl0, obr0)

    c_bcovera = (np.maximum(oal, oar) < max_overhang) & (np.minimum(obl, obr) > min_overhang)
    c_acoverb = (np.maximum(obl, obr) < max_overhang) & (np.minimum(oal, oar) > min_overhang)
    c_internal = np.minimum(oal, oar) > max_overhang
    c_left = oal <= max_overhang
    c_bwd = (obr <= max_overhang) & (obl >= max_overhang)
    c_bwd_int = (obr >= max_overhang) & (obl >= max_overhang)
    c_right = oar <= max_overhang
    c_fwd = (obl <= max_overhang) & (obr >= max_overhang)
    c_fwd_int = (obl >= max_overhang) & (obr >= max_overhang)

    t = np.where(
        c_bcovera, BCOVERA,
        np.where(
            c_acoverb, ACOVERB,
            np.where(
                c_internal, INTERNAL,
                np.where(
                    c_left,
                    np.where(c_bwd, BACKWARD, np.where(c_bwd_int, BACKWARD_INTERNAL, UNDEFINED)),
                    np.where(
                        c_right,
                        np.where(c_fwd, FORWARD, np.where(c_fwd_int, FORWARD_INTERNAL, UNDEFINED)),
                        UNDEFINED,
                    ),
                ),
            ),
        ),
    )
    return t.astype(np.int32)


def lattice_points(a_start, a_end, b_start, b_end, rc, npairs, pair_off,
                   cum, seg_id, k_local, tspace: int):
    """Flat lattice point coordinates (A_k, W_k) for all overlaps, int32.

    seg_id/k_local index the flat point array (one overlap has npairs+1
    points); W_k = w0 + sign * cum[pair_off + k - 1]."""
    s = seg_id.long()
    a0 = a_start[s]
    npr = npairs[s]
    interior = (torch.div(a0, tspace, rounding_mode="floor") + k_local) * tspace
    A = torch.where(k_local == 0, a0,
                    torch.where(k_local == npr, a_end[s], interior))
    is_rc = rc[s] == 1
    sign = torch.where(is_rc, -1, 1)
    w0 = torch.where(is_rc, b_end[s], b_start[s])
    wend = torch.where(is_rc, b_start[s], b_end[s])
    # jax clamps out-of-range gathers; the value is used only when k > 0
    cidx = torch.clamp(pair_off[s] + torch.clamp(k_local - 1, min=0), 0,
                       max(cum.shape[0] - 1, 0))
    csum = torch.where(k_local == 0, 0, cum[cidx]) if cum.numel() else \
        torch.zeros_like(k_local)
    W = torch.where(k_local == npr, wend, w0 + sign * csum)
    return A.to(torch.int32), W.to(torch.int32)


def trim_overlaps(a_start, a_end, b_start, b_end, rc,
                  eff_a_read_start, eff_a_read_end, eff_b_read_start,
                  eff_b_read_end, npairs, pair_off, cum, seg_id, k_local, *,
                  tspace: int):
    """Batched LOverlap::trim_overlap (LAInterface.cpp:4552-4683).

    eff_*_read_* are the per-overlap read masks.  Returns
    (eff_a_match_start, eff_a_match_end, eff_b_match_start,
    eff_b_match_end, active); the first/last lattice point that satisfies
    each predicate is a segment min/max (`scatter_reduce`)."""
    n_ov = a_start.shape[0]
    A, W = lattice_points(a_start, a_end, b_start, b_end, rc, npairs,
                          pair_off, cum, seg_id, k_local, tspace)
    s = seg_id.long()
    rcs = rc[s] == 1
    # start predicate: rc=0 -> A>=eas & W>=ebs ; rc=1 -> A>=eas & W<=ebe
    start_ok = (A >= eff_a_read_start[s]) & torch.where(
        rcs, W <= eff_b_read_end[s], W >= eff_b_read_start[s])
    # end predicate:   rc=0 -> A<=eae & W<=ebe ; rc=1 -> A<=eae & W>=ebs
    end_ok = (A <= eff_a_read_end[s]) & torch.where(
        rcs, W >= eff_b_read_start[s], W <= eff_b_read_end[s])

    BIG = 1 << 30
    kl = k_local.long()
    first_k = torch.full((n_ov,), BIG, dtype=torch.int64, device=A.device)
    first_k.scatter_reduce_(0, s, torch.where(start_ok, kl, BIG), "amin")
    last_k = torch.full((n_ov,), -1, dtype=torch.int64, device=A.device)
    last_k.scatter_reduce_(0, s, torch.where(end_ok, kl, -1), "amax")
    npr = npairs.long()
    sidx = torch.where(first_k >= BIG, npr + 1, first_k)
    eidx = torch.where(last_k < 0, 0, last_k)

    # point offsets: pair_off + overlap index (each overlap adds one point)
    pt_off = pair_off.long() + torch.arange(n_ov, device=A.device)
    si = pt_off + torch.minimum(sidx, npr)
    ei = pt_off + torch.minimum(eidx, npr)
    sA, sW, eA, eW = A[si], W[si], A[ei], W[ei]

    found_s = first_k < BIG
    found_e = last_k >= 0
    eff_a_ms = torch.where(found_s, sA, a_start)
    eff_a_me = torch.where(found_e, eA, a_end)
    # rc=0: start point carries (ams,bms), end point (ame,bme)
    # rc=1: start point carries (ams,bme), end point (ame,bms)
    is_rc = rc == 1
    eff_b_ms = torch.where(is_rc, torch.where(found_e, eW, b_start),
                           torch.where(found_s, sW, b_start))
    eff_b_me = torch.where(is_rc, torch.where(found_s, sW, b_end),
                           torch.where(found_e, eW, b_end))
    active = sidx < eidx  # (LAInterface.cpp:4667-4670)
    return eff_a_ms, eff_a_me, eff_b_ms, eff_b_me, active


def add_types_asymmetric(
    eff_a_match_start, eff_a_match_end, eff_b_match_start, eff_b_match_end,
    eff_a_read_start, eff_a_read_end, eff_b_read_start, eff_b_read_end,
    rc, max_overhang, min_overhang,
) -> torch.Tensor:
    """Batched LOverlap::AddTypesAsymmetric (LAInterface.cpp:4721-4806) as
    a torch op, int32 MatchType codes."""
    oal = eff_a_match_start - eff_a_read_start
    oar = eff_a_read_end - eff_a_match_end
    obl0 = eff_b_match_start - eff_b_read_start
    obr0 = eff_b_read_end - eff_b_match_end
    is_rc = rc == 1
    obl = torch.where(is_rc, obr0, obl0)
    obr = torch.where(is_rc, obl0, obr0)

    c_bcovera = (torch.maximum(oal, oar) < max_overhang) & (torch.minimum(obl, obr) > min_overhang)
    c_acoverb = (torch.maximum(obl, obr) < max_overhang) & (torch.minimum(oal, oar) > min_overhang)
    c_internal = torch.minimum(oal, oar) > max_overhang
    c_left = oal <= max_overhang
    c_bwd = (obr <= max_overhang) & (obl >= max_overhang)
    c_bwd_int = (obr >= max_overhang) & (obl >= max_overhang)
    c_right = oar <= max_overhang
    c_fwd = (obl <= max_overhang) & (obr >= max_overhang)
    c_fwd_int = (obl >= max_overhang) & (obr >= max_overhang)

    # the if/else-if cascade in priority order; the BACKWARD branch leaves
    # UNDEFINED when neither sub-case fires, the FORWARD branch likewise
    w = torch.where
    t = w(c_bcovera, BCOVERA,
          w(c_acoverb, ACOVERB,
            w(c_internal, INTERNAL,
              w(c_left,
                w(c_bwd, BACKWARD, w(c_bwd_int, BACKWARD_INTERNAL, UNDEFINED)),
                w(c_right,
                  w(c_fwd, FORWARD, w(c_fwd_int, FORWARD_INTERNAL, UNDEFINED)),
                  UNDEFINED)))))
    return t.to(torch.int32)


def matching_position(ov_idx, pos_a, a_start, a_end, b_start, b_end, rc,
                      npairs, pair_off, cum, *, tspace: int) -> torch.Tensor:
    """Batched LOverlap::GetMatchingPosition (LAInterface.cpp:4498-4546),
    int32 [m]; the closed form is derived in hinge_tpu.ops.classify."""
    o = ov_idx.long()
    a0 = a_start[o]
    P = npairs[o]
    base = torch.div(a0, tspace, rounding_mode="floor")
    sign = 1 - 2 * rc[o]
    w0 = torch.where(rc[o] == 1, b_end[o], b_start[o])

    # smallest j >= 0 with A_{j+1} = (base+j+1)*tspace >= pos
    j_raw = torch.div(pos_a + tspace - 1, tspace, rounding_mode="floor") - base - 1
    # P <= 1 runs zero loop iterations, so it is always exhausted
    exhausted = (j_raw > P - 2) | (P <= 1)
    j = torch.clamp(torch.where(exhausted, P - 1, torch.clamp(j_raw, min=0)),
                    min=0)
    A_j = torch.where(j == 0, a0, (base + j) * tspace)
    # jax clamps out-of-range gathers; the value is used only when j > 0
    cidx = torch.clamp(pair_off[o] + torch.clamp(j - 1, min=0), 0,
                       max(cum.shape[0] - 1, 0))
    W_j = w0 + sign * torch.where(j == 0, 0, cum[cidx])
    res = W_j + pos_a - A_j
    res = torch.where(exhausted & (A_j >= pos_a), -2, res)
    out_of_range = (pos_a < a0) | (pos_a > a_end[o])
    return torch.where(out_of_range, -1, res).to(torch.int32)
