"""Overlap classification and trace-point coordinate walks.

Port of `hinge_tpu/ops/classify.py`.  `matching_position` is a torch op;
the host helpers and constants are carried over unchanged because their
module imports jax.  The trim lattice (`_lattice_points`, `trim_overlaps`,
`add_types_asymmetric`), which runs only when the native trim library is
missing, is not ported yet (ROADMAP queue item 2).
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
