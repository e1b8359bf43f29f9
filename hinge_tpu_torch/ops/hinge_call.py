"""Hinge calling (filter.cpp:838-1070) as one batched torch op.

Port of `hinge_tpu/ops/hinge_call.py`; the [tasks, pileup] formulation,
its derivation and the scan-order semantics are documented there.  The
row-wise `jax.vmap(jnp.searchsorted)` becomes `torch.searchsorted` on a
2-D sorted tensor, `take_along_axis` becomes `torch.gather` with int64
indices, and every cumulative count is kept int32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hinge_tpu_torch.device import to_device, to_host

I32 = torch.int32
_BIG = 1 << 29  # > any read coordinate/overhang; non-supporters sort last


def _hinge_kernel(pos_a, grad, m0, m1, rid, ams, ame, lov, rov, valid,
                  ordidx=None, *, theta: int, htl: int, hbl: int, hrut: int,
                  hbpt: int):
    """tasks: pos_a/grad/m0/m1/rid int32 [T]; per-read padded rows
    ams/ame/lov/rov int32 [R, P], valid bool [R, P]; ordidx (optional)
    int32 [T, P] per-task scan order (entries >= P are padding).
    Returns (bridged bool [T], support int32 [T])."""
    r = rid.long()
    A0, A1, LO, RO, VV = ams[r], ame[r], lov[r], rov[r], valid[r]
    pos = pos_a[:, None]
    is_out = (grad == -1)[:, None]

    near_out = (A1 > pos - htl) & (A1 < pos + htl) & (RO > theta) & VV
    near_in = (A0 > pos - htl) & (A0 < pos + htl) & (LO > theta) & VV
    near = torch.where(is_out, near_out, near_in)
    support = near.sum(dim=1, dtype=I32)

    first = torch.where(is_out, A0, A1)
    second = torch.where(is_out, LO, RO)
    P = first.shape[1]
    if ordidx is not None:
        in_range = ordidx < P
        order = torch.clamp(ordidx, 0, P - 1).long()
        vals = near.gather(1, order) & in_range
    else:
        # lexicographic (first, second) order via two stable argsorts
        k2 = torch.where(near, torch.where(is_out, second, -second), _BIG)
        o1 = torch.argsort(k2, dim=1, stable=True)
        k1 = torch.where(near, torch.where(is_out, first, -first), _BIG)
        o2 = torch.argsort(k1.gather(1, o1), dim=1, stable=True)
        order = o1.gather(1, o2)
        vals = near.gather(1, order)
    firs = first.gather(1, order)
    secs = second.gather(1, order)

    mask_ref = torch.where(is_out, m0[:, None], m1[:, None])
    dist = torch.where(is_out, firs - mask_ref, mask_ref - firs)
    a_flag = vals & (dist < hbl)
    b_flag = vals & ~a_flag & (secs < theta)
    c_flag = vals & ~a_flag & (secs > theta)

    considered = torch.cumsum((a_flag | b_flag | c_flag).to(I32), dim=1,
                              dtype=I32)
    extending = torch.cumsum(a_flag.to(I32), dim=1, dtype=I32)
    first0 = firs[:, :1]
    spread = torch.where(is_out, firs - first0, first0 - firs)
    fail = (a_flag | b_flag) & (
        (extending > hrut) | ((considered > hrut) & (spread > hbl)))

    # pileup window at each element: the primary key is non-decreasing
    # along each row, so one row-wise searchsorted gives the window end
    g = torch.where(vals, torch.where(is_out, firs, -firs), _BIG).contiguous()
    upto = torch.searchsorted(g, g + hbl, side="left", out_int32=True)
    idxs = torch.arange(P, dtype=I32, device=g.device)[None, :]
    succ = c_flag & ((upto - idxs) > hbpt)

    fail_idx = torch.where(fail, idxs, P).min(dim=1).values
    succ_idx = torch.where(succ, idxs, P).min(dim=1).values
    bridged = ~(fail_idx < succ_idx)
    return bridged, support


def introsort_perm(keys: np.ndarray, descending: bool) -> np.ndarray:
    """The exact std::sort permutation (libstdc++ introsort) for a
    single-key comparator, by the native oracle.

    Host code, carried over from
    `hinge_tpu/ops/hinge_call.py::introsort_perm` (that module imports
    jax), less its stable argsort for a missing native library."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if not descending:
        keys = -keys
    lib = get_lib()
    out = np.zeros(len(keys), np.int32)
    lib.stdsort_desc_perm(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(keys)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def task_scan_orders(tasks, pos_a, grad, read_rows, P: int, theta: int,
                     htl: int) -> np.ndarray:
    """Per-task supporter scan order [T, P] in the reference's
    std::sort(pairAscend/pairDescend) order; entries >= P mark padding.

    Host code, carried over unchanged from
    `hinge_tpu/ops/hinge_call.py::task_scan_orders`."""
    T = len(pos_a)
    out = np.full((T, P), P, np.int32)
    for t in range(T):
        r = int(tasks[t][0])
        a0, a1, lo, ro = read_rows[r]
        pos = int(pos_a[t])
        if int(grad[t]) == -1:
            near = (a1 > pos - htl) & (a1 < pos + htl) & (ro > theta)
            first = a0
            desc = False
        else:
            near = (a0 > pos - htl) & (a0 < pos + htl) & (lo > theta)
            first = a1
            desc = True
        idx = np.nonzero(near)[0]
        if len(idx):
            perm = introsort_perm(first[idx], descending=desc)
            out[t, : len(idx)] = idx[perm]
    return out


def call_hinges_device(
    tasks, pos_a: np.ndarray, grad: np.ndarray, m0: np.ndarray,
    m1: np.ndarray,
    read_rows: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    theta: int, htl: int, hbl: int, hrut: int, hbpt: int, *, device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad each task's read pileup into a [R, P] bucket and run
    `_hinge_kernel` on `device`.  read_rows maps read id -> (ams, ame,
    left_ovh, right_ovh) in the reference's pileup order.  Returns
    (bridged bool [T], support int32 [T])."""
    T = len(pos_a)
    if T == 0:
        return np.zeros(0, bool), np.zeros(0, np.int32)
    rids_unique = sorted({int(r) for r, _ in tasks})
    rmap = {r: k for k, r in enumerate(rids_unique)}
    pmax = max(len(read_rows[r][0]) for r in rids_unique)
    P = 8
    while P < pmax:
        P *= 2
    R = len(rids_unique)
    cols = np.zeros((4, R, P), np.int32)
    valid = np.zeros((R, P), bool)
    for r in rids_unique:
        k = rmap[r]
        n = len(read_rows[r][0])
        for c in range(4):
            cols[c, k, :n] = read_rows[r][c]
        valid[k, :n] = True
    rid = np.array([rmap[int(r)] for r, _ in tasks], np.int32)
    ordidx = task_scan_orders(tasks, pos_a, grad, read_rows, P,
                              theta=theta, htl=htl)
    i32 = lambda a: to_device(np.asarray(a, np.int32), device)  # noqa: E731
    bridged, support = _hinge_kernel(
        i32(pos_a), i32(grad), i32(m0), i32(m1), i32(rid),
        *(to_device(cols[c], device) for c in range(4)),
        to_device(valid, device), to_device(ordidx, device),
        theta=theta, htl=htl, hbl=hbl, hrut=hrut, hbpt=hbpt)
    return to_host(bridged), to_host(support)
