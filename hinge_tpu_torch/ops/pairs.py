"""Per-(A,B)-pair candidate selection and batched ProcessAlignment.

Host code carried over from `hinge_tpu/ops/pairs.py` (that module imports
jax for its device trim fallback); the semantics and the libstdc++ order
replay are documented there.  The trim runs in the native library; when
that library is missing, the trim lattice of `ops/classify.py` runs on the
caller's device instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hinge_tpu_torch.data.overlaps import OverlapStore
from hinge_tpu_torch.device import to_device
from hinge_tpu_torch.ops import classify as CL


def top_k_per_pair(ov: OverlapStore, k: int = 2) -> np.ndarray:
    """Row indices of the top-k overlaps per (a_id, b_id) pair, in the
    reference's emission order (see hinge_tpu.ops.pairs.top_k_per_pair)."""
    n = ov.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    key = ov.a_id.astype(np.int64) * (int(ov.b_id.max()) + 1) + ov.b_id
    mlen = ov.match_len().astype(np.int64)

    orders = _libstdcxx_orders()
    if orders is not None:
        umap_batch, sort_batch = orders
        order0 = np.lexsort((np.arange(n), key))
        sk = key[order0]
        first = np.ones(n, dtype=bool)
        first[1:] = sk[1:] != sk[:-1]
        grp_start = np.nonzero(first)[0]
        grp_off = np.append(grp_start, n).astype(np.int64)
        n_grp = len(grp_start)
        w = np.ascontiguousarray(mlen[order0])
        perm = np.zeros(n, dtype=np.int32)
        sort_batch(w, grp_off, n_grp, perm)
        grp_a = ov.a_id[order0[grp_start]].astype(np.int64)
        grp_b = ov.b_id[order0[grp_start]].astype(np.int32)
        grp_min_las = np.minimum.reduceat(order0, grp_off[:-1])
        ins = np.lexsort((grp_min_las, grp_a))
        a_sorted = grp_a[ins]
        a_first = np.ones(n_grp, dtype=bool)
        a_first[1:] = a_sorted[1:] != a_sorted[:-1]
        a_off = np.append(np.nonzero(a_first)[0], n_grp).astype(np.int64)
        keys_flat = np.ascontiguousarray(grp_b[ins])
        uorder = np.zeros(n_grp, dtype=np.int32)
        umap_batch(keys_flat, a_off, len(a_off) - 1, uorder)
        a_counts = np.diff(a_off)
        g_emit = ins[np.repeat(a_off[:-1], a_counts) + uorder.astype(np.int64)]
        g_size = (grp_off[g_emit + 1] - grp_off[g_emit]).astype(np.int64)
        take = np.minimum(g_size, k)
        tot = int(take.sum())
        local = np.arange(tot, dtype=np.int64)
        off_take = np.cumsum(take) - take
        local -= np.repeat(off_take, take)
        gs_rep = np.repeat(grp_off[g_emit], take)
        flat = gs_rep + local
        return order0[gs_rep + perm[flat]]

    order = np.lexsort((np.arange(n), -mlen, key))
    sk = key[order]
    first = np.ones(n, dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    grp_id = np.cumsum(first) - 1
    grp_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.arange(n) - grp_start
    n_grp = int(grp_id[-1]) + 1
    min_las = np.full(n_grp, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(min_las, grp_id, order)
    keep_mask = rank < k
    out = np.lexsort((rank[keep_mask], min_las[grp_id[keep_mask]]))
    return order[keep_mask][out]


def _libstdcxx_orders():
    """(umap_iter_order_batch, stdsort_desc_perm_batch) callables bound to
    numpy arrays, or None without the native library."""
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "umap_iter_order_batch"):
        return None
    import ctypes as c

    p32 = c.POINTER(c.c_int32)
    p64 = c.POINTER(c.c_int64)

    def umap_batch(keys, off, n_groups, out):
        lib.umap_iter_order_batch(
            keys.ctypes.data_as(p32), off.ctypes.data_as(p64),
            c.c_int64(n_groups), out.ctypes.data_as(p32))

    def sort_batch(weights, off, n_groups, out):
        lib.stdsort_desc_perm_batch(
            weights.ctypes.data_as(p64), off.ctypes.data_as(p64),
            c.c_int64(n_groups), out.ctypes.data_as(p32))

    return umap_batch, sort_batch


@dataclasses.dataclass
class ProcessedAlignments:
    """Batched ProcessAlignment outputs for selected overlap rows."""

    rows: np.ndarray  # indices into the source OverlapStore
    eff_a_match_start: np.ndarray
    eff_a_match_end: np.ndarray
    eff_b_match_start: np.ndarray
    eff_b_match_end: np.ndarray
    match_type: np.ndarray  # int32 MatchType codes
    active: np.ndarray  # bool
    weight: np.ndarray  # int32
    length: np.ndarray  # int32
    # effective read ranges (mask values) gathered per candidate, kept for
    # the layout stage's edge printing
    _ears: np.ndarray = None
    _eare: np.ndarray = None
    _ebrs: np.ndarray = None
    _ebre: np.ndarray = None


def _native_trim(sub: OverlapStore, ears, eare, ebrs, ebre, tspace: int):
    """Trace-walk trim via native/sweeps.cpp::trim_overlaps_batch; None
    without the toolchain."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "trim_overlaps_batch"):
        return None
    n = sub.n
    i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
    a0, a1 = i32(sub.a_start), i32(sub.a_end)
    b0, b1 = i32(sub.b_start), i32(sub.b_end)
    rc, tl = i32(sub.rc), i32(sub.tlen)
    toff = np.ascontiguousarray(sub.trace_off, np.int64)
    tr = np.ascontiguousarray(sub.trace, np.uint16)
    eams = np.empty(n, np.int32)
    eame = np.empty(n, np.int32)
    ebms = np.empty(n, np.int32)
    ebme = np.empty(n, np.int32)
    act = np.empty(n, np.uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.trim_overlaps_batch(
        a0.ctypes.data_as(p32), a1.ctypes.data_as(p32),
        b0.ctypes.data_as(p32), b1.ctypes.data_as(p32), rc.ctypes.data_as(p32),
        i32(ears).ctypes.data_as(p32), i32(eare).ctypes.data_as(p32),
        i32(ebrs).ctypes.data_as(p32), i32(ebre).ctypes.data_as(p32),
        tl.ctypes.data_as(p32),
        toff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(n), ctypes.c_int32(tspace),
        eams.ctypes.data_as(p32), eame.ctypes.data_as(p32),
        ebms.ctypes.data_as(p32), ebme.ctypes.data_as(p32),
        act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return eams, eame, ebms, ebme, act.view(np.bool_)


def _lattice_trim(sub: OverlapStore, ears, eare, ebrs, ebre, device):
    """The trim lattice (ops/classify.trim_overlaps) on `device`; numpy
    outputs in the order of _native_trim."""
    tw = CL.build_trace_walk(sub)
    seg_id, k_local, _ = CL.make_point_index(tw.npairs)
    dv = lambda a: to_device(np.asarray(a), device)  # noqa: E731
    out = CL.trim_overlaps(
        dv(sub.a_start), dv(sub.a_end), dv(sub.b_start), dv(sub.b_end),
        dv(sub.rc), dv(ears), dv(eare), dv(ebrs), dv(ebre),
        dv(tw.npairs), dv(tw.pair_off), dv(tw.cum), dv(seg_id), dv(k_local),
        tspace=CL.TRIM_GRID)
    eams, eame, ebms, ebme, act = (x.cpu().numpy() for x in out)
    return (eams.astype(np.int32), eame.astype(np.int32),
            ebms.astype(np.int32), ebme.astype(np.int32), act)


def process_alignments(
    ov: OverlapStore,
    rows: np.ndarray,
    eff_read_start: np.ndarray,  # int32 [n_reads] from .mas
    eff_read_end: np.ndarray,
    aln_threshold: int,
    theta: int,
    theta2: int,
    trim: bool,
    *,
    device,
) -> ProcessedAlignments:
    """Batched ProcessAlignment (maximal.cpp:65-134); the trim lattice, if
    it runs, runs on `device`."""
    sub = ov.take(rows)
    ears = eff_read_start[sub.a_id].astype(np.int32)
    eare = eff_read_end[sub.a_id].astype(np.int32)
    ebrs = eff_read_start[sub.b_id].astype(np.int32)
    ebre = eff_read_end[sub.b_id].astype(np.int32)

    if trim:
        # CL.TRIM_GRID, not ov.tspace: the reference trims on a hardcoded
        # 100-base lattice whatever the file's trace spacing is
        native = _native_trim(sub, ears, eare, ebrs, ebre, CL.TRIM_GRID)
        if native is None:
            native = _lattice_trim(sub, ears, eare, ebrs, ebre, device)
        eams, eame, ebms, ebme, act = native
    else:
        eams, eame = sub.a_start.copy(), sub.a_end.copy()
        ebms, ebme = sub.b_start.copy(), sub.b_end.copy()
        act = np.ones(len(rows), dtype=bool)

    too_short = ((ebme - ebms) < aln_threshold) | ((eame - eams) < aln_threshold)
    active = act & ~too_short
    mtype = CL.add_types_asymmetric_np(
        eams, eame, ebms, ebme, ears, eare, ebrs, ebre,
        sub.rc, theta, theta2,
    )
    mtype = np.where(active, mtype, CL.NOT_ACTIVE).astype(np.int32)
    weight = (eame - eams) + (ebme - ebms)
    length = (sub.a_end - sub.a_start) + (sub.b_end - sub.b_start)
    return ProcessedAlignments(
        rows=rows,
        eff_a_match_start=eams.astype(np.int32),
        eff_a_match_end=eame.astype(np.int32),
        eff_b_match_start=ebms.astype(np.int32),
        eff_b_match_end=ebme.astype(np.int32),
        match_type=mtype,
        active=active,
        weight=weight.astype(np.int32),
        length=length.astype(np.int32),
        _ears=ears,
        _eare=eare,
        _ebrs=ebrs,
        _ebre=ebre,
    )
