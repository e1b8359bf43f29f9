"""The built-in all-vs-all overlapper on a torch device.

Port of `hinge_tpu/overlap/mapper.py::overlap_reads`.  With
HINGE_DEVICE_JOIN=1 the half-pair base records come from the device join
(`overlap/device_join.py`) on the run's device; without it, hinge_tpu's
overlap_reads runs unchanged (the native C join).  Either way the records
are then deduplicated and mirrored on the host exactly as in hinge_tpu.

There is no fallback: with the switch on, an input that the device join's
gates refuse raises ValueError instead of taking the C join.  The switch
must never reach hinge_tpu's `map_reads_to_targets(half_pairs=True)`, which
would import hinge_tpu's jax device join.
"""

from __future__ import annotations

import os

import numpy as np

from hinge_tpu.data.overlaps import OverlapStore, ReadStore
from hinge_tpu.overlap.mapper import _mirror_all, _native_scatter_copy


def overlap_reads(
    rs: ReadStore,
    k: int = 15,
    w: int = 12,
    min_span: int = 1000,
    min_hits: int = 4,
    band_width: int = 500,
    tspace: int = 100,
    *,
    device,
) -> OverlapStore:
    """All-vs-all read overlapping: every overlap as an exactly
    coordinate-mirrored (i,j)/(j,i) record pair, trivial self matches
    dropped (see hinge_tpu.overlap.mapper.overlap_reads)."""
    if os.environ.get("HINGE_DEVICE_JOIN", "") != "1":
        from hinge_tpu.overlap import mapper as M

        return M.overlap_reads(rs, k=k, w=w, min_span=min_span,
                               min_hits=min_hits, band_width=band_width,
                               tspace=tspace)
    from hinge_tpu_torch.overlap import device_join as DJ

    gate = DJ.join_gate(rs, k, w, band_width)
    if gate is not None:
        raise ValueError(f"HINGE_DEVICE_JOIN=1: the device join cannot run "
                         f"on these reads ({gate})")
    ov = DJ.overlap_base_records(
        rs, k=k, w=w, min_span=min_span, min_hits=min_hits,
        band_width=band_width, tspace=tspace, device=device)
    return dedup_and_mirror(ov, band_width, tspace)


def dedup_and_mirror(ov: OverlapStore, band_width: int,
                     tspace: int) -> OverlapStore:
    """Drop trivial self matches, keep one canonical record per unordered
    pair and synthesize its exact mirror; carried over unchanged from
    hinge_tpu.overlap.mapper.overlap_reads (after its join)."""
    diag = ov.a_start.astype(np.int64) - ov.b_start.astype(np.int64)
    trivial = (ov.a_id == ov.b_id) & (ov.rc == 0) & (np.abs(diag) < band_width)
    ov = ov.take(np.nonzero(~trivial)[0])

    # keep one canonical record per unordered pair (largest summed length,
    # then lowest ids) and synthesize its exact mirror
    mlen = ov.match_len()
    lo = np.minimum(ov.a_id, ov.b_id)
    hi = np.maximum(ov.a_id, ov.b_id)
    span_key = np.minimum(ov.a_start, ov.b_start)  # separate repeat intervals
    order = np.lexsort((ov.a_id, -mlen, span_key // (4 * band_width), lo, hi))
    # first row in `order` per (lo, hi, rc, span-bin) key, fully vectorized
    pos_in_order = np.empty(ov.n, dtype=np.int64)
    pos_in_order[order] = np.arange(ov.n, dtype=np.int64)
    spanbin = span_key // (4 * band_width)
    ko = np.lexsort((pos_in_order, spanbin, ov.rc, hi, lo))
    first = np.ones(ov.n, dtype=bool)
    if ov.n > 1:
        first[1:] = (
            (lo[ko][1:] != lo[ko][:-1]) | (hi[ko][1:] != hi[ko][:-1])
            | (ov.rc[ko][1:] != ov.rc[ko][:-1])
            | (spanbin[ko][1:] != spanbin[ko][:-1])
        )
    keep_rows = np.sort(ko[first])
    base = ov.take(keep_rows)

    m_cols, m_trace, m_tlen = _mirror_all(base, tspace)
    n2 = 2 * base.n
    cols = {}
    for kk in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
               "b_start", "b_end", "rc", "diffs"):
        out = np.empty(n2, dtype=np.int64)
        out[0::2] = getattr(base, kk)
        out[1::2] = m_cols[kk]
        cols[kk] = out
    tlen = np.empty(n2, dtype=np.int64)
    tlen[0::2] = base.tlen
    tlen[1::2] = m_tlen
    # interleave trace chunks: canonical record r, then its mirror
    toff = np.zeros(n2 + 1, dtype=np.int64)
    np.cumsum(tlen, out=toff[1:])
    trace = np.zeros(int(toff[-1]), dtype=np.uint16)
    for src, src_off, dst_off in (
        (base.trace, base.trace_off, toff[0::2]),
        (m_trace, np.cumsum(m_tlen) - m_tlen, toff[1::2]),
    ):
        lens = np.asarray(tlen[0::2] if src is base.trace else m_tlen,
                          dtype=np.int64)
        tot = int(lens.sum())
        if tot == 0:
            continue
        if not _native_scatter_copy(src, src_off, lens, trace, dst_off):
            rows = np.repeat(np.arange(base.n, dtype=np.int64), lens)
            intra = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens)
            trace[np.asarray(dst_off)[rows] + intra] = src[
                np.asarray(src_off)[rows] + intra]
    return OverlapStore.from_arrays(
        tspace=tspace, trace=trace, tlen=tlen, **cols,
    ).sort_by_a()
