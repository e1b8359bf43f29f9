"""Copied from hinge_tpu/ops/dalign_trace.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, without hinge_tpu's Python wave (`iter_np_script`,
`script_to_rows`) that stands in when its native library does not build:
every window here is aligned by native/dalign_np.cpp.

Exact DALIGNER trace-window alignment (recoverAlignment parity).

The reference recovers full alignments from trace points by running a
private O(nd) wavefront aligner inside every trace-point window
(LAInterface::computeTracePTS -> iter_np, LAInterface.cpp:3410/3152) and
then emitting padded alignment strings (getAlignmentTags,
LAInterface.cpp:3709-3915).  Byte parity of X.draft.fasta/X.consensus.fasta
requires reproducing that specific optimal path — its wave move preference
and "uppermost" traceback normalization — not just any minimal-edit path.

Context: the wave's diagonal slides can read one byte BEFORE a window
(frontier diagonals enter the slide at j=-1) and the traceback one byte past
its end.  The reference aligns inside Load_Subread buffers spanning
[abpos-10, aepos+10) with 4-sentinels on both sides (DB.c:1449-1459,
recoverAlignment LAInterface.cpp:4183-4205), so this module builds the same
padded context per alignment and aligns windows at offsets into it.

Provides:
  - align_overlap_rows_exact(...): exact full rows for many overlaps.
  - fill_window_diffs / align_rows_flat_store: the same for whole stores.

Row convention: base codes 0..3, gap code 4 (the reference uses 7 -> '-').
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

BORDER = 10  # recoverAlignment's subread border (LAInterface.cpp:4149)


def make_context(seq: np.ndarray, start: int, end: int) -> Tuple[np.ndarray, int, int]:
    """Load_Subread-equivalent context for a match span [start, end):
    bases [max(start-10,0), min(end+10,len)) framed by 4-sentinels.

    Returns (ctx bytes, index of position `start` in ctx, lowest represented
    position's ctx index == 1 ... i.e. (ctx, off0, amin) where ctx[off0]
    corresponds to seq[start] and ctx[0] is the sentinel at amin-1)."""
    amin = max(start - BORDER, 0)
    amax = min(end + BORDER, len(seq))
    ctx = np.empty(amax - amin + 2, dtype=np.uint8)
    ctx[0] = 4
    ctx[1:-1] = seq[amin:amax]
    ctx[-1] = 4
    return ctx, start - amin + 1, amin


def window_bounds(a_start: int, a_end: int, b_start: int, b_end: int,
                  trace_pairs: np.ndarray, tspace: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-window [bound_i, bound_i+1) coordinates along A and B
    (computeTracePTS' loop, LAInterface.cpp:3479-3502)."""
    interior = np.arange((a_start // tspace + 1) * tspace, a_end, tspace,
                         dtype=np.int64)
    a_bounds = np.concatenate([[a_start], interior, [a_end]])
    b_bounds = np.empty(len(a_bounds), dtype=np.int64)
    b_bounds[0] = b_start
    if len(a_bounds) > 2:
        b_bounds[1:-1] = b_start + np.cumsum(
            trace_pairs[: len(a_bounds) - 2, 1].astype(np.int64))
    b_bounds[-1] = b_end
    return a_bounds, b_bounds


class _WindowBatch:
    """Accumulates windows (with their padded contexts) across many overlaps
    and aligns them in one native call."""

    def __init__(self):
        self.ctx_a: List[np.ndarray] = []
        self.ctx_b: List[np.ndarray] = []
        # per-RECORD numpy chunks (per-window python appends were a top
        # host cost at the 10^5-read scale), concatenated once in _flat
        self._a_ptr: List[np.ndarray] = []
        self._b_ptr: List[np.ndarray] = []
        self._a_len: List[np.ndarray] = []
        self._b_len: List[np.ndarray] = []
        self._a_avail: List[np.ndarray] = []
        self._b_avail: List[np.ndarray] = []
        self._owner: List[np.ndarray] = []
        self._abase = 0
        self._bbase = 0
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def owner(self) -> np.ndarray:
        return (np.concatenate(self._owner)
                if self._owner else np.zeros(0, np.int64))

    def add_overlap(self, owner: int, a_seq: np.ndarray, b_frame: np.ndarray,
                    a_start: int, a_end: int, b_start: int, b_end: int,
                    trace_pairs: np.ndarray, tspace: int) -> None:
        ctx_a, off_a0, _ = make_context(a_seq, a_start, a_end)
        ctx_b, off_b0, _ = make_context(b_frame, b_start, b_end)
        ab, bb = window_bounds(a_start, a_end, b_start, b_end,
                               trace_pairs, tspace)
        self.ctx_a.append(ctx_a)
        self.ctx_b.append(ctx_b)
        ab = np.asarray(ab, dtype=np.int64)
        bb = np.asarray(bb, dtype=np.int64)
        pa = off_a0 + (ab[:-1] - a_start)
        pb = off_b0 + (bb[:-1] - b_start)
        self._a_ptr.append(self._abase + pa)
        self._b_ptr.append(self._bbase + pb)
        self._a_len.append(np.diff(ab))
        self._b_len.append(np.diff(bb))
        self._a_avail.append(pa)
        self._b_avail.append(pb)
        self._owner.append(np.full(len(ab) - 1, owner, dtype=np.int64))
        self._n += len(ab) - 1
        self._abase += len(ctx_a)
        self._bbase += len(ctx_b)

    def _flat(self):
        abuf = np.concatenate(self.ctx_a)
        bbuf = np.concatenate(self.ctx_b)
        return (
            abuf, bbuf,
            np.concatenate(self._a_ptr).astype(np.int64),
            np.concatenate(self._b_ptr).astype(np.int64),
            np.concatenate(self._a_len).astype(np.int32),
            np.concatenate(self._b_len).astype(np.int32),
            np.concatenate(self._a_avail).astype(np.int32),
            np.concatenate(self._b_avail).astype(np.int32),
        )

    def align_flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All window rows as flat (flat_a, flat_b, win_len) in window order —
        no per-window array materialization (the per-window list in align()
        dominated the host profile at 10^5-read consensus scale)."""
        if self._n == 0:
            z = np.zeros(0, np.uint8)
            return z, z, np.zeros(0, np.int64)
        abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail = self._flat()
        return rows_flat_from_windows(abuf, bbuf, a_ptr, b_ptr, a_len, b_len,
                                      a_avail, b_avail)

    def diffs(self) -> np.ndarray:
        """Per-window mismatch-column counts of the exact alignments,
        computed natively without materializing rows."""
        if self._n == 0:
            return np.zeros(0, np.int32)
        abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail = self._flat()
        return _native_diffs(abuf, bbuf, a_ptr, a_len, a_avail,
                             b_ptr, b_len, b_avail)


def rows_flat_from_windows(abuf, bbuf, a_ptr, b_ptr, a_len, b_len,
                           a_avail, b_avail):
    """Exact rows for prebuilt flat windows -> (flat_a, flat_b, win_len)."""
    n = len(a_ptr)
    z = np.zeros(0, np.uint8)
    if n == 0:
        return z, z, np.zeros(0, np.int64)
    out_a, out_b, out_off, out_len = _native_rows_raw(
        abuf, bbuf, a_ptr, a_len, a_avail, b_ptr, b_len, b_avail)
    # compact the capacity-strided native buffers into dense flat rows
    tot = _native_compact(out_a, out_b, out_off, out_len)
    return out_a[:tot], out_b[:tot], out_len.astype(np.int64)


def _native_compact(out_a, out_b, out_off, out_len) -> int:
    """In-place dense compaction of capacity-strided row buffers (C memmove
    pass); returns the dense total."""
    from hinge_tpu_torch import native

    lib = native.get_lib()
    import ctypes as c

    return int(lib.dalign_compact_rows(
        out_a.ctypes.data_as(c.POINTER(c.c_uint8)),
        out_b.ctypes.data_as(c.POINTER(c.c_uint8)),
        out_off.ctypes.data_as(c.POINTER(c.c_int64)),
        out_len.ctypes.data_as(c.POINTER(c.c_int32)),
        c.c_int64(len(out_len)),
    ))


def _native_rows_raw(abuf, bbuf, a_ptr, a_len, a_avail, b_ptr, b_len, b_avail):
    import os as _os

    from hinge_tpu_torch import native

    lib = native.get_lib()
    import ctypes as c

    n = len(a_ptr)
    caps = a_len.astype(np.int64) + b_len
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(caps[:-1], out=out_off[1:])
    total = int(caps.sum())
    out_a = _SCRATCH.get("rows_a", max(total, 1), np.uint8)
    out_b = _SCRATCH.get("rows_b", max(total, 1), np.uint8)
    out_len = np.zeros(n, dtype=np.int32)

    p8 = c.POINTER(c.c_uint8)
    p32 = c.POINTER(c.c_int32)
    p64 = c.POINTER(c.c_int64)
    rc = lib.dalign_rows_batch_mt(
        abuf.ctypes.data_as(p8), bbuf.ctypes.data_as(p8),
        a_ptr.ctypes.data_as(p64), a_len.ctypes.data_as(p32),
        a_avail.ctypes.data_as(p32),
        b_ptr.ctypes.data_as(p64), b_len.ctypes.data_as(p32),
        b_avail.ctypes.data_as(p32),
        c.c_int64(n),
        out_a.ctypes.data_as(p8), out_b.ctypes.data_as(p8),
        out_off.ctypes.data_as(p64), out_len.ctypes.data_as(p32),
        c.c_int32(_os.cpu_count() or 1),
    )
    _check_windows("dalign_rows_batch_mt", rc)
    return out_a, out_b, out_off, out_len


def _check_windows(fn: str, rc: int) -> None:
    """Raise on the C wave's -1: a window of negative length, or with no
    context byte before it.  The window builders here make one only from a
    malformed record (a negative start, a_start > a_end, or trace
    displacements that run past its B span), which neither the overlapper
    nor DALIGNER writes."""
    if rc != 0:
        raise ValueError(f"{fn} returned {rc}: a window of negative length "
                         "or without context (a malformed record)")


def _native_diffs(abuf, bbuf, a_ptr, a_len, a_avail, b_ptr, b_len, b_avail):
    import os as _os

    from hinge_tpu_torch import native

    lib = native.get_lib()
    import ctypes as c

    n = len(a_ptr)
    out = np.zeros(n, dtype=np.int32)
    p8 = c.POINTER(c.c_uint8)
    p32 = c.POINTER(c.c_int32)
    p64 = c.POINTER(c.c_int64)
    rc = lib.dalign_diffs_batch(
        abuf.ctypes.data_as(p8), bbuf.ctypes.data_as(p8),
        a_ptr.ctypes.data_as(p64), a_len.ctypes.data_as(p32),
        a_avail.ctypes.data_as(p32),
        b_ptr.ctypes.data_as(p64), b_len.ctypes.data_as(p32),
        b_avail.ctypes.data_as(p32),
        c.c_int64(n), out.ctypes.data_as(p32),
        c.c_int32(_os.cpu_count() or 1),
    )
    _check_windows("dalign_diffs_batch", rc)
    return out


class _Scratch:
    """Grow-only reusable buffers: fresh multi-GB np.empty allocations cost
    ~12 us/page in minor faults on this host (~15 s per 1.25 GB context
    build at the 10^5-read scale); reused pages are warm.  Callers receive
    VIEWS — each named buffer is valid only until the next call that asks
    for the same name."""

    def __init__(self):
        self._bufs = {}

    def get(self, name: str, size: int, dtype) -> np.ndarray:
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != np.dtype(dtype) or len(buf) < size:
            buf = np.empty(int(size * 5 // 4) + 16, dtype=dtype)
            self._bufs[name] = buf
        return buf[:size]


_SCRATCH = _Scratch()


def _native_contexts(a_cat, a_lo, a_hi, a_dst, b_cat, b_lo, b_hi, b_dst,
                     rcb, abuf, bbuf) -> None:
    from hinge_tpu_torch import native

    lib = native.get_lib()
    import ctypes as c

    p8 = c.POINTER(c.c_uint8)
    p64 = c.POINTER(c.c_int64)
    rc8 = np.ascontiguousarray(rcb, np.uint8)
    args = []
    for arr, ptr in ((a_cat, p8), (a_lo, p64), (a_hi, p64), (a_dst, p64),
                     (b_cat, p8), (b_lo, p64), (b_hi, p64), (b_dst, p64)):
        args.append(np.ascontiguousarray(arr).ctypes.data_as(ptr))
    lib.build_contexts(*args, rc8.ctypes.data_as(p8), c.c_int64(len(a_lo)),
                       abuf.ctypes.data_as(p8), bbuf.ctypes.data_as(p8))


def _seg_arange(counts: np.ndarray) -> np.ndarray:
    """Within-segment indices 0..counts[i]-1, flat int64."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(np.cumsum(counts) - counts, counts)
    return out


def build_flat_windows(
    a_cat: np.ndarray, a_off: np.ndarray, a_len_rec: np.ndarray,
    b_cat: np.ndarray, b_off: np.ndarray, b_len_rec: np.ndarray,
    a0, a1, b0, b1, rc,
    trace: np.ndarray, trace_off: np.ndarray, tlen: np.ndarray,
    tspace: int,
):
    """Vectorized _WindowBatch construction for n records at once — the
    per-record add_overlap loop (make_context copies + window_bounds
    aranges) was ~30% of map+consensus wall at the 10^5-read scale.

    a_cat/b_cat: uint8 base pools; a_off/b_off per-record offsets of each
    record's A/B sequence inside them; a_len_rec/b_len_rec the sequence
    lengths; a0..b1 match coords with B in ORIGINAL orientation; rc the
    complement flags; trace/trace_off/tlen the flat DALIGNER trace.

    Returns (abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail,
    owner) — bit-identical to looping _WindowBatch.add_overlap over the
    records in order (oracle-tested in tests/test_dalign_trace.py)."""
    i64 = np.int64
    n = len(a0)
    a0, a1 = a0.astype(i64), a1.astype(i64)
    b0, b1 = b0.astype(i64), b1.astype(i64)
    a_len_rec = a_len_rec.astype(i64)
    b_len_rec = b_len_rec.astype(i64)
    rcb = rc.astype(bool)
    bf0 = np.where(rcb, b_len_rec - b1, b0)
    bf1 = np.where(rcb, b_len_rec - b0, b1)

    # ---- per-record padded contexts (Load_Subread semantics) ----
    amin = np.maximum(a0 - BORDER, 0)
    amax = np.minimum(a1 + BORDER, a_len_rec)
    bmin = np.maximum(bf0 - BORDER, 0)
    bmax = np.minimum(bf1 + BORDER, b_len_rec)
    ca_len = amax - amin + 2
    cb_len = bmax - bmin + 2
    ca_off = np.zeros(n + 1, i64)
    np.cumsum(ca_len, out=ca_off[1:])
    cb_off = np.zeros(n + 1, i64)
    np.cumsum(cb_len, out=cb_off[1:])
    abuf = _SCRATCH.get("ctx_a", int(ca_off[-1]), np.uint8)
    bbuf = _SCRATCH.get("ctx_b", int(cb_off[-1]), np.uint8)
    abuf[ca_off[:-1]] = 4
    abuf[ca_off[1:] - 1] = 4
    bbuf[cb_off[:-1]] = 4
    bbuf[cb_off[1:] - 1] = 4
    # context interiors: per-record memcpy/revcomp into the preallocated
    # buffers, natively (a Python slice loop was ~20% of map+consensus wall
    # at 10^5 records; index-array gathers even slower)
    ao = (a_off.astype(i64) + amin)
    a_hi_src = (a_off.astype(i64) + amax)
    ad = ca_off[:-1] + 1
    b_off = b_off.astype(i64)
    bo_lo = np.where(rcb, b_off + b_len_rec - bmax, b_off + bmin)
    bo_hi = np.where(rcb, b_off + b_len_rec - bmin, b_off + bmax)
    bd = cb_off[:-1] + 1
    _native_contexts(a_cat, ao, a_hi_src, ad,
                     b_cat, bo_lo, bo_hi, bd, rcb, abuf, bbuf)

    # ---- window lattice (computeTracePTS' loop) ----
    s0 = (a0 // tspace + 1) * tspace
    nw = np.maximum(0, -(-(a1 - s0) // tspace)) + 1
    rec_w = np.repeat(np.arange(n, dtype=i64), nw)
    w = _seg_arange(nw)
    a_lo = np.where(w == 0, a0[rec_w], s0[rec_w] + (w - 1) * tspace)
    last = w == nw[rec_w] - 1
    a_hi = np.where(last, a1[rec_w], s0[rec_w] + w * tspace)
    # B displacement per non-final window from the trace's odd stream
    disp = np.zeros(len(w), i64)
    hd = ~last
    disp[hd] = trace[trace_off[rec_w[hd]].astype(i64) + 2 * w[hd] + 1]
    cs = np.cumsum(disp)
    first_w = np.cumsum(nw) - nw
    excl = cs - disp - np.repeat((cs - disp)[first_w], nw)
    b_lo = bf0[rec_w] + excl
    b_hi = np.where(hd, b_lo + disp, bf1[rec_w])

    pa = (a0 - amin + 1)[rec_w] + (a_lo - a0[rec_w])
    pb = (bf0 - bmin + 1)[rec_w] + excl
    return (abuf, bbuf,
            ca_off[:-1][rec_w] + pa, cb_off[:-1][rec_w] + pb,
            (a_hi - a_lo).astype(np.int32), (b_hi - b_lo).astype(np.int32),
            pa.astype(np.int32), pb.astype(np.int32), rec_w)


def _pool_from_targets(targets) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cat, off, len) pool over a short list of target sequences."""
    lens = np.array([len(t) for t in targets], np.int64)
    off = np.zeros(len(targets) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    cat = (np.concatenate([np.asarray(t, np.uint8) for t in targets])
           if targets else np.zeros(0, np.uint8))
    return cat, off[:-1], lens


def fill_window_diffs(ov, targets, rs) -> None:
    """Populate an OverlapStore's per-window trace diffs + record diffs from
    the EXACT window alignments, in place.  A-ids index `targets` (a short
    list of sequences); B-ids index the ReadStore's flat base pool.

    DALIGNER consumers size their wave arrays from the recorded per-window
    diff counts (computeTracePTS, LAInterface.cpp:3444-3456: dmax = max
    points[2w]); a trace whose diffs understate the true edit count makes
    the reference binaries overflow those arrays and crash.  Our minimizer
    mapper interpolates trace b-displacements without aligning, so this pass
    fills the diffs the same way DALIGNER would: the edit count of the
    optimal window alignment (>= the wave's D by construction).
    """
    a_cat, a_off, a_lens = _pool_from_targets(targets)
    (abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail,
     owner) = build_flat_windows(
        a_cat, a_off[ov.a_id], a_lens[ov.a_id],
        rs.bases, rs.bases_off[ov.b_id], rs.length[ov.b_id].astype(np.int64),
        ov.a_start, ov.a_end, ov.b_start, ov.b_end, ov.rc,
        ov.trace, ov.trace_off, ov.tlen, int(ov.tspace))
    d = _native_diffs(abuf, bbuf, a_ptr, a_len, a_avail,
                      b_ptr, b_len, b_avail).astype(np.int64)
    if len(owner) == 0:
        ov.diffs[:] = 0
        return
    # windows were appended per record in order: local slot = index - first
    first = np.zeros(ov.n + 1, dtype=np.int64)
    np.add.at(first, owner + 1, 1)
    np.cumsum(first, out=first)
    win_local = np.arange(len(owner), dtype=np.int64) - first[owner]
    ov.trace[ov.trace_off[owner] + 2 * win_local] = np.minimum(d, 65535)
    ov.diffs[:] = np.bincount(owner, weights=d, minlength=ov.n).astype(
        ov.diffs.dtype)


def align_rows_flat_store(
    ov, rows_idx: np.ndarray, tmpl: np.ndarray, rs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact flat alignment rows for OverlapStore records rows_idx, A side
    fixed to one template (consensus's contig-vs-reads case): returns
    (flat_a, flat_b, item_len) like align_overlap_rows_exact_flat but with
    the whole window batch built vectorized from the store columns."""
    rows_idx = np.asarray(rows_idx, np.int64)
    n = len(rows_idx)
    z = np.zeros(0, np.uint8)
    if n == 0:
        return z, z, np.zeros(0, np.int64)
    tmpl = np.asarray(tmpl, np.uint8)
    (abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail,
     owner) = build_flat_windows(
        tmpl, np.zeros(n, np.int64), np.full(n, len(tmpl), np.int64),
        rs.bases, rs.bases_off[ov.b_id[rows_idx]],
        rs.length[ov.b_id[rows_idx]].astype(np.int64),
        ov.a_start[rows_idx], ov.a_end[rows_idx],
        ov.b_start[rows_idx], ov.b_end[rows_idx], ov.rc[rows_idx],
        ov.trace, ov.trace_off[rows_idx], ov.tlen[rows_idx],
        int(ov.tspace))
    flat_a, flat_b, win_len = rows_flat_from_windows(
        abuf, bbuf, a_ptr, b_ptr, a_len, b_len, a_avail, b_avail)
    item_len = np.zeros(n, np.int64)
    if len(owner):
        np.add.at(item_len, owner, win_len)
    return flat_a, flat_b, item_len


def align_overlap_rows_exact_flat(
    items: Sequence[Tuple],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact full alignment rows for many overlaps, flat: returns
    (flat_a, flat_b, item_len) where item i's rows occupy the flat slice
    [sum(item_len[:i]), sum(item_len[:i+1])).  Windows are appended per
    item in item order, so the flat window order IS item order.

    items: sequence of (a_seq, b_frame, a_start, a_end, b_start, b_end,
    trace_pairs, tspace) — same tuple shape as
    batch_align.align_overlap_rows_bulk."""
    batch = _WindowBatch()
    for idx, (a_seq, b_frame, a0, a1, b0, b1, tp, tspace) in enumerate(items):
        batch.add_overlap(idx, np.asarray(a_seq, np.uint8),
                          np.asarray(b_frame, np.uint8),
                          int(a0), int(a1), int(b0), int(b1), tp, int(tspace))
    flat_a, flat_b, win_len = batch.align_flat()
    owner = batch.owner
    item_len = np.zeros(len(items), np.int64)
    if len(owner):
        np.add.at(item_len, owner, win_len)
    return flat_a, flat_b, item_len


def align_overlap_rows_exact(
    items: Sequence[Tuple],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Exact full alignment rows for many overlaps (the reference's
    recoverAlignment + getAlignmentTags, batched).  Returns per-item
    (row_a, row_b) VIEWS into one flat buffer — copy anything mutated."""
    flat_a, flat_b, item_len = align_overlap_rows_exact_flat(items)
    off = np.zeros(len(items) + 1, np.int64)
    np.cumsum(item_len, out=off[1:])
    return [
        (flat_a[off[i] : off[i + 1]], flat_b[off[i] : off[i + 1]])
        for i in range(len(items))
    ]
