"""Copied from hinge_tpu/overlap/mapper.py: the logic verbatim, the imports
rewritten to hinge_tpu_torch, and the device join's branch moved from
`map_reads_to_targets` into `overlap_reads`, where it runs the port's
device join (overlap/device_join.py) on the run's device.

`overlap_reads` takes its half-pair base records from the device join or
from the native C join (`map_reads_to_targets(half_pairs=True)`), as
`use_device_join` decides: the device join on a CUDA device and the C join
on the CPU, unless HINGE_DEVICE_JOIN=1 (the device join) or =0 (the C join)
says otherwise.  Either way the records are then deduplicated and mirrored
on the host (`dedup_and_mirror`).  There is no fallback: an input that the
device join's gates refuse raises ValueError, naming the gate and
HINGE_DEVICE_JOIN=0, instead of taking the C join.  `map_reads_to_targets`
always runs the C join, whatever the switch says.

Minimizer-based read-to-reference mapper — fully vectorized.

The reference pipeline delegates alignment discovery to external tools
(DALIGNER / minimap; `demo/*/run.sh`, `pipeline_consensus.py:41-64` runs
HPC.daligner to map raw reads onto the draft).  This module provides a
built-in equivalent so the framework is standalone.

Pipeline (no per-hit Python):
  1. (w,k)-minimizer extraction per sequence (numpy rolling hash),
  2. query->index join as one `searchsorted` against the sorted index hash
     array (buckets > 64 entries dropped as repetitive),
  3. chaining = diagonal-band histogram per (read, strand, target) group via
     one lexsort + segment counting; best adjacent band pair wins,
  4. spans from segment min/max over the banded hits; trace-point
     displacements interpolated from the anchors every tspace bases.

Output: OverlapStore records (A = target/contig, B = read) with the
DALIGNER/getOverlap coordinate convention, consumable by the consensus
stage exactly like `.las` input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hinge_tpu_torch.data.overlaps import INT, OverlapStore, ReadStore, revcomp_codes


def _kmer_hash(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    v = np.zeros(n - k + 1, dtype=np.uint64)
    for i in range(k):
        v = (v << np.uint64(2)) | codes[i : n - k + 1 + i].astype(np.uint64)
    v = (v ^ (v >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    v = (v ^ (v >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return v ^ (v >> np.uint64(31))


def minimizers(codes: np.ndarray, k: int = 15, w: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, hashes) of window minimizers. Uses the native C core when
    available (bit-identical hash), numpy otherwise."""
    native = _native_minimizers(codes, k, w)
    if native is not None:
        return native
    h = _kmer_hash(codes, k)
    n = len(h)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    if n <= w:
        p = int(np.argmin(h))
        return np.array([p]), h[[p]]
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(h, w)
    idx = np.argmin(win, axis=1) + np.arange(len(win))
    keep = np.unique(idx)
    return keep, h[keep]


def _native_minimizers(codes: np.ndarray, k: int, w: int):
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "minimizers"):
        return None
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    cap = n - k + 1
    pos = np.zeros(cap, dtype=np.int64)
    hsh = np.zeros(cap, dtype=np.uint64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cnt = lib.minimizers(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int32(k), ctypes.c_int32(w),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hsh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if cnt < 0:
        return None
    return pos[:cnt], hsh[:cnt]


class _BufferPool:
    """Grow-only scratch buffers for the native calls.

    First-touch page faults are extremely expensive in sandboxed/virtualized
    environments (measured ~10-30us/page here when faulting from multiple
    threads), so allocating hundreds of MB of fresh output buffers per call
    dominated the overlapper. Reusing one named buffer per call site pays the
    fault cost once per process. Returned views are only valid until the
    same name is requested again — callers copy anything that escapes."""

    def __init__(self):
        self._bufs = {}

    def get(self, name: str, size: int, dtype) -> np.ndarray:
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != np.dtype(dtype) or len(buf) < size:
            buf = np.empty(int(size * 5 // 4) + 16, dtype=dtype)
            self._bufs[name] = buf
        return buf[:size]


_POOL = _BufferPool()


def _minimizers_batch(codes: np.ndarray, offsets: np.ndarray, k: int, w: int,
                      both_strands: bool):
    """Native batched minimizers over concatenated sequences. Returns
    (pos int32, hash uint64, counts int64 per stream) or None. Streams are
    per sequence (forward[, reverse-complement]) in sequence order,
    bit-identical to per-sequence `minimizers` calls."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "minimizers_batch"):
        return None
    n_seq = len(offsets) - 1
    lens = np.diff(offsets)
    caps = np.maximum(lens - k + 1, 0).astype(np.int64)
    if both_strands:
        caps = np.repeat(caps, 2)
    cap_off = np.zeros(len(caps) + 1, dtype=np.int64)
    np.cumsum(caps, out=cap_off[1:])
    tot_cap = int(cap_off[-1])
    out_pos = _POOL.get("mini_pos", tot_cap, np.int32)
    out_hash = _POOL.get("mini_hash", tot_cap, np.uint64)
    out_cnt = _POOL.get("mini_cnt", len(caps), np.int64)
    out_cnt[:] = 0
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    c = ctypes
    tot = lib.minimizers_batch(
        codes.ctypes.data_as(c.POINTER(c.c_uint8)),
        offsets.ctypes.data_as(c.POINTER(c.c_int64)),
        c.c_int64(n_seq), c.c_int32(k), c.c_int32(w),
        c.c_int32(1 if both_strands else 0),
        cap_off.ctypes.data_as(c.POINTER(c.c_int64)),
        out_pos.ctypes.data_as(c.POINTER(c.c_int32)),
        out_hash.ctypes.data_as(c.POINTER(c.c_uint64)),
        out_cnt.ctypes.data_as(c.POINTER(c.c_int64)),
    )
    return out_pos[:tot], out_hash[:tot], out_cnt


@dataclasses.dataclass
class MapperIndex:
    k: int
    w: int
    hashes: np.ndarray  # sorted uint64
    packed: np.ndarray  # uint64 (tid << 40 | pos), bucket-aligned with hashes
    t_len: np.ndarray


def build_index(targets: List[np.ndarray], k: int = 15, w: int = 10,
                max_bucket: int = 64) -> MapperIndex:
    nat = _native_build_index(targets, k, w, max_bucket)
    if nat is not None:
        return nat
    hs, ps = [], []
    for tid, t in enumerate(targets):
        pos, h = minimizers(t, k, w)
        hs.append(h)
        ps.append((np.uint64(tid) << np.uint64(40)) | pos.astype(np.uint64))
    allh = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
    allp = np.concatenate(ps) if ps else np.zeros(0, np.uint64)
    order = np.argsort(allh, kind="stable")
    allh, allp = allh[order], allp[order]
    if len(allh):
        # drop repetitive buckets: run-lengths on the (already sorted) hash
        # array — equivalent to np.unique(return_counts) without its re-sort
        new = np.empty(len(allh), dtype=bool)
        new[0] = True
        np.not_equal(allh[1:], allh[:-1], out=new[1:])
        starts = np.nonzero(new)[0]
        cnts = np.diff(np.append(starts, len(allh)))
        keep = cnts[np.cumsum(new) - 1] <= max_bucket
        allh, allp = allh[keep], allp[keep]
    return MapperIndex(
        k=k, w=w, hashes=allh, packed=allp,
        t_len=np.array([len(t) for t in targets], dtype=np.int64),
    )


def _native_build_index(targets: List[np.ndarray], k: int, w: int,
                        max_bucket: int) -> Optional[MapperIndex]:
    """Fully native index build: batched minimizers + stable LSD radix sort
    + repetitive-bucket filter. Bit-identical to the numpy path."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "index_sort_filter") or not targets:
        return None
    lens = np.array([len(t) for t in targets], dtype=np.int64)
    offsets = np.zeros(len(targets) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.concatenate(targets) if len(targets) > 1 else np.asarray(targets[0])
    got = _minimizers_batch(flat, offsets, k, w, both_strands=False)
    if got is None:
        return None
    pos, hashes, counts = got
    tids = np.repeat(np.arange(len(targets), dtype=np.uint64), counts)
    packed = (tids << np.uint64(40)) | pos.astype(np.uint64)
    # copy: `hashes` is a pooled scratch view that the per-block query
    # minimizer calls will overwrite, but the index must outlive them
    hashes = hashes.copy()
    packed = np.ascontiguousarray(packed)
    c = ctypes
    n2 = lib.index_sort_filter(
        hashes.ctypes.data_as(c.POINTER(c.c_uint64)),
        packed.ctypes.data_as(c.POINTER(c.c_uint64)),
        c.c_int64(len(hashes)), c.c_int64(max_bucket),
    )
    if n2 < 0:
        return None
    return MapperIndex(k=k, w=w, hashes=hashes[:n2], packed=packed[:n2],
                       t_len=lens)


def map_reads_to_targets(
    targets: List[np.ndarray],
    rs: ReadStore,
    k: int = 15,
    w: int = 12,  # matches overlap_reads so the per-ReadStore minimizer
                  # cache is shared across the overlap and map stages
    min_span: int = 1000,
    min_hits: int = 4,
    band_width: int = 500,
    tspace: int = 100,
    query_block: int = 2048,
    half_pairs: bool = False,
) -> OverlapStore:
    """Chunked over query reads so the hit table stays bounded (all-vs-all
    at genome scale would otherwise materialize 10^8+ hits at once).

    half_pairs: all-vs-all mode where queries ARE the targets — keep only
    hits with tid >= global rid, halving the hit table (the (j,i) twin of
    every record is synthesized downstream by overlap_reads).  In this mode
    the minimizers are computed ONCE for all reads (both strands); the
    forward streams double as the index input and the per-block query
    slices come from the same arrays (the index build previously re-ran
    the whole minimizer pass over identical sequences)."""
    # whole-run query minimizers, cached ON the ReadStore so later stages
    # over the same reads (overlap -> map in assemble()) never recompute
    # them; pooled scratch views are copied once so the cache, the index,
    # and every block outlive later pool reuse
    pre = None  # (qp_all, qh_all, counts_all)
    if rs.bases is not None:
        cache = minimizer_cache(rs)
        pre = cache.get((k, w))
        if pre is None:
            got = _minimizers_batch(rs.bases, rs.bases_off, k, w,
                                    both_strands=True)
            if got is not None:
                pre = cache_minimizers(rs, k, w, *(a.copy() for a in got))
    index = None
    if half_pairs and pre is not None:
        # all-vs-all: the forward streams double as the index input
        index = _index_from_minimizers(targets, pre, k, w)
    if index is None:
        index = build_index(targets, k, w)

    def block_slice(lo, hi):
        if pre is None:
            return None
        qp_all, qh_all, counts_all = pre
        s0, s1 = 2 * lo, 2 * hi
        off = np.zeros(len(counts_all) + 1, np.int64)
        np.cumsum(counts_all, out=off[1:])
        return (qp_all[off[s0] : off[s1]], qh_all[off[s0] : off[s1]],
                counts_all[s0:s1])

    if rs.n_reads > query_block:
        stores = []
        for lo in range(0, rs.n_reads, query_block):
            hi = min(lo + query_block, rs.n_reads)
            sub = ReadStore(
                length=rs.length[lo:hi],
                bases_off=(rs.bases_off[lo : hi + 1] - rs.bases_off[lo]),
                bases=rs.bases[rs.bases_off[lo] : rs.bases_off[hi]],
            )
            part = _map_block(index, targets, sub, k, w, min_span, min_hits,
                              band_width, tspace, rid_base=lo,
                              half_pairs=half_pairs,
                              pre_minimizers=block_slice(lo, hi))
            stores.append(part)
        out = _concat(stores, tspace)
    else:
        out = _map_block(index, targets, rs, k, w, min_span, min_hits,
                         band_width, tspace, rid_base=0,
                         half_pairs=half_pairs,
                         pre_minimizers=block_slice(0, rs.n_reads))
    if not half_pairs:
        # fill true per-window diffs: DALIGNER consumers size wave arrays
        # from them (see dalign_trace.fill_window_diffs); interpolated
        # traces with diffs=0 crash the reference consensus binary
        from hinge_tpu_torch.ops.dalign_trace import fill_window_diffs

        fill_window_diffs(out, targets, rs)
    return out


def minimizer_cache(rs: ReadStore) -> dict:
    """The whole-run query minimizers cached on `rs`, by (k, w): (pos
    int32, hash uint64, count a stream int64), the streams forward then
    reverse complement a read (`_minimizers_batch`'s layout).  Filled by
    the join, C or device (cache_minimizers); read by
    map_reads_to_targets."""
    cache = getattr(rs, "_minimizer_cache", None)
    if cache is None:
        cache = {}
        try:
            rs._minimizer_cache = cache
        except Exception:
            pass
    return cache


def cache_minimizers(rs: ReadStore, k: int, w: int, pos, hsh, counts):
    """Store the whole-run query minimizers of `rs` in its cache and
    return the entry: `pos` and `hsh` one a minimizer (`hsh` the hash's
    64 bits in any 8-byte integer type), `counts` one a stream, the
    streams forward then reverse complement a read, in read order."""
    entry = (np.asarray(pos, np.int32), np.asarray(hsh).view(np.uint64),
             np.asarray(counts, np.int64))
    minimizer_cache(rs)[(k, w)] = entry
    return entry


def _concat(stores: List[OverlapStore], tspace: int) -> OverlapStore:
    cols = {}
    for f in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
              "b_start", "b_end", "rc", "diffs", "tlen"):
        cols[f] = np.concatenate([getattr(s, f) for s in stores]) if stores else np.zeros(0, INT)
    trace = np.concatenate([s.trace for s in stores]) if stores else np.zeros(0, np.uint16)
    offs = []
    base = 0
    for s in stores:
        offs.append(s.trace_off + base)
        base += len(s.trace)
    cols["trace_off"] = np.concatenate(offs) if offs else np.zeros(0, np.int64)
    return OverlapStore(trace=trace, tspace=tspace, **cols).sort_by_a()


def _index_from_minimizers(targets, pre, k: int, w: int,
                           max_bucket: int = 64) -> Optional[MapperIndex]:
    """Index built from precomputed both-strands minimizer streams (the
    FORWARD stream of each read is exactly what build_index would compute);
    bit-identical to build_index on the same targets."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "index_sort_filter"):
        return None
    qp_all, qh_all, counts_all = pre
    n = len(targets)
    off = np.zeros(len(counts_all) + 1, np.int64)
    np.cumsum(counts_all, out=off[1:])
    fwd = np.arange(0, 2 * n, 2)
    lens = np.array([len(t) for t in targets], dtype=np.int64)
    hashes = np.concatenate([qh_all[off[s] : off[s + 1]] for s in fwd])
    tids = np.repeat(np.arange(n, dtype=np.uint64), counts_all[fwd])
    pos = np.concatenate([qp_all[off[s] : off[s + 1]] for s in fwd])
    packed = np.ascontiguousarray(
        (tids << np.uint64(40)) | pos.astype(np.uint64))
    hashes = np.ascontiguousarray(hashes)
    c = ctypes
    n2 = lib.index_sort_filter(
        hashes.ctypes.data_as(c.POINTER(c.c_uint64)),
        packed.ctypes.data_as(c.POINTER(c.c_uint64)),
        c.c_int64(len(hashes)), c.c_int64(max_bucket),
    )
    if n2 < 0:
        return None
    return MapperIndex(k=k, w=w, hashes=hashes[:n2], packed=packed[:n2],
                       t_len=lens)


def _map_block(
    index: MapperIndex,
    targets: List[np.ndarray],
    rs: ReadStore,
    k: int,
    w: int,
    min_span: int,
    min_hits: int,
    band_width: int,
    tspace: int,
    rid_base: int = 0,
    half_pairs: bool = False,
    pre_minimizers=None,
) -> OverlapStore:
    n_targets = len(targets)

    # ---- 1. all query minimizers (precomputed slice in the all-vs-all
    # path, batched native otherwise, per-read fallback) ----
    got = pre_minimizers
    if got is None:
        got = (
            _minimizers_batch(rs.bases, rs.bases_off, k, w, both_strands=True)
            if rs.bases is not None else None
        )
    qr = qs = None  # only needed by the numpy join fallback; built lazily
    if got is not None:
        qp, qh, counts = got
        stream_lens = counts.tolist()
    else:
        q_hash: List[np.ndarray] = []
        q_pos: List[np.ndarray] = []
        q_rid: List[np.ndarray] = []
        q_str: List[np.ndarray] = []
        for rid in range(rs.n_reads):
            read = rs.get_bases(rid)
            for strand in (0, 1):
                codes = read if strand == 0 else revcomp_codes(read)
                pos, h = minimizers(codes, k, w)
                q_hash.append(h)
                q_pos.append(pos.astype(np.int32))
                q_rid.append(np.full(len(h), rid, dtype=np.int32))
                q_str.append(np.full(len(h), strand, dtype=np.int32))
        if not q_hash:
            return _empty(tspace)
        stream_lens = [len(h) for h in q_hash]
        qh = np.concatenate(q_hash)
        qp = np.concatenate(q_pos)
        qr = np.concatenate(q_rid)
        qs = np.concatenate(q_str)
    if len(qh) == 0:
        return _empty(tspace)

    # native C join+chaining core: per-read local hash histogram, no global
    # hit table (orders of magnitude less memory traffic than the numpy
    # join below); falls back to numpy when the toolchain is unavailable
    native = _native_map_block(
        index, qh, qp, stream_lens, rid_base, half_pairs,
        band_width, min_hits,
    )
    if native is not None:
        hit_row, hit_q, hit_t, g_rid, g_strand, g_tid = native
        if len(g_rid) == 0:
            return _empty(tspace)
        # min_hits was already enforced on the full (pre-subsample) band
        # counts inside the native pass; only degenerate rows drop here.
        # Hit columns stay int32 (the native emit path consumes them as-is).
        return _emit_records(
            hit_row, hit_q, hit_t, g_rid, g_strand, g_tid,
            rs, index, k, min_span, 2, tspace, rid_base,
        )
    if qr is None:
        counts = np.asarray(stream_lens, dtype=np.int64)
        qr = np.repeat(
            np.arange(rs.n_reads, dtype=np.int32), counts[0::2] + counts[1::2]
        )
        qs = np.repeat(
            np.tile(np.array([0, 1], dtype=np.int32), rs.n_reads), counts
        )

    # ---- 2. join against the sorted index ----
    # queries sorted by hash first: successive binary searches then walk the
    # index in order (warm cache) instead of jumping randomly — several-fold
    # faster at 10^6+ lookups
    qord = np.argsort(qh, kind="stable")
    lo = np.searchsorted(index.hashes, qh[qord], side="left")
    hi = np.searchsorted(index.hashes, qh[qord], side="right")
    cnt = hi - lo
    tot = int(cnt.sum())
    if tot == 0:
        return _empty(tspace)
    # flat bucket indices: repeat(lo) + intra-bucket arange
    rep = qord[np.repeat(np.arange(len(qh), dtype=np.int64), cnt)]
    intra = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    packed = index.packed[np.repeat(lo, cnt) + intra]
    del intra
    h_rid = qr[rep]
    if half_pairs:
        # all-vs-all: keep tid >= global rid only (packed = tid<<40 | pos, so
        # one uint64 compare); the (j,i) twins are synthesized downstream
        keep = packed >= ((h_rid.astype(np.uint64) + np.uint64(rid_base))
                          << np.uint64(40))
        packed, rep, h_rid = packed[keep], rep[keep], h_rid[keep]
        tot = len(packed)
        if tot == 0:
            return _empty(tspace)
    h_tid = (packed >> np.uint64(40)).astype(np.int32)
    h_tpos = (packed & np.uint64((1 << 40) - 1)).astype(np.int32)
    h_qpos = qp[rep]
    h_str = qs[rep]

    # ---- 3. diagonal-band histogram per (read, strand, target) ----
    diag = h_tpos - h_qpos  # can be negative
    band = (diag + np.int32(1 << 30)) // np.int32(band_width)
    bmin = int(band.min())
    band -= np.int32(bmin)
    n_bands = np.int64(int(band.max()) + 1)
    # one int64 key sort instead of a two-pass lexsort
    group = ((h_rid.astype(np.int64) * 2 + h_str) * n_targets + h_tid)
    key = group * n_bands + band
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    g_s, b_s = key_s // n_bands, (key_s % n_bands).astype(np.int64)
    del key, key_s, group
    gb_new = np.ones(tot, dtype=bool)
    gb_new[1:] = (g_s[1:] != g_s[:-1]) | (b_s[1:] != b_s[:-1])
    gb_start = np.nonzero(gb_new)[0]
    gb_count = np.diff(np.append(gb_start, tot))
    gb_group = g_s[gb_start]
    gb_band = b_s[gb_start]
    # adjacent-band merge: count(b) + count(b+1) when same group
    nxt_same = np.zeros(len(gb_start), dtype=bool)
    nxt_same[:-1] = (gb_group[1:] == gb_group[:-1]) & (gb_band[1:] == gb_band[:-1] + 1)
    pair_count = gb_count.copy()
    pair_count[:-1] += np.where(nxt_same[:-1], gb_count[1:], 0)
    # best band pair per group
    grp_new = np.ones(len(gb_start), dtype=bool)
    grp_new[1:] = gb_group[1:] != gb_group[:-1]
    grp_idx = np.cumsum(grp_new) - 1
    n_grp = int(grp_idx[-1]) + 1
    best_count = np.zeros(n_grp, dtype=np.int64)
    np.maximum.at(best_count, grp_idx, pair_count)
    # first gb achieving the best count per group
    is_best = pair_count == best_count[grp_idx]
    first_best = np.full(n_grp, 1 << 60, dtype=np.int64)
    np.minimum.at(first_best, grp_idx[is_best], np.nonzero(is_best)[0].astype(np.int64))

    keep_groups = np.nonzero(best_count >= min_hits)[0]
    if len(keep_groups) == 0:
        return _empty(tspace)

    # ---- 4. vectorized emission over all accepted groups ----
    # flat hit table of every accepted group's (band, band+1) slice
    gbs = first_best[keep_groups].astype(np.int64)
    seg_s = gb_start[gbs]
    seg_e = seg_s + gb_count[gbs]
    ext = (gbs + 1 < len(gb_start)) & nxt_same[gbs]
    seg_e = np.where(ext, gb_start[np.minimum(gbs + 1, len(gb_start) - 1)]
                     + gb_count[np.minimum(gbs + 1, len(gb_count) - 1)], seg_e)
    seg_len = (seg_e - seg_s).astype(np.int64)
    G = len(gbs)
    tot_h = int(seg_len.sum())
    row_of = np.repeat(np.arange(G, dtype=np.int64), seg_len)
    flat = np.arange(tot_h, dtype=np.int64)
    flat -= np.repeat(np.cumsum(seg_len) - seg_len, seg_len)
    flat += np.repeat(seg_s, seg_len)
    idxs = order[flat]
    tq = h_qpos[idxs].astype(np.int64)
    tt = h_tpos[idxs].astype(np.int64)

    grp = gb_group[gbs]
    g_rid = (grp // (2 * n_targets)).astype(np.int64)
    g_strand = ((grp // n_targets) % 2).astype(np.int64)
    g_tid = (grp % n_targets).astype(np.int64)
    return _emit_records(row_of, tq, tt, g_rid, g_strand, g_tid, rs, index,
                         k, min_span, min_hits, tspace, rid_base)


def _native_map_block(index: MapperIndex, qh, qp, stream_lens,
                      rid_base, half_pairs, band_width, min_hits,
                      sub_gap: int = 32):
    """ctypes call into map_block_hits (io_native.cpp); None if the native
    library is unavailable. Returns (hit_row, hit_q, hit_t, g_rid, g_strand,
    g_tid) with hits subsampled to >= sub_gap bp apart on the query."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "map_block_hits"):
        return None
    stream_off = np.zeros(len(stream_lens) + 1, dtype=np.int64)
    np.cumsum(stream_lens, out=stream_off[1:])
    n_reads = len(stream_lens) // 2
    qh = np.ascontiguousarray(qh, dtype=np.uint64)
    qp32 = np.ascontiguousarray(qp, dtype=np.int32)
    hashes = np.ascontiguousarray(index.hashes, dtype=np.uint64)
    packed = np.ascontiguousarray(index.packed, dtype=np.uint64)
    c = ctypes
    cap_hits = max(1 << 20, 2 * len(qh))
    cap_groups = 1 << 18
    while True:
        out_row = _POOL.get("mb_row", cap_hits, np.int32)
        out_q = _POOL.get("mb_q", cap_hits, np.int32)
        out_t = _POOL.get("mb_t", cap_hits, np.int32)
        out_rid = _POOL.get("mb_rid", cap_groups, np.int32)
        out_strand = _POOL.get("mb_strand", cap_groups, np.int32)
        out_tid = _POOL.get("mb_tid", cap_groups, np.int64)
        n_hits = c.c_int64(0)
        ng = lib.map_block_hits(
            hashes.ctypes.data_as(c.POINTER(c.c_uint64)),
            packed.ctypes.data_as(c.POINTER(c.c_uint64)),
            c.c_int64(len(hashes)),
            qh.ctypes.data_as(c.POINTER(c.c_uint64)),
            qp32.ctypes.data_as(c.POINTER(c.c_int32)),
            stream_off.ctypes.data_as(c.POINTER(c.c_int64)),
            c.c_int64(n_reads),
            c.c_int64(rid_base), c.c_int32(1 if half_pairs else 0),
            c.c_int32(band_width), c.c_int32(min_hits), c.c_int32(sub_gap),
            out_row.ctypes.data_as(c.POINTER(c.c_int32)),
            out_q.ctypes.data_as(c.POINTER(c.c_int32)),
            out_t.ctypes.data_as(c.POINTER(c.c_int32)),
            c.c_int64(cap_hits),
            out_rid.ctypes.data_as(c.POINTER(c.c_int32)),
            out_strand.ctypes.data_as(c.POINTER(c.c_int32)),
            out_tid.ctypes.data_as(c.POINTER(c.c_int64)),
            c.c_int64(cap_groups),
            c.byref(n_hits),
        )
        if ng == -1:
            cap_hits *= 2
            cap_groups *= 2
            continue
        nh = n_hits.value
        return (out_row[:nh], out_q[:nh], out_t[:nh],
                out_rid[:ng].astype(np.int64), out_strand[:ng].astype(np.int64),
                out_tid[:ng])


def _emit_records(row_of, tq, tt, g_rid, g_strand, g_tid, rs, index,
                  k, min_span, min_cnt, tspace, rid_base):
    """OverlapStore records from per-group banded hits: monotone-t filter,
    span check, then one flat vectorized trace-point interpolation pass.
    Shared tail of the native and numpy _map_block paths."""
    G = len(g_rid)
    if G == 0 or len(row_of) == 0:
        return _empty(tspace)
    nat = _native_emit_records(row_of, tq, tt, G, k, min_span, min_cnt, tspace)
    if nat is not None:
        ok, nq0, nq1, nt0, nt1, nnb, ntrace = nat
        acc = np.nonzero(ok)[0]
        if len(acc) == 0:
            return _empty(tspace)
        rid, strand, tid = g_rid[acc], g_strand[acc], g_tid[acc]
        blen = rs.length[rid].astype(np.int64)
        alen = index.t_len[tid].astype(np.int64)
        b_start = np.where(strand == 0, nq0[acc], blen - nq1[acc])
        b_end = np.where(strand == 0, nq1[acc], blen - nq0[acc])
        return OverlapStore.from_arrays(
            tspace=tspace, trace=ntrace,
            a_id=tid, b_id=rid + rid_base,
            a_len=alen, b_len=blen,
            a_start=nt0[acc], a_end=nt1[acc],
            b_start=b_start, b_end=b_end,
            rc=strand, diffs=np.zeros(len(acc), dtype=np.int64),
            tlen=2 * (nnb[acc] - 1),
        ).sort_by_a()
    # numpy tail (native emit unavailable); hit columns may arrive int32
    row_of = np.asarray(row_of, dtype=np.int64)
    tq = np.asarray(tq, dtype=np.int64)
    tt = np.asarray(tt, dtype=np.int64)
    # sort hits by (group row, qpos) — single int64 key
    o2 = np.argsort((row_of << np.int64(31)) | tq, kind="stable")
    row_s, tq_s, tt_s = row_of[o2], tq[o2], tt[o2]
    # segmented monotone-t filter: cummax within group via large offsets
    LARGE = np.int64(1) << 42
    mono = np.maximum.accumulate(tt_s + row_s * LARGE) - row_s * LARGE
    keep_h = mono == tt_s
    row_s, tq_s, tt_s = row_s[keep_h], tq_s[keep_h], tt_s[keep_h]
    # per-group boundaries after filtering
    cnt_g = np.bincount(row_s, minlength=G)
    gstart = np.concatenate([[0], np.cumsum(cnt_g)[:-1]])
    gend = np.cumsum(cnt_g) - 1
    ok = cnt_g >= min_cnt
    q0 = np.where(ok, tq_s[np.clip(gstart, 0, max(len(tq_s) - 1, 0))], 0)
    q1 = np.where(ok, tq_s[np.clip(gend, 0, max(len(tq_s) - 1, 0))] + k, 0)
    t0 = np.where(ok, tt_s[np.clip(gstart, 0, max(len(tt_s) - 1, 0))], 0)
    t1 = np.where(ok, tt_s[np.clip(gend, 0, max(len(tt_s) - 1, 0))] + k, 0)
    ok &= (q1 - q0 >= min_span) & (t1 - t0 >= min_span)

    rid, strand, tid = g_rid, g_strand, g_tid
    blen = rs.length[rid].astype(np.int64)
    alen = index.t_len[tid].astype(np.int64)
    b_start = np.where(strand == 0, q0, blen - q1)
    b_end = np.where(strand == 0, q1, blen - q0)

    acc = np.nonzero(ok)[0]
    if len(acc) == 0:
        return _empty(tspace)

    # ---- 5. vectorized trace interpolation over all accepted groups ----
    # flat table of every group's tspace-grid bounds [T0, k*tspace..., T1]
    T0a, T1a = t0[acc], t1[acc]
    Q0a, Q1a = q0[acc], q1[acc]
    n_int = np.maximum((T1a - 1) // tspace - T0a // tspace, 0)
    nb_g = n_int + 2
    G2 = len(acc)
    roff = np.cumsum(nb_g) - nb_g
    NBtot = int(nb_g.sum())
    row_b = np.repeat(np.arange(G2, dtype=np.int64), nb_g)
    jj2 = np.arange(NBtot, dtype=np.int64) - roff[row_b]
    last_j = nb_g[row_b] - 1
    bounds = (T0a[row_b] // tspace + jj2) * tspace
    bounds = np.where(jj2 == 0, T0a[row_b],
                      np.where(jj2 == last_j, T1a[row_b], bounds))
    # segmented interpolation of bounds against each group's (tt, tq)
    # anchors: one global searchsorted on the group-offset keys (j = last
    # anchor <= q, incl. duplicate x).  INTEGER-EXACT round-half-even of
    # the exact rational (matches native emit_records and the device join
    # bit-for-bit — no float rounding in the trace lattice anywhere).
    jh = np.searchsorted(tt_s + row_s * LARGE,
                         bounds + acc[row_b] * LARGE, side="right") - 1
    ge_b = gend[acc][row_b]
    x0v, y0v = tt_s[jh], tq_s[jh]
    has_next = jh < ge_b
    jn = np.minimum(jh + 1, ge_b)
    denom = np.maximum(tt_s[jn] - x0v, 1)
    num = y0v * denom + np.where(has_next, (bounds - x0v) * (tq_s[jn] - y0v), 0)
    qd = num // denom
    r2 = 2 * (num - qd * denom)
    qd += ((r2 > denom) | ((r2 == denom) & (qd & 1 == 1))).astype(np.int64)
    bar = np.where(jj2 == 0, Q0a[row_b],
                   np.where(jj2 == last_j, Q1a[row_b], qd)).astype(np.int64)
    # per-group displacement diffs (mask out cross-group positions)
    disp_flat = np.clip(bar[1:] - bar[:-1], 0, 65534)
    valid_d = row_b[1:] == row_b[:-1]
    dsum = np.bincount(
        row_b[1:][valid_d], weights=disp_flat[valid_d].astype(np.float64),
        minlength=G2,
    ).astype(np.int64)
    # fold the rounding remainder into each group's last displacement
    delta = (Q1a - Q0a) - dsum
    last_idx = roff + nb_g - 2
    newlast = disp_flat[last_idx] + delta
    okd = (newlast >= 0) & (newlast < 65535)
    disp_flat[last_idx] = np.where(okd, newlast, disp_flat[last_idx])
    dispv = disp_flat[valid_d]
    trace = np.zeros(2 * len(dispv), dtype=np.uint16)
    trace[1::2] = dispv

    return OverlapStore.from_arrays(
        tspace=tspace, trace=trace,
        a_id=tid[acc], b_id=rid[acc] + rid_base,
        a_len=alen[acc], b_len=blen[acc],
        a_start=T0a, a_end=T1a,
        b_start=b_start[acc], b_end=b_end[acc],
        rc=strand[acc], diffs=np.zeros(G2, dtype=np.int64),
        tlen=2 * (nb_g - 1),
    ).sort_by_a()


def _native_emit_records(row_of, tq, tt, G, k, min_span, min_cnt, tspace):
    """Native emit core: (row,q)-stable sort + monotone filter + spans +
    trace interpolation. Returns (ok, q0, q1, t0, t1, nb, trace) or None."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "emit_records"):
        return None
    n = len(row_of)
    row32 = np.ascontiguousarray(row_of, dtype=np.int32)
    q32 = np.ascontiguousarray(tq, dtype=np.int32)
    t32 = np.ascontiguousarray(tt, dtype=np.int32)
    ok = np.zeros(G, dtype=np.uint8)
    q0 = np.zeros(G, dtype=np.int64)
    q1 = np.zeros(G, dtype=np.int64)
    t0 = np.zeros(G, dtype=np.int64)
    t1 = np.zeros(G, dtype=np.int64)
    nb = np.zeros(G, dtype=np.int64)
    c = ctypes
    cap = max(1 << 16, 4 * n)
    for _ in range(2):
        trace = _POOL.get("emit_trace", cap, np.uint16)
        total = c.c_int64(0)
        r = lib.emit_records(
            row32.ctypes.data_as(c.POINTER(c.c_int32)),
            q32.ctypes.data_as(c.POINTER(c.c_int32)),
            t32.ctypes.data_as(c.POINTER(c.c_int32)),
            c.c_int64(n), c.c_int64(G), c.c_int32(k),
            c.c_int32(min_span), c.c_int32(min_cnt), c.c_int32(tspace),
            ok.ctypes.data_as(c.POINTER(c.c_uint8)),
            q0.ctypes.data_as(c.POINTER(c.c_int64)),
            q1.ctypes.data_as(c.POINTER(c.c_int64)),
            t0.ctypes.data_as(c.POINTER(c.c_int64)),
            t1.ctypes.data_as(c.POINTER(c.c_int64)),
            nb.ctypes.data_as(c.POINTER(c.c_int64)),
            trace.ctypes.data_as(c.POINTER(c.c_uint16)),
            c.c_int64(cap), c.byref(total),
        )
        if r == 0:
            # copy: the pooled buffer is reused by the next call, but the
            # trace escapes into the returned OverlapStore
            return ok, q0, q1, t0, t1, nb, trace[: total.value].copy()
        cap = total.value
    return None


def _empty(tspace):
    z = np.zeros(0, INT)
    return OverlapStore.from_arrays(
        tspace=tspace, a_id=z, b_id=z, a_len=z, b_len=z, a_start=z, a_end=z,
        b_start=z, b_end=z, rc=z,
    )


def use_device_join(device) -> bool:
    """Whether overlap_reads runs the device join on `device`:
    HINGE_DEVICE_JOIN=1 yes, =0 no (the C join); unset, on CUDA only."""
    mode = os.environ.get("HINGE_DEVICE_JOIN", "")
    if mode not in ("", "0", "1"):
        raise ValueError(f"HINGE_DEVICE_JOIN={mode!r}: expected 0 or 1")
    if mode:
        return mode == "1"
    return torch.device(device).type == "cuda"


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
    stats: Optional[dict] = None,
) -> OverlapStore:
    """All-vs-all read overlapping: the read set mapped against itself.

    Replaces the reference's external DALIGNER run (L0 in SURVEY.md §1) for
    fasta-only pipelines. Like a merged `.las`, every overlap appears as an
    exactly coordinate-mirrored (i,j)/(j,i) record pair (the downstream
    draft stage matches records by summed length, draft.cpp:163-177, so the
    two directions must agree byte-for-byte); trivial self matches (same
    read, forward strand, near-zero diagonal) are dropped.  The half-pair
    base records come from the device join on `device` or from the C join,
    as `use_device_join(device)` says; `stats`, when given, gathers the
    device join's (overlap_base_records).
    """
    if not use_device_join(device):
        targets = [rs.get_bases(i) for i in range(rs.n_reads)]
        ov = map_reads_to_targets(
            targets, rs, k=k, w=w, min_span=min_span, min_hits=min_hits,
            band_width=band_width, tspace=tspace, half_pairs=True,
        )
        return dedup_and_mirror(ov, band_width, tspace)
    from hinge_tpu_torch.overlap import device_join as DJ

    gate = DJ.join_gate(rs, k, w, band_width, device=device)
    if gate is not None:
        raise ValueError(f"the device join cannot run on these reads "
                         f"({gate}); HINGE_DEVICE_JOIN=0 runs the C join")
    ov = DJ.overlap_base_records(
        rs, k=k, w=w, min_span=min_span, min_hits=min_hits,
        band_width=band_width, tspace=tspace, device=device, stats=stats)
    return dedup_and_mirror(ov, band_width, tspace)


def dedup_and_mirror(ov: OverlapStore, band_width: int,
                     tspace: int) -> OverlapStore:
    """Drop trivial self matches, keep one canonical record per unordered
    pair and synthesize its exact mirror (the tail of hinge_tpu's
    overlap_reads, after its join)."""
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


def _mirror_all(base: OverlapStore, tspace: int):
    """(j,i) twins of every record in `base` (mapper output convention:
    per-record trace displacements at odd positions): B-grid trace points
    interpolated along each record's (A, W) lattice, with a telescoping
    correction so displacements sum exactly to the A span.  Native C fast
    path (one linear two-pointer pass per record, io_native.cpp
    mirror_traces) with the vectorized numpy body as fallback/oracle.
    Returns (cols dict, flat trace, per-record tlen)."""
    n = base.n
    a0 = base.a_start.astype(np.int64)
    a1 = base.a_end.astype(np.int64)
    b0 = base.b_start.astype(np.int64)
    b1 = base.b_end.astype(np.int64)
    rc = base.rc.astype(np.int64)
    cols = dict(
        a_id=base.b_id.astype(np.int64), b_id=base.a_id.astype(np.int64),
        a_len=base.b_len.astype(np.int64), b_len=base.a_len.astype(np.int64),
        a_start=b0, a_end=b1, b_start=a0, b_end=a1,
        rc=rc, diffs=base.diffs.astype(np.int64),
    )
    if n == 0:
        return cols, np.zeros(0, np.uint16), np.zeros(0, np.int64)

    native = _native_mirror_all(base, tspace, b0, b1)
    if native is not None:
        m_trace, m_tlen = native
        return cols, m_trace, m_tlen

    # ---- A/W anchor lattice per record (cf. _lattice) ----
    nd = base.tlen.astype(np.int64) // 2  # displacement count
    nbA = nd + 1
    totA = int(nbA.sum())
    offA = np.cumsum(nbA) - nbA
    rowA = np.repeat(np.arange(n, dtype=np.int64), nbA)
    jA = np.arange(totA, dtype=np.int64) - offA[rowA]
    # flat displacement values (odd trace positions per record)
    totD = int(nd.sum())
    rowD = np.repeat(np.arange(n, dtype=np.int64), nd)
    jD = np.arange(totD, dtype=np.int64) - (np.cumsum(nd) - nd)[rowD]
    disp = base.trace[base.trace_off[rowD] + 2 * jD + 1].astype(np.int64)
    # segmented cumsum of displacements
    cs = np.cumsum(disp)
    seg0 = cs[np.cumsum(nd) - nd] - disp[np.cumsum(nd) - nd]
    cseg = cs - seg0[rowD]  # inclusive cumsum within record
    sign = np.where(rc == 1, -1, 1)
    w0 = np.where(rc == 1, b1, b0)
    wend = np.where(rc == 1, b0, b1)
    lastA = nbA - 1
    W = np.empty(totA, dtype=np.int64)
    A = np.empty(totA, dtype=np.int64)
    # interior anchor i (1 <= i <= nbA-2): w0 + sign * cumsum(disp)[i-1];
    # its cumsum entry sits at offD[row] + i - 1
    offD = np.cumsum(nd) - nd
    idxD = np.clip(offD[rowA] + jA - 1, 0, max(totD - 1, 0))
    interiorW = w0[rowA] + sign[rowA] * cseg[idxD]
    W = np.where(jA == 0, w0[rowA],
                 np.where(jA == lastA[rowA], wend[rowA], interiorW))
    A = np.where(jA == 0, a0[rowA],
                 np.where(jA == lastA[rowA], a1[rowA],
                          (a0[rowA] // tspace + jA) * tspace))
    # ascending-W view (reverse segments of rc records)
    rev = rc[rowA] == 1
    src = np.where(rev, offA[rowA] + lastA[rowA] - jA, offA[rowA] + jA)
    Wasc = W[src]
    Aasc = A[src]

    # ---- B-grid bounds per record ----
    nbB = np.maximum((b1 - 1) // tspace - b0 // tspace, 0) + 2
    totB = int(nbB.sum())
    offB = np.cumsum(nbB) - nbB
    rowB = np.repeat(np.arange(n, dtype=np.int64), nbB)
    jB = np.arange(totB, dtype=np.int64) - offB[rowB]
    lastB = nbB - 1
    bnd = (b0[rowB] // tspace + jB) * tspace
    bnd = np.where(jB == 0, b0[rowB],
                   np.where(jB == lastB[rowB], b1[rowB], bnd))

    # ---- segmented interpolation of bounds on the (Wasc, Aasc) anchors ----
    LARGE = np.int64(1) << 42
    jh = np.searchsorted(Wasc + rowA * LARGE, bnd + rowB * LARGE,
                         side="right") - 1
    endA = offA + lastA
    has_next = jh < endA[rowB]
    jn = np.minimum(jh + 1, endA[rowB])
    x0, y0 = Wasc[jh], Aasc[jh]
    denom = np.maximum(Wasc[jn] - x0, 1)
    frac = np.where(has_next, (bnd - x0) / denom, 0.0)
    a_at = y0 + frac * (Aasc[jn] - y0)
    bar = np.round(a_at).astype(np.int64)

    # ---- |diffs| within record, telescoping fold, trace assembly ----
    dm = np.abs(bar[1:] - bar[:-1])
    valid = rowB[1:] == rowB[:-1]
    dsum = np.bincount(rowB[1:][valid], weights=dm[valid].astype(np.float64),
                       minlength=n).astype(np.int64)
    delta = (a1 - a0) - dsum
    last_idx = offB + nbB - 2  # index into dm of each record's last diff
    dm[last_idx] = np.maximum(0, dm[last_idx] + delta)
    dmv = np.clip(dm[valid], 0, 65534)
    trace = np.zeros(2 * len(dmv), dtype=np.uint16)
    trace[1::2] = dmv
    return cols, trace, 2 * (nbB - 1)


def _native_scatter_copy(src, src_off, lens, dst, dst_off) -> bool:
    """Segmented uint16 copy via io_native scatter_copy_u16; False without
    the native library (caller falls back to the numpy scatter)."""
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "scatter_copy_u16"):
        return False
    import ctypes as c

    pu16 = c.POINTER(c.c_uint16)
    p64 = c.POINTER(c.c_int64)
    src = np.ascontiguousarray(src, dtype=np.uint16)
    so = np.ascontiguousarray(src_off, dtype=np.int64)
    ln = np.ascontiguousarray(lens, dtype=np.int64)
    do = np.ascontiguousarray(dst_off, dtype=np.int64)
    lib.scatter_copy_u16(
        src.ctypes.data_as(pu16), so.ctypes.data_as(p64),
        ln.ctypes.data_as(p64), dst.ctypes.data_as(pu16),
        do.ctypes.data_as(p64), c.c_int64(len(ln)),
    )
    return True


def _native_mirror_all(base: OverlapStore, tspace: int, b0, b1):
    """(flat mirror trace, per-record tlen) via io_native mirror_traces, or
    None without the native library."""
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "mirror_traces"):
        return None
    import ctypes as c

    nbB = np.maximum((b1 - 1) // tspace - b0 // tspace, 0) + 2
    m_tlen = 2 * (nbB - 1)
    m_off = np.zeros(base.n, dtype=np.int64)
    np.cumsum(m_tlen[:-1], out=m_off[1:])
    m_trace = np.zeros(int(m_tlen.sum()), dtype=np.uint16)
    p32 = c.POINTER(c.c_int32)
    p64 = c.POINTER(c.c_int64)
    pu16 = c.POINTER(c.c_uint16)
    args = [np.ascontiguousarray(x, dtype=np.int32) for x in (
        base.a_start, base.a_end, base.b_start, base.b_end, base.rc, base.tlen)]
    toff = np.ascontiguousarray(base.trace_off, dtype=np.int64)
    tr = np.ascontiguousarray(base.trace, dtype=np.uint16)
    lib.mirror_traces(
        *(a.ctypes.data_as(p32) for a in args[:5]),
        args[5].ctypes.data_as(p32),
        toff.ctypes.data_as(p64), tr.ctypes.data_as(pu16),
        c.c_int64(base.n), c.c_int32(tspace),
        m_off.ctypes.data_as(p64), m_trace.ctypes.data_as(pu16),
        c.c_int32(os.cpu_count() or 1),
    )
    return m_trace, m_tlen

