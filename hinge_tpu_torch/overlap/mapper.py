"""Copied from hinge_tpu/overlap/mapper.py: the logic verbatim, the imports
rewritten to hinge_tpu_torch, and the device join's branch moved from
`map_reads_to_targets` into `overlap_reads`, where it runs the port's
device join (overlap/device_join.py) on the run's device.  The port has
none of hinge_tpu's numpy fallbacks for a missing native library: every
step below runs in it (native/io_native.cpp).

`overlap_reads` takes its half-pair base records from the device join or
from the native C join (`map_reads_to_targets(half_pairs=True)`), as
`use_device_join` decides: the device join on a CUDA device and the C join
on the CPU, unless HINGE_DEVICE_JOIN=1 (the device join) or =0 (the C join)
says otherwise.  Either way the records are then deduplicated and mirrored
on the host (`dedup_and_mirror`).  There is no fallback: an input that the
device join's gates refuse raises ValueError, naming the gate and
HINGE_DEVICE_JOIN=0, instead of taking the C join.  `map_reads_to_targets`
always runs the C join, whatever the switch says.

Minimizer-based read-to-reference mapper.

The reference pipeline delegates alignment discovery to external tools
(DALIGNER / minimap; `demo/*/run.sh`, `pipeline_consensus.py:41-64` runs
HPC.daligner to map raw reads onto the draft).  This module provides a
built-in equivalent so the framework is standalone.

Pipeline (no per-hit Python):
  1. (w,k)-minimizer extraction per sequence (rolling hash, `_kmer_hash`'s
     bits; `minimizers_batch`),
  2. the index: a stable radix sort by hash, buckets > 64 entries dropped
     as repetitive (`index_sort_filter`),
  3. join + chaining per read (`map_block_hits`): a diagonal-band
     histogram per (read, strand, target) group, best adjacent band pair
     wins, its hits thinned to >= 32 bases apart on the query,
  4. spans from the monotone hits; trace-point displacements interpolated
     from the anchors every tspace bases (`emit_records`).

Output: OverlapStore records (A = target/contig, B = read) with the
DALIGNER/getOverlap coordinate convention, consumable by the consensus
stage exactly like `.las` input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from hinge_tpu_torch.data.overlaps import INT, OverlapStore, ReadStore
from hinge_tpu_torch.utils.log import span


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
    """(positions, hashes) of window minimizers, by the native C core (the
    hash is _kmer_hash's, bit for bit)."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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
    (pos int32, hash uint64, counts int64 per stream). Streams are
    per sequence (forward[, reverse-complement]) in sequence order,
    bit-identical to per-sequence `minimizers` calls."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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
    """The targets' minimizer index: batched native minimizers, then
    `_sorted_index`."""
    lens = np.array([len(t) for t in targets], dtype=np.int64)
    if not targets:
        z = np.zeros(0, np.uint64)
        return MapperIndex(k=k, w=w, hashes=z, packed=z, t_len=lens)
    offsets = np.zeros(len(targets) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.concatenate(targets) if len(targets) > 1 else np.asarray(targets[0])
    pos, hashes, counts = _minimizers_batch(flat, offsets, k, w,
                                            both_strands=False)
    tids = np.repeat(np.arange(len(targets), dtype=np.uint64), counts)
    packed = (tids << np.uint64(40)) | pos.astype(np.uint64)
    # copy: `hashes` is a pooled scratch view that the per-block query
    # minimizer calls will overwrite, but the index must outlive them
    return _sorted_index(hashes.copy(), packed, lens, k, w, max_bucket)


def _sorted_index(hashes, packed, t_len, k: int, w: int,
                  max_bucket: int) -> MapperIndex:
    """MapperIndex from unsorted (hash, tid << 40 | pos) entries: stable
    LSD radix sort by hash + repetitive-bucket filter (buckets of more than
    `max_bucket` entries dropped), in place, by the native
    index_sort_filter."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    c = ctypes
    n2 = lib.index_sort_filter(
        hashes.ctypes.data_as(c.POINTER(c.c_uint64)),
        packed.ctypes.data_as(c.POINTER(c.c_uint64)),
        c.c_int64(len(hashes)), c.c_int64(max_bucket),
    )
    if n2 < 0:
        raise MemoryError(
            f"index_sort_filter returned {n2}: no scratch for "
            f"{len(hashes)} index entries")
    return MapperIndex(k=k, w=w, hashes=hashes[:n2], packed=packed[:n2],
                       t_len=t_len)


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
            with span("map.minimizers"):
                got = _minimizers_batch(rs.bases, rs.bases_off, k, w,
                                        both_strands=True)
                pre = cache_minimizers(rs, k, w, *(a.copy() for a in got))
    with span("map.index"):
        if half_pairs and pre is not None:
            # all-vs-all: the forward streams double as the index input
            index = _index_from_minimizers(targets, pre, k, w)
        else:
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

    with span("map.blocks"):
        if rs.n_reads > query_block:
            stores = []
            for lo in range(0, rs.n_reads, query_block):
                hi = min(lo + query_block, rs.n_reads)
                sub = ReadStore(
                    length=rs.length[lo:hi],
                    bases_off=(rs.bases_off[lo : hi + 1] - rs.bases_off[lo]),
                    bases=rs.bases[rs.bases_off[lo] : rs.bases_off[hi]],
                )
                part = _map_block(index, sub, k, w, min_span,
                                  min_hits, band_width, tspace, rid_base=lo,
                                  half_pairs=half_pairs,
                                  pre_minimizers=block_slice(lo, hi))
                stores.append(part)
            out = _concat(stores, tspace)
        else:
            out = _map_block(index, rs, k, w, min_span, min_hits,
                             band_width, tspace, rid_base=0,
                             half_pairs=half_pairs,
                             pre_minimizers=block_slice(0, rs.n_reads))
    if not half_pairs:
        # fill true per-window diffs: DALIGNER consumers size wave arrays
        # from them (see dalign_trace.fill_window_diffs); interpolated
        # traces with diffs=0 crash the reference consensus binary
        from hinge_tpu_torch.ops.dalign_trace import fill_window_diffs

        with span("map.diffs"):
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
                           max_bucket: int = 64) -> MapperIndex:
    """Index built from precomputed both-strands minimizer streams (the
    FORWARD stream of each read is exactly what build_index would compute);
    bit-identical to build_index on the same targets."""
    qp_all, qh_all, counts_all = pre
    n = len(targets)
    off = np.zeros(len(counts_all) + 1, np.int64)
    np.cumsum(counts_all, out=off[1:])
    fwd = np.arange(0, 2 * n, 2)
    lens = np.array([len(t) for t in targets], dtype=np.int64)
    hashes = np.concatenate([qh_all[off[s] : off[s + 1]] for s in fwd])
    tids = np.repeat(np.arange(n, dtype=np.uint64), counts_all[fwd])
    pos = np.concatenate([qp_all[off[s] : off[s + 1]] for s in fwd])
    packed = (tids << np.uint64(40)) | pos.astype(np.uint64)
    return _sorted_index(hashes, packed, lens, k, w, max_bucket)


def _map_block(
    index: MapperIndex,
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
    # ---- 1. all query minimizers (precomputed slice in the all-vs-all
    # path, batched native otherwise) ----
    got = pre_minimizers
    if got is None:
        got = _minimizers_batch(rs.bases, rs.bases_off, k, w,
                                both_strands=True)
    qp, qh, counts = got
    if len(qh) == 0:
        return _empty(tspace)

    # ---- 2. native C join+chaining core: per-read local hash histogram,
    # no global hit table ----
    hit_row, hit_q, hit_t, g_rid, g_strand, g_tid = _native_map_block(
        index, qh, qp, counts.tolist(), rid_base, half_pairs,
        band_width, min_hits,
    )
    if len(g_rid) == 0:
        return _empty(tspace)
    # min_hits was already enforced on the full (pre-subsample) band
    # counts inside the native pass; only degenerate rows drop here.
    # Hit columns stay int32 (the native emit path consumes them as-is).
    return _emit_records(
        hit_row, hit_q, hit_t, g_rid, g_strand, g_tid,
        rs, index, k, min_span, 2, tspace, rid_base,
    )


def _native_map_block(index: MapperIndex, qh, qp, stream_lens,
                      rid_base, half_pairs, band_width, min_hits,
                      sub_gap: int = 32):
    """ctypes call into map_block_hits (io_native.cpp). Returns (hit_row,
    hit_q, hit_t, g_rid, g_strand, g_tid) with hits subsampled to >= sub_gap
    bp apart on the query."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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
    span check and trace-point interpolation, by the native emit core."""
    G = len(g_rid)
    if G == 0 or len(row_of) == 0:
        return _empty(tspace)
    ok, nq0, nq1, nt0, nt1, nnb, ntrace = _native_emit_records(
        row_of, tq, tt, G, k, min_span, min_cnt, tspace)
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


def _native_emit_records(row_of, tq, tt, G, k, min_span, min_cnt, tspace):
    """Native emit core: (row,q)-stable sort + monotone filter + spans +
    trace interpolation. Returns (ok, q0, q1, t0, t1, nb, trace)."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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
    raise RuntimeError(
        f"emit_records returned {r} with a trace buffer of the "
        f"{cap} values it asked for")


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
) -> OverlapStore:
    """All-vs-all read overlapping: the read set mapped against itself.

    Replaces the reference's external DALIGNER run (L0 in SURVEY.md §1) for
    fasta-only pipelines. Like a merged `.las`, every overlap appears as an
    exactly coordinate-mirrored (i,j)/(j,i) record pair (the downstream
    draft stage matches records by summed length, draft.cpp:163-177, so the
    two directions must agree byte-for-byte); trivial self matches (same
    read, forward strand, near-zero diagonal) are dropped.  The half-pair
    base records come from the device join on `device` or from the C join,
    as `use_device_join(device)` says; the mirroring is the span
    `overlap.mirror`.
    """
    if not use_device_join(device):
        targets = [rs.get_bases(i) for i in range(rs.n_reads)]
        ov = map_reads_to_targets(
            targets, rs, k=k, w=w, min_span=min_span, min_hits=min_hits,
            band_width=band_width, tspace=tspace, half_pairs=True,
        )
        with span("overlap.mirror"):
            return dedup_and_mirror(ov, band_width, tspace)
    from hinge_tpu_torch.overlap import device_join as DJ

    gate = DJ.join_gate(rs, k, w, band_width, device=device)
    if gate is not None:
        raise ValueError(f"the device join cannot run on these reads "
                         f"({gate}); HINGE_DEVICE_JOIN=0 runs the C join")
    ov = DJ.overlap_base_records(
        rs, k=k, w=w, min_span=min_span, min_hits=min_hits,
        band_width=band_width, tspace=tspace, device=device)
    with span("overlap.mirror"):
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
        _native_scatter_copy(src, src_off, lens, trace, dst_off)
    return OverlapStore.from_arrays(
        tspace=tspace, trace=trace, tlen=tlen, **cols,
    ).sort_by_a()


def _mirror_all(base: OverlapStore, tspace: int):
    """(j,i) twins of every record in `base` (mapper output convention:
    per-record trace displacements at odd positions): B-grid trace points
    interpolated along each record's (A, W) lattice, with a telescoping
    correction so displacements sum exactly to the A span, by the native
    mirror_traces (one linear two-pointer pass per record, io_native.cpp).
    Returns (cols dict, flat trace, per-record tlen)."""
    b0 = base.b_start.astype(np.int64)
    b1 = base.b_end.astype(np.int64)
    cols = dict(
        a_id=base.b_id.astype(np.int64), b_id=base.a_id.astype(np.int64),
        a_len=base.b_len.astype(np.int64), b_len=base.a_len.astype(np.int64),
        a_start=b0, a_end=b1,
        b_start=base.a_start.astype(np.int64),
        b_end=base.a_end.astype(np.int64),
        rc=base.rc.astype(np.int64), diffs=base.diffs.astype(np.int64),
    )
    if base.n == 0:
        return cols, np.zeros(0, np.uint16), np.zeros(0, np.int64)
    m_trace, m_tlen = _native_mirror_all(base, tspace, b0, b1)
    return cols, m_trace, m_tlen


def _native_scatter_copy(src, src_off, lens, dst, dst_off) -> None:
    """Segmented uint16 copy via io_native scatter_copy_u16."""
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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


def _native_mirror_all(base: OverlapStore, tspace: int, b0, b1):
    """(flat mirror trace, per-record tlen) via io_native mirror_traces."""
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
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

