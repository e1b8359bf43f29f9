"""All-vs-all minimizer overlap join as torch ops on one device.

Port of `hinge_tpu/overlap/device_join.py`: rolling-hash minimizer
extraction, index build, seed-hit join, diagonal-band chaining, greedy
anchor thinning and trace-point emission run on the device, which
receives only the 2-bit-packed read codes and returns only the surviving
records and their traces.  Records are bit-identical to the native C path
(mapper._native_map_block + emit_records) and to hinge_tpu's device join:
every ordering, tie-break, subsampling and rounding rule is kept.

What differs from hinge_tpu, and why it gives the same records:

  * Shapes are dynamic, so each buffer is sized from the counts (one host
    sync per compaction) and there are no capacity caps, overflow flags or
    retries.
  * The bounded binary searches become global `torch.searchsorted` calls
    over a packed key.  Each searched array is globally sorted by
    (segment, key) -- the index by hash (its prefix buckets are ranges of
    the hash), the accepted hits by (row, q), the kept anchors by (row, t)
    -- so the first index >= / > a (segment, key) target is the bounded
    search's answer.  Hence no prefix table and no search-depth gates.
  * There is no unsigned 64-bit arithmetic: the splitmix hash runs on
    int64 (multiply and XOR wrap to the same bits; every right shift is
    masked to be logical) and hashes are compared with their sign bit
    flipped, which orders int64 as the uint64 values would be ordered.
  * Seed hits of over-full index buckets (> max_bucket entries) are never
    expanded: hinge_tpu expands and then drops them, so the surviving hit
    stream and its order are the same.
  * Multi-key stable sorts pack (read, group key) into one int64; the
    (row, q, t) sort is two stable passes, t first.

  * Reads shorter than k + w run: a stream of fewer than w k-mers gets
    the C join's one minimizer at its first minimum.  hinge_tpu gates
    them off.

The key-packing gates of hinge_tpu stay (`join_gate`), beside one on the
card's free memory: where one fails, overlap_base_records returns None.

p3 (`thin_rows`) is a hand kernel on CUDA tensors, K4
(csrc/thin_rows.cu: a warp walks a row once, 32 anchors a step, the
greedy step by ballots and shuffles); its twin `thin_rows_ref` runs for
CPU tensors.  The other programs are torch ops.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional

import numpy as np
import torch

from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore
from hinge_tpu_torch.device import DeviceError, to_device
from hinge_tpu_torch.ops._build import load_kernels

# copied from hinge_tpu/overlap/device_join.py (:61-62, :666-674)
BANDBITS = 12          # band_rel field width in the 32-bit group key
MAX_TID = 1 << 18      # key packs tid into 31-(1+BANDBITS) = 18 bits
#: the join's peak device memory, bytes a read base and fixed: a margin
#: over the peaks that `bench_defaults_ab`'s join check measured on an
#: H100, 2,061,248,000 bytes at 138,000,923 read bases and 8,699,400,192
#: at 690,004,897 (~12 bytes a base); join_gate refuses an input above it
JOIN_BYTES_PER_BASE = 16
JOIN_BYTES_FIXED = 1 << 30

_I64 = torch.int64
_SIGN = -(1 << 63)  # flips int64 order into uint64 order
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_B30 = 1 << 30
_TBITS = 25  # row << 25 | q (or t) keys: q, t < 2^24 (join_gate) + slack

#: calls of each device program on CUDA tensors, and K4's launches
#: ("thin_rows"), read by chip_smoke.py to prove the overlap stage went
#: through this module
launches = {"minimizer": 0, "index": 0, "p1": 0, "p2": 0, "p3": 0, "p4": 0,
            "thin_rows": 0}


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        launches[name] += 1


def _lsr(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def splitmix(v: torch.Tensor) -> torch.Tensor:
    """mapper._kmer_hash's finalizer on int64 bit patterns."""
    h = (v ^ _lsr(v, 30)) * _M1
    h = (h ^ _lsr(h, 27)) * _M2
    return h ^ _lsr(h, 31)


def kmer_hash(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Hash of every k-mer start of a code vector (bit pattern of
    mapper._kmer_hash as int64; positions past n-k hash zero-padded
    k-mers)."""
    v = torch.zeros_like(codes, dtype=_I64)
    c = codes.to(_I64)
    for i in range(k):
        v = (v << 2) | _shift(c, i, 0)
    return splitmix(v)


def _shift(a: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    if s == 0:
        return a
    s = min(s, a.shape[0])
    return torch.cat([a[s:], a.new_full((s,), fill)])


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _tmin(a, b):
    """(h, pos) lexicographic min; h in flipped (unsigned) order."""
    ah, ap = a
    bh, bp = b
    take_a = (ah < bh) | ((ah == bh) & (ap <= bp))
    return torch.where(take_a, ah, bh), torch.where(take_a, ap, bp)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _pack_codes(rs: ReadStore) -> np.ndarray:
    c = np.ascontiguousarray(rs.bases, dtype=np.uint8)
    n = len(c)
    pad = (-n) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    quads = c.reshape(-1, 4)
    return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)).astype(np.uint8)


# ---------------------------------------------------------------------------
# the device programs (one per jitted program of hinge_tpu)
# ---------------------------------------------------------------------------


def minimizers(packed, code_off, lens, r0: int, r1: int, x_len: int,
               k: int, w: int):
    """Block minimizers (hinge_tpu `_minimizer_fn`): unpack the 2-bit codes
    of reads [r0, r1) into the [fwd, rc]* working array of length x_len,
    hash every k-mer, take the first-tie (h, pos) minimum of every w-window
    and compact the selected positions.

    A window touching an invalid k-mer start (the k-1 tail of a stream)
    resolves to the pad key (h=0, pos=-1) and is discarded, which is the
    per-stream window semantics (w <= k).  A stream of fewer than w
    k-mers gets its first minimum, and one shorter than k nothing, as in
    the C join.  Returns the query minimizers
    (mh flipped hash, mpos, msid) and the forward-stream index entries
    (ih, itid, ipos), int64, in position order."""
    _count("minimizer", packed)
    dev = packed.device
    slen = lens[r0:r1].repeat_interleave(2)  # fwd, rc per read
    ss = _excl_cumsum(slen)
    sid = torch.repeat_interleave(torch.arange(slen.shape[0], device=dev),
                                  slen, output_size=x_len)
    pos = torch.arange(x_len, device=dev)
    off_in = pos - ss[sid]
    rd = r0 + (sid >> 1)
    is_rc = (sid & 1) == 1
    L = lens[rd]
    src = code_off[rd] + torch.where(is_rc, L - 1 - off_in, off_in)
    code = (packed[src >> 2].to(_I64) >> ((src & 3) * 2)) & 3
    code = torch.where(is_rc, 3 - code, code)

    h = kmer_hash(code, k)
    valid = off_in <= L - k
    key = torch.where(valid, h ^ _SIGN, _SIGN)
    pk = torch.where(valid, pos, -1)

    # sliding (h, pos) min over windows of w via a sparse table
    mins = {1: (key, pk)}
    s = 1
    while s < w:
        ph, pp = mins[s]
        mins[2 * s] = _tmin((ph, pp), (_shift(ph, s, _SIGN), _shift(pp, s, -1)))
        s *= 2
    p2 = 1 << (w.bit_length() - 1)
    if p2 == w:
        wp = mins[p2][1]
    else:
        p2b = _pow2(w - p2)
        _, wp = _tmin(mins[p2], (_shift(mins[p2b][0], w - p2b, _SIGN),
                                 _shift(mins[p2b][1], w - p2b, -1)))
    sel = torch.zeros(x_len + 1, dtype=torch.bool, device=dev)
    sel[torch.where(wp >= 0, wp, x_len)] = True
    # a stream of 1..w-1 k-mers has no whole window: it gets one
    # minimizer, at the first minimum of its k-mers (mapper.minimizers)
    n_kmers = slen - k + 1
    short = (n_kmers >= 1) & (n_kmers < w)
    if bool(short.any()):
        sp = torch.nonzero(valid & short[sid]).squeeze(1)
        s_id, s_key = sid[sp], key[sp]
        n_st = slen.shape[0]
        s_min = torch.full((n_st,), (1 << 63) - 1, dtype=_I64,
                           device=dev).scatter_reduce_(0, s_id, s_key, "amin")
        at_min = s_key == s_min[s_id]
        first = torch.full((n_st,), x_len, dtype=_I64,
                           device=dev).scatter_reduce_(
            0, s_id[at_min], sp[at_min], "amin")
        sel[first[short]] = True
    m = torch.nonzero(sel[:x_len]).squeeze(1)
    mh, mpos, msid = key[m], off_in[m], sid[m]
    fwd = torch.nonzero((msid & 1) == 0).squeeze(1)
    return (mh, mpos, msid), (mh[fwd], r0 + (msid[fwd] >> 1), mpos[fwd])


def build_index(ih, itid, ipos, max_bucket: int):
    """Global index (hinge_tpu `_scatter_fn` + `_index_fn`): the blocks'
    entries concatenated in block order, stably sorted by hash, and the
    entries of buckets with more than max_bucket entries marked invalid."""
    _count("index", ih)
    order = torch.sort(ih, stable=True).indices
    sh, stid, spos = ih[order], itid[order], ipos[order]
    n = sh.shape[0]
    newb = torch.ones(n, dtype=torch.bool, device=sh.device)
    newb[1:] = sh[1:] != sh[:-1]
    bid = torch.cumsum(newb, 0) - 1
    cnts = torch.zeros(n, dtype=_I64, device=sh.device).index_add_(
        0, bid, torch.ones_like(bid))
    return sh, stid, spos, cnts[bid] <= max_bucket


def join_hits(sh, stid, spos, entry_valid, mh, mpos, msid, r0: int,
              band_off, band_width: int):
    """p1: index lookup, hit expansion, band key, and the stable sort by
    (read, target, strand, band).  Only half pairs (target >= read) are
    kept.  Returns (skey, q, t) of the surviving hits, sorted, with
    skey = read << 31 | target << 13 | strand << 12 | band_rel."""
    _count("p1", mh)
    dev = mh.device
    n_idx = sh.shape[0]
    lo = torch.searchsorted(sh, mh, right=False)
    cnt = torch.searchsorted(sh, mh, right=True) - lo
    # over-full buckets: every hit would be dropped, so expand none (the
    # caller never passes an empty index)
    cnt = torch.where(entry_valid[torch.clamp(lo, max=n_idx - 1)], cnt, 0)
    offs = _excl_cumsum(cnt)
    total = int(cnt.sum())
    qm = torch.repeat_interleave(torch.arange(mh.shape[0], device=dev), cnt,
                                 output_size=total)
    entry = lo[qm] + torch.arange(total, device=dev) - offs[qm]
    g_rid = r0 + (msid[qm] >> 1)
    tid = stid[entry]
    ok = torch.nonzero(tid >= g_rid).squeeze(1)
    qm, entry, g_rid, tid = qm[ok], entry[ok], g_rid[ok], tid[ok]
    strand = msid[qm] & 1
    q = mpos[qm]
    t = spos[entry]
    band = torch.div(t - q + _B30, band_width, rounding_mode="floor")
    # join_gate keeps band_rel inside [0, 2^BANDBITS): t - q >= -(L_q - k)
    band_rel = band - band_off[g_rid - r0]
    gkey = (((tid << 1) | strand) << BANDBITS) | band_rel
    skey = (g_rid << 31) | gkey
    order = torch.sort(skey, stable=True).indices
    return skey[order], q[order], t[order]


def chain_bands(skey, q_s, t_s, min_hits: int):
    """p2: band run lengths, best adjacent band pair per (read, target,
    strand) group, accepted rows, and the accepted hits sorted by
    (row, q, t).  Returns (a_row, a_q, a_t, row_rid, row_tid, row_strand)."""
    _count("p2", skey)
    dev = skey.device
    n_h = skey.shape[0]
    newband = torch.ones(n_h, dtype=torch.bool, device=dev)
    newband[1:] = skey[1:] != skey[:-1]
    band_id = torch.cumsum(newband, 0) - 1
    b_start = torch.nonzero(newband).squeeze(1)
    nb = b_start.shape[0]
    b_cnt = torch.cat([b_start[1:], b_start.new_tensor([n_h])]) - b_start
    b_rid = skey[b_start] >> 31
    b_key = skey[b_start] & ((1 << 31) - 1)
    b_grp = b_key >> BANDBITS

    newgrp = torch.ones(nb, dtype=torch.bool, device=dev)
    newgrp[1:] = (b_rid[1:] != b_rid[:-1]) | (b_grp[1:] != b_grp[:-1])
    grp_id = torch.cumsum(newgrp, 0) - 1
    # adjacent band of the same read: key + 1 (as hinge_tpu, across the
    # group boundary too)
    next_same = torch.zeros(nb, dtype=torch.bool, device=dev)
    next_same[:-1] = (b_rid[1:] == b_rid[:-1]) & (b_key[1:] == b_key[:-1] + 1)
    pair_cnt = b_cnt + torch.where(
        next_same, torch.cat([b_cnt[1:], b_cnt.new_zeros(1)]), 0)
    g_best = torch.zeros(nb, dtype=_I64, device=dev).scatter_reduce_(
        0, grp_id, pair_cnt, "amax")
    ar = torch.arange(nb, device=dev)
    is_best = pair_cnt == g_best[grp_id]
    g_besti = torch.full((nb,), nb, dtype=_I64, device=dev).scatter_reduce_(
        0, grp_id, torch.where(is_best, ar, nb), "amin")

    accepted_b = g_best[grp_id] >= min_hits
    g_accept = newgrp & accepted_b
    row_of = torch.cumsum(g_accept, 0) - 1
    rows_b = torch.nonzero(g_accept).squeeze(1)
    row_rid, row_grp = b_rid[rows_b], b_grp[rows_b]

    bi = g_besti[grp_id]
    sel_best = accepted_b & (ar == bi)
    sel_next = accepted_b & (ar == bi + 1) & \
        next_same[torch.clamp(bi, 0, max(nb - 1, 0))]
    row_at = torch.where(sel_best | sel_next, row_of, -1)
    hit_row = row_at[band_id]
    acc = torch.nonzero(hit_row >= 0).squeeze(1)
    a_row, a_q, a_t = hit_row[acc], q_s[acc], t_s[acc]
    # sort by (row, q, t): stable passes, least significant key first
    o = torch.sort(a_t, stable=True).indices
    a_row, a_q, a_t = a_row[o], a_q[o], a_t[o]
    o = torch.sort((a_row << 24) | a_q, stable=True).indices
    return (a_row[o], a_q[o], a_t[o], row_rid, row_grp >> 1, row_grp & 1)


def thin_rows(a_row, a_q, a_t, n_rows: int, k: int, sub_gap: int,
              min_span: int, min_cnt: int, tspace: int):
    """p3 on the anchors' device: K4 (csrc/thin_rows.cu) for CUDA tensors,
    the plain twin `thin_rows_ref` for CPU tensors.  Arguments and
    outputs as for `thin_rows_ref`."""
    dev = a_row.device
    for name, x in (("a_row", a_row), ("a_q", a_q), ("a_t", a_t)):
        if x.dtype != _I64 or x.dim() != 1 or x.device != dev:
            raise ValueError(f"thin_rows: {name} must be int64 [n_a] on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if not (a_row.shape == a_q.shape == a_t.shape):
        raise ValueError("thin_rows: a_row, a_q, a_t differ in length")
    if n_rows < 1:
        raise ValueError(f"thin_rows: n_rows = {n_rows}, want > 0")
    _count("p3", a_row)
    if dev.type == "cpu":
        return thin_rows_ref(a_row, a_q, a_t, n_rows, k, sub_gap, min_span,
                             min_cnt, tspace)
    return launch_thin_rows(a_row, a_q, a_t, n_rows, k, sub_gap, min_span,
                            min_cnt, tspace)


def launch_thin_rows(a_row, a_q, a_t, n_rows: int, k: int, sub_gap: int,
                     min_span: int, min_cnt: int, tspace: int):
    """K4 on CUDA tensors that thin_rows has checked: the row bounds, the
    walk (a warp a row, the kept anchors to scratch), the prefix sum of
    the kept counts with one host sync for their total, and the copy into
    f.  Raises DeviceError when a kernel does not build or launch,
    ValueError when a row keeps no anchor (the input broke the
    one-anchor-a-row contract)."""
    dev = a_row.device
    if dev.type != "cuda":
        raise ValueError(f"thin_rows: no kernel for device {dev}")
    lib = load_kernels()
    a_row, a_q, a_t = a_row.contiguous(), a_q.contiguous(), a_t.contiguous()
    n_a = a_row.shape[0]
    params = [int(x) for x in (k, sub_gap, min_span, min_cnt, tspace)]

    def check(err, what):
        if err:
            raise DeviceError(f"thin_rows {what} failed: cudaError {err}")

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # one buffer: fr_start, fr_end, Q0, Q1, T0, T1, nb (the outputs),
        # then m, r_start [n_rows + 1] and stats [2], 8 bytes a word
        rows = torch.empty(9 * n_rows + 3, dtype=_I64, device=dev)
        okr = torch.empty(n_rows, dtype=torch.bool, device=dev)
        fr_start, fr_end, Q0, Q1, T0, T1, nb, m, r_start = (
            rows.data_ptr() + 8 * n_rows * i for i in range(9))
        stats = r_start + 8 * (n_rows + 1)
        scratch = torch.empty(2 * n_a, dtype=_I64, device=dev)
        k_q = scratch.data_ptr()
        k_t = k_q + 8 * n_a
        check(lib.hinge_thin_rows_bounds(a_row.data_ptr(), n_a, n_rows,
                                         r_start, stats, stream), "bounds")
        check(lib.hinge_thin_rows_walk(
            a_q.data_ptr(), a_t.data_ptr(), r_start, n_rows, *params, k_q,
            k_t, m, Q0, Q1, T0, T1, okr.data_ptr(), nb, stats, stream),
            "walk")
        torch.cumsum(rows[7 * n_rows : 8 * n_rows], 0,
                     out=rows[n_rows : 2 * n_rows])
        host = (ctypes.c_longlong * 2)()
        check(lib.hinge_thin_rows_sync(fr_end, n_rows, stats,
                                       ctypes.addressof(host), stream), "sync")
        n_f, m_min = host
        if m_min < 1:
            raise ValueError("thin_rows: a row kept no anchor; each of rows "
                             "0..n_rows-1 must hold at least one")
        f = torch.empty(3 * n_f, dtype=_I64, device=dev)
        f_q, f_t, f_row = (f.data_ptr() + 8 * n_f * i for i in range(3))
        check(lib.hinge_thin_rows_copy(r_start, m, fr_end, k_q, k_t, n_rows,
                                       f_q, f_t, f_row, fr_start, stream),
              "copy")
    launches["thin_rows"] += 1
    f_q, f_t, f_row = f.view(3, n_f)
    fr_start, fr_end, Q0, Q1, T0, T1, nb = rows[: 7 * n_rows].view(7, n_rows)
    return f_q, f_t, f_row, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb


def thin_rows_ref(a_row, a_q, a_t, n_rows: int, k: int, sub_gap: int,
                  min_span: int, min_cnt: int, tspace: int):
    """p3 as plain torch ops, K4's twin: greedy sub_gap thinning (each
    anchor's successor is the first hit >= sub_gap bases later in its
    row; the emission set is the orbit of the row head, marked by pointer
    doubling), the monotone-t filter, and per-row spans (n_rows > 0, each
    row with at least one hit; anchors int64, sorted by (row, q, t)).
    Returns (f_q, f_t, f_row, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb)."""
    dev = a_row.device
    n_a = a_row.shape[0]
    rows = torch.arange(n_rows, device=dev)
    r_start = torch.searchsorted(a_row, rows, right=False)
    r_end = torch.searchsorted(a_row, rows, right=True)
    aidx = torch.arange(n_a, device=dev)
    qkey = (a_row << _TBITS) | a_q
    nxt = torch.searchsorted(qkey, (a_row << _TBITS) + (a_q + sub_gap))
    nxt = torch.maximum(nxt, aidx + 1)
    nxt = torch.where(nxt < r_end[a_row], nxt, n_a)

    # pointer doubling: after r rounds the orbit's first 2^r - 1 steps
    # are marked; an orbit is no longer than its row
    S = (aidx == r_start[a_row]).to(torch.int32)
    J = nxt
    sentinel = J.new_tensor([n_a])
    rounds = int((r_end - r_start).max()).bit_length()
    for _ in range(rounds):
        hit = torch.zeros(n_a + 1, dtype=torch.int32, device=dev)
        hit.scatter_reduce_(0, J, S, "amax")
        S = torch.maximum(S, hit[:n_a])
        J = torch.cat([J, sentinel])[J]
    S = S > 0
    q_emit_max = torch.zeros(n_rows, dtype=_I64, device=dev).scatter_reduce_(
        0, a_row, torch.where(S, a_q, 0), "amax")
    is_last = aidx == r_end[a_row] - 1
    S = S | (is_last & (a_q != q_emit_max[a_row]))
    ks = torch.nonzero(S).squeeze(1)
    k_row, k_q, k_t = a_row[ks], a_q[ks], a_t[ks]

    kk = (k_row << _TBITS) | k_t
    run = torch.cummax(kk, 0).values
    prev = torch.cat([run.new_tensor([-1]), run[:-1]])
    keep = ((prev >> _TBITS) != k_row) | (k_t >= (prev & ((1 << _TBITS) - 1)))
    fs = torch.nonzero(keep).squeeze(1)
    f_row, f_q, f_t = k_row[fs], k_q[fs], k_t[fs]

    fr_start = torch.searchsorted(f_row, rows, right=False)
    fr_end = torch.searchsorted(f_row, rows, right=True)
    m = fr_end - fr_start
    has = m > 0
    # every row keeps its head anchor, so f is not empty
    si = torch.clamp(fr_start, max=f_row.shape[0] - 1)
    ei = torch.clamp(fr_end - 1, min=0)
    Q0 = torch.where(has, f_q[si], 0)
    T0 = torch.where(has, f_t[si], 0)
    Q1 = torch.where(has, f_q[ei] + k, 0)
    T1 = torch.where(has, f_t[ei] + k, 0)
    okr = (m >= min_cnt) & (Q1 - Q0 >= min_span) & (T1 - T0 >= min_span)
    fl = lambda x: torch.div(x, tspace, rounding_mode="floor")  # noqa: E731
    n_int = torch.clamp(fl(T1 - 1) - fl(T0), min=0)
    nb = torch.where(okr, n_int + 2, 0)
    return f_q, f_t, f_row, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb


def emit_traces(f_q, f_t, f_row, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb,
                tspace: int):
    """p4: trace-point grid bounds, integer-exact round-half-even
    interpolation of each bound on the kept anchors, the remainder fold
    into the last displacement, and the flat trace (rows with okr, in row
    order; tlen = 2*(nb-1) each).  Returns the trace as int32."""
    _count("p4", f_q)
    dev = f_q.device
    n_rows = nb.shape[0]
    boff = _excl_cumsum(nb)
    tb_total = int(nb.sum())
    if tb_total == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    row_b = torch.repeat_interleave(torch.arange(n_rows, device=dev), nb,
                                    output_size=tb_total)
    jj = torch.arange(tb_total, device=dev) - boff[row_b]
    last_j = nb[row_b] - 1
    T0b = T0[row_b]
    bval = (torch.div(T0b, tspace, rounding_mode="floor") + jj) * tspace
    bval = torch.where(jj == 0, T0b, torch.where(jj == last_j, T1[row_b], bval))

    fkey = (f_row << _TBITS) | f_t
    ub = torch.searchsorted(fkey, (row_b << _TBITS) + bval, right=True)
    fs, fe = fr_start[row_b], fr_end[row_b]
    jh = torch.minimum(torch.maximum(ub - 1, fs), torch.maximum(fe - 1, fs))
    has_next = jh < fe - 1
    jn = torch.clamp(jh + 1, max=f_t.shape[0] - 1)
    denom = torch.clamp(f_t[jn] - f_t[jh], min=1)
    dy = f_q[jn] - f_q[jh]
    num = f_q[jh] * denom + torch.where(has_next, (bval - f_t[jh]) * dy, 0)
    qd = torch.div(num, denom, rounding_mode="floor")
    r2 = 2 * (num - qd * denom)
    qd = qd + ((r2 > denom) | ((r2 == denom) & ((qd & 1) == 1))).to(_I64)
    bar = torch.where(jj == 0, Q0[row_b], torch.where(jj == last_j, Q1[row_b], qd))

    nxt_bar = torch.cat([bar[1:], bar.new_zeros(1)])
    is_d = jj < last_j
    d = torch.where(is_d, torch.clamp(nxt_bar - bar, 0, 65534), 0)
    dsum = torch.zeros(n_rows, dtype=_I64, device=dev).index_add_(0, row_b, d)
    delta = torch.where(okr, (Q1 - Q0) - dsum, 0)
    is_lastd = is_d & (jj == last_j - 1)
    newlast = d + delta[row_b]
    d = torch.where(is_lastd & (newlast >= 0) & (newlast < 65535), newlast, d)

    tlen_row = torch.where(okr, 2 * (nb - 1), 0)
    toff = _excl_cumsum(tlen_row)
    # 2 * tb_total bounds the trace length; the caller cuts it to sum(tlen)
    tpos = torch.where(is_d, toff[row_b] + 2 * jj + 1, 2 * tb_total)
    trace = torch.zeros(2 * tb_total + 1, dtype=_I64, device=dev)
    trace.scatter_reduce_(0, tpos, d, "amax")
    return trace[: 2 * tb_total].to(torch.int32)


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------


def join_gate(rs: ReadStore, k: int, w: int, band_width: int,
              device=None) -> Optional[str]:
    """The key-packing gates of hinge_tpu's device join (its :693-701),
    less its short-read gate, and on a CUDA `device` the card's free
    memory: the reason the join cannot run on `rs`, or None when it can.
    Reads shorter than k + w run (see minimizers)."""
    if rs.bases is None:
        return "no read bases"
    if rs.n_reads == 0:
        return None
    lens = rs.length.astype(np.int64)
    if rs.n_reads >= MAX_TID:
        return f"{rs.n_reads} reads >= MAX_TID = {MAX_TID}"
    if int(lens.max()) >= (1 << 24):
        return f"a read of {int(lens.max())} bases >= 2^24"
    if w > k:
        return f"w = {w} > k = {k}"
    if (2 * int(lens.max())) // band_width + 2 >= (1 << BANDBITS):
        return f"band_rel of a {int(lens.max())}-base read overflows {BANDBITS} bits"
    if device is not None and torch.device(device).type == "cuda":
        need = JOIN_BYTES_FIXED + JOIN_BYTES_PER_BASE * int(lens.sum())
        free = _free_bytes(torch.device(device))
        if need > free:
            return (f"{int(lens.sum())} read bases need ~{need} bytes of "
                    f"device memory, {free} free")
    return None


def _free_bytes(dev: torch.device) -> int:
    """Device memory the join can take: the card's free bytes and the
    caching allocator's reserved but unused ones."""
    free, _ = torch.cuda.mem_get_info(dev)
    return (free + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


class _PhaseClock:
    """Per-phase wall seconds, CUDA-synchronised, into `stats` (no-op and
    no syncs when stats is None)."""

    def __init__(self, stats, device):
        self.stats = stats
        self.cuda = device.type == "cuda"
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.stats is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.stats[name] = self.stats.get(name, 0.0) + (now - self.t)
        self.t = now


def overlap_base_records(
    rs: ReadStore,
    k: int = 15,
    w: int = 12,
    min_span: int = 1000,
    min_hits: int = 4,
    band_width: int = 500,
    tspace: int = 100,
    sub_gap: int = 32,
    max_bucket: int = 64,
    min_cnt: int = 2,
    block_bases: int = 1 << 23,
    *,
    device,
    stats: Optional[dict] = None,
) -> Optional[OverlapStore]:
    """All-vs-all half-pair base records computed on `device`; None when a
    gate fails (see join_gate).  `stats`, when given, gathers per-phase
    seconds (minimizer, index, p1..p4, fetch; CUDA-synchronised), blocks,
    hits, and p3's accepted anchors in and kept anchors out.  The query minimizers wait on the host between the index
    build and their block's join, so the device holds one block's at a
    time, and stay there in `mapper.minimizer_cache(rs)` for the map
    stage, as the C join leaves them."""
    from hinge_tpu_torch.overlap import mapper as _mapper

    if join_gate(rs, k, w, band_width, device=device) is not None:
        return None
    if rs.n_reads == 0:
        return _mapper._empty(tspace)
    dev = torch.device(device)
    lens = rs.length.astype(np.int64)
    clock = _PhaseClock(stats, dev)

    # block partition by X length (fwd + rc codes per read), as hinge_tpu
    blocks = []  # (r0, r1, x_len)
    r0 = cur = 0
    for r in range(rs.n_reads):
        xl = 2 * int(lens[r])
        if cur and cur + xl > block_bases:
            blocks.append((r0, r, cur))
            r0, cur = r, 0
        cur += xl
    blocks.append((r0, rs.n_reads, cur))

    d_packed = to_device(_pack_codes(rs), dev)
    d_off = to_device(rs.bases_off.astype(np.int64), dev)
    d_lens = to_device(lens, dev)
    host_q, idx_parts = [], []  # a block's (pos, hash, count a stream)
    for b0, r1, xl in blocks:
        (mh, mpos, msid), ix = minimizers(d_packed, d_off, d_lens, b0, r1,
                                          xl, k, w)
        host_q.append((mpos.to(torch.int32).cpu(), (mh ^ _SIGN).cpu(),
                       torch.bincount(msid, minlength=2 * (r1 - b0)).cpu()))
        idx_parts.append(ix)
    del d_packed, d_off, mh, mpos, msid
    q_pos, q_hsh, q_cnt = _mapper.cache_minimizers(
        rs, k, w, *(torch.cat(c).numpy() for c in zip(*host_q)))
    del host_q
    q_off = np.concatenate([[0], np.cumsum(q_cnt)])
    clock.lap("minimizer")
    idx = [torch.cat(c) for c in zip(*idx_parts)]
    del idx_parts
    sh, stid, spos, entry_valid = build_index(*idx, max_bucket)
    del idx
    clock.lap("index")
    if sh.shape[0] == 0:  # every read shorter than k: no seed can hit
        return _mapper._empty(tspace)

    stores: List[OverlapStore] = []
    n_hits = n_anchors = n_kept = 0
    for b0, r1, _ in blocks:
        m0, m1 = q_off[2 * b0], q_off[2 * r1]
        mh = to_device(q_hsh[m0:m1].view(np.int64), dev) ^ _SIGN
        mpos = to_device(q_pos[m0:m1], dev).to(_I64)
        msid = torch.repeat_interleave(
            torch.arange(2 * (r1 - b0), device=dev),
            to_device(q_cnt[2 * b0 : 2 * r1], dev), output_size=int(m1 - m0))
        band_off = torch.div(-(d_lens[b0:r1] - k) + _B30, band_width,
                             rounding_mode="floor")
        skey, q_s, t_s = join_hits(sh, stid, spos, entry_valid, mh, mpos,
                                   msid, b0, band_off, band_width)
        n_hits += skey.shape[0]
        clock.lap("p1")
        a_row, a_q, a_t, row_rid, row_tid, row_strand = chain_bands(
            skey, q_s, t_s, min_hits)
        del skey, q_s, t_s
        clock.lap("p2")
        nr = row_rid.shape[0]
        if nr == 0:
            continue
        p3 = thin_rows(a_row, a_q, a_t, nr, k, sub_gap, min_span, min_cnt,
                       tspace)
        n_anchors += a_row.shape[0]
        n_kept += p3[0].shape[0]
        del a_row, a_q, a_t
        clock.lap("p3")
        _, _, _, _, _, Q0, Q1, T0, T1, okr, nb = p3
        trace = emit_traces(*p3, tspace)
        del p3
        clock.lap("p4")
        host = lambda x: x.cpu().numpy()  # noqa: E731
        rid, strand, tid = host(row_rid), host(row_strand), host(row_tid)
        ok = host(okr)
        q0, q1, t0, t1, nbv = (host(x) for x in (Q0, Q1, T0, T1, nb))
        acc = np.nonzero(ok)[0]
        tr = host(trace)[: int(2 * (nbv[acc] - 1).sum())].astype(np.uint16)
        clock.lap("fetch")
        if len(acc) == 0:
            continue
        rida, strda, tida = rid[acc], strand[acc], tid[acc]
        blen = rs.length[rida].astype(np.int64)
        alen = rs.length[tida].astype(np.int64)
        b_start = np.where(strda == 0, q0[acc], blen - q1[acc])
        b_end = np.where(strda == 0, q1[acc], blen - q0[acc])
        stores.append(OverlapStore.from_arrays(
            tspace=tspace, trace=tr,
            a_id=tida, b_id=rida,
            a_len=alen, b_len=blen,
            a_start=t0[acc], a_end=t1[acc],
            b_start=b_start, b_end=b_end,
            rc=strda, diffs=np.zeros(len(acc), dtype=np.int64),
            tlen=2 * (nbv[acc] - 1),
        ).sort_by_a())
    if stats is not None:
        stats["blocks"] = len(blocks)
        stats["hits"] = n_hits
        stats["anchors"] = n_anchors
        stats["kept"] = n_kept
    if not stores:
        return _mapper._empty(tspace)
    if len(stores) == 1:
        return stores[0]
    return _mapper._concat(stores, tspace)
