"""Stage 8 — consensus polishing (`hinge consensus`, reference
`src/consensus/consensus.cpp`).

Two-database mode: contigs are the A reads, raw reads the B reads.  Per
contig: keep the best alignment per read above min_length
(remove_multialign, consensus.cpp:62-75), derive full alignment rows, chop
100 columns at each end (chop_end:28-45), then a column-wise plurality vote
over {A,C,G,T,-} plus a single-insertion track (:162-269):

* coverage < 3 -> keep the draft base lowercased,
* insertion emitted when insertion_score > cov/2 (argmax over A,C,G,T),
* deletion when '-' wins the column.

The vote accumulations are scatter-adds over (position, base), done as
torch ops on the run's device (`ops/consensus_vote.py`) when it is a CUDA
device, else by the native C vote (numpy without the toolchain);
HINGE_DEVICE_VOTE=1 / 0 / np forces the device vote / the native vote /
numpy (`vote_route`).  All three are integer-exact.

Port of `hinge_tpu/stages/consensus.py`, host code carried over: that
module imports `ops.batch_align` (jax) for a trace-realignment branch its
one caller never takes (it passes only rows with tlen <= 0), so the port
drops that branch.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore, revcomp_codes
from hinge_tpu_torch.ops import dalign_trace as DT
from hinge_tpu_torch.ops import myers as MY
from hinge_tpu_torch.ops.pairs import _libstdcxx_orders

GAP = MY.GAP


def _vote_pairs_flat(
    flat_a: np.ndarray,   # uint8 alignment A rows, all reads concatenated
    flat_b: np.ndarray,   # uint8 alignment B rows, same layout
    seg_len: np.ndarray,  # int64 row length per read
    pos0: np.ndarray,     # int64 a_start per read
    alen: int,
    chop: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Segment-vectorized chop_end + column-position walk over ALL reads'
    alignment rows at once.  Returns the vote pairs (pm, bm, pi, bi):
    match (position, base) and insertion (position, base), exactly the
    per-read loop's concatenated output (consensus.cpp:162-230 semantics,
    chop_end per :28-45)."""
    total = int(flat_a.size)
    n = int(seg_len.size)
    if total == 0 or n == 0:
        z64, z8 = np.zeros(0, np.int64), np.zeros(0, np.uint8)
        return z64, z8, z64, z8
    seg_len = seg_len.astype(np.int64)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(seg_len, out=seg_off[1:])
    a_nogap = flat_a != GAP
    ps = np.zeros(total + 1, np.int64)
    np.cumsum(a_nogap, out=ps[1:])

    big = seg_len >= 2 * chop + 10
    # chop_end's leading-gap skip: first k >= chop with A non-gap (else n).
    # Rank/gather instead of a 10^7-element unique: the first non-gap at or
    # after flat position s is ng_idx[ps[s]].
    ng_idx = np.flatnonzero(a_nogap)
    s = seg_off[:-1] + np.minimum(np.int64(chop), seg_len)
    rank = ps[s]
    if ng_idx.size:
        j = ng_idx[np.minimum(rank, ng_idx.size - 1)]
        hit = (rank < ng_idx.size) & (j < seg_off[1:])
        first_k = np.where(hit, j - seg_off[:-1], seg_len)
    else:
        first_k = seg_len
    start_k = np.where(big, first_k, 0)
    end_k = np.where(big, seg_len - chop, seg_len)
    # offset = A non-gaps before the chop start (chop_end's return offset)
    offset = ps[seg_off[:-1] + start_k] - ps[seg_off[:-1]]

    # kept range per segment as +1/-1 boundary scatter + cumsum (avoids the
    # per-column seg_id/k int64 repeats); same math as the device kernel
    lo = seg_off[:-1] + start_k
    hi = seg_off[:-1] + np.maximum(end_k, start_k)
    d = np.zeros(total + 1, np.int32)
    np.add.at(d, lo, 1)
    np.add.at(d, hi, -1)
    keep = np.cumsum(d[:total], dtype=np.int32) > 0

    x = a_nogap & keep
    c = np.cumsum(x, dtype=np.int64)  # inclusive kept non-gap count
    starts = seg_off[:-1]
    base = np.where(starts > 0, c[np.maximum(starts, 1) - 1], 0)
    # pos[j] = segment's affine constant + kept non-gaps strictly before j,
    # the constant rethreaded per segment through a difference scatter
    A = pos0 + offset - base
    Aprev = np.concatenate([np.zeros(1, np.int64), A[:-1]])
    da = np.zeros(total, np.int64)
    real = starts < total
    np.add.at(da, starts[real], (A - Aprev)[real])
    pos = np.cumsum(da) + c - x
    in_range = keep & (pos < alen)
    m_match = a_nogap & in_range
    m_ins = (~a_nogap) & (flat_b != GAP) & in_range
    return pos[m_match], flat_b[m_match], pos[m_ins], flat_b[m_ins]


def _vote_tallies(
    flat_a: np.ndarray, flat_b: np.ndarray, seg_len: np.ndarray,
    pos0: np.ndarray, alen: int, chop: int = 100,
    chunk_cols: int = 8_000_000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Accumulated vote tables (scores[alen,5], cov[alen], ins_score[alen],
    ins_scores[alen,5]) over read chunks of ~chunk_cols alignment columns —
    bounds the int64 working set at the 10^5-read scale (a 10^9-column flat
    buffer would otherwise need ~5x8 GB of temporaries).

    Segments are walked in CONTIG-POSITION order (the vote is a sum, so
    read order is free), which keeps each chunk's votes inside a narrow
    position window — the per-chunk bincounts are chunk-sized slices of the
    tables instead of fresh alen*5 allocations (those dominated wall at
    345M columns / 27.6Mb contigs: ~1.1 GB allocated+swept per chunk)."""
    n = int(seg_len.size)
    scores = np.zeros(alen * 5, np.int64)
    cov = np.zeros(alen, np.int64)
    ins_score = np.zeros(alen, np.int64)
    ins_scores = np.zeros(alen * 5, np.int64)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(seg_len, out=seg_off[1:])
    order = np.argsort(pos0, kind="stable")
    i = 0
    while i < n:
        cols, j = 0, i
        while j < n and (cols == 0
                         or cols + seg_len[order[j]] <= chunk_cols):
            cols += int(seg_len[order[j]])
            j += 1
        idx = order[i:j]
        fa = np.concatenate(
            [flat_a[seg_off[s] : seg_off[s + 1]] for s in idx])
        fb = np.concatenate(
            [flat_b[seg_off[s] : seg_off[s + 1]] for s in idx])
        pm, bm, pi, bi = _vote_pairs_flat(
            fa, fb, seg_len[idx], pos0[idx], alen, chop=chop)
        if pm.size or pi.size:
            lo = int(min(pm.min() if pm.size else alen,
                         pi.min() if pi.size else alen))
            hi = int(max(pm.max() if pm.size else 0,
                         pi.max() if pi.size else 0)) + 1
            w = hi - lo
            scores[lo * 5 : hi * 5] += np.bincount(
                (pm - lo) * 5 + bm, minlength=w * 5)
            cov[lo:hi] += np.bincount(pm - lo, minlength=w)[:w]
            ins_score[lo:hi] += np.bincount(pi - lo, minlength=w)[:w]
            ins_scores[lo * 5 : hi * 5] += np.bincount(
                (pi - lo) * 5 + bi, minlength=w * 5)
        i = j
    return (scores.reshape(alen, 5).astype(np.int32),
            cov.astype(np.int32), ins_score.astype(np.int32),
            ins_scores.reshape(alen, 5).astype(np.int32))


def _native_vote_tallies(flat_a, flat_b, seg_len, pos0, alen, chop=100):
    """One-pass C vote accumulation (native/sweeps.cpp); integer-exact vs
    `_vote_tallies`, which tests pin as the oracle.  None without the
    toolchain."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "consensus_vote_batch"):
        return None
    n = int(seg_len.size)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(seg_len.astype(np.int64), out=seg_off[1:])
    fa = np.ascontiguousarray(flat_a, np.uint8)
    fb = np.ascontiguousarray(flat_b, np.uint8)
    p0 = np.ascontiguousarray(pos0, np.int64)
    scores = np.zeros(alen * 5, np.int64)
    cov = np.zeros(alen, np.int64)
    ins_score = np.zeros(alen, np.int64)
    ins_scores = np.zeros(alen * 5, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.consensus_vote_batch(
        fa.ctypes.data_as(u8p), fb.ctypes.data_as(u8p),
        seg_off.ctypes.data_as(i64p), p0.ctypes.data_as(i64p),
        ctypes.c_int64(n), ctypes.c_int64(alen), ctypes.c_int32(chop),
        scores.ctypes.data_as(i64p), cov.ctypes.data_as(i64p),
        ins_score.ctypes.data_as(i64p), ins_scores.ctypes.data_as(i64p),
    )
    return (scores.reshape(alen, 5).astype(np.int32), cov.astype(np.int32),
            ins_score.astype(np.int32), ins_scores.reshape(alen, 5).astype(np.int32))


def vote_route(device) -> str:
    """Which vote the consensus stage runs on `device`: "device" (torch ops
    on it), "native" (the C vote; numpy without the toolchain) or "np".
    HINGE_DEVICE_VOTE=1 / 0 / np picks one; unset, the device vote on CUDA
    and the native vote on the CPU."""
    mode = os.environ.get("HINGE_DEVICE_VOTE", "")
    routes = {"1": "device", "0": "native", "np": "np"}
    if mode in routes:
        return routes[mode]
    if mode:
        raise ValueError(f"HINGE_DEVICE_VOTE={mode!r}: expected 0, 1 or np")
    return "device" if torch.device(device).type == "cuda" else "native"


def _tallies_dispatch(flat_a, flat_b, seg_len, pos0, alen, device):
    """The vote tallies by the route `vote_route(device)` picks."""
    route = vote_route(device)
    if route == "device":
        from hinge_tpu_torch.ops.consensus_vote import vote_tallies_device

        return vote_tallies_device(flat_a, flat_b, seg_len, pos0, alen,
                                   device=device)
    if route == "native":
        native = _native_vote_tallies(flat_a, flat_b, seg_len, pos0, alen)
        if native is not None:
            return native
    return _vote_tallies(flat_a, flat_b, seg_len, pos0, alen)


def remove_multialign(rows: np.ndarray, ov: OverlapStore, min_len: int) -> List[int]:
    """Best alignment per B read with span >= min_len (consensus.cpp:62-75);
    rows must already be sorted by descending summed match length."""
    out: List[int] = []
    seen = set()
    for r in rows:
        r = int(r)
        if int(ov.a_end[r] - ov.a_start[r]) >= min_len:
            b = int(ov.b_id[r])
            if b not in seen:
                seen.add(b)
                out.append(r)
    return out


def sort_alignments(aln: OverlapStore, n_contigs: int):
    """Per-contig alignment order by compare_overlap_aln (desc summed match
    length), replaying the reference's sort exactly.

    The reference sorts with libstdc++ std::sort (consensus.cpp:136), which
    is UNSTABLE: alignments of the same B read with tied summed match
    lengths can land in introsort order, and remove_multialign then keeps a
    different alignment than a stable sort would (seen as case-only
    consensus divergence at the 4.6Mb scale).  Replay the exact introsort
    permutation via native/stdcxx_order.cpp; fall back to the stable order
    only without the native toolchain.  Returns (order, bounds): contig ci's
    sorted rows are order[bounds[ci]:bounds[ci+1]].
    """
    file_order = np.argsort(aln.a_id, kind="stable").astype(np.int64)
    bounds = np.searchsorted(aln.a_id[file_order], np.arange(n_contigs + 1))
    _orders = _libstdcxx_orders()
    # rows with a_id outside [0, n_contigs) have no contig to vote on; drop
    # them up front so both sort paths (native batch + lexsort fallback)
    # see the same population (the lexsort path previously ignored them
    # silently while the native path mis-sized its permutation)
    if aln.n and (int(aln.a_id.min()) < 0 or int(aln.a_id.max()) >= n_contigs):
        keep = (aln.a_id[file_order] >= 0) & (aln.a_id[file_order] < n_contigs)
        file_order = file_order[keep]
        bounds = np.searchsorted(
            aln.a_id[file_order], np.arange(n_contigs + 1))
    if _orders is not None and len(file_order):
        _, _sort_batch = _orders
        w = np.ascontiguousarray(aln.match_len().astype(np.int64)[file_order])
        off = np.ascontiguousarray(bounds.astype(np.int64))
        perm = np.empty(len(file_order), np.int32)
        _sort_batch(w, off, n_contigs, perm)
        counts = np.diff(bounds)
        order = file_order[np.repeat(bounds[:-1], counts) + perm]
    else:
        sub = np.lexsort((
            np.arange(len(file_order)),
            -(aln.match_len()[file_order]),
            aln.a_id[file_order],
        ))
        order = file_order[sub]
    return order, bounds


def select_rows(rows: np.ndarray, aln: OverlapStore, min_len: int):
    """Rows the vote loop actually consumes for one contig.

    Reference quirk (consensus.cpp:62,155): remove_multialign receives the
    alignment vector BY VALUE, so its per-B dedup and length filter compact
    only the local copy — the caller keeps the original sorted list and the
    vote loop consumes its first seq_count entries (duplicate B reads and
    short alignments included).  Only the COUNT survives; replicate exactly.
    """
    seq_count = len(remove_multialign(rows, aln, min_len))
    return list(rows[:seq_count])


def run_consensus(
    contigs: List[Tuple[str, str]],  # (name, draft sequence text)
    rs: ReadStore,  # raw reads
    aln: OverlapStore,  # contig-vs-read records (A=contig, B=read)
    cfg: Config,
    out_fasta: Optional[str] = None,
    band: int = 300,
    *,
    device,
) -> List[Tuple[str, str]]:
    min_len = cfg.consensus.min_length
    n_contigs = len(contigs)
    from hinge_tpu_torch.data.overlaps import str_to_codes

    draft_codes = [str_to_codes(seq) for _, seq in contigs]

    order, bounds = sort_alignments(aln, n_contigs)

    results: List[Tuple[str, str]] = []
    for ci in range(n_contigs):
        tmpl = draft_codes[ci]
        alen = len(tmpl)
        rows = order[bounds[ci] : bounds[ci + 1]]
        sel = select_rows(rows, aln, min_len)
        if not sel:
            results.append((f"Consensus{ci}", contigs[ci][1]))
            continue

        # all alignment rows for this contig in one flat pooled buffer,
        # batch-built straight from the store columns (vectorized contexts
        # + window lattice; the per-record add_overlap loop was ~30% of
        # consensus wall at the 10^5-read scale)
        sel_arr = np.asarray(sel, np.int64)
        traced = sel_arr[aln.tlen[sel_arr] > 0]
        fb_a, fb_b, fb_pos0 = [], [], []
        for r in sel_arr[aln.tlen[sel_arr] <= 0]:
            ra, rb = _contig_read_rows(aln, int(r), tmpl, rs, band)
            fb_a.append(np.asarray(ra, np.uint8))
            fb_b.append(np.asarray(rb, np.uint8))
            fb_pos0.append(int(aln.a_start[r]))
        # exact recoverAlignment+getAlignmentTags rows (ops/dalign_trace.py)
        flat_a, flat_b, seg_len = DT.align_rows_flat_store(
            aln, traced, tmpl, rs)
        pos0 = aln.a_start[traced].astype(np.int64)
        if fb_a:
            flat_a = np.concatenate([flat_a] + fb_a)
            flat_b = np.concatenate([flat_b] + fb_b)
            seg_len = np.concatenate(
                [seg_len, np.array([len(x) for x in fb_a], np.int64)])
            pos0 = np.concatenate([pos0, np.array(fb_pos0, np.int64)])

        # pooled column vote, fully segment-vectorized in bounded chunks:
        # (pos, base) pairs of every read at once, then ONE bincount per
        # tally per chunk (the per-read Python loop was 54% of consensus
        # wall in the host profile).  On CUDA it runs as device
        # scatter-adds (ops/consensus_vote.py, bit-identical).
        scores, cov, ins_score, ins_scores = _tallies_dispatch(
            flat_a, flat_b, seg_len, pos0, alen, device)

        # emission (consensus.cpp:231-269), vectorized: each draft position
        # emits 0-2 bytes (optional insertion + base-or-deletion); build the
        # two per-position byte columns and compact the used ones
        lowmask = cov < 3
        max_base = np.argmax(scores, axis=1)  # first max wins, like the loop
        ins_emit = (ins_score > cov // 2) & ~lowmask
        max_ins = np.argmax(ins_scores[:, :4], axis=1)
        draft_text = contigs[ci][1]
        draft_bytes = np.frombuffer(draft_text.encode(), dtype=np.uint8)[:alen]
        upper = np.frombuffer(b"ACGT", dtype=np.uint8)
        to_lower = draft_bytes | 0x20  # ASCII lowercase
        col0 = np.where(ins_emit, upper[max_ins], 0).astype(np.uint8)
        base_byte = np.where(
            lowmask, to_lower,
            np.where(max_base < 4, upper[np.minimum(max_base, 3)], 0),
        ).astype(np.uint8)
        interleaved = np.empty(2 * alen, dtype=np.uint8)
        interleaved[0::2] = col0
        interleaved[1::2] = base_byte
        out_bytes = interleaved[interleaved != 0]
        results.append((f"Consensus{ci}", out_bytes.tobytes().decode()))

    if out_fasta is not None:
        with open(out_fasta, "w") as f:
            for name, seq in results:
                f.write(f">{name}\n{seq}\n")
    return results


def _contig_read_rows(aln: OverlapStore, r: int, tmpl: np.ndarray, rs: ReadStore, band: int):
    """Alignment rows contig-vs-read for a record r without trace points
    (A row = contig)."""
    read = rs.get_bases(int(aln.b_id[r]))
    rc = int(aln.rc[r])
    blen = int(aln.b_len[r])
    if rc:
        b_frame = revcomp_codes(read)
        bb = blen - int(aln.b_end[r])
        be = blen - int(aln.b_start[r])
    else:
        b_frame = read
        bb, be = int(aln.b_start[r]), int(aln.b_end[r])
    return MY.align_full(
        tmpl[int(aln.a_start[r]) : int(aln.a_end[r])], b_frame[bb:be], band
    )
