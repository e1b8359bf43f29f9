"""Copied from hinge_tpu/ops/myers.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch; the batch aligners run the native kernel only, without
hinge_tpu's per-window Python loop for a missing native library.

Banded Myers O(ND) difference alignment.

Faithful reimplementation of the vendored FALCON aligner the reference uses
for ladder consensus (`src/lib/DW_banded.c:_align`): greedy furthest-reaching
diagonals with adaptive banding (diagonals within band_tolerance of the best
antidiagonal survive), identical tie-breaking in the predecessor choice
(`k == min_k || (k != max_k && V[k-1] < V[k+1])`).

The snake extension runs as a vectorized numpy mismatch scan instead of the
byte-at-a-time loop.  Sequences are uint8 base codes (0..3); gaps in the
output rows are code 4.

`align_with_trace` stitches per-trace-window alignments into full overlap
alignment strings — our replacement for the reference's
`recoverAlignment` + `getAlignmentTags` (LAInterface.cpp:4125-4252,
3709-3915), which re-derive DALIGNER's exact trace.  Ours re-aligns each
tspace window between the same trace points, so coordinates stay anchored
to the lattice while the within-window alignment is our own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

GAP = 4
_GAP_CH = np.uint8(GAP)


@dataclasses.dataclass
class Alignment:
    aligned: bool
    q_aln: np.ndarray  # uint8 codes with 4 = gap
    t_aln: np.ndarray
    q_s: int = 0
    q_e: int = 0
    t_s: int = 0
    t_e: int = 0
    dist: int = 0


def _snake(q: np.ndarray, t: np.ndarray, x: int, y: int) -> int:
    """Length of the maximal match run starting at (x, y)."""
    L = min(len(q) - x, len(t) - y)
    if L <= 0:
        return 0
    eq = q[x : x + L] == t[y : y + L]
    idx = np.argmin(eq)
    if eq[idx]:
        return L
    return int(idx)


def _match_run_table(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """R[x, y] = length of the maximal match run starting at (x, y).

    Exact precomputation of every _snake answer for one window: bottom-up
    R[x, y] = (q[x] == t[y]) * (R[x+1, y+1] + 1) with zero padding, so the
    d-loop's snake extension becomes an O(1) table lookup instead of a numpy
    mismatch scan per (d, k).  Bit-identical results; only worth the O(mn)
    table for window-sized inputs (align_pair guards the size)."""
    m, n = len(q), len(t)
    R = np.zeros((m + 1, n + 1), dtype=np.int32)
    M = q[:, None] == t[None, :]
    for x in range(m - 1, -1, -1):
        R[x, :n] = np.where(M[x], R[x + 1, 1 : n + 1] + 1, 0)
    return R


_RUN_TABLE_MAX = 512 * 512  # ~1MB int32 table cap


def align_pair(q: np.ndarray, t: np.ndarray, band_tolerance: int = 150) -> Alignment:
    """DW_banded.c:_align transcription (get_aln_str=1)."""
    q_len, t_len = len(q), len(t)
    if q_len == 0 and t_len == 0:
        return Alignment(True, np.zeros(0, np.uint8), np.zeros(0, np.uint8))
    if 0 < q_len * t_len <= _RUN_TABLE_MAX:
        R = _match_run_table(q, t)

        def snake(x, y):
            if 0 <= x < q_len and 0 <= y < t_len:
                return int(R[x, y])
            return _snake(q, t, x, y)

    else:

        def snake(x, y):
            return _snake(q, t, x, y)

    max_d = int(0.3 * (q_len + t_len))
    band_size = band_tolerance * 2
    k_offset = max_d
    V = np.zeros(2 * max_d + 2, dtype=np.int64)
    U = np.zeros(2 * max_d + 2, dtype=np.int64)
    d_path = {}
    best_m = -1
    min_k = max_k = 0
    aligned = False
    x = y = 0
    k = 0
    for d in range(max_d):
        if max_k - min_k > band_size:
            break
        for k in range(min_k, max_k + 1, 2):
            if k == min_k or (k != max_k and V[k - 1 + k_offset] < V[k + 1 + k_offset]):
                pre_k = k + 1
                x = int(V[k + 1 + k_offset])
            else:
                pre_k = k - 1
                x = int(V[k - 1 + k_offset]) + 1
            y = x - k
            x1, y1 = x, y
            run = snake(x, y)
            x += run
            y += run
            d_path[(d, k)] = (x1, y1, x, y, pre_k)
            V[k + k_offset] = x
            U[k + k_offset] = x + y
            if x + y > best_m:
                best_m = x + y
            if x >= q_len or y >= t_len:
                aligned = True
                break
        if aligned:
            break
        new_min_k, new_max_k = max_k, min_k
        for k2 in range(min_k, max_k + 1, 2):
            if U[k2 + k_offset] >= best_m - band_tolerance:
                new_min_k = min(new_min_k, k2)
                new_max_k = max(new_max_k, k2)
        max_k = new_max_k + 1
        min_k = new_min_k - 1

    if not aligned:
        return Alignment(False, np.zeros(0, np.uint8), np.zeros(0, np.uint8))

    # backtrack
    path = []
    cd, ck = d, k
    while cd >= 0:
        x1, y1, x2, y2, pre_k = d_path[(cd, ck)]
        path.append((x2, y2))
        path.append((x1, y1))
        ck = pre_k
        cd -= 1
    path = path[::-1]
    cx, cy = path[0]
    q_s, t_s = cx, cy
    q_chunks = []
    t_chunks = []
    for nx, ny in path[1:]:
        if nx == cx and ny == cy:
            continue
        if nx == cx and ny != cy:
            q_chunks.append(np.full(ny - cy, GAP, dtype=np.uint8))
            t_chunks.append(t[cy:ny])
        elif nx != cx and ny == cy:
            q_chunks.append(q[cx:nx])
            t_chunks.append(np.full(nx - cx, GAP, dtype=np.uint8))
        else:
            q_chunks.append(q[cx:nx])
            t_chunks.append(t[cy:ny])
        cx, cy = nx, ny
    q_aln = np.concatenate(q_chunks) if q_chunks else np.zeros(0, np.uint8)
    t_aln = np.concatenate(t_chunks) if t_chunks else np.zeros(0, np.uint8)
    return Alignment(True, q_aln, t_aln, q_s, x, t_s, y, d)


def align_full(q: np.ndarray, t: np.ndarray, band_tolerance: int = 150) -> Tuple[np.ndarray, np.ndarray]:
    """Alignment rows that consume *all* of q and t: _align result padded
    with trailing gap columns for whichever side wasn't exhausted, and
    leading gap columns when the d-path start skipped a prefix."""
    a = align_pair(q, t, band_tolerance)
    if not a.aligned:
        # degenerate fallback: q then t in disjoint columns
        q_row = np.concatenate([q, np.full(len(t), GAP, np.uint8)])
        t_row = np.concatenate([np.full(len(q), GAP, np.uint8), t])
        return q_row, t_row
    q_chunks = []
    t_chunks = []
    if a.q_s or a.t_s:
        q_chunks += [q[: a.q_s], np.full(a.t_s, GAP, np.uint8)]
        t_chunks += [np.full(a.q_s, GAP, np.uint8), t[: a.t_s]]
    q_chunks.append(a.q_aln)
    t_chunks.append(a.t_aln)
    if a.q_e < len(q):
        q_chunks.append(q[a.q_e :])
        t_chunks.append(np.full(len(q) - a.q_e, GAP, np.uint8))
    if a.t_e < len(t):
        q_chunks.append(np.full(len(t) - a.t_e, GAP, np.uint8))
        t_chunks.append(t[a.t_e :])
    return np.concatenate(q_chunks), np.concatenate(t_chunks)


def align_exact(q: np.ndarray, t: np.ndarray, band_tolerance: int = 150) -> Tuple[np.ndarray, np.ndarray]:
    """EXACT DW_banded.c:_align rows: the aligned core only — no leading or
    trailing pads; not-aligned returns empty rows (the reference leaves
    aln_str_size = 0).  This is what draft.cpp:636 feeds to get_align_tags;
    the unconsumed template tail then receives no tags, which shifts
    coverage and the falcon DP's global best."""
    a = align_pair(q, t, band_tolerance)
    if not a.aligned:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    return a.q_aln, a.t_aln


def align_exact_batch(qs, ts, band_tolerance: int = 150):
    """align_exact over a batch (the native kernel with pad_full=0)."""
    return _align_batch_impl(qs, ts, band_tolerance, pad_full=0)


def align_full_batch(qs, ts, band_tolerance: int = 150):
    """align_full over a batch of windows.

    Runs the native C kernel (io_native.cpp myers_align_batch — the same
    furthest-reaching-diagonal recurrence, so rows are byte-identical).
    This is the CPU path for the draft/consensus window alignments.
    """
    return _align_batch_impl(qs, ts, band_tolerance, pad_full=1)


def _align_batch_impl(qs, ts, band_tolerance: int, pad_full: int):
    B = len(qs)
    if B == 0:
        return []
    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    import ctypes as C

    q_off = np.zeros(B + 1, dtype=np.int64)
    t_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(q) for q in qs], out=q_off[1:])
    np.cumsum([len(t) for t in ts], out=t_off[1:])
    qcat = (np.concatenate(qs) if q_off[-1] else np.zeros(0, np.uint8)).astype(
        np.uint8, copy=False)
    tcat = (np.concatenate(ts) if t_off[-1] else np.zeros(0, np.uint8)).astype(
        np.uint8, copy=False)
    qcat = np.ascontiguousarray(qcat)
    tcat = np.ascontiguousarray(tcat)
    cap = int(q_off[-1] + t_off[-1])
    q_rows = np.empty(cap, dtype=np.uint8)
    t_rows = np.empty(cap, dtype=np.uint8)
    row_off = np.empty(B + 1, dtype=np.int64)
    ok = np.empty(B, dtype=np.int32)
    u8p = C.POINTER(C.c_uint8)
    i64p = C.POINTER(C.c_int64)
    lib.myers_align_batch(
        qcat.ctypes.data_as(u8p), q_off.ctypes.data_as(i64p),
        tcat.ctypes.data_as(u8p), t_off.ctypes.data_as(i64p),
        C.c_int64(B), C.c_int32(band_tolerance),
        q_rows.ctypes.data_as(u8p), t_rows.ctypes.data_as(u8p),
        row_off.ctypes.data_as(i64p), ok.ctypes.data_as(C.POINTER(C.c_int32)),
        C.c_int32(pad_full),
    )
    return [
        (q_rows[row_off[i] : row_off[i + 1]].copy(),
         t_rows[row_off[i] : row_off[i + 1]].copy())
        for i in range(B)
    ]


def align_with_trace(
    a_seq: np.ndarray,  # full A read codes (read orientation)
    b_seq: np.ndarray,  # full B read codes, COMPLEMENTED when rc=1 (i.e. in
    #   the match's coordinate frame, like the reference's bseq)
    a_start: int,
    a_end: int,
    b_start_raw: int,  # raw bbpos/bepos in the match frame (complemented
    b_end_raw: int,  # coords for rc=1 — NOT the forward-strand flipped ones)
    trace_pairs: np.ndarray,  # (P, 2) uint16 (diffs, b-disp)
    tspace: int = 100,
    band_tolerance: int = 150,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stitch window alignments between consecutive trace points.

    Returns (a_row, b_row) uint8 rows covering A[a_start:a_end] and
    B[b_start_raw:b_end_raw] exactly.
    """
    P = len(trace_pairs)
    a_bounds = [a_start]
    nb = a_start
    while True:
        nb = (nb // tspace + 1) * tspace
        if nb >= a_end:
            break
        a_bounds.append(nb)
    a_bounds.append(a_end)
    b_bounds = [b_start_raw]
    for j in range(len(a_bounds) - 2):
        b_bounds.append(b_bounds[-1] + int(trace_pairs[j][1]))
    b_bounds.append(b_end_raw)

    a_chunks = []
    b_chunks = []
    for w in range(len(a_bounds) - 1):
        qa = a_seq[a_bounds[w] : a_bounds[w + 1]]
        tb = b_seq[b_bounds[w] : b_bounds[w + 1]]
        ra, rb = align_full(qa, tb, band_tolerance)
        a_chunks.append(ra)
        b_chunks.append(rb)
    return np.concatenate(a_chunks), np.concatenate(b_chunks)
