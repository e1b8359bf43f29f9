"""Copied from hinge_tpu/ops/falcon_vote.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, without hinge_tpu's per-row tag loop (`get_align_tags`)
for a missing native library: the tags come from native/sweeps.cpp only.

FALCON-style align-tag MSA consensus.

Reference: vendored `src/lib/falcon.c` (`get_align_tags`:69-130,
`get_cns_from_align_tags`:270-520) — the per-ladder consensus kernel of the
draft stage.  Semantics replicated:

* each alignment column becomes a tag (t_pos, delta, q_base) with a link to
  its predecessor tag,
* tags accumulate into per-(t_pos, delta, base) columns with per-link counts,
* a forward DP scores each column as max over links of
  (prev score + link_count - coverage[t_pos]/2),
* backtracking from the global best yields the consensus; bases at
  coverage <= min_cov are emitted lowercase (we return a mask instead).

Inputs are uint8 code rows (0..3 bases, 4 = gap) from hinge_tpu.ops.myers.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

GAP = 4


def get_align_tags_batch(rows_q, rows_t, sentinel: bool = True):
    """get_align_tags (falcon.c:69-130) over many aligned row pairs via the
    native C pass (native/sweeps.cpp::falcon_tags_batch).  Each column
    becomes a tag (t_pos, delta, p_t_pos, p_delta, p_q_base, q_base) (bases
    0..4, 4 = gap; p_q_base 5 = '.' start sentinel), chained to the last
    kept tag; columns with delta >= 255 or before the template are
    dropped.  sentinel=True prepends the virtual 'T'/'T' column
    (draft.cpp:652-659) to every pair.  Returns a list of (L_i, 6) int32
    arrays."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    n = len(rows_q)
    if n == 0:
        return []
    lib = get_lib()
    row_off = np.zeros(n + 1, np.int64)
    for i, q in enumerate(rows_q):
        row_off[i + 1] = row_off[i] + len(q)
    fq = (np.concatenate(rows_q) if row_off[-1] else np.zeros(0, np.uint8))
    ft = (np.concatenate(rows_t) if row_off[-1] else np.zeros(0, np.uint8))
    fq = np.ascontiguousarray(fq, np.uint8)
    ft = np.ascontiguousarray(ft, np.uint8)
    toff = np.zeros(n, np.int64)
    cap = int(row_off[-1]) + (n if sentinel else 0)
    flat = np.empty((max(cap, 1), 6), np.int32)
    cnt = np.zeros(n, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.falcon_tags_batch(
        fq.ctypes.data_as(u8p), ft.ctypes.data_as(u8p),
        row_off.ctypes.data_as(i64p), toff.ctypes.data_as(i64p),
        ctypes.c_int64(n), ctypes.c_int32(1 if sentinel else 0),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cnt.ctypes.data_as(i64p),
    )
    out = []
    pos = 0
    for i in range(n):
        out.append(flat[pos : pos + int(cnt[i])])
        pos += int(cnt[i])
    if pos != total:
        # buffer-overrun symptom in the native pass; must survive python -O
        raise RuntimeError(
            f"falcon_tags_batch row counts ({pos}) != total tags ({total})")
    return out


def get_cns_from_align_tags(
    tag_seqs: List[np.ndarray], t_len: int, min_cov: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Consensus via the MSA link DP — vectorized accumulation.

    Tag/link counting (the bulk of the work: one entry per alignment column
    per sequence) runs as one np.unique over the concatenated tag rows; the
    sequential link DP then touches only the *unique* columns (~t_len of
    them) instead of every raw tag. Semantics identical to
    get_cns_from_align_tags_ref (falcon.c:270-520), tested equal.
    """
    nonempty = [t for t in tag_seqs if len(t)]
    if not nonempty:
        return np.zeros(0, np.uint8), np.zeros(0, bool)
    allt = np.concatenate(nonempty, axis=0)
    # coverage: delta==0 rows per t_pos
    coverage = np.zeros(t_len, dtype=np.int64)
    d0 = allt[allt[:, 1] == 0, 0]
    d0 = d0[(d0 >= 0) & (d0 < t_len)]
    np.add.at(coverage, d0, 1)
    # clamp base codes like the scalar path
    rows = allt.copy()
    rows[:, 4] = np.minimum(rows[:, 4], 4)
    rows[:, 5] = np.minimum(rows[:, 5], 4)
    # unique link rows WITH first-occurrence index: update_col appends new
    # links in stream order (falcon.c:192-225), and the DP's strict `>`
    # tie-break means link order decides equal-score winners — so each
    # column must iterate its links in first-appearance order.
    uniq, first, counts = np.unique(rows, axis=0, return_index=True,
                                    return_counts=True)
    # columns in (t_pos, delta, base) order (falcon.c:366-369 loop nest);
    # within a column, links in first-appearance order
    order = np.lexsort((first, uniq[:, 5], uniq[:, 1], uniq[:, 0]))
    uniq = uniq[order]
    counts = counts[order]
    col_keys = uniq[:, [0, 1, 5]]
    new_col = np.ones(len(uniq), dtype=bool)
    new_col[1:] = (col_keys[1:] != col_keys[:-1]).any(axis=1)
    col_start = np.nonzero(new_col)[0]
    col_end = np.append(col_start[1:], len(uniq))

    scores: dict = {}
    bests: dict = {}
    best_cks: dict = {}
    g_best_score = -1.0
    g_best_key = None
    for s, e in zip(col_start, col_end):
        tp, dl, base = int(uniq[s, 0]), int(uniq[s, 1]), int(uniq[s, 5])
        best_score = -1.0
        best_link = None
        best_ck = -1
        covh = coverage[tp] * 0.5 if 0 <= tp < t_len else 0.0
        for ck, r in enumerate(range(s, e)):
            pi, pj, pb = int(uniq[r, 2]), int(uniq[r, 3]), int(uniq[r, 4])
            cnt = int(counts[r])
            if pi == -1:
                score = cnt - covh
            else:
                # untouched predecessor columns carry best_score == -1
                # (falcon.c:381/426 leaves aln_col->score = -1)
                score = scores.get((pi, pj, pb), -1.0) + cnt - covh
            if score > best_score:
                best_score = score
                best_link = (pi, pj, pb)
                best_ck = ck
        key = (tp, dl, base)
        scores[key] = best_score
        bests[key] = best_link
        best_cks[key] = best_ck
        if best_score > g_best_score:
            g_best_score = best_score
            g_best_key = key

    if g_best_key is None:
        return np.zeros(0, np.uint8), np.zeros(0, bool)
    seq: List[int] = []
    low: List[bool] = []
    key = g_best_key
    # Reference quirk (falcon.c:456-460): the backtrack seeds ck with
    # g_best_ck — the best LINK INDEX of the best column — and the emitter
    # interprets it as a base code.  ck==4 emits '-' (dropped); ck>4 leaves
    # bb at its initial '$' (we encode '$' as code 5).
    ck0 = best_cks[g_best_key]
    first_bb = ck0 if ck0 <= 4 else 5
    first_col = True
    while True:
        i, _, _ = key
        bb = first_bb if first_col else key[2]
        first_col = False
        nxt = bests.get(key)
        if nxt is None or nxt[0] == -1 or len(seq) >= t_len * 2:
            break
        if bb != GAP:
            seq.append(bb)
            low.append(bool(0 <= i < t_len and coverage[i] <= min_cov))
        key = (nxt[0], nxt[1], nxt[2])
    seq.reverse()
    low.reverse()
    return np.array(seq, dtype=np.uint8), np.array(low, dtype=bool)


def get_cns_batch(
    tag_windows: List[np.ndarray], t_lens, min_covs
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Batched get_cns_from_align_tags over independent windows.

    tag_windows[i] is one (N_i, 6) int32 array — that window's tag sequences
    already concatenated (sequence boundaries are irrelevant to the column
    DP).  Runs the native C core (io_native.cpp:falcon_cns_batch); the
    windows it rejects take the per-window numpy path.  Outputs
    byte-identical either way.
    """
    B = len(tag_windows)
    if B == 0:
        return []
    t_lens = np.asarray(t_lens, dtype=np.int64)
    min_covs = np.asarray(min_covs, dtype=np.int64)
    out: List = [None] * B
    _native_cns_batch(tag_windows, t_lens, min_covs, out)
    for i in range(B):
        if out[i] is None:
            out[i] = get_cns_from_align_tags(
                [tag_windows[i]], int(t_lens[i]), int(min_covs[i])
            )
    return out


def _native_cns_batch(tag_windows, t_lens, min_covs, out) -> None:
    """Fill out[i] with window i's (consensus, low-coverage mask), leaving
    None where the C core rejects the window (its out_len -1)."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    B = len(tag_windows)
    win_off = np.zeros(B + 1, dtype=np.int64)
    for i, tw in enumerate(tag_windows):
        win_off[i + 1] = win_off[i] + len(tw)
    flat = (
        np.concatenate([np.ascontiguousarray(t, dtype=np.int32).reshape(-1, 6)
                        for t in tag_windows if len(t)])
        if win_off[-1] else np.zeros((0, 6), np.int32)
    )
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    # non-positive t_len would shrink later windows' offsets (ADVICE r1):
    # clamp so a degenerate window can't corrupt its neighbours
    caps = np.maximum(2 * t_lens, 0)
    out_off = np.zeros(B, dtype=np.int64)
    np.cumsum(caps[:-1], out=out_off[1:])
    total = int(caps.sum())
    out_seq = np.zeros(max(total, 1), dtype=np.uint8)
    out_low = np.zeros(max(total, 1), dtype=np.uint8)
    out_len = np.zeros(B, dtype=np.int64)
    c = ctypes
    lib.falcon_cns_batch(
        flat.ctypes.data_as(c.POINTER(c.c_int32)),
        win_off.ctypes.data_as(c.POINTER(c.c_int64)),
        t_lens.ctypes.data_as(c.POINTER(c.c_int64)),
        min_covs.ctypes.data_as(c.POINTER(c.c_int64)),
        c.c_int64(B),
        out_off.ctypes.data_as(c.POINTER(c.c_int64)),
        out_seq.ctypes.data_as(c.POINTER(c.c_uint8)),
        out_low.ctypes.data_as(c.POINTER(c.c_uint8)),
        out_len.ctypes.data_as(c.POINTER(c.c_int64)),
        c.c_int32(os.cpu_count() or 1),
    )
    for i in range(B):
        n = int(out_len[i])
        if n < 0:
            continue  # rejected: get_cns_batch runs the numpy path
        o = int(out_off[i])
        out[i] = (out_seq[o : o + n].copy(),
                  out_low[o : o + n].astype(bool))


def get_cns_from_align_tags_ref(
    tag_seqs: List[np.ndarray], t_len: int, min_cov: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar reference implementation (falcon.c:270-520 transcription).

    Returns (consensus codes uint8, low_coverage bool mask per emitted base).
    """
    coverage = np.zeros(t_len, dtype=np.int64)
    # column store: (t_pos, delta, base) -> {"links": {(pt,pd,pb): count},
    #                                        "score": float, "best": (pt,pd,pb)}
    cols: Dict[Tuple[int, int, int], dict] = {}
    max_delta: Dict[int, int] = {}

    for tags in tag_seqs:
        t_pos = 0
        for row in tags:
            tp, delta, ptp, pdl, pqb, qb = (int(v) for v in row)
            if delta == 0:
                t_pos = tp
                if 0 <= t_pos < t_len:
                    coverage[t_pos] += 1
            if delta > max_delta.get(t_pos, 0):
                max_delta[t_pos] = delta
            base = qb if qb <= 4 else 4
            key = (t_pos, delta, base)
            col = cols.get(key)
            if col is None:
                col = {"links": {}, "score": -1.0, "best": None}
                cols[key] = col
            lk = (ptp, pdl, pqb if pqb <= 4 else 4)
            col["links"][lk] = col["links"].get(lk, 0) + 1

    g_best_score = -1.0
    g_best_key = None
    # iterate in (t_pos, delta, base) order like the reference's triple
    # loop; links in dict-insertion order = update_col append order
    for key in sorted(cols.keys()):
        i = key[0]
        col = cols[key]
        best_score = -1.0
        best_link = None
        best_ck = -1
        for ck, ((pi, pj, pb), cnt) in enumerate(col["links"].items()):
            if pi == -1:
                score = cnt - coverage[i] * 0.5
            else:
                prev = cols.get((pi, pj, pb))
                # untouched predecessor columns keep score -1 (falcon.c:426)
                prev_score = prev["score"] if prev is not None else -1.0
                score = prev_score + cnt - coverage[i] * 0.5
            if score > best_score:
                best_score = score
                best_link = (pi, pj, pb)
                best_ck = ck
        col["score"] = best_score
        col["best"] = best_link
        col["best_ck"] = best_ck
        if best_score > g_best_score:
            g_best_score = best_score
            g_best_key = key

    if g_best_key is None:
        return np.zeros(0, np.uint8), np.zeros(0, bool)

    # backtrack (falcon.c:442-500): walk from the global best, emitting each
    # column's base before stepping to its predecessor; the column linked
    # from -1 (the caller's prepended sentinel) is never emitted.
    # Reference quirk (falcon.c:456-460): the FIRST emitted base is the best
    # column's best link INDEX read as a base code ('-' dropped, >4 -> '$',
    # which we encode as code 5).
    seq: List[int] = []
    low: List[bool] = []
    key = g_best_key
    ck0 = cols[g_best_key]["best_ck"]
    bb = ck0 if ck0 <= 4 else 5
    while True:
        i = key[0]
        col = cols[key]
        nxt = col["best"]
        if nxt is None or nxt[0] == -1 or len(seq) >= t_len * 2:
            break
        if bb != GAP:
            seq.append(bb)
            low.append(bool(coverage[i] <= min_cov))
        key = (nxt[0], nxt[1], nxt[2])
        bb = key[2]
    seq.reverse()
    low.reverse()
    return np.array(seq, dtype=np.uint8), np.array(low, dtype=bool)
