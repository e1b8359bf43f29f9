"""Banded Needleman-Wunsch window aligner on the hand-written CUDA kernels.

Port of `hinge_tpu/ops/pallas_band_nw.py` (its docstring derives the
regular-access band formulation).  Two kernels, each with a plain torch
twin in this module:

- `band_fill` (K1, csrc/band_fill.cu; twin `band_fill_ref`): int8 move
  codes (B, mrows, 256), 0 diag, 1 up, 2 left, 3 invalid;
- `row_traceback` (K2, csrc/row_traceback.cu; twin `row_traceback_ref`):
  per-row left-run counts, terminating moves and the leading left
  columns.

A wrapper takes its twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  `band_align_batch` is the dispatch:
windows the band cannot hold go to the scalar Myers path, the rest are
sorted by length and aligned in blocks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu_torch.ops.myers import align_full
from hinge_tpu_torch.device import DeviceError, to_device
from hinge_tpu_torch.ops._build import load_kernels

GAP = 4
BW = 256
HB = BW // 2
INF = 1 << 24
I32 = torch.int32
#: windows per band_fill / row_traceback launch in band_align_batch
MAX_BATCH = 8192

#: kernel launches per wrapper (a launch that compares a kernel with its
#: twin counts too; callers reset the counts around the run they measure)
launches = {"band_fill": 0, "row_traceback": 0}


def _check(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim:
        raise TypeError(f"{name}: want {dtype} with {ndim} dims, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, want {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lengths(q, t, m, n):
    B = q.shape[0]
    if t.shape[0] != B or m.shape != (B,) or n.shape != (B,):
        raise ValueError("q, t, m, n disagree on the batch size")
    ok = ((m >= 0) & (m <= q.shape[1]) & (n >= 0) & (n <= t.shape[1])).all()
    if not bool(ok):
        raise ValueError("window lengths m/n exceed the q/t buffers")


def _launch_on(dev):
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return load_kernels(), torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# K1: band fill
# ---------------------------------------------------------------------------


def band_fill_ref(q, t, m, n, mrows: int) -> torch.Tensor:
    """Plain torch band fill: a loop over DP rows of (B, 256) vector ops.

    q (B, Lq) uint8 window queries, valid on [0, m); t (B, Lt) uint8
    targets, valid on [0, n); m, n (B,) int32.  Returns moves
    (B, mrows, 256) int8.  The TPU layout's pads (250 past m in q, 251
    left and 252 right of t) are materialised here, as the Pallas kernel
    reads them."""
    B, dev = q.shape[0], q.device
    lane = torch.arange(BW, dtype=I32, device=dev)[None, :]
    m_, n_ = m[:, None], n[:, None]
    qf = torch.full((B, mrows), 250, dtype=I32, device=dev)
    w = min(q.shape[1], mrows)
    qf[:, :w] = q[:, :w].to(I32)
    qf = torch.where(torch.arange(mrows, device=dev)[None, :] < m_, qf, 250)
    tw = mrows + BW
    tf = torch.full((B, HB + tw), 252, dtype=I32, device=dev)
    w = min(t.shape[1], tw)
    tf[:, HB:HB + w] = t[:, :w].to(I32)
    tidx = torch.arange(HB + tw, device=dev)[None, :]
    tf = torch.where(tidx < HB, 251, torch.where(tidx < HB + n_, tf, 252))

    crow = torch.where((lane - HB >= 0) & (lane - HB <= n_), lane - HB, INF)
    inf_col = torch.full((B, 1), INF, dtype=I32, device=dev)
    moves = torch.empty((B, mrows, BW), dtype=torch.int8, device=dev)
    for r in range(mrows):
        i = r + 1
        sub = (tf[:, r:r + BW] != qf[:, r:r + 1]).to(I32)
        diag_c = crow + sub
        up_c = torch.cat([crow[:, 1:], inf_col], dim=1) + 1
        j = i + lane - HB
        valid = (j >= 1) & (j <= n_)
        is_j0 = j == 0
        keep = valid | is_j0
        e = torch.where(valid, torch.minimum(diag_c, up_c), INF)
        e = torch.where(is_j0, i, e)
        # the Pallas scan shifts INF into its low lanes, capping it at INF
        g = torch.clamp(torch.cummin(e - lane, dim=1).values, max=INF)
        c = torch.where(keep, torch.minimum(e, g + lane), INF)
        mv = torch.where(c < e, 2, torch.where(diag_c <= up_c, 0, 1))
        mv = torch.where(is_j0, 1, mv)
        moves[:, r] = torch.where(keep, mv, 3).to(torch.int8)
        crow = torch.where(i <= m_, c, crow)
    return moves


def band_fill(q, t, m, n, mrows: int) -> torch.Tensor:
    """Band fill on q's device: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors.  Arguments as for `band_fill_ref`."""
    dev = q.device
    _check("q", q, torch.uint8, 2, dev)
    _check("t", t, torch.uint8, 2, dev)
    _check("m", m, I32, 1, dev)
    _check("n", n, I32, 1, dev)
    _check_lengths(q, t, m, n)
    if dev.type == "cpu":
        return band_fill_ref(q, t, m, n, mrows)
    return launch_band_fill(q, t, m, n, mrows)


def launch_band_fill(q, t, m, n, mrows: int) -> torch.Tensor:
    """The K1 launch alone, for CUDA tensors that band_fill has checked:
    no host synchronisation, so back-to-back calls time the kernel."""
    dev = q.device
    lib, stream = _launch_on(dev)
    B = q.shape[0]
    moves = torch.empty((B, mrows, BW), dtype=torch.int8, device=dev)
    if B == 0 or mrows == 0:
        return moves
    with torch.cuda.device(dev):
        err = lib.hinge_band_fill(
            q.data_ptr(), q.stride(0), t.data_ptr(), t.stride(0),
            m.data_ptr(), n.data_ptr(), moves.data_ptr(), B, mrows, stream)
    if err:
        raise DeviceError(f"band_fill kernel launch failed: cudaError {err}")
    launches["band_fill"] += 1
    return moves


# ---------------------------------------------------------------------------
# K2: row-synchronised traceback
# ---------------------------------------------------------------------------


def row_traceback_ref(moves, m, n):
    """Plain torch row-synchronised traceback (same loop shape as the
    kernel): returns (cnts (B, mrows) uint8, mv0s (B, mrows) int8,
    j_rem (B,) int32), zeros on rows r >= m."""
    B, mrows, _ = moves.shape
    dev = moves.device
    lane = torch.arange(BW, dtype=I32, device=dev)[None, :]
    cnts = torch.zeros((B, mrows), dtype=torch.uint8, device=dev)
    mv0s = torch.zeros((B, mrows), dtype=torch.int8, device=dev)
    j = n.to(I32).clone()
    top_rows = min(int(m.max()) if B else 0, mrows)
    for r in range(top_rows - 1, -1, -1):
        row = moves[:, r].to(I32)
        active = r < m
        k_e = torch.clamp(j - (r + 1) + HB, 0, BW - 1)
        enc = torch.where((lane <= k_e[:, None]) & (row != 2),
                          lane * 4 + row, -1)
        top = enc.max(dim=1).values
        kstop = top >> 2
        mv0 = top & 3
        cnt = k_e - kstop
        j = torch.where(active, j - cnt - (mv0 == 0).to(I32), j)
        cnts[:, r] = torch.where(active, cnt & 0xFF, 0).to(torch.uint8)
        mv0s[:, r] = torch.where(active, mv0, 0).to(torch.int8)
    return cnts, mv0s, j


def row_traceback(moves, m, n):
    """Traceback on the moves' device: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors.  Arguments as for
    `row_traceback_ref`."""
    dev = moves.device
    _check("moves", moves, torch.int8, 3, dev)
    _check("m", m, I32, 1, dev)
    _check("n", n, I32, 1, dev)
    B, mrows, bw = moves.shape
    if bw != BW or m.shape != (B,) or n.shape != (B,):
        raise ValueError(f"moves {tuple(moves.shape)} vs m {tuple(m.shape)}, "
                         f"n {tuple(n.shape)}: want (B, mrows, {BW}), (B,)")
    if dev.type == "cpu":
        return row_traceback_ref(moves, m, n)
    lib, stream = _launch_on(dev)
    cnts = torch.empty((B, mrows), dtype=torch.uint8, device=dev)
    mv0s = torch.empty((B, mrows), dtype=torch.int8, device=dev)
    j_rem = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return cnts, mv0s, j_rem
    with torch.cuda.device(dev):
        err = lib.hinge_row_traceback(
            moves.data_ptr(), m.data_ptr(), n.data_ptr(), cnts.data_ptr(),
            mv0s.data_ptr(), j_rem.data_ptr(), B, mrows, stream)
    if err:
        raise DeviceError(
            f"row_traceback kernel launch failed: cudaError {err}")
    launches["row_traceback"] += 1
    return cnts, mv0s, j_rem


# ---------------------------------------------------------------------------
# emission + dispatch
# ---------------------------------------------------------------------------


def _emit_rowrec(qs, ts, cnts, mv0s, j_rem):
    """Rows from per-DP-row traceback records, one flat pass over the whole
    batch.  Forward layout per window: j_rem leading left columns, then per
    DP row r: the up/diag column followed by cnt[r] left columns.

    Host numpy, carried over unchanged from
    `hinge_tpu/ops/pallas_band_nw.py::_emit_rowrec` (that module imports
    jax)."""
    B = len(qs)
    ms = np.array([len(q) for q in qs], np.int64)
    cnt_sum = np.array(
        [int(cnts[w, : ms[w]].astype(np.int64).sum()) for w in range(B)],
        np.int64)
    jr = j_rem.astype(np.int64)
    cols_w = jr + ms + cnt_sum
    base = np.zeros(B + 1, np.int64)
    np.cumsum(cols_w, out=base[1:])
    q_flat = np.full(int(base[-1]), GAP, np.uint8)
    t_flat = np.full(int(base[-1]), GAP, np.uint8)
    tfill = np.ones(int(base[-1]), bool)

    # per-(window,row) flat records
    rowner = np.repeat(np.arange(B), ms)
    ridx = np.arange(int(ms.sum()), dtype=np.int64)
    ridx -= np.repeat(np.cumsum(ms) - ms, ms)
    cnt_f = cnts[rowner, ridx].astype(np.int64)
    mv0_f = mv0s[rowner, ridx]
    # column of row r's up/diag cell = base + jr + r + sum(cnt[<r])
    ccum = np.cumsum(cnt_f)
    seg0 = ccum[np.cumsum(ms) - ms] - cnt_f[np.cumsum(ms) - ms]
    ccum_local = ccum - np.repeat(seg0, ms) - cnt_f  # exclusive within window
    offs = base[rowner] + jr[rowner] + ridx + ccum_local
    q_bases = np.concatenate(
        [np.asarray(q, np.uint8) for q in qs]) if ms.sum() else np.zeros(0, np.uint8)
    q_flat[offs] = q_bases
    tfill[offs[mv0_f == 1]] = False
    # t bases fill every remaining column, in order per window
    t_bases = np.concatenate(
        [np.asarray(t, np.uint8) for t in ts]) if B else np.zeros(0, np.uint8)
    t_flat[tfill] = t_bases
    return [
        (q_flat[base[w] : base[w + 1]], t_flat[base[w] : base[w + 1]])
        for w in range(B)
    ]


def band_align_batch(
    qs: Sequence[np.ndarray],
    ts: Sequence[np.ndarray],
    *,
    device,
    max_batch: int = MAX_BATCH,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Optimal banded global alignment rows (gap code 4) for a batch of
    windows, consuming both sequences entirely (align_full semantics).

    Windows whose length difference the band cannot hold, and empty
    queries, go to the scalar Myers path; the rest are sorted by query
    length and aligned on `device` in blocks of at most max_batch."""
    out: List = [None] * len(qs)
    todo = []
    for i in range(len(qs)):
        if abs(len(qs[i]) - len(ts[i])) >= HB - 1 or len(qs[i]) == 0:
            out[i] = align_full(qs[i], ts[i])
        else:
            todo.append(i)
    order = sorted(todo, key=lambda i: len(qs[i]))
    for blk in range(0, len(order), max_batch):
        sel = order[blk : blk + max_batch]
        qsel = [qs[i] for i in sel]
        tsel = [ts[i] for i in sel]
        m = np.array([len(x) for x in qsel], np.int32)
        n = np.array([len(x) for x in tsel], np.int32)
        qc = np.zeros((len(sel), int(m.max())), np.uint8)
        tc = np.zeros((len(sel), int(n.max())), np.uint8)
        for w in range(len(sel)):
            qc[w, : m[w]] = qsel[w]
            tc[w, : n[w]] = tsel[w]
        dm, dn = to_device(m, device), to_device(n, device)
        moves = band_fill(to_device(qc, device), to_device(tc, device),
                          dm, dn, mrows=int(m.max()))
        cnts, mv0s, j_rem = row_traceback(moves, dm, dn)
        del moves  # free this block's moves before the next block's fill
        res = _emit_rowrec(qsel, tsel, cnts.cpu().numpy(),
                           mv0s.cpu().numpy(), j_rem.cpu().numpy())
        for w, i in enumerate(sel):
            out[i] = res[w]
    return out
