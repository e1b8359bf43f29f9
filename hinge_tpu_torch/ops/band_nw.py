"""Banded Needleman-Wunsch window aligner on the hand-written CUDA kernels.

Port of `hinge_tpu/ops/pallas_band_nw.py` (its docstring derives the
regular-access band formulation).  Three kernels, each with a plain
torch twin in this module:

- `band_fill` (K1, csrc/band_fill.cu; twin `band_fill_ref`): int8 move
  codes (B, mrows, 256), 0 diag, 1 up, 2 left, 3 invalid;
- `row_traceback` (K2, csrc/row_traceback.cu; twin `row_traceback_ref`):
  per-row left-run counts, terminating moves and the leading left
  columns;
- `emit_rows` (K2e, csrc/emit_rows.cu; twin `emit_rows_ref`): the gapped
  q and t rows of every window from K2's records, end to end in one flat
  buffer.

A wrapper takes its twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  `band_align_batch` is the dispatch:
windows the band cannot hold go to the Myers path, the rest are
sorted by length and aligned in blocks, each going up as one flat buffer
and coming down as one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu_torch.ops.myers import align_full_batch
from hinge_tpu_torch.device import DeviceError, to_device, to_host
from hinge_tpu_torch.utils.log import count, span
from hinge_tpu_torch.ops._build import load_kernels

GAP = 4
BW = 256
HB = BW // 2
INF = 1 << 24
I32 = torch.int32
#: windows per band_fill / row_traceback / emit_rows launch in band_align_batch
MAX_BATCH = 8192

#: kernel launches per wrapper (a launch that compares a kernel with its
#: twin counts too; callers reset the counts around the run they measure)
launches = {"band_fill": 0, "row_traceback": 0, "emit_rows": 0}


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
# K2e: rows from the traceback's records
# ---------------------------------------------------------------------------

#: K2e's launch shape: consecutive DP rows a thread, threads a window at
#: most, and stage bytes a row (q's and t's each) at most
EMIT_ITEMS = 4
EMIT_MAX_THREADS = 256
EMIT_MAX_STAGE = 16384


def emit_plan(mrows: int) -> Tuple[int, int]:
    """K2e's launch shape from the block's longest window (mrows rows):
    threads a window (a power of two from 32 to 256, EMIT_ITEMS rows each
    where that covers the window) and the shared-memory stage a row, in
    bytes: a multiple of 16 that holds the columns of a window of mrows
    rows against a target up to HB - 2 bases longer, plus 16 for the
    alignment shift, up to EMIT_MAX_STAGE (longer windows' chunks past it
    go straight to device memory)."""
    threads = 32
    while threads < EMIT_MAX_THREADS and threads * EMIT_ITEMS < mrows:
        threads *= 2
    stage = -(-(2 * mrows + HB + 16) // 16) * 16
    return threads, min(stage, EMIT_MAX_STAGE)


def _emit_check(cnts, mv0s, j_rem, m, n, q, t):
    dev = cnts.device
    _check("cnts", cnts, torch.uint8, 2, dev)
    _check("mv0s", mv0s, torch.int8, 2, dev)
    for name, x in (("j_rem", j_rem), ("m", m), ("n", n)):
        _check(name, x, I32, 1, dev)
    _check("q", q, torch.uint8, 1, dev)
    _check("t", t, torch.uint8, 1, dev)
    B = cnts.shape[0]
    if mv0s.shape != cnts.shape or any(
            x.shape != (B,) for x in (j_rem, m, n)):
        raise ValueError(
            f"cnts {tuple(cnts.shape)}, mv0s {tuple(mv0s.shape)}, j_rem / m "
            f"/ n {[tuple(x.shape) for x in (j_rem, m, n)]}: want (B, mrows) "
            "twice and (B,)")


def emit_rows_ref(cnts, mv0s, j_rem, m, n, q, t):
    """Plain torch K2e: the alignment rows of a block of windows from K2's
    records, on any device.

    cnts (B, mrows) uint8, mv0s (B, mrows) int8, j_rem (B,) int32 as
    `row_traceback` returns them; m, n (B,) int32 the windows' lengths;
    q, t (uint8, flat) the windows' query and target bases end to end.
    Window w has cols = j_rem + m + sum(cnt[:m]) columns: j_rem leading
    left columns, then per DP row r its up/diag column (q[r]; in t a gap
    where mv0 == 1) followed by cnt[r] left columns (gaps in q); t's bases
    fill every column that is not an up column, in order.  Returns (meta,
    rows): meta int64 (B + 2,), meta[w] the window's first column
    (meta[B] the total) and meta[B + 1] the windows whose records do not
    fit their lengths (cols - ups != n, j_rem < 0, m outside [0, mrows],
    bases past q or t), which get no columns; rows uint8 with the q rows
    at [0, total) and the t rows at [total, 2 total), gap code GAP.

    Replaces host numpy, `hinge_tpu/ops/pallas_band_nw.py::_emit_rowrec`
    (same rows)."""
    B, mrows = cnts.shape
    dev, i64 = cnts.device, torch.int64
    m64, n64, jr = m.to(i64), n.to(i64), j_rem.to(i64)
    live = torch.arange(mrows, device=dev)[None, :] < m64[:, None]
    cnt = torch.where(live, cnts.to(i64), 0)
    up = live & (mv0s == 1)
    cols = jr + m64 + cnt.sum(1)
    mq, nt = m64.clamp(min=0), n64.clamp(min=0)
    qoff, toff = torch.cumsum(mq, 0) - mq, torch.cumsum(nt, 0) - nt
    bad = ((m64 < 0) | (m64 > mrows) | (n64 < 0) | (jr < 0)
           | (cols - up.sum(1) != n64) | (qoff + mq > q.numel())
           | (toff + nt > t.numel()))
    cols = torch.where(bad, 0, cols)
    meta = torch.zeros(B + 2, dtype=i64, device=dev)
    meta[1:B + 1] = torch.cumsum(cols, 0)
    meta[B + 1] = bad.sum()
    total = int(meta[B])
    rows = torch.full((2 * total,), GAP, dtype=torch.uint8, device=dev)

    # a record a live row of a window that fits, in (window, row) order
    live &= ~bad[:, None]
    wid, r = live.nonzero(as_tuple=True)
    seg = cnt + 1
    seg_w = torch.where(live, seg, 0).sum(1)
    excl = torch.cumsum(seg[live], 0) - seg[live]
    col = (meta[wid] + jr[wid] + excl
           - (torch.cumsum(seg_w, 0) - seg_w)[wid])
    rows[col] = q[qoff[wid] + r]
    tfill = torch.ones(total, dtype=torch.bool, device=dev)
    tfill[col[up[live]]] = False
    # every fitting window's t bases, in order
    nt_ok = torch.where(bad, 0, nt)
    tw = torch.repeat_interleave(torch.arange(B, device=dev), nt_ok)
    tpos = (torch.arange(tw.numel(), device=dev)
            - (torch.cumsum(nt_ok, 0) - nt_ok)[tw])
    rows[total + tfill.nonzero()[:, 0]] = t[toff[tw] + tpos]
    return meta, rows


def emit_rows(cnts, mv0s, j_rem, m, n, q, t):
    """Rows on the records' device: K2e (csrc/emit_rows.cu) for CUDA
    tensors, `emit_rows_ref` for CPU tensors.  Arguments and (meta, rows)
    as for `emit_rows_ref`; on CUDA, rows has room for 2 (q.numel() +
    t.numel()) bytes, of which the first 2 meta[B] hold the rows, and
    nothing waits for the card."""
    _emit_check(cnts, mv0s, j_rem, m, n, q, t)
    dev = cnts.device
    if dev.type == "cpu":
        return emit_rows_ref(cnts, mv0s, j_rem, m, n, q, t)
    lib, stream = _launch_on(dev)
    B, mrows = cnts.shape
    if B == 0:
        return (torch.zeros(2, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.uint8, device=dev))
    meta = torch.empty(B + 2, dtype=torch.int64, device=dev)
    rows = torch.empty(2 * (q.numel() + t.numel()), dtype=torch.uint8,
                       device=dev)
    scratch = torch.empty(3 * B, dtype=torch.int64, device=dev)
    threads, stage = emit_plan(mrows)
    with torch.cuda.device(dev):
        err = lib.hinge_emit_rows(
            cnts.data_ptr(), mv0s.data_ptr(), j_rem.data_ptr(), m.data_ptr(),
            n.data_ptr(), q.data_ptr(), q.numel(), t.data_ptr(), t.numel(),
            scratch.data_ptr(), meta.data_ptr(), rows.data_ptr(), B, mrows,
            threads, stage, stream)
    if err:
        raise DeviceError(f"emit_rows kernel launch failed: cudaError {err}")
    launches["emit_rows"] += 1
    return meta, rows


def fetch_rows(meta, rows):
    """(bases, q rows, t rows) on the host from `emit_rows`' output: the
    window bases (int64, B + 1) and the flat rows, in two copies (meta,
    then the rows' used bytes).  Raises ValueError when a window's records
    did not fit its lengths."""
    head = to_host(meta)
    B = head.size - 2
    if head[B + 1]:
        raise ValueError(f"emit_rows: the traceback records of {head[B + 1]} "
                         f"of {B} windows do not fit their lengths")
    total = int(head[B])
    both = to_host(rows[:2 * total])
    return head[:B + 1], both[:total], both[total:]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def pack_block(qs, ts) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A block of windows as one flat uint8 buffer: m and n (int32, B
    each), then every query's bases, then every target's; and m, n."""
    m = np.fromiter(map(len, qs), np.int32, len(qs))
    n = np.fromiter(map(len, ts), np.int32, len(ts))
    buf = np.concatenate([m.view(np.uint8), n.view(np.uint8), *qs, *ts],
                         dtype=np.uint8, casting="unsafe")
    return buf, m, n


def _padded(flat, lens, width: int) -> torch.Tensor:
    """(B, width) rows of a flat buffer of windows end to end (lengths
    `lens`): window w's bases lead row w, and whatever follows them in the
    buffer fills the rest (K1 and its twin read a window only within its
    length)."""
    off = torch.cumsum(lens, 0) - lens
    idx = off[:, None] + torch.arange(width, device=flat.device)
    return flat[idx.clamp_(max=max(flat.numel() - 1, 0))]


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
    queries, go to the Myers path (`myers.align_full_batch`: align_full's
    rows, by the native batch where it builds); the rest (counted as
    `band_nw.pairs`) are sorted by query length and aligned on `device`
    in blocks of at most max_batch, each block in the spans
    `band_nw.pack` (one flat buffer of the bases and lengths), `.device`
    (the buffer up, K1, K2 and K2e), `.fetch` (the window bases and the
    flat rows down) and `.emit` (cutting the rows into per-window views).
    `band_nw.rows_on_card` counts the windows whose rows the card made
    (0 on the CPU, where the twins run)."""
    out: List = [None] * len(qs)
    todo, wide = [], []
    for i in range(len(qs)):
        if abs(len(qs[i]) - len(ts[i])) >= HB - 1 or len(qs[i]) == 0:
            wide.append(i)
        else:
            todo.append(i)
    for i, rows in zip(wide, align_full_batch([qs[i] for i in wide],
                                              [ts[i] for i in wide])):
        out[i] = rows
    order = sorted(todo, key=lambda i: len(qs[i]))
    count("band_nw.pairs", len(order))
    on_card = torch.device(device).type == "cuda"
    for blk in range(0, len(order), max_batch):
        sel = order[blk : blk + max_batch]
        with span("band_nw.pack"):
            buf, m, n = pack_block([qs[i] for i in sel], [ts[i] for i in sel])
        with span("band_nw.device", device):
            B, sq = len(sel), int(m.sum())
            dbuf = to_device(buf, device)
            dm = dbuf[: 4 * B].view(I32)
            dn = dbuf[4 * B : 8 * B].view(I32)
            dq, dt = dbuf[8 * B : 8 * B + sq], dbuf[8 * B + sq :]
            mrows = int(m.max())
            moves = band_fill(_padded(dq, dm, mrows), _padded(dt, dn, int(n.max())),
                              dm, dn, mrows=mrows)
            cnts, mv0s, j_rem = row_traceback(moves, dm, dn)
            del moves  # free this block's moves before the next block's fill
            meta, rows = emit_rows(cnts, mv0s, j_rem, dm, dn, dq, dt)
        with span("band_nw.fetch"):
            bases, q_rows, t_rows = fetch_rows(meta, rows)
        with span("band_nw.emit"):
            b = bases.tolist()
            for w, i in enumerate(sel):
                out[i] = (q_rows[b[w] : b[w + 1]], t_rows[b[w] : b[w + 1]])
        count("band_nw.rows_on_card", B if on_card else 0)
    return out
