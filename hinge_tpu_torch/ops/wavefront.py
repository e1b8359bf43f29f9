"""Batched anti-diagonal wavefront aligner: port of `hinge_tpu/ops/wavefront.py` (DW_banded.c).

The draft ladder consensus aligns thousands of ~tspace-bp window pairs with
the vendored FALCON banded O(ND) aligner (`src/lib/DW_banded.c:_align`);
`ops/myers.py` transcribes it scalar-exactly and the native
`myers_align_batch` is its multithreaded C batch form.  This module is the
device form: the d-loop is a true dependence, every diagonal of every
window advances in parallel.  One kernel, K3, with a plain torch twin:

- `wave_align` (K3, csrc/wave_align.cu; twin `wave_forward_ref` +
  `wave_backtrack_ref`): the forward wave with its band-relative int16
  history, then the backtrack to the path points.  A wrapper takes the
  twin only for CPU tensors; for CUDA tensors it launches the kernel or
  raises.  K3 is bound by each window's chain of ~60 dependent steps,
  not by bytes: it gives a window a group of lanes (several windows a
  warp, stepped together; wider groups when the launch has few windows
  an SM, `k3_lanes`), works and keeps history only on the live band,
  and keeps the history's tail in shared memory (`k3_plan`).

Exactness (the twin repeats hinge_tpu's XLA program step for step):
identical tie-breaking (`k == min_k || (k != max_k && V[k-1] < V[k+1])`,
DW_banded.c:140-147), adaptive band pruning (best_m - band_tolerance,
:188-201), termination (first k in ascending order reaching an end,
:169-180; the max_d = 0.3*(m+n) cap, computed in float32 as JAX does, and
the band_size overflow abort, :131-137), and the chunked snake's
clip-and-pad semantics.  Row emission is host numpy, copied verbatim.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu_torch.device import DeviceError, to_device
from hinge_tpu_torch.ops.band_nw import _check

GAP = 4
_PAD_Q = 4  # pad codes chosen so q-pad never equals t-pad nor a real base
_PAD_T = 5
SNAKE_CHUNK = 16
I32 = torch.int32
#: windows per K3 launch in the single-device align_exact_batch_device on
#: CUDA (run_sharded_wave_align launches one block a shard instead), from
#: `chip_smoke.py --k3-sweep` on an H100 (per 1024 ladder windows: 0.098
#: ms at 1024 a launch, 0.034 at 4096, 0.0185 at 16384, 0.0159 at 32768).
#: K3's scratch is capped by the blocks resident on the card, so a larger
#: launch grows only px/py, two int32 rows of 2*max_d+2 a window (8.8 KB
#: at max_d 549): 32768 a launch would hold 288 MB of them to save
#: ~0.003 ms per 1024 windows.  The twin keeps hinge_tpu's 256
WAVE_BATCH = 16384
TWIN_BATCH = 256

#: kernel launches per wrapper (callers reset the count around the run
#: they measure)
launches = {"wave_align": 0}


# ---------------------------------------------------------------------------
# plain torch twin: forward wave
# ---------------------------------------------------------------------------


def _snake_batch(q, t, x0, y0, active0, chunk: int):
    """Vectorized greedy snake: run lengths of maximal match runs starting
    at (x0, y0) per lane (DW_banded.c:158-165), in chunks of `chunk`
    compares from a base clipped into [0, L-1]."""
    B, KB = x0.shape
    L = q.shape[1]
    coff = torch.arange(chunk, dtype=I32, device=q.device)
    qf = q.reshape(-1)
    tf = t.reshape(-1)
    base = (torch.arange(B, dtype=torch.int64, device=q.device) * L)[:, None, None]
    run = torch.zeros_like(x0)
    active = active0
    while bool(active.any()):
        xi = torch.clamp(x0 + run, 0, L - 1)[..., None] + coff
        yi = torch.clamp(y0 + run, 0, L - 1)[..., None] + coff
        qc = qf[base + torch.clamp(xi, 0, L - 1)]
        tc = tf[base + torch.clamp(yi, 0, L - 1)]
        eq = qc == tc
        all_eq = eq.all(dim=-1)
        inc = torch.where(all_eq, chunk,
                          torch.argmin(eq.to(torch.uint8), dim=-1).to(I32))
        run = run + torch.where(active, inc, 0)
        active = active & all_eq
    return run


def wave_forward_ref(q, t, m, n, band_tolerance: int, *, max_d: int, kb: int,
                     chunk: int = SNAKE_CHUNK, stats=None):
    """Forward DW wave over a padded batch.

    q, t: uint8 [B, L] (q padded with 4, t with 5 so pads never match);
    m, n: int32 [B] true lengths.  Returns the per-d band-relative history
    (Vh int16 [B, max_d, kb], minkh/maxkh int16 [B, max_d]) plus the
    terminal state (aligned bool, d_fin, k_fin, x_fin int32 [B]).  A
    `stats` dict with keys steps, diagonals and compares accumulates the
    work the inputs need (for a bound; it syncs every step)."""
    B, L = q.shape
    dev = q.device
    K0 = max_d
    KW = 2 * max_d + 2
    band_size = band_tolerance * 2
    lane = torch.arange(kb, dtype=I32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]

    # float32 product truncated to int, like the oracle's (int) cast
    dmax = (0.3 * (m + n)).to(I32)

    # V carries one extra trash column that takes the dropped writes
    V = torch.zeros((B, KW + 1), dtype=I32, device=dev)
    best_m = torch.full((B,), -1, dtype=I32, device=dev)
    z = torch.zeros((B,), dtype=I32, device=dev)
    min_k, max_k, d_fin, k_fin, x_fin = z, z, z, z, z
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    aligned = torch.zeros_like(done)
    Vh = torch.zeros((B, max_d, kb), dtype=torch.int16, device=dev)
    minkh = torch.zeros((B, max_d), dtype=torch.int16, device=dev)
    maxkh = torch.zeros((B, max_d), dtype=torch.int16, device=dev)

    for d in range(max_d):
        live = (~done) & (d < dmax)
        overflow = (max_k - min_k) > band_size  # DW_banded.c:131-137
        done = done | (live & overflow)
        live = live & ~overflow

        k = min_k[:, None] + 2 * lane[None, :]
        lane_ok = (2 * lane[None, :] <= (max_k - min_k)[:, None]) & live[:, None]
        idx = k + K0
        gidx = torch.clamp(idx, 1, KW - 2).long()
        Vm1 = V.gather(1, gidx - 1)
        Vp1 = V.gather(1, gidx + 1)
        take_right = (k == min_k[:, None]) | (
            (k != max_k[:, None]) & (Vm1 < Vp1))
        x0 = torch.where(take_right, Vp1, Vm1 + 1)
        y0 = x0 - k
        snaking = lane_ok & (x0 < m[:, None]) & (y0 < n[:, None])
        run = _snake_batch(q, t, x0, y0, snaking, chunk)
        x = x0 + run
        y = y0 + run
        if stats is not None:
            # the work this step needs: live windows, live diagonals and
            # byte compares (each snake's matches and its mismatch)
            stats["steps"] += int(live.sum())
            stats["diagonals"] += int(lane_ok.sum())
            stats["compares"] += int((run + 1)[snaking].sum())

        # history (band-relative lanes)
        Vh[:, d, :] = torch.where(lane_ok, x, 0).to(torch.int16)
        minkh[:, d] = torch.where(live, min_k, 0).to(torch.int16)
        maxkh[:, d] = torch.where(live, max_k, 0).to(torch.int16)

        # masked write-back of V: lanes out of the band go to the trash column
        sidx = torch.where(lane_ok & (idx >= 0) & (idx < KW), idx, KW).long()
        V[bidx, sidx] = x

        # termination: FIRST k ascending with x >= m or y >= n (:169-180)
        fin = lane_ok & ((x >= m[:, None]) | (y >= n[:, None]))
        any_fin = fin.any(dim=1)
        flane = torch.argmax(fin.to(torch.uint8), dim=1)
        hit = live & any_fin
        aligned = aligned | hit
        done = done | hit
        d_fin = torch.where(hit, d, d_fin)
        k_fin = torch.where(hit, min_k + 2 * flane.to(I32), k_fin)
        x_fin = torch.where(hit, x[bidx[:, 0], flane], x_fin)

        # band update for live windows that did not finish (:188-201)
        upd = live & ~any_fin
        u_val = x + y
        best_m2 = torch.maximum(
            best_m, torch.where(lane_ok, u_val, -(1 << 30)).max(dim=1).values)
        keep = lane_ok & (u_val >= (best_m2 - band_tolerance)[:, None])
        new_min = torch.where(keep, k, 1 << 30).min(dim=1).values
        new_max = torch.where(keep, k, -(1 << 30)).max(dim=1).values
        new_min = torch.where(keep.any(dim=1), new_min, max_k)  # :188 defaults
        new_max = torch.where(keep.any(dim=1), new_max, min_k)
        min_k = torch.where(upd, new_min - 1, min_k)
        max_k = torch.where(upd, new_max + 1, max_k)
        best_m = torch.where(upd, best_m2, best_m)
    return Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin


# ---------------------------------------------------------------------------
# plain torch twin: backtrack
# ---------------------------------------------------------------------------


def wave_backtrack_ref(Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin, *,
                       max_d: int):
    """Path points from the V history: pts[2d] = snake start of step d,
    pts[2d+1] = snake end; valid for d <= d_fin (aligned windows only).
    The predecessor choice is re-derived with the forward tie rule from
    row d-1 of the history."""
    B, _, kb = Vh.shape
    dev = Vh.device
    bb = torch.arange(B, device=dev)
    W = 2 * max_d + 2
    px = torch.zeros((B, W), dtype=I32, device=dev)
    py = torch.zeros((B, W), dtype=I32, device=dev)
    k, x2 = k_fin.clone(), x_fin.clone()
    for i in range(max_d + 1):
        d = d_fin - i  # walk d_fin .. 0
        on = aligned & (d >= 0)
        dm1 = torch.clamp(d - 1, min=0).long()
        mk1 = minkh[bb, dm1].to(I32)
        lm = torch.clamp(torch.div(k - 1 - mk1, 2, rounding_mode="floor"),
                         0, kb - 1).long()
        lp = torch.clamp(torch.div(k + 1 - mk1, 2, rounding_mode="floor"),
                         0, kb - 1).long()
        Vm1 = Vh[bb, dm1, lm].to(I32)
        Vp1 = Vh[bb, dm1, lp].to(I32)
        dl = torch.clamp(d, 0, max_d - 1).long()  # jax clamps the gather
        mk = minkh[bb, dl].to(I32)
        xk = maxkh[bb, dl].to(I32)
        take_right = (k == mk) | ((k != xk) & (Vm1 < Vp1))
        x1 = torch.where(d == 0, 0, torch.where(take_right, Vp1, Vm1 + 1))
        y1 = x1 - k
        pos = torch.clamp(2 * d, 0, W - 2).long()
        px[bb, pos] = torch.where(on, x1, px[bb, pos])
        py[bb, pos] = torch.where(on, y1, py[bb, pos])
        px[bb, pos + 1] = torch.where(on, x2, px[bb, pos + 1])
        py[bb, pos + 1] = torch.where(on, x2 - k, py[bb, pos + 1])
        # step to predecessor: its post-snake x is the value we chose from
        pre_k = torch.where(take_right, k + 1, k - 1)
        x2p = torch.where(take_right, Vp1, Vm1)
        k = torch.where(on & (d > 0), pre_k, k)
        x2 = torch.where(on & (d > 0), x2p, x2)
    return px, py


# ---------------------------------------------------------------------------
# K3: forward wave + backtrack in one kernel
# ---------------------------------------------------------------------------


def wave_align(q, t, m, n, band_tolerance: int, *, max_d: int, kb: int):
    """Forward wave and backtrack on q's device: K3 for CUDA tensors, the
    plain twin for CPU tensors.

    q, t uint8 [B, L] padded with 4 and 5 (L >= max(m, n) + 16); m, n
    int32 [B].  Returns (px, py int32 [B, 2*max_d+2], aligned bool [B],
    d_fin, k_fin, x_fin int32 [B]); px/py hold the path points at
    [0, 2*d_fin+2) and are scratch beyond (zeros in the twin)."""
    dev = q.device
    _check("q", q, torch.uint8, 2, dev)
    _check("t", t, torch.uint8, 2, dev)
    _check("m", m, I32, 1, dev)
    _check("n", n, I32, 1, dev)
    B, L = q.shape
    if t.shape != (B, L) or m.shape != (B,) or n.shape != (B,):
        raise ValueError("q, t, m, n disagree on the batch shape")
    if kb < 1 or max_d < 1:
        raise ValueError(f"max_d {max_d} and kb {kb} must be positive")
    if dev.type == "cpu":
        Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin = wave_forward_ref(
            q, t, m, n, band_tolerance, max_d=max_d, kb=kb)
        px, py = wave_backtrack_ref(Vh, minkh, maxkh, aligned, d_fin, k_fin,
                                    x_fin, max_d=max_d)
        return px, py, aligned, d_fin, k_fin, x_fin
    return launch_wave_align(q, t, m, n, band_tolerance, max_d=max_d, kb=kb)


#: K3's limits (csrc/wave_align.cu): band slots, and the bound on L and
#: max_d that the one-warp-a-window K3 of commit b79cf98 set (4 * (its V
#: row + q + t) <= SMEM_MAX); every input inside it is taken, and it keeps
#: L < 32768, so K3's int16 V is exact
KB_MAX = 256
SMEM_MAX = 232448
#: the most threads a block has (a block holds K3_THREADS // lanes
#: windows when they fit)
K3_THREADS = 128
#: the group widths (lanes a window) K3 is built for, widest first, each
#: with the most windows an SM a launch may have to take it (the last
#: takes any): a wide group shortens each window's chain of steps while
#: the card has few windows, a narrow one spends no issue on idle lanes
#: once the card is full.  Crossovers from `chip_smoke.py --k3-sweep` on
#: an H100's 132 SMs: 32 lanes fastest up to 15.5 windows an SM, 16 from
#: 23.3 to 46.5, 8 from 62.1 on
K3_WIDTHS = ((32, 20.0), (16, 54.0), (8, float("inf")))
#: the most history entries a window keeps in its shared-memory ring
K3_RING = 64


def _a16(v: int) -> int:
    return -(-v // 16) * 16


def check_k3_limits(L: int, max_d: int, kb: int) -> None:
    """Raise ValueError for a block K3 does not take."""
    if kb > KB_MAX or 4 * (_a16((2 * max_d + 2) * 4) + 2 * _a16(L)) > SMEM_MAX:
        raise ValueError(f"K3 takes kb <= {KB_MAX} and 4 * (a V row of "
                         f"2*max_d+2 int32 + q + t of L bytes) <= {SMEM_MAX} "
                         f"bytes: kb {kb}, max_d {max_d}, L {L}")


def k3_lanes(B: int, sms: int) -> int:
    """The group width of a K3 launch of B windows on a card of `sms` SMs:
    the widest of K3_WIDTHS whose windows-an-SM limit B keeps under."""
    return next(g for g, most in K3_WIDTHS if B <= most * sms)


def k3_plan(L: int, max_d: int, kb: int, band_tolerance: int,
            lanes: int) -> dict:
    """K3's launch shape for one block of windows at `lanes` lanes a window.

    ring: history entries a window keeps in shared memory, K3_RING or two
    rows of the widest live band (min(kb, band_tolerance + 1) slots, plus
    min_k and max_k each) if fewer; window_smem: q, t and the ring;
    windows_per_block; threads; hist_per_slot: the int16 history stream's
    most entries for one window, one row a step of at most
    min(d + 1, widest) slots plus its two band edges, rounded up to 8
    entries."""
    if lanes not in [g for g, _ in K3_WIDTHS]:
        raise ValueError(f"K3 is built for {[g for g, _ in K3_WIDTHS]} lanes "
                         f"a window, not {lanes}")
    widest = max(1, min(kb, band_tolerance + 1))
    ring = min(2 * widest + 4, K3_RING)
    window = 2 * _a16(L + 4) + _a16(2 * ring)
    wb = max(1, min(K3_THREADS // lanes, SMEM_MAX // window))
    ramp = min(max_d, widest)
    hist = ramp * (ramp + 1) // 2 + (max_d - ramp) * widest + 2 * max_d
    hist = -(-hist // 8) * 8  # 16-byte aligned streams
    return {"lanes": lanes, "ring": ring, "window_smem": window,
            "windows_per_block": wb, "threads": -(-wb * lanes // 32) * 32,
            "hist_per_slot": hist}


#: blocks of a plan resident on a card at once, by (device, plan)
_resident: dict = {}


def k3_grid(B: int, plan: dict, resident: int) -> int:
    """Persistent blocks of one launch: enough for the batch, no more than
    fit on the card at once."""
    return max(1, min(-(-B // plan["windows_per_block"]), resident))


def launch_wave_align(q, t, m, n, band_tolerance: int, *, max_d: int, kb: int):
    """The K3 launch alone, for CUDA tensors that wave_align has checked:
    no host synchronisation, so back-to-back calls time the kernel.  The
    group width comes from the batch and the card (`k3_lanes`)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return launch_k3_at(q, t, m, n, band_tolerance, max_d=max_d, kb=kb,
                        lanes=k3_lanes(q.shape[0], sms))


def launch_k3_at(q, t, m, n, band_tolerance: int, *, max_d: int, kb: int,
                 lanes: int):
    """launch_wave_align at a given group width (its sweep and tests)."""
    from hinge_tpu_torch.ops._build import load_kernels

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B, L = q.shape
    W = 2 * max_d + 2
    check_k3_limits(L, max_d, kb)
    plan = k3_plan(L, max_d, kb, band_tolerance, lanes)
    lib = load_kernels()
    px = torch.empty((B, W), dtype=I32, device=dev)
    py = torch.empty((B, W), dtype=I32, device=dev)
    aligned = torch.empty((B,), dtype=torch.bool, device=dev)
    fins = torch.empty((3, B), dtype=I32, device=dev)
    if B == 0:
        return px, py, aligned, fins[0], fins[1], fins[2]
    wb, ring, hps = plan["windows_per_block"], plan["ring"], plan["hist_per_slot"]
    with torch.cuda.device(dev):
        key = (dev.index, plan["lanes"], wb, L, ring)
        if key not in _resident:
            _resident[key] = lib.hinge_wave_align_resident(plan["lanes"], wb, L, ring)
        if _resident[key] <= 0:
            raise DeviceError(f"wave_align fits no block on {dev}: "
                              f"cudaError {-_resident[key]}")
        grid = k3_grid(B, plan, _resident[key])
        # scratch: one history stream a resident window, entries past a
        # window's end never written
        hist = torch.empty(grid * wb * hps, dtype=torch.int16, device=dev)
        err = lib.hinge_wave_align(
            q.data_ptr(), t.data_ptr(), L, m.data_ptr(), n.data_ptr(), B,
            band_tolerance, max_d, kb, plan["lanes"], wb, ring, hps, grid,
            hist.data_ptr(), px.data_ptr(), py.data_ptr(), aligned.data_ptr(),
            fins[0].data_ptr(), fins[1].data_ptr(), fins[2].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise DeviceError(f"wave_align kernel launch failed: cudaError {err}")
    launches["wave_align"] += 1
    return px, py, aligned, fins[0], fins[1], fins[2]


# ---------------------------------------------------------------------------
# row emission (host, one flat vectorized pass)
# ---------------------------------------------------------------------------


def _emit_rows_batch(qs, ts, px, py, npts, aligned):
    """Aligned rows per window from path points (align_pair's backtrack
    emission: vertical -> q gaps, horizontal -> t gaps, diagonal -> both).
    Returns list[(q_aln, t_aln)]; unaligned windows get empty rows
    (align_exact semantics).  Carried over unchanged from hinge_tpu."""
    B = len(qs)
    out: List = [None] * B
    for i in range(B):
        if not aligned[i]:
            out[i] = (np.zeros(0, np.uint8), np.zeros(0, np.uint8))
            continue
        np_i = int(npts[i])
        cx = px[i, :np_i]
        cy = py[i, :np_i]
        dq = np.diff(cx.astype(np.int64))
        dt = np.diff(cy.astype(np.int64))
        keep = (dq > 0) | (dt > 0)
        dq, dt = dq[keep], dt[keep]
        sx, sy = cx[:-1][keep], cy[:-1][keep]
        cols = np.maximum(dq, dt)
        totc = int(cols.sum())
        off = np.cumsum(cols) - cols
        rows_r = np.repeat(np.arange(len(cols)), cols)
        inner = np.arange(totc, dtype=np.int64) - off[rows_r]
        q_row = np.full(totc, GAP, np.uint8)
        t_row = np.full(totc, GAP, np.uint8)
        qm = dq[rows_r] > 0
        tm = dt[rows_r] > 0
        q_row[qm] = qs[i][(sx[rows_r] + inner)[qm]]
        t_row[tm] = ts[i][(sy[rows_r] + inner)[tm]]
        out[i] = (q_row, t_row)
    return out


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_block(qs, ts, band_tolerance: int = 150):
    """The padded host inputs of one block: (q, t, m, n, max_d, kb), with
    L = round_up(Lmax + 16, 128) and max_d = max(2, int(0.3 * max(m+n)))
    as hinge_tpu's `_align_block` builds them."""
    B = len(qs)
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    Lmax = max(1, int(max(m.max(), n.max())))
    L = _round_up(Lmax + SNAKE_CHUNK, 128)
    q = np.full((B, L), _PAD_Q, np.uint8)
    t = np.full((B, L), _PAD_T, np.uint8)
    for i in range(B):
        q[i, : m[i]] = qs[i]
        t[i, : n[i]] = ts[i]
    max_d = max(2, int(0.3 * int((m + n).max())))
    return q, t, m, n, max_d, band_tolerance + 2


def _align_block(qs, ts, band_tolerance, device):
    q, t, m, n, max_d, kb = pack_block(qs, ts, band_tolerance)
    px, py, aligned, d_fin, _, _ = (
        x.cpu().numpy() for x in wave_align(
            *(to_device(a, device) for a in (q, t, m, n)), band_tolerance,
            max_d=max_d, kb=kb))
    npts = 2 * (d_fin + 1)
    # zero-length pair: scalar align_pair short-circuits to aligned/empty
    both_empty = (m == 0) & (n == 0)
    aligned_h = aligned | both_empty
    npts = np.where(both_empty, 0, npts)
    return _emit_rows_batch(qs, ts, px, py, npts, aligned_h)


def align_exact_batch_device(
    qs: Sequence[np.ndarray],
    ts: Sequence[np.ndarray],
    band_tolerance: int = 150,
    max_batch: int = 0,
    *,
    device,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """DW_banded-exact rows for a batch of windows, computed on `device`
    in blocks of `max_batch` windows sorted by size (default WAVE_BATCH on
    CUDA, TWIN_BATCH on the CPU).  Byte-identical to myers.align_exact /
    the native myers_align_batch."""
    B = len(qs)
    if B == 0:
        return []
    if not max_batch:
        max_batch = WAVE_BATCH if torch.device(device).type == "cuda" else TWIN_BATCH
    out: List = [None] * B
    # bucket by size so padding (and max_d) stays tight
    lens = np.array([len(qs[i]) + len(ts[i]) for i in range(B)])
    order = np.argsort(lens, kind="stable")
    for blk in range(0, B, max_batch):
        sel = order[blk : blk + max_batch]
        res = _align_block([qs[i] for i in sel], [ts[i] for i in sel],
                           band_tolerance, device)
        for j, i in enumerate(sel):
            out[i] = res[j]
    return out
