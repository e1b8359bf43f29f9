"""The port's DW_banded wave (hinge_tpu_torch.ops.wavefront) against
hinge_tpu's device wave and the scalar oracle, tolerance 0.

On the CPU `wave_align` runs its plain torch twin, whose rows must equal
hinge_tpu's `align_exact_batch_device` and the port's `myers.align_exact`
on every case of tests/test_wavefront.py and on an m+n sweep across the
dmax cap, and whose raw state (history, terminal state, path points) must
equal hinge_tpu's `_wave_forward` / `_wave_backtrack` on the same padded
block.  K3's launch plan (csrc/wave_align.cu: lanes, shared memory, ring
and history sizes) is checked against the history the twin writes.  The
`cuda` cases hold K3 against the twin; jax and hinge_tpu are imported
only by the CPU cases, so on a card without them run
`python -m pytest tests/test_torch_wavefront.py -q -m cuda --noconftest`.
"""

import numpy as np
import pytest
import torch

from hinge_tpu_torch.ops import myers as MY
from hinge_tpu_torch.ops import wavefront as TW


def _jw():
    from hinge_tpu.ops import wavefront as JW

    return JW


def _make_pair(rng, n, err):
    """tests/test_wavefront.py's pair: t random, q a noisy copy."""
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for b in t:
        r = rng.random()
        if r < err * 0.4:
            continue
        if r < err * 0.8:
            q.append(int(rng.integers(0, 4)))
        else:
            q.append(int(b))
        if rng.random() < err * 0.3:
            q.append(int(rng.integers(0, 4)))
    return np.array(q, np.uint8), t


def _check(qs, ts):
    got = TW.align_exact_batch_device(qs, ts, device="cpu")
    want = _jw().align_exact_batch_device(qs, ts)
    for i, (q, t) in enumerate(zip(qs, ts)):
        qa, ta = MY.align_exact(q, t)
        for row, (g, w, o) in enumerate(zip(got[i], want[i], (qa, ta))):
            np.testing.assert_array_equal(g, w, err_msg=f"window {i} row {row}")
            np.testing.assert_array_equal(g, o, err_msg=f"window {i} row {row}")


def _fuzz():
    rng = np.random.default_rng(11)
    pairs = [_make_pair(rng, int(rng.integers(40, 350)),
                        float(rng.uniform(0.02, 0.35))) for _ in range(48)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _edges():
    rng = np.random.default_rng(5)
    t0 = rng.integers(0, 4, 300).astype(np.uint8)
    cases = [
        (t0.copy(), t0),
        (np.zeros(0, np.uint8), rng.integers(0, 4, 40).astype(np.uint8)),
        (rng.integers(0, 4, 40).astype(np.uint8), np.zeros(0, np.uint8)),
        (np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
        (rng.integers(0, 4, 400).astype(np.uint8),
         rng.integers(0, 4, 400).astype(np.uint8)),
        (np.array([1], np.uint8), np.array([2], np.uint8)),
        (rng.integers(0, 4, 50).astype(np.uint8),
         rng.integers(0, 4, 300).astype(np.uint8)),
    ]
    return [c[0] for c in cases], [c[1] for c in cases]


def _sweep():
    """Every m+n from 1 to 120 (so every multiple of 10, where 0.3*(m+n)
    is integral), unrelated and mostly-equal pairs: windows that finish
    near or past the dmax cap."""
    rng = np.random.default_rng(13)
    qs, ts = [], []
    for s in range(1, 121):
        for shared in (False, True):
            m = int(rng.integers(0, s + 1))
            q = rng.integers(0, 4, m).astype(np.uint8)
            t = rng.integers(0, 4, s - m).astype(np.uint8)
            if shared:
                k = min(m, s - m)
                q[: k // 2] = t[: k // 2]
            qs.append(q)
            ts.append(t)
    return qs, ts


def test_fuzz_rows_match_hinge_tpu_and_oracle():
    _check(*_fuzz())


def test_edge_cases_match_hinge_tpu_and_oracle():
    _check(*_edges())


def test_mixed_size_bucketing_matches_hinge_tpu_and_oracle():
    rng = np.random.default_rng(9)
    pairs = [_make_pair(rng, s, 0.15) for s in [5, 300, 12, 250, 90, 7, 180]]
    _check([p[0] for p in pairs], [p[1] for p in pairs])


def test_dmax_sweep_matches_hinge_tpu_and_oracle():
    _check(*_sweep())


def test_block_size_does_not_change_rows():
    qs, ts = _fuzz()
    a = TW.align_exact_batch_device(qs, ts, device="cpu", max_batch=7)
    b = TW.align_exact_batch_device(qs, ts, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.concatenate(x), np.concatenate(y))


def test_twin_state_matches_hinge_tpu_programs():
    """History, terminal state and path points of one padded block equal
    hinge_tpu's `_wave_forward` / `_wave_backtrack`."""
    qs, ts = _edges()
    fq, ft = _fuzz()
    qs, ts = qs + fq[:9], ts + ft[:9]
    import jax.numpy as jnp

    JW = _jw()
    q, t, m, n, max_d, kb = TW.pack_block(qs, ts)
    jf = JW._wave_forward(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m),
                          jnp.asarray(n), jnp.int32(150), max_d=max_d, kb=kb)
    jpx, jpy = JW._wave_backtrack(*jf, max_d=max_d)
    args = [torch.from_numpy(a) for a in (q, t, m, n)]
    stats = dict(steps=0, diagonals=0, compares=0)
    tf = TW.wave_forward_ref(*args, 150, max_d=max_d, kb=kb, stats=stats)
    for name, g, w in zip(("Vh", "minkh", "maxkh", "aligned", "d_fin", "k_fin",
                           "x_fin"), tf, jf):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tpx, tpy = TW.wave_backtrack_ref(*tf, max_d=max_d)
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(jpy))
    got = TW.wave_align(*args, 150, max_d=max_d, kb=kb)
    for g, w in zip(got, (tpx, tpy, *tf[3:])):
        assert torch.equal(g, w)
    # every live step writes a history row: at least d_fin+1 per aligned
    # window; a diagonal per live step at least, a compare per snake
    aligned, d_fin = tf[3].numpy(), tf[4].numpy()
    assert stats["steps"] >= int((d_fin[aligned] + 1).sum())
    assert stats["diagonals"] >= stats["steps"] > 0
    assert stats["compares"] > 0


def test_wave_align_checks_its_inputs():
    q, t, m, n, max_d, kb = TW.pack_block(*_edges())
    args = [torch.from_numpy(a) for a in (q, t, m, n)]
    with pytest.raises(TypeError):
        TW.wave_align(args[0].to(torch.int32), *args[1:], 150, max_d=max_d, kb=kb)
    with pytest.raises(ValueError):
        TW.wave_align(args[0], args[1][:-1], *args[2:], 150, max_d=max_d, kb=kb)


def test_k3_plan_shapes():
    """The launch plan at phase 9c's block (L 1024, max_d 549, kb 152,
    band_tolerance 150) and at the edges of the limits."""
    p = TW.k3_plan(1024, 549, 152, 150, 8)
    assert p == {"lanes": 8, "ring": 64, "window_smem": 2208,
                 "windows_per_block": 16, "threads": 128, "hist_per_slot": 72672}
    # the ring holds K3_RING entries, or two rows of the widest live band
    # (min(kb, bt + 1) slots and two band edges each) if fewer
    assert TW.k3_plan(1024, 549, 5, 150, 8)["ring"] == 14
    assert TW.k3_plan(1024, 549, 152, 10, 8)["ring"] == 26
    assert TW.k3_plan(1024, 3, 152, 150, 8)["hist_per_slot"] == 16  # 1+2+3+6
    for lanes, _ in TW.K3_WIDTHS:
        for L, max_d in ((128, 2), (1024, 549), (29040, 1), (16, 7259)):
            TW.check_k3_limits(L, max_d, 256)
            p = TW.k3_plan(L, max_d, 256, 150, lanes)
            wb = p["windows_per_block"]
            assert wb >= 1 and wb * lanes <= TW.K3_THREADS
            assert wb * p["window_smem"] <= TW.SMEM_MAX
            assert p["threads"] % 32 == 0 and p["threads"] >= wb * lanes
    assert TW.k3_plan(29040, 1, 152, 150, 8)["windows_per_block"] == 3
    for lanes in (3, 4, 64):
        with pytest.raises(ValueError):
            TW.k3_plan(1024, 549, 152, 150, lanes)


def test_k3_limits_raise():
    """The inputs the one-warp-a-window K3 took, and no others: kb <= 256 and
    4 * (V row + q + t) within the shared memory of a block."""
    TW.check_k3_limits(29040, 1, 256)
    TW.check_k3_limits(16, 7259, 1)
    for L, max_d, kb in ((1024, 549, 257), (29056, 1, 152), (16, 7260, 152)):
        with pytest.raises(ValueError):
            TW.check_k3_limits(L, max_d, kb)


def test_k3_grid():
    p = TW.k3_plan(1024, 549, 152, 150, 8)
    assert TW.k3_grid(11129, p, 792) == 696
    assert TW.k3_grid(20000, p, 792) == 792
    assert TW.k3_grid(1000, p, 1320) == 63
    assert TW.k3_grid(1, p, 1320) == 1
    assert TW.k3_grid(17, TW.k3_plan(1024, 549, 152, 150, 32), 5) == 5


@pytest.mark.parametrize("B,sms,lanes", [
    (1, 132, 32), (256, 132, 32), (20 * 132, 132, 32), (20 * 132 + 1, 132, 16),
    (54 * 132, 132, 16), (54 * 132 + 1, 132, 8), (11129, 132, 8),
    (32768, 132, 8), (512, 16, 16), (2 ** 20, 1, 8)])
def test_k3_lanes_by_windows_an_sm(B, sms, lanes):
    """The group width follows the launch's windows an SM: the widest
    group while the card has few, 8 lanes once it is full (9c's shard
    block of 11,129 on 132 SMs; its 256-window block takes 32)."""
    assert TW.k3_lanes(B, sms) == lanes
    assert TW.k3_plan(1024, 549, 152, 150, lanes)["lanes"] == lanes


def test_k3_widths_widest_first():
    widths = [g for g, _ in TW.K3_WIDTHS]
    limits = [most for _, most in TW.K3_WIDTHS]
    assert widths == sorted(widths, reverse=True) and widths[-1] == 8
    assert limits == sorted(limits) and limits[-1] == float("inf")


@pytest.mark.parametrize("bt,kb", [(150, None), (10, None), (20, 5)])
def test_k3_history_fits_its_plan(bt, kb):
    """Every aligned window's compact history (each row's live slots and
    its two band edges), as the twin's path writes it, fits the plan's
    scratch stream."""
    qs, ts = _fuzz()
    eq, et = _edges()
    q, t, m, n, max_d, kb0 = TW.pack_block(qs + eq, ts + et, bt)
    kb = kb or kb0
    fwd = TW.wave_forward_ref(*(torch.from_numpy(a) for a in (q, t, m, n)), bt,
                              max_d=max_d, kb=kb)
    minkh, maxkh, aligned, d_fin = (x.numpy().astype(np.int64) for x in
                                    (fwd[1], fwd[2], fwd[3], fwd[4]))
    plan = TW.k3_plan(q.shape[1], max_d, kb, bt, 8)
    assert aligned.any()
    for i in np.flatnonzero(aligned):
        rows = np.minimum(kb, (maxkh[i, : d_fin[i] + 1]
                               - minkh[i, : d_fin[i] + 1]) // 2 + 1) + 2
        assert rows.sum() <= plan["hist_per_slot"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _k3_block_vs_twin(q, t, m, n, bt, max_d, kb, dev):
    args = [torch.from_numpy(a).to(dev) for a in (q, t, m, n)]
    got = TW.wave_align(*args, bt, max_d=max_d, kb=kb)
    want = TW.wave_align(*(a.cpu() for a in args), bt, max_d=max_d, kb=kb)
    torch.cuda.synchronize()
    for name, g, w in zip(("aligned", "d_fin", "k_fin", "x_fin"), got[2:], want[2:]):
        assert torch.equal(g.cpu(), w), name
    npts = 2 * (want[3] + 1)
    for name, g, w in zip(("px", "py"), got[:2], want[:2]):
        g = g.cpu()
        for i in range(len(m)):
            assert torch.equal(g[i, : npts[i]], w[i, : npts[i]]), (name, i)
    return want


def _k3_vs_twin(qs, ts, dev, bt=150, kb=None):
    q, t, m, n, max_d, kb0 = TW.pack_block(qs, ts, bt)
    return _k3_block_vs_twin(q, t, m, n, bt, max_d, kb or kb0, dev)


@pytest.mark.cuda
def test_cuda_k3_matches_twin(cuda_device):
    qs, ts = _fuzz()
    eq, et = _edges()
    _k3_vs_twin(qs + eq, ts + et, cuda_device)
    _k3_vs_twin(*_sweep(), cuda_device)


@pytest.mark.cuda
def test_cuda_k3_rows_match_oracle(cuda_device):
    qs, ts = _fuzz()
    got = TW.align_exact_batch_device(qs, ts, device=cuda_device)
    for i, (q, t) in enumerate(zip(qs, ts)):
        for g, w in zip(got[i], MY.align_exact(q, t)):
            np.testing.assert_array_equal(g, w, err_msg=f"window {i}")


def _unpadded_block(qs, ts):
    """qs/ts padded to L = max length + 1..3 (not a multiple of 16): the
    snake meets the pad in its last chunk, whose base the twin clips at
    L-1."""
    m = np.array([len(x) for x in qs], np.int32)
    n = np.array([len(x) for x in ts], np.int32)
    L = int(max(m.max(), n.max())) + 3
    q = np.full((len(qs), L), 4, np.uint8)
    t = np.full((len(qs), L), 5, np.uint8)
    for i in range(len(qs)):
        q[i, : m[i]] = qs[i]
        t[i, : n[i]] = ts[i]
    return q, t, m, n, max(2, int(0.3 * int((m + n).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [g for g, _ in TW.K3_WIDTHS])
def test_cuda_k3_edges_match_twin(cuda_device, lanes, monkeypatch):
    """K3's redesign at its edges, every group width, against the twin."""
    monkeypatch.setattr(TW, "k3_lanes", lambda B, sms: lanes)
    rng = np.random.default_rng(21)
    empty = np.zeros(0, np.uint8)
    # bands wider than a group, up to the overflow abort: unrelated pairs
    wide = [_make_pair(rng, int(rng.integers(150, 400)), 0.9) for _ in range(24)]
    wq, wt = [p[0] for p in wide], [p[1] for p in wide]
    want = _k3_vs_twin(wq, wt, cuda_device)
    assert not bool(want[2].all())  # some windows overflow the band
    _k3_vs_twin(wq, wt, cuda_device, bt=20)
    _k3_vs_twin(wq, wt, cuda_device, bt=20, kb=5)  # slots past kb dropped
    # histories longer than the on-chip ring (26 entries at bt 10; 306
    # at bt 150 for windows of ~1,000 steps' rows)
    long_ = [_make_pair(rng, int(rng.integers(500, 1000)), 0.2) for _ in range(16)]
    lq, lt = [p[0] for p in long_], [p[1] for p in long_]
    _k3_vs_twin(lq, lt, cuda_device, bt=10)
    want = _k3_vs_twin(lq, lt, cuda_device)
    assert int(want[3].max()) > 150
    # snakes into the pads and the L-1 clip; y0 < 0 bases (m << n); very
    # different lengths side by side; empty windows among them
    t0 = rng.integers(0, 4, 700).astype(np.uint8)
    qs = [t0.copy(), t0[:3], t0[:20], empty, t0[:650], empty, t0, t0[5:],
          t0[:1], empty]
    ts = [t0, t0, t0[:300], t0[:40], t0, empty, t0[:9], t0, t0[:2], empty]
    for L_q, L_t in zip(*[[p[i] for p in (_make_pair(rng, s, 0.1) for s in
                                          (900, 4, 600, 30, 1000, 7))]
                          for i in (0, 1)]):
        qs.append(L_q)
        ts.append(L_t)
    _k3_vs_twin(qs, ts, cuda_device)
    _k3_block_vs_twin(*_unpadded_block(qs, ts), 150, 152, cuda_device)
