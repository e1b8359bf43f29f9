"""The port's DW_banded wave (hinge_tpu_torch.ops.wavefront) against
hinge_tpu's device wave and the scalar oracle, tolerance 0.

On the CPU `wave_align` runs its plain torch twin, whose rows must equal
hinge_tpu's `align_exact_batch_device` and the port's `myers.align_exact`
on every case of tests/test_wavefront.py and on an m+n sweep across the
dmax cap, and whose raw state (history, terminal state, path points) must
equal hinge_tpu's `_wave_forward` / `_wave_backtrack` on the same padded
block.  The `cuda` cases hold K3 (csrc/wave_align.cu) against the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hinge_tpu.ops import wavefront as JW
from hinge_tpu_torch.ops import myers as MY
from hinge_tpu_torch.ops import wavefront as TW
from tests.test_wavefront import _make_pair


def _check(qs, ts):
    got = TW.align_exact_batch_device(qs, ts, device="cpu")
    want = JW.align_exact_batch_device(qs, ts)
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _k3_vs_twin(qs, ts, dev):
    q, t, m, n, max_d, kb = TW.pack_block(qs, ts)
    args = [torch.from_numpy(a).to(dev) for a in (q, t, m, n)]
    got = TW.wave_align(*args, 150, max_d=max_d, kb=kb)
    want = TW.wave_align(*(a.cpu() for a in args), 150, max_d=max_d, kb=kb)
    torch.cuda.synchronize()
    for name, g, w in zip(("aligned", "d_fin", "k_fin", "x_fin"), got[2:], want[2:]):
        assert torch.equal(g.cpu(), w), name
    npts = 2 * (want[3] + 1)
    for name, g, w in zip(("px", "py"), got[:2], want[:2]):
        g = g.cpu()
        for i in range(len(qs)):
            assert torch.equal(g[i, : npts[i]], w[i, : npts[i]]), (name, i)


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
