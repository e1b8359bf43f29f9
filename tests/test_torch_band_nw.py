"""Band-NW port (hinge_tpu_torch.ops.band_nw) against hinge_tpu.

On the CPU the wrappers run their plain torch twins, which must be
bit-equal to the Pallas kernels run in interpret mode (`_band_fill`,
`_row_traceback_pallas`) and to the XLA scan traceback (`_row_traceback`).
Shapes stay small (B=32, m, n <= 200 for the interpreted kernels) because
interpret mode compiles slowly; every case shares one compile.  The
`cuda` case holds the CUDA kernels against the twins on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hinge_tpu.ops import pallas_band_nw as J
from hinge_tpu_torch.ops import band_nw as T
from tests.test_pallas_band_nw import _make_pair, _np_oracle

B, MROWS = 32, 256  # the interpreted kernels' shapes for m, n <= 200


def _windows(seed, count=B, lo=120, hi=200):
    """Seeded windows plus the edge cases: m=1, |m-n| = 126, identical
    strings, a long indel run (rows whose lanes up to k_e are all left)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(count - 5):
        q, t = _make_pair(rng, int(rng.integers(lo, hi)),
                          float(rng.uniform(0.01, 0.15)))
        qs.append(q)
        ts.append(t)
    t = rng.integers(0, 4, 180).astype(np.uint8)
    qs += [t[:1], t[:60], t.copy(), np.concatenate([t[:40], t[140:]]),
           t[:150]]
    ts += [t[:3], t[:186], t, t, np.concatenate([t[:70], t[100:180]])]
    return qs, ts


def _tpu_layout(qs, ts, mrows=MROWS):
    """The Pallas kernel's padded inputs: q 250 past m; 128 leading 251s,
    then t, then 252s."""
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    lq, lt = mrows + 128, 768
    q = np.full((len(qs), lq), 250, np.uint8)
    tp = np.full((len(qs), lt), 252, np.uint8)
    tp[:, :128] = 251
    for w in range(len(qs)):
        q[w, : m[w]] = qs[w]
        tp[w, 128 : 128 + n[w]] = ts[w]
    return q, tp, m, n


def _port_layout(qs, ts):
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    q = np.zeros((len(qs), m.max()), np.uint8)
    t = np.zeros((len(qs), n.max()), np.uint8)
    for w in range(len(qs)):
        q[w, : m[w]] = qs[w]
        t[w, : n[w]] = ts[w]
    return [torch.from_numpy(a) for a in (q, t, m, n)]


@pytest.fixture(scope="module")
def jax_moves():
    qs, ts = _windows(0)
    q, tp, m, n = _tpu_layout(qs, ts)
    moves = J._band_fill(jnp.asarray(q), jnp.asarray(tp), jnp.asarray(m),
                         jnp.asarray(n), bw=256, rc=32, mrows=MROWS,
                         interpret=True)
    return qs, ts, np.asarray(moves), m, n


def test_band_fill_ref_matches_pallas_fill(jax_moves):
    qs, ts, want, _, _ = jax_moves
    got = T.band_fill(*_port_layout(qs, ts), mrows=MROWS)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_traceback_ref_matches_pallas_and_scan(jax_moves):
    _, _, moves, m, n = jax_moves
    jm, jn, jmv = jnp.asarray(m), jnp.asarray(n), jnp.asarray(moves)
    got = T.row_traceback(torch.from_numpy(moves.copy()),
                          torch.from_numpy(m), torch.from_numpy(n))
    for want in (J._row_traceback_pallas(jmv, jm, jn, bw=256, mrows=MROWS,
                                         interpret=True),
                 J._row_traceback(jmv, jm, jn, bw=256, mrows=MROWS)):
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row_traceback_ref_on_random_moves():
    """Arbitrary move codes reach the corners real fills rarely do: rows
    with no non-left lane up to k_e (top = -1, cnt = k_e + 1, which wraps
    to 0 as uint8 at k_e = 255)."""
    rng = np.random.default_rng(7)
    b, mrows = 48, 700
    moves = rng.integers(0, 4, (b, mrows, 256)).astype(np.int8)
    moves[:, ::3, :] = 2
    moves[:8, :, :] = 2
    m = rng.integers(1, mrows + 1, b).astype(np.int32)
    n = (m + rng.integers(-126, 127, b)).clip(0).astype(np.int32)
    want = J._row_traceback(jnp.asarray(moves), jnp.asarray(m),
                            jnp.asarray(n), bw=256, mrows=mrows)
    got = T.row_traceback(torch.from_numpy(moves), torch.from_numpy(m),
                          torch.from_numpy(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0])[:8] == 0).any()


def test_row_traceback_ref_on_any_int8_codes():
    """The traceback is defined for every int8 code, not only the 0..3
    that band_fill writes: a lane's key is k*4 + code, so a low lane with
    a large code can win the max, and cnt can be negative."""
    rng = np.random.default_rng(11)
    b, mrows = 24, 300
    moves = rng.integers(-128, 128, (b, mrows, 256)).astype(np.int8)
    moves[:4] %= 4
    m = rng.integers(1, mrows + 1, b).astype(np.int32)
    n = (m + rng.integers(-126, 127, b)).clip(0).astype(np.int32)
    want = J._row_traceback(jnp.asarray(moves), jnp.asarray(m),
                            jnp.asarray(n), bw=256, mrows=mrows)
    got = T.row_traceback(torch.from_numpy(moves), torch.from_numpy(m),
                          torch.from_numpy(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_band_align_batch_rows(jax_moves):
    """Port rows equal hinge_tpu's interpreted band_align_batch and the
    numpy full-DP oracle; band overflow goes to the Myers path."""
    qs, ts = _windows(1)
    qs[3] = qs[3][:20]  # |m - n| >= 127: the Myers fallback
    ts[3] = np.concatenate([ts[3], ts[3]])
    want = J.band_align_batch(qs, ts)
    got = T.band_align_batch(qs, ts, device="cpu", max_batch=13)
    for w, ((gq, gt), (wq, wt)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gq, wq, err_msg=f"window {w}")
        np.testing.assert_array_equal(gt, wt, err_msg=f"window {w}")
    for w in (0, 5, len(qs) - 3, len(qs) - 1):
        oq, ot = _np_oracle(qs[w], ts[w])
        np.testing.assert_array_equal(got[w][0], oq)
        np.testing.assert_array_equal(got[w][1], ot)


def test_wrappers_validate_arguments():
    q, t, m, n = _port_layout(*_windows(2, count=8))
    with pytest.raises(ValueError):
        T.band_fill(q[:, :10], t, m, n, mrows=MROWS)  # m exceeds q
    with pytest.raises(TypeError):
        T.band_fill(q.to(torch.int32), t, m, n, mrows=MROWS)
    with pytest.raises(ValueError):
        T.row_traceback(torch.zeros((8, 4, 128), dtype=torch.int8), m, n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_twins(cuda_device):
    qs, ts = _windows(3, count=300, lo=600, hi=1100)
    q, t, m, n = (x.to(cuda_device) for x in _port_layout(qs, ts))
    mrows = int(m.max())
    before = dict(T.launches)
    moves = T.band_fill(q, t, m, n, mrows=mrows)
    ref = T.band_fill_ref(q, t, m, n, mrows)
    torch.cuda.synchronize()
    assert torch.equal(moves, ref)
    got = T.row_traceback(moves, m, n)
    want = T.row_traceback_ref(moves, m, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert T.launches["band_fill"] == before["band_fill"] + 1
    assert T.launches["row_traceback"] == before["row_traceback"] + 1


@pytest.mark.cuda
def test_cuda_traceback_on_any_int8_codes(cuda_device):
    """Rows with codes outside 0..3 take the kernel's per-cell max."""
    rng = np.random.default_rng(12)
    moves = rng.integers(-128, 128, (64, 700, 256)).astype(np.int8)
    moves[:16] %= 4
    m = rng.integers(1, 701, 64).astype(np.int32)
    n = (m + rng.integers(-126, 127, 64)).clip(0).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (moves, m, n)]
    got, want = T.row_traceback(*args), T.row_traceback_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_fill_past_16_bit_costs(cuda_device):
    """Windows whose costs would pass the fill's 16-bit INF without its
    periodic rebase."""
    rng = np.random.default_rng(13)
    qs, ts = [], []
    for w in range(2):
        q, t = _make_pair(rng, 30_000 + 7 * w, 0.05)
        qs.append(q)
        ts.append(t)
    q, t, m, n = (x.to(cuda_device) for x in _port_layout(qs, ts))
    mrows = int(m.max())
    moves = T.band_fill(q, t, m, n, mrows=mrows)
    assert torch.equal(moves, T.band_fill_ref(q, t, m, n, mrows))
