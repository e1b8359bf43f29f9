"""hinge_tpu_torch.ops.classify against hinge_tpu.ops.classify.

`matching_position` runs on the same seeded queries through the jitted
JAX op and the torch port (CPU); results must be equal, including
out-of-match positions (-1), the after-loop fallthrough (-2) and the
P <= 1 overlaps that are always "exhausted".  The carried-over host
helpers must return what hinge_tpu's return.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hinge_tpu.ops import classify as J
from hinge_tpu_torch.ops import classify as T


def _lattice(seed, n_ov=200):
    rng = np.random.default_rng(seed)
    npairs = rng.integers(0, 12, n_ov).astype(np.int32)
    npairs[:10] = 1  # single trace pair: the loop never runs
    a_start = rng.integers(0, 3000, n_ov).astype(np.int32)
    a_start[:5] = 100 * rng.integers(0, 30, 5)  # on a grid multiple
    a_end = (a_start + 100 * np.maximum(npairs, 1)
             - rng.integers(0, 99, n_ov)).astype(np.int32)
    b_start = rng.integers(0, 3000, n_ov).astype(np.int32)
    b_end = (b_start + (a_end - a_start) + rng.integers(-40, 40, n_ov)).astype(np.int32)
    rc = rng.integers(0, 2, n_ov).astype(np.int32)
    pair_off = np.zeros(n_ov, np.int64)
    np.cumsum(npairs[:-1], out=pair_off[1:])
    disp = rng.integers(80, 120, int(npairs.sum())).astype(np.int32)
    cum = np.zeros_like(disp)
    for o in range(n_ov):
        s = pair_off[o]
        cum[s : s + npairs[o]] = np.cumsum(disp[s : s + npairs[o]])
    return a_start, a_end, b_start, b_end, rc, npairs, pair_off, cum


def _queries(seed, a_start, a_end, n_q=3000):
    rng = np.random.default_rng(seed + 100)
    n_ov = len(a_start)
    ov = rng.integers(0, n_ov, n_q).astype(np.int32)
    span = a_end[ov] - a_start[ov]
    pos = (a_start[ov] + (rng.random(n_q) * (span + 400)).astype(np.int32)
           - 200).astype(np.int32)
    # exact edges and grid multiples
    pos[:200] = a_start[ov[:200]]
    pos[200:400] = a_end[ov[200:400]]
    pos[400:600] = (pos[400:600] // 100) * 100
    ov[600:620] = np.arange(20) % 5  # pos == a_start on a grid multiple, P=1
    pos[600:620] = a_start[ov[600:620]]
    return ov, pos


def test_matching_position_matches_jax():
    for seed in (0, 1):
        lat = _lattice(seed)
        ov, pos = _queries(seed, lat[0], lat[1])
        want = np.asarray(J.matching_position(
            jnp.asarray(ov), jnp.asarray(pos), *(jnp.asarray(a) for a in lat),
            tspace=J.TRIM_GRID))
        got = T.matching_position(
            torch.from_numpy(ov), torch.from_numpy(pos),
            *(torch.from_numpy(a) for a in lat), tspace=T.TRIM_GRID)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == -1).any() and (want == -2).any()


def test_matching_position_single_pair_exhausted():
    """P == 1 with pos == a_start on a tspace multiple: j_raw is -1, yet
    the scalar loop ran zero iterations, so the fallthrough applies."""
    a_start = np.array([300, 300, 250], np.int32)
    a_end = np.array([380, 390, 340], np.int32)
    b_start = np.array([10, 10, 10], np.int32)
    b_end = np.array([95, 100, 95], np.int32)
    rc = np.array([0, 1, 0], np.int32)
    npairs = np.array([1, 1, 1], np.int32)
    pair_off = np.array([0, 1, 2], np.int64)
    cum = np.array([85, 90, 85], np.int32)
    ov = np.array([0, 0, 1, 1, 2, 2], np.int32)
    pos = np.array([300, 350, 300, 390, 250, 300], np.int32)
    lat = (a_start, a_end, b_start, b_end, rc, npairs, pair_off, cum)
    want = np.asarray(J.matching_position(
        jnp.asarray(ov), jnp.asarray(pos), *(jnp.asarray(a) for a in lat),
        tspace=100))
    got = T.matching_position(torch.from_numpy(ov), torch.from_numpy(pos),
                              *(torch.from_numpy(a) for a in lat), tspace=100)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == -2


def test_host_helpers_carry_over(noisy_sim):
    ov = noisy_sim["overlaps"]
    tw_j, tw_t = J.build_trace_walk(ov), T.build_trace_walk(ov)
    for a, b in zip(tw_t, tw_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T.make_point_index(tw_t.npairs),
                    J.make_point_index(tw_j.npairs)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 5000, 500).astype(np.int32) for _ in range(8)]
    rc = rng.integers(0, 2, 500).astype(np.int32)
    np.testing.assert_array_equal(
        T.add_types_asymmetric_np(*cols, rc, 300, 1000),
        J.add_types_asymmetric_np(*cols, rc, 300, 1000))
    for name in ("FORWARD", "BACKWARD", "ACOVERB", "BCOVERA", "UNDEFINED",
                 "INTERNAL", "NOT_ACTIVE", "FORWARD_INTERNAL",
                 "BACKWARD_INTERNAL", "TRIM_GRID"):
        assert getattr(T, name) == getattr(J, name)
