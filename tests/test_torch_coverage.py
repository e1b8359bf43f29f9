"""hinge_tpu_torch.ops.coverage against hinge_tpu.ops.coverage.

The same numpy inputs (seeded) go through the jnp op and its torch port
on the CPU; every output must be exactly equal (tolerance 0, same dtype
width).  Covers the torch pitfalls the port guards: floor division of
negative values, the padding row of the scatter, int32 cumsum, first-index
argmax and cummax in place of associative_scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hinge_tpu.ops import coverage as J
from hinge_tpu_torch.ops import coverage as T

N_READS, NB, RESO = 24, 40, 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype.itemsize == want.dtype.itemsize, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _events(seed, n_ov=400, pad_rows=True):
    rng = np.random.default_rng(seed)
    a_rel = np.sort(rng.integers(0, N_READS, n_ov)).astype(np.int32)
    if pad_rows:
        a_rel[-20:] = N_READS  # padding-row overlaps, sliced off
    a_s = rng.integers(-300, NB * RESO, n_ov).astype(np.int32)
    a_e = (a_s + rng.integers(0, 900, n_ov)).astype(np.int32)
    return a_rel, a_s, a_e


def test_event_bins_negative_floor_division():
    v = np.array([-401, -400, -399, -41, -40, -39, -1, 0, 1, 39, 40, 41,
                  1599, 1600, 5000], np.int32)
    _eq(T.event_bins(_t(v), RESO, NB), J.event_bins(jnp.asarray(v), RESO, NB))


@pytest.mark.parametrize("cutoff", [0, 300])
def test_profile_coverage_with_padding_row(cutoff):
    a_rel, a_s, a_e = _events(1)
    want = J.profile_coverage(jnp.asarray(a_rel), jnp.asarray(a_s),
                              jnp.asarray(a_e), jnp.int32(cutoff),
                              n_reads=N_READS, nb=NB, reso=RESO)
    got = T.profile_coverage(_t(a_rel), _t(a_s), _t(a_e), cutoff,
                             n_reads=N_READS, nb=NB, reso=RESO)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_pileup_stats_and_n_entries():
    a_rel, a_s, a_e = _events(2)
    a_rel[:30] = 3  # one read with many events, some reads with none
    a_rel = np.sort(a_rel)
    jme, jms, jc = J.pileup_stats(jnp.asarray(a_rel), jnp.asarray(a_s),
                                  jnp.asarray(a_e), n_reads=N_READS, nb=1,
                                  reso=RESO)
    tme, tms, tc = T.pileup_stats(_t(a_rel), _t(a_s), _t(a_e), n_reads=N_READS)
    for g, w in ((tme, jme), (tms, jms), (tc, jc)):
        _eq(g, w)
    # negative max events (empty or cut-down pileups) floor, not truncate
    for cut in (0, 300):
        jmax = jnp.maximum(jme - cut, jms + cut)
        tmax = torch.maximum(tme - cut, tms + cut)
        _eq(T.n_entries_from_max_event(tmax, tc, RESO),
            J.n_entries_from_max_event(jmax, jc, RESO))
    neg = np.array([-81, -80, -79, -1, 0, 79, 80], np.int32)
    cnt = np.ones_like(neg)
    _eq(T.n_entries_from_max_event(_t(neg), _t(cnt), RESO),
        J.n_entries_from_max_event(jnp.asarray(neg), jnp.asarray(cnt), RESO))


def _grid(seed, zero_frac=0.3):
    rng = np.random.default_rng(seed)
    g = rng.integers(-2, 6, (N_READS, NB)).astype(np.int32)
    g[rng.random((N_READS, NB)) < zero_frac] = 0
    g[0] = 0          # no run at all
    g[1, :] = 4       # one run from bin 0 to the end (never flushed)
    g[2, :5] = 3      # run starting at bin 0 (maxstart reports reso)
    g[2, 5] = 0
    g[3, 2:6] = 2     # two equally long runs: the first must win
    g[3, 6] = 0
    g[3, 9:13] = 2
    g[3, 13] = 0
    ne = rng.integers(0, NB + 1, N_READS).astype(np.int32)
    ne[1] = NB
    return g, ne


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coverage_mask(seed):
    g, ne = _grid(seed)
    cut = np.maximum(g - 1, 0)
    want = J.coverage_mask(jnp.asarray(cut), jnp.asarray(ne), reso=RESO)
    got = T.coverage_mask(_t(cut), _t(ne), reso=RESO)
    for gg, ww in zip(got, want):
        _eq(gg, ww)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), zero_frac=st.floats(0.0, 0.9))
def test_coverage_mask_property(seed, zero_frac):
    g, ne = _grid(seed, zero_frac)
    want = J.coverage_mask(jnp.asarray(g), jnp.asarray(ne), reso=RESO)
    got = T.coverage_mask(_t(g), _t(ne), reso=RESO)
    for gg, ww in zip(got, want):
        _eq(gg, ww)


def test_coverage_gradient_and_repeat_annotation():
    rng = np.random.default_rng(5)
    steps = rng.integers(-3, 4, (N_READS, NB))
    steps[rng.random((N_READS, NB)) < 0.1] *= 6  # steep repeat boundaries
    cov_np = np.maximum(np.cumsum(steps, axis=1) + 20, 0).astype(np.int32)
    cov = jnp.asarray(cov_np)
    _eq(T.coverage_gradient(_t(cov_np)), J.coverage_gradient(cov))
    ne = rng.integers(0, NB + 1, N_READS).astype(np.int32)
    ms = rng.integers(0, 400, N_READS).astype(np.int32)
    me = (ms + rng.integers(0, 1500, N_READS)).astype(np.int32)
    kw = dict(reso=RESO, coverage_fraction=3, min_thresh=2, max_thresh=5,
              no_hinge_region=100)
    for min_cov in (0, 4, 9):
        want = J.repeat_annotation_mask(cov, jnp.asarray(ne), jnp.asarray(ms),
                                        jnp.asarray(me), jnp.int32(min_cov),
                                        **kw)
        got = T.repeat_annotation_mask(_t(cov_np), _t(ne), _t(ms), _t(me),
                                       min_cov, **kw)
        assert got.dtype == torch.int8
        _eq(got, want)
        assert np.abs(np.asarray(want)).sum() > 0  # the case is exercised


def test_qv_mask_np_matches_device_qv_mask():
    rng = np.random.default_rng(9)
    good = rng.random((30, 25)) < 0.7
    nseg = rng.integers(0, 26, 30).astype(np.int32)
    want = J.qv_mask(jnp.asarray(good), jnp.asarray(nseg), tspace=100)
    got = T.qv_mask_np(good, nseg, tspace=100)
    for gg, ww in zip(got, want):
        _eq(gg, ww)


def test_int32_cumsum_does_not_widen():
    x = torch.ones((2, 5), dtype=torch.int32)
    assert torch.cumsum(x, dim=1).dtype == torch.int64  # the pitfall
    a_rel, a_s, a_e = _events(4)
    out = T.profile_coverage(_t(a_rel), _t(a_s), _t(a_e), 0,
                             n_reads=N_READS, nb=NB, reso=RESO)
    assert out.dtype == torch.int32
