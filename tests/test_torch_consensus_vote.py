"""hinge_tpu_torch.ops.consensus_vote against hinge_tpu's device vote, the
numpy tallies oracle and the native C vote, on the CPU, tolerance 0.

The rows are tests/test_consensus_vote.py's: empty rows, rows shorter than
the chop, fully gapped rows and leading gaps past the chop, plus one read
longer than a chunk so that it gets a chunk of its own."""

import numpy as np
import pytest

from hinge_tpu.ops.consensus_vote import vote_tallies_device as jax_vote
from hinge_tpu.stages.consensus import _native_vote_tallies, _vote_tallies
from hinge_tpu_torch.ops import consensus_vote as TV
from hinge_tpu_torch.stages import consensus as TC
from tests.test_consensus_vote import _flat, _random_rows

GAP = 4


def _case(seed, oversize=False):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    rows_a, rows_b = _random_rows(rng, n)
    rows_a.insert(0, np.zeros(0, np.uint8))  # an empty row
    rows_b.insert(0, np.zeros(0, np.uint8))
    if oversize:
        rows_a.append(rng.integers(0, 5, 9000).astype(np.uint8))
        rows_b.append(rng.integers(0, 5, 9000).astype(np.uint8))
    fa, fb, sl = _flat(rows_a, rows_b)
    pos0 = rng.integers(0, 50, sl.size).astype(np.int64)
    return fa, fb, sl, pos0, int(rng.integers(200, 3000))


def _assert_tables_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_vote_matches_hinge_tpu_and_numpy(seed):
    """Several chunks (4096 columns each) and the default single chunk."""
    fa, fb, sl, pos0, alen = _case(seed, oversize=seed % 2 == 1)
    ref = _vote_tallies(fa, fb, sl, pos0, alen)
    _assert_tables_equal(
        jax_vote(fa, fb, sl, pos0, alen, chunk_cols=4096, alen_bucket=1024),
        ref)
    _assert_tables_equal(
        TV.vote_tallies_device(fa, fb, sl, pos0, alen, chunk_cols=4096,
                               device="cpu"), ref)
    _assert_tables_equal(
        TV.vote_tallies_device(fa, fb, sl, pos0, alen, device="cpu"), ref)


def test_vote_matches_native():
    fa, fb, sl, pos0, alen = _case(11, oversize=True)
    native = _native_vote_tallies(fa, fb, sl, pos0, alen)
    if native is None:
        pytest.skip("native toolchain unavailable")
    _assert_tables_equal(
        TV.vote_tallies_device(fa, fb, sl, pos0, alen, chunk_cols=4096,
                               device="cpu"), native)


def test_vote_chunk_edge_rows():
    """A rows fully gapped or empty: no match votes, only insertions (the
    300-column row is chopped away whole, the 5-column one is kept)."""
    rows = [np.full(300, GAP, np.uint8), np.zeros(0, np.uint8),
            np.full(5, GAP, np.uint8)]
    fa, fb, sl = _flat(rows, [np.zeros(len(r), np.uint8) for r in rows])
    pos0 = np.zeros(3, np.int64)
    got = TV.vote_tallies_device(fa, fb, sl, pos0, 400, device="cpu")
    _assert_tables_equal(got, _vote_tallies(fa, fb, sl, pos0, 400))
    assert not got[0].any() and not got[1].any() and got[2][0] == 5


def test_stage_dispatch_routes_device_vote(monkeypatch):
    """HINGE_DEVICE_VOTE=1 takes the torch vote on the given device; its
    tables equal the default route's."""
    fa, fb, sl, pos0, alen = _case(3)
    monkeypatch.delenv("HINGE_DEVICE_VOTE", raising=False)
    ref = TC._tallies_dispatch(fa, fb, sl, pos0, alen, "cpu")
    calls = []
    real = TV.vote_tallies_device

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    monkeypatch.setattr(TV, "vote_tallies_device", spy)
    monkeypatch.setenv("HINGE_DEVICE_VOTE", "1")
    _assert_tables_equal(
        TC._tallies_dispatch(fa, fb, sl, pos0, alen, "cpu"), ref)
    assert calls == ["cpu"]
