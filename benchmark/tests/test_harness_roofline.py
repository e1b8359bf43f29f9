"""The roofline shares count the op's work from its inputs and outputs
alone: the draft aligner's count is the same whichever aligner runs."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.probes import Probes


def _ladder(seed=3, n=12, length=400):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=length, dtype=np.uint8)
    qs, ts = [], []
    for i in range(n):
        q = t.copy()
        if i % 3:  # two of three pairs carry edits; the rest are identical
            pos = rng.integers(0, length, size=8)
            q[pos] = (q[pos] + 1) % 4
            q = np.delete(q, pos[:2])
        qs.append(q)
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("band", (50, 150))
def test_draft_align_work_is_the_same_on_every_path(monkeypatch, band):
    from hinge_tpu_torch.stages import draft

    qs, ts = _ladder()
    got = {}
    for env in ("HINGE_FAST_ALIGN", "HINGE_PARITY_ALIGN"):
        monkeypatch.delenv("HINGE_FAST_ALIGN", raising=False)
        monkeypatch.delenv("HINGE_PARITY_ALIGN", raising=False)
        monkeypatch.setenv(env, "1")
        with Probes(traced=True) as p:
            rows = draft._align_ladder_pairs(qs, ts, band, device="cpu")
        assert len(rows) == len(qs)
        (nbytes, ops, secs), = p.ops["draft_align"]
        got[env] = (nbytes, ops)
        assert secs > 0
    assert got["HINGE_FAST_ALIGN"] == got["HINGE_PARITY_ALIGN"]
    want = roofline.draft_align_work(
        [len(q) for q in qs], [len(t) for t in ts],
        [len(q) == len(t) and np.array_equal(q, t) for q, t in zip(qs, ts)],
        band)
    assert got["HINGE_FAST_ALIGN"] == want
    # identical pairs cost their bytes and no fill
    assert roofline.draft_align_work([10], [10], [True], band) == (40, 0)


def test_join_thin_work_counts_the_ops_inputs_and_outputs():
    from hinge_tpu_torch.overlap import device_join

    g = torch.Generator().manual_seed(1)
    n_rows, per = 5, 40
    a_row = torch.arange(n_rows).repeat_interleave(per)
    a_q = torch.sort(torch.randint(0, 5000, (n_rows, per), generator=g)).values.reshape(-1)
    a_t = a_q + torch.randint(0, 20, (n_rows * per,), generator=g)
    with Probes(traced=True) as p:
        out = device_join.thin_rows(a_row, a_q, a_t, n_rows, 15, 100, 100, 2, 100)
    (nbytes, ops, secs), = p.ops["join_thin"]
    n_f = int(out[0].shape[0])
    assert 0 < n_f <= n_rows * per
    assert (nbytes, ops) == roofline.join_thin_work(n_rows * per, n_f, n_rows)


def test_share_reads_nothing_without_calls_and_at_most_the_bound():
    assert roofline.share_pct([]) is None
    b = roofline.bound_s(3.35e12, 0)
    assert b == pytest.approx(1.0)
    assert roofline.share_pct([(3.35e12, 0, 2.0)]) == pytest.approx(50.0)


def test_the_count_knows_no_implementation_size():
    import inspect

    src = inspect.getsource(roofline)
    assert "BN_BW" not in src and "hinge_tpu_torch" not in src
