"""The device join's p3 (hinge_tpu_torch.overlap.device_join.thin_rows)
against hinge_tpu's jitted p3 and the C emit loop, tolerance 0.

On the CPU the dispatcher runs the plain twin `thin_rows_ref`, whose
outputs must equal hinge_tpu's `_join_fns(...).p3` on padded int32 inputs
and a numpy transcription of native/io_native.cpp's emit loop (greedy
sub_gap emission, then the last-anchor rule) followed by the monotone-t
filter, on seeded row sets: random rows, single-anchor rows, a row of
5,200 anchors, equal q at a row's tail, non-monotone t, every anchor
within sub_gap, and sub_gap 1.  The `cuda` cases hold K4
(csrc/thin_rows.cu) to the twin on the same CUDA tensors; jax and
hinge_tpu are imported only by the CPU cases, so on a card without them
run `python -m pytest tests/test_torch_thin_rows.py -q -m cuda --noconftest`.
"""

import numpy as np
import pytest
import torch

from hinge_tpu_torch.overlap import device_join as DJ

K, MIN_SPAN, MIN_CNT, TSPACE = 15, 300, 2, 100
ACAP, ROWCAP = 8192, 1024
OUT = ("f_q", "f_t", "f_row", "fr_start", "fr_end", "Q0", "Q1", "T0", "T1",
       "okr", "nb")
KINDS = ("random", "single", "long", "tail_eq", "nonmono_t", "within_gap")
CASES = [(kind, 32) for kind in KINDS] + [("random", 1), ("tail_eq", 1)]


def _sorted(rows, qs, ts):
    row = np.concatenate([np.full(len(q), r) for r, q in zip(rows, qs)])
    q, t = np.concatenate(qs), np.concatenate(ts)
    o = np.lexsort((t, q, row))
    return row[o].astype(np.int64), q[o].astype(np.int64), t[o].astype(np.int64)


def row_set(kind, seed=0, sub_gap=32):
    """Anchors (row, q, t) int64 sorted by (row, q, t), rows 0..n-1 each
    with at least one anchor; and n."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []

    def add(q, t):
        qs.append(np.asarray(q, np.int64))
        ts.append(np.asarray(t, np.int64))

    def noisy_row(n, span):
        q = np.sort(rng.integers(0, span, n)) + int(rng.integers(0, 50_000))
        add(q, np.maximum(q + int(rng.integers(-2_000, 2_000))
                          + rng.integers(-40, 41, n), 0))

    if kind == "random":
        for _ in range(50):
            noisy_row(int(rng.integers(1, 140)), int(rng.integers(1, 8_000)))
    elif kind == "single":
        for _ in range(80):
            noisy_row(1, 1)
    elif kind == "long":
        noisy_row(5_200, 400_000)
        for _ in range(12):
            noisy_row(int(rng.integers(1, 60)), int(rng.integers(1, 3_000)))
    elif kind == "tail_eq":
        g = sub_gap
        for q in ([0, g + 8, g + 8], [0, 10, 10], [0, g + 8, g + 8, g + 8],
                  [0, g, g + 1, 2 * g, 2 * g], [5, 5], [7, 7, 7],
                  [0, g - 1, g - 1], [0, 3 * g, 3 * g + 1]):
            add(q, 400 + rng.permutation(len(q)) * 7)
        for _ in range(20):
            q = np.sort(rng.integers(0, 4 * g, int(rng.integers(2, 12))))
            q[-2:] = q[-1]
            add(q, rng.integers(0, 600, len(q)))
    elif kind == "nonmono_t":
        for _ in range(40):
            n = int(rng.integers(2, 120))
            add(np.sort(rng.integers(0, 5_000, n)), rng.integers(0, 5_000, n))
    elif kind == "within_gap":
        for _ in range(40):
            n = int(rng.integers(1, 40))
            q = np.sort(rng.integers(0, sub_gap, n)) + int(rng.integers(0, 9_000))
            add(q, q + rng.integers(0, 2 * sub_gap, n))
    else:
        raise ValueError(kind)
    row, q, t = _sorted(range(len(qs)), qs, ts)
    return row, q, t, len(qs)


def c_emit_thin(row, q, t, n_rows, sub_gap, k=K, min_span=MIN_SPAN,
                min_cnt=MIN_CNT, tspace=TSPACE):
    """native/io_native.cpp:673-697 (emit loop, then each row's last seen
    anchor if its q differs from the last emitted one) over the anchors in
    (row, q, t) order, then the monotone-t filter and the row spans, in
    plain numpy; the 11 outputs of thin_rows_ref."""
    i32_min = np.iinfo(np.int32).min
    last_emit_q = np.full(n_rows, i32_min, np.int64)
    last_seen_q = np.full(n_rows, i32_min, np.int64)
    last_seen_t = np.zeros(n_rows, np.int64)
    out = []
    for r, hq, ht in zip(row, q, t):
        last_seen_q[r], last_seen_t[r] = hq, ht
        if last_emit_q[r] != i32_min and hq - last_emit_q[r] < sub_gap:
            continue
        out.append((r, hq, ht))
        last_emit_q[r] = hq
    for r in range(n_rows):
        if last_seen_q[r] != i32_min and last_seen_q[r] != last_emit_q[r]:
            out.append((r, last_seen_q[r], last_seen_t[r]))
    out.sort(key=lambda x: x[0])  # stable: the last anchor ends its row
    kept, max_t = [], {}
    for r, hq, ht in out:
        if r not in max_t or ht >= max_t[r]:
            kept.append((r, hq, ht))
        max_t[r] = max(max_t.get(r, ht), ht)
    f = np.array(kept, np.int64).reshape(-1, 3)
    m = np.bincount(f[:, 0], minlength=n_rows)
    fr_end = np.cumsum(m)
    fr_start = fr_end - m
    Q0, T0 = f[fr_start, 1], f[fr_start, 2]
    Q1, T1 = f[fr_end - 1, 1] + k, f[fr_end - 1, 2] + k
    okr = (m >= min_cnt) & (Q1 - Q0 >= min_span) & (T1 - T0 >= min_span)
    n_int = np.maximum((T1 - 1) // tspace - T0 // tspace, 0)
    nb = np.where(okr, n_int + 2, 0)
    return f[:, 1], f[:, 2], f[:, 0], fr_start, fr_end, Q0, Q1, T0, T1, okr, nb


def _twin(row, q, t, n_rows, sub_gap, device="cpu"):
    args = [torch.from_numpy(a).to(device) for a in (row, q, t)]
    return DJ.thin_rows_ref(*args, n_rows, K, sub_gap, MIN_SPAN, MIN_CNT,
                            TSPACE)


def _jax_p3(row, q, t, n_rows, sub_gap):
    """hinge_tpu's jitted p3 on the anchors padded to ACAP (a_row with
    ROWCAP, a_q / a_t with 0): (f_q, f_t) over [:n_f] and the row arrays
    over [:n_rows]."""
    import jax.numpy as jnp

    from hinge_tpu.overlap import device_join as JDJ

    n = len(row)
    assert n <= ACAP and n_rows <= ROWCAP
    pad = lambda a, v: np.concatenate(  # noqa: E731
        [a, np.full(ACAP - n, v)]).astype(np.int32)
    with JDJ._enable_x64():
        p3 = JDJ._join_fns(K, 500, 4, sub_gap, MIN_SPAN, MIN_CNT, TSPACE,
                           1024, ACAP, 1024, ROWCAP, ACAP, 1 << 16, 1 << 16,
                           8)[2]
        out = [np.asarray(x) for x in p3(
            jnp.asarray(pad(row, ROWCAP)), jnp.asarray(pad(q, 0)),
            jnp.asarray(pad(t, 0)), np.int32(n_rows))]
    f_q, f_t, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb, flags = out
    assert not flags.any(), flags
    n_f = int(fr_end[n_rows - 1])
    return {"f_q": f_q[:n_f], "f_t": f_t[:n_f],
            **{name: a[:n_rows] for name, a in zip(
                OUT[3:], (fr_start, fr_end, Q0, Q1, T0, T1, okr, nb))}}


def _assert_outputs_equal(got, want, what):
    for name, g, w in zip(OUT, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        assert np.array_equal(g, w), (what, name)


@pytest.mark.parametrize("kind,sub_gap", CASES)
def test_twin_matches_hinge_tpu_p3(kind, sub_gap):
    row, q, t, n_rows = row_set(kind, seed=7, sub_gap=sub_gap)
    got = _twin(row, q, t, n_rows, sub_gap)
    want = _jax_p3(row, q, t, n_rows, sub_gap)
    for name, g in zip(OUT, got):
        if name in want:
            assert np.array_equal(g.numpy(), want[name]), (kind, name)
    assert got[0].dtype == torch.int64 and got[9].dtype == torch.bool
    assert all(x.dtype == torch.int64 for i, x in enumerate(got) if i != 9)
    if kind == "long":
        assert int((got[4] - got[3]).max()) > 1 << 8  # a long kept row


@pytest.mark.parametrize("kind,sub_gap", CASES)
def test_twin_matches_c_emit_loop(kind, sub_gap):
    row, q, t, n_rows = row_set(kind, seed=11, sub_gap=sub_gap)
    want = c_emit_thin(row, q, t, n_rows, sub_gap)
    _assert_outputs_equal(_twin(row, q, t, n_rows, sub_gap), want, kind)
    if kind == "single":
        assert len(want[0]) == n_rows  # each head once, never again
    if kind == "nonmono_t":
        assert len(want[0]) < len(c_emit_thin(row, q, np.sort(t), n_rows,
                                              sub_gap)[0])


def test_tail_rule_cases():
    """The last anchor is added when its q differs from the last emitted
    q, before the t filter, and never twice."""
    g = 32
    row, q, t = _sorted([0, 1, 2, 3], [np.array([0, g + 8, g + 8]),
                                       np.array([0, 10, 10]),
                                       np.array([5, 5]),
                                       np.array([0, 10])],
                        [np.array([100, 300, 310]), np.array([100, 50, 60]),
                         np.array([1, 2]), np.array([100, 90])])
    f_q, f_t, f_row, fr_start, fr_end, *_ = _twin(row, q, t, 4, g)
    # row 0: head, then q = 40 (t = 300); the tail's q = 40 is not re-added
    # row 1: head, then the tail (q 10 != 0) at t = 60 < 100: filtered
    # row 2: one q: the head only; row 3: the tail at t = 90: filtered
    assert f_q.tolist() == [0, g + 8, 0, 5, 0]
    assert f_t.tolist() == [100, 300, 100, 1, 100]
    assert f_row.tolist() == [0, 0, 1, 2, 3]
    assert fr_start.tolist() == [0, 2, 3, 4] and fr_end.tolist() == [2, 3, 4, 5]


def test_dispatcher_takes_the_twin_on_cpu(monkeypatch):
    """CPU tensors go to thin_rows_ref and build nothing; K4's launch
    refuses a CPU tensor; malformed inputs raise."""
    def no_build():
        raise AssertionError("thin_rows built a kernel for CPU tensors")

    monkeypatch.setattr(DJ, "load_kernels", no_build)
    row, q, t, n_rows = row_set("random", seed=3)
    args = [torch.from_numpy(a) for a in (row, q, t)]
    before = dict(DJ.launches)
    got = DJ.thin_rows(*args, n_rows, K, 32, MIN_SPAN, MIN_CNT, TSPACE)
    want = DJ.thin_rows_ref(*args, n_rows, K, 32, MIN_SPAN, MIN_CNT, TSPACE)
    for name, g, w in zip(OUT, got, want):
        assert torch.equal(g, w), name
    assert DJ.launches == before  # counts are CUDA launches only
    with pytest.raises(ValueError, match="no kernel"):
        DJ.launch_thin_rows(*args, n_rows, K, 32, MIN_SPAN, MIN_CNT, TSPACE)
    with pytest.raises(ValueError, match="int64"):
        DJ.thin_rows(args[0].to(torch.int32), *args[1:], n_rows, K, 32,
                     MIN_SPAN, MIN_CNT, TSPACE)
    with pytest.raises(ValueError, match="length"):
        DJ.thin_rows(args[0], args[1][:-1], args[2], n_rows, K, 32,
                     MIN_SPAN, MIN_CNT, TSPACE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _k4_vs_twin(row, q, t, n_rows, sub_gap, dev):
    args = [torch.from_numpy(a).to(dev) for a in (row, q, t)]
    before = DJ.launches["thin_rows"]
    got = DJ.thin_rows(*args, n_rows, K, sub_gap, MIN_SPAN, MIN_CNT, TSPACE)
    want = DJ.thin_rows_ref(*args, n_rows, K, sub_gap, MIN_SPAN, MIN_CNT,
                            TSPACE)
    torch.cuda.synchronize()
    assert DJ.launches["thin_rows"] == before + 1
    for name, g, w in zip(OUT, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sub_gap", CASES)
def test_cuda_k4_matches_twin(cuda_device, kind, sub_gap):
    for seed in range(3):
        _k4_vs_twin(*row_set(kind, seed, sub_gap), sub_gap, cuda_device)


@pytest.mark.cuda
def test_cuda_k4_large_block(cuda_device):
    """Many rows of skewed lengths (a few past 2^12 anchors), more rows
    than one grid pass of the walk would need to be wide."""
    rng = np.random.default_rng(5)
    sizes = np.minimum(rng.geometric(1 / 40, 30_000), 9_000)
    sizes[rng.integers(0, len(sizes), 5)] = 6_000
    qs = [np.sort(rng.integers(0, 200 * n, n)) for n in sizes]
    ts = [np.maximum(x + rng.integers(-50, 51, len(x)), 0) for x in qs]
    row, q, t = _sorted(range(len(sizes)), qs, ts)
    _k4_vs_twin(row, q, t, len(sizes), 32, cuda_device)


@pytest.mark.cuda
def test_cuda_k4_refuses_a_row_without_anchors(cuda_device):
    row, q, t, n_rows = row_set("random", seed=1)
    row = np.where(row >= 10, row + 1, row)  # row 10 left empty
    args = [torch.from_numpy(a).to(cuda_device) for a in (row, q, t)]
    with pytest.raises(ValueError, match="kept no anchor"):
        DJ.thin_rows(*args, n_rows + 1, K, 32, MIN_SPAN, MIN_CNT, TSPACE)
