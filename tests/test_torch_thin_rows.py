"""The device join's p3 (hinge_tpu_torch.overlap.device_join.thin_rows)
against hinge_tpu's jitted p3 and the C emit loop, tolerance 0.

On the CPU the dispatcher runs the plain twin `thin_rows_ref`, whose
outputs must equal hinge_tpu's `_join_fns(...).p3` on padded int32 inputs
and a numpy transcription of native/io_native.cpp's emit loop (greedy
sub_gap emission, then the last-anchor rule) followed by the monotone-t
filter, on seeded row sets: random rows, single-anchor rows, a row of
5,200 anchors, equal q at a row's tail, non-monotone t, every anchor
within sub_gap, and sub_gap 1; and on row sets placed at K4's 32-anchor
chunk edges.  A numpy lane model of K4's walk (a warp a row, 32-anchor
chunks, the greedy step by ballots) must equal the twin on all of them.
The `cuda` cases hold K4 (csrc/thin_rows.cu) to the twin on the same
CUDA tensors; jax and
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
#: row sets at the edges of K4's 32-anchor chunks (sub_gap 32)
BOUNDARY_KINDS = ("chunk_lens", "eq_straddle", "tail_early_eq",
                  "tail_early_ne", "t_fall_boundary", "gap_over_span")
BOUNDARY_CASES = [(kind, 32) for kind in BOUNDARY_KINDS]
#: the row lengths of "chunk_lens": either side of one and two chunks, and
#: the longest row of the device join's largest block at 4.6 Mb
CHUNK_LENS = (31, 32, 33, 63, 64, 65, 2359)
#: int64 values the join never makes (q and t past 2^24, negative t), a
#: sub_gap past 2^31 and a negative one: against the C emit loop only
#: (hinge_tpu's p3 is int32; the twin packs q and t into 25 bits)
WIDE_CASES = [("wide_values", 32), ("random", 3 << 30), ("random", -5)]


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
    elif kind == "chunk_lens":
        for n in CHUNK_LENS:
            for spacing in (4, 20, 60):
                noisy_row(n, spacing * n)
    elif kind == "eq_straddle":
        # a run of 10 equal q across lane 31 | 32 and across 63 | 64,
        # starting at each lane from 24 to 32
        for off in range(24, 33):
            q = np.arange(75, dtype=np.int64) * (sub_gap // 3 + 1)
            q[off : off + 10] = q[off]
            q[off + 32 : off + 40] = q[off + 32]
            add(q, np.sort(rng.integers(0, 9_000, len(q))))
    elif kind in ("tail_early_eq", "tail_early_ne"):
        # the last emission is lane 5 of the first chunk (q = 100); every
        # later anchor, the tail in a later chunk included, has q within
        # sub_gap of it: equal to it, or (ne) the tail one more
        for n in (33, 40, 64, 65, 100):
            q = np.full(n, 100, np.int64)
            q[:5] = np.arange(5)
            if kind == "tail_early_ne":
                q[-1] = 101
            for t_tail in (0, 10_000):
                t = np.arange(n, dtype=np.int64) * 10
                t[-1] = t_tail
                add(q, t)
    elif kind == "t_fall_boundary":
        # every anchor emitted (q steps by sub_gap); t climbs, falls at
        # lane `drop` (either side of a chunk edge), and climbs again
        for drop in (30, 31, 32, 33, 34, 63, 64):
            n = drop + 20
            q = np.arange(n, dtype=np.int64) * sub_gap
            t = np.arange(n, dtype=np.int64) * 100
            t[drop:] -= 100 * (drop // 2)
            add(q, t)
    elif kind == "wide_values":
        # q and t from 2^40 on; rows whose q crosses 2^30; negative t; t
        # past 2^30 from lane 40 on
        for _ in range(6):
            n = int(rng.integers(1, 150))
            q = np.sort(rng.integers(0, 40 * n, n)) + (1 << 40)
            add(q, q + rng.integers(-300, 300, n))
        for _ in range(6):
            n = int(rng.integers(40, 200))
            q = np.sort(rng.integers(-30 * n, 30 * n, n)) + (1 << 30)
            add(q, q + rng.integers(-500, 500, n))
        for _ in range(6):
            n = int(rng.integers(1, 100))
            q = np.sort(rng.integers(0, 40 * n, n))
            add(q, q - (1 << 20) + rng.integers(-300, 300, n))
        for _ in range(4):
            n = int(rng.integers(41, 120))
            q = np.sort(rng.integers(0, 40 * n, n))
            t = q + rng.integers(-300, 300, n)
            t[40:] += 1 << 30
            add(q, t)
    elif kind == "gap_over_span":
        # rows longer than a chunk whose q span is below sub_gap
        for _ in range(20):
            n = int(rng.integers(33, 130))
            q = np.sort(rng.integers(0, sub_gap - 1, n)) + int(rng.integers(0, 9_000))
            add(q, q + rng.integers(0, 3 * sub_gap, n))
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


LANES = np.arange(32)


def _chunk(qc, tc, left, sub_gap, c):
    """csrc/thin_rows.cu::resolve: the greedy step once per emitted
    anchor (a ballot is a boolean mask over the lanes, its first set lane
    (__ffs) an argmax, a shuffle an index), the t filter on each
    emission, then the last-anchor rule on the row's last chunk.  Returns
    the kept lanes; `c` is the carried state (any emission yet, the last
    emitted q, the largest emitted t, the last kept anchor)."""
    thr = c["last_q"] + sub_gap if c["any"] else -(1 << 63)
    live, keep = LANES < left, np.zeros(32, bool)
    while True:
        ballot = (qc >= thr) & live
        if not ballot.any():
            break
        f = int(np.argmax(ballot))
        qf, tf = int(qc[f]), int(tc[f])
        c.update(any=True, last_q=qf)
        thr = qf + sub_gap
        live &= LANES > f
        if tf >= c["max_t"]:
            keep[f] = True
            c.update(max_t=tf, q1=qf, t1=tf)
    if left <= 32:
        ql, tl = int(qc[left - 1]), int(tc[left - 1])
        if ql != c["last_q"] and tl >= c["max_t"]:
            keep[left - 1] = True
            c.update(q1=ql, t1=tl)
    return keep


def lane_model(row, q, t, n_rows, sub_gap, k=K, min_span=MIN_SPAN,
               min_cnt=MIN_CNT, tspace=TSPACE):
    """K4 (csrc/thin_rows.cu) lane by lane in numpy: the bounds (the first
    anchor of each row by a search), the walk (a warp a row, chunks of 32
    anchors; the walk's state carried across chunks), kept anchors at their
    row's input offset (slot = m + __popc of the kept lanes below),
    fr_end = cumsum(m), and the copy into f.  The 11 outputs of
    thin_rows_ref."""
    n_a = len(row)
    r_start = np.searchsorted(row, np.arange(n_rows + 1))
    k_q, k_t = np.zeros(n_a, np.int64), np.zeros(n_a, np.int64)
    m, Q0, Q1, T0, T1 = (np.zeros(n_rows, np.int64) for _ in range(5))
    for r in range(n_rows):
        s, e = int(r_start[r]), int(r_start[r + 1])
        c = dict(any=False, last_q=0, max_t=-(1 << 63), q1=0, t1=0)
        mr = 0
        for base in range(s, e, 32):
            left = e - base
            idx = np.minimum(base + LANES, n_a - 1)
            qc = np.where(LANES < left, q[idx], 0)
            tc = np.where(LANES < left, t[idx], 0)
            if base == s:
                Q0[r], T0[r] = qc[0], tc[0]
            keep = _chunk(qc, tc, left, sub_gap, c)
            slot = mr + np.cumsum(keep) - keep
            k_q[s + slot[keep]], k_t[s + slot[keep]] = qc[keep], tc[keep]
            mr += int(keep.sum())
        m[r] = mr
        if mr:
            Q1[r], T1[r] = c["q1"] + k, c["t1"] + k
    fr_end = np.cumsum(m)
    fr_start = fr_end - m
    take = np.concatenate([np.arange(s, s + n) for s, n in zip(r_start, m)]
                          + [np.zeros(0, np.int64)])
    f_row = np.repeat(np.arange(n_rows), m)
    okr = (m >= min_cnt) & (Q1 - Q0 >= min_span) & (T1 - T0 >= min_span)
    n_int = np.maximum((T1 - 1) // tspace - T0 // tspace, 0)
    nb = np.where(okr, n_int + 2, 0)
    return (k_q[take], k_t[take], f_row, fr_start, fr_end, Q0, Q1, T0, T1,
            okr, nb)


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


@pytest.mark.parametrize("kind,sub_gap", CASES + BOUNDARY_CASES)
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


@pytest.mark.parametrize("kind,sub_gap", CASES + BOUNDARY_CASES)
def test_twin_matches_c_emit_loop(kind, sub_gap):
    row, q, t, n_rows = row_set(kind, seed=11, sub_gap=sub_gap)
    want = c_emit_thin(row, q, t, n_rows, sub_gap)
    _assert_outputs_equal(_twin(row, q, t, n_rows, sub_gap), want, kind)
    if kind == "single":
        assert len(want[0]) == n_rows  # each head once, never again
    if kind == "nonmono_t":
        assert len(want[0]) < len(c_emit_thin(row, q, np.sort(t), n_rows,
                                              sub_gap)[0])


@pytest.mark.parametrize("kind,sub_gap", CASES + BOUNDARY_CASES)
def test_lane_model_matches_twin(kind, sub_gap):
    """K4's walk, modelled lane by lane, equals the twin; and each chunk-
    edge row set reaches the edge it was built for."""
    row, q, t, n_rows = row_set(kind, seed=13, sub_gap=sub_gap)
    want = _twin(row, q, t, n_rows, sub_gap)
    got = lane_model(row, q, t, n_rows, sub_gap)
    _assert_outputs_equal(want, got, kind)
    m = got[4] - got[3]
    if kind == "chunk_lens":
        assert set(CHUNK_LENS) <= set(np.bincount(row).tolist())
    elif kind == "tail_early_eq":
        assert (m == 2).all()  # the head and q = 100, never the tail
    elif kind == "tail_early_ne":
        # the tail (q 101, lane >= 32 of the row) is kept when its t passes
        assert m.tolist() == [2, 3] * 5
        assert (got[0][got[4] - 1] == np.tile([100, 101], 5)).all()
    elif kind == "t_fall_boundary":
        n = np.bincount(row)
        assert (m < n).all() and (m > 32).all()
    elif kind == "gap_over_span":
        assert (m <= 2).all()


@pytest.mark.parametrize("kind,sub_gap", WIDE_CASES)
def test_lane_model_matches_c_emit_loop_on_wide_values(kind, sub_gap):
    """K4's walk, modelled lane by lane, on values and gaps the join never
    makes, equals the C emit loop."""
    row, q, t, n_rows = row_set(kind, seed=17, sub_gap=sub_gap)
    want = c_emit_thin(row, q, t, n_rows, sub_gap)
    _assert_outputs_equal(lane_model(row, q, t, n_rows, sub_gap), want, kind)
    if kind == "wide_values":
        assert (q >= 1 << 30).any() and (q < 1 << 30).any() and (t < 0).any()


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


def test_k4_entry_points_match_their_signatures():
    """Each extern "C" entry point of csrc/thin_rows.cu takes as many
    arguments as ops/_build.SIGNATURES binds (ctypes would pass the wrong
    words otherwise, which only a card could show)."""
    import re

    from hinge_tpu_torch.ops import _build

    src = open(f"{_build.CSRC_DIR}/thin_rows.cu").read()
    found = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    want = {k: len(v) for k, v in _build.SIGNATURES.items()
            if k.startswith("hinge_thin_rows")}
    assert found == want


def test_previous_k4_source_is_kept():
    """chip_smoke.py times the previous K4 (one thread a row) from the
    repo's copy of its source, byte-equal to commit PREV_K4's."""
    import hashlib
    import pathlib

    import chip_smoke

    root = pathlib.Path(__file__).resolve().parents[1]
    data = (root / chip_smoke.PREV_K4_SOURCE).read_bytes()
    assert hashlib.sha256(data).hexdigest() == chip_smoke.PREV_K4_SHA256
    assert b"one thread walks one row once" in data


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _k4_vs_twin(row, q, t, n_rows, sub_gap, dev):
    """K4 through thin_rows (one launch counted) equal to the twin on all
    11 outputs."""
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
@pytest.mark.parametrize("kind,sub_gap", CASES + BOUNDARY_CASES)
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
@pytest.mark.parametrize("kind,sub_gap", WIDE_CASES)
def test_cuda_k4_matches_c_emit_loop_on_wide_values(cuda_device, kind,
                                                     sub_gap):
    for seed in range(3):
        row, q, t, n_rows = row_set(kind, seed, sub_gap)
        want = c_emit_thin(row, q, t, n_rows, sub_gap)
        args = [torch.from_numpy(a).to(cuda_device) for a in (row, q, t)]
        got = DJ.thin_rows(*args, n_rows, K, sub_gap, MIN_SPAN, MIN_CNT,
                           TSPACE)
        _assert_outputs_equal(got, want, (kind, seed))


@pytest.mark.cuda
def test_cuda_k4_single_anchor_rows(cuda_device):
    """30,000 rows of one anchor each: a warp's walk of a row is one lane."""
    rng = np.random.default_rng(9)
    q = rng.integers(0, 1 << 23, 30_000)
    row, q, t = _sorted(range(30_000), [q[i : i + 1] for i in range(30_000)],
                        [rng.integers(0, 1 << 23, 1) for _ in range(30_000)])
    _k4_vs_twin(row, q, t, 30_000, 32, cuda_device)


@pytest.mark.cuda
def test_cuda_k4_refuses_a_row_without_anchors(cuda_device):
    row, q, t, n_rows = row_set("random", seed=1)
    row = np.where(row >= 10, row + 1, row)  # row 10 left empty
    args = [torch.from_numpy(a).to(cuda_device) for a in (row, q, t)]
    with pytest.raises(ValueError, match="kept no anchor"):
        DJ.thin_rows(*args, n_rows + 1, K, 32, MIN_SPAN, MIN_CNT, TSPACE)
