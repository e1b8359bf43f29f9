"""K2e, the band-NW rows made from K2's records
(hinge_tpu_torch.ops.band_nw.emit_rows), against hinge_tpu's host numpy
`_emit_rowrec`, tolerance 0.

On the CPU the wrapper runs the plain twin `emit_rows_ref`, whose rows
must equal `_emit_rowrec`'s on seeded consistent records and on the edge
cases: leading left columns (j_rem > 0), one-row windows, length
differences of HB - 2 either way, every row an up move, and a block of
one window.  A numpy model of K2e's three launches (the count, the scan
over windows, a block a window in chunks of threads x ITEMS rows through
a shared-memory stage at the destination's alignment) must equal the twin
across chunk edges and on the path past the stage.  The `cuda` cases hold
K2e (csrc/emit_rows.cu) to the twin on the same CUDA tensors and
`band_align_batch` on CUDA to its CPU path; jax and hinge_tpu are
imported only by the CPU cases, so on a card without them run
`python -m pytest tests/test_torch_emit_rows.py -q -m cuda --noconftest`.
"""

import numpy as np
import pytest
import torch

from hinge_tpu_torch.ops import band_nw as BN

#: (kind, windows, longest window): the edge cases K2e must hold
CASES = [("random", 40, 300), ("j_rem", 24, 200), ("m1", 16, 1),
         ("diff_up", 12, 260), ("diff_down", 12, 260), ("all_up", 16, 150),
         ("one_window", 1, 500)]


def records(kind, B, mrows, seed=0):
    """Seeded K2 records that fit their lengths: (qs, ts, cnts, mv0s,
    j_rem, m, n) with qs / ts the windows' bases as numpy arrays."""
    rng = np.random.default_rng(seed)
    m = (np.full(B, mrows) if kind in ("m1", "one_window", "diff_up",
                                       "diff_down")
         else rng.integers(1, mrows + 1, B)).astype(np.int32)
    cnts = np.where(rng.random((B, mrows)) < 0.25,
                    rng.integers(1, 4, (B, mrows)), 0).astype(np.uint8)
    mv0s = rng.choice(np.array([0, 0, 0, 1, 3], np.int8), (B, mrows))
    j_rem = np.where(rng.random(B) < 0.5, rng.integers(1, 6, B),
                     0).astype(np.int32)
    if kind == "j_rem":
        j_rem = rng.integers(1, 40, B).astype(np.int32)
    if kind == "all_up":
        mv0s[:] = 1
    if kind in ("diff_up", "diff_down"):  # |m - n| = HB - 2
        cnts[:] = 0
        mv0s[:] = np.where(rng.random((B, mrows)) < 0.5, 0, 3)
        j_rem[:] = 0
        for w in range(B):
            rows = rng.choice(m[w], BN.HB - 2, replace=False)
            if kind == "diff_up":   # n = m + 126 by left runs
                cnts[w, rows] = 1
            else:                   # n = m - 126 by up moves
                mv0s[w, rows] = 1
    for w in range(B):
        cnts[w, m[w]:] = 0
        mv0s[w, m[w]:] = 0
    cols = j_rem + m + cnts.astype(np.int64).sum(1)
    n = (cols - (mv0s == 1).sum(1)).astype(np.int32)
    qs = [rng.integers(0, 4, k).astype(np.uint8) for k in m]
    ts = [rng.integers(0, 4, k).astype(np.uint8) for k in n]
    return qs, ts, cnts, mv0s, j_rem, m, n


def _tensors(qs, ts, cnts, mv0s, j_rem, m, n, dev="cpu"):
    flat = [np.concatenate(x) if len(x) else np.zeros(0, np.uint8)
            for x in (qs, ts)]
    return [torch.from_numpy(np.array(a)).to(dev)
            for a in (cnts, mv0s, j_rem, m, n, *flat)]


def _windows(bases, q_rows, t_rows):
    return [(q_rows[a:b], t_rows[a:b]) for a, b in zip(bases[:-1], bases[1:])]


@pytest.mark.parametrize("kind,B,mrows", CASES)
def test_twin_matches_host_emit(kind, B, mrows):
    from hinge_tpu.ops.pallas_band_nw import _emit_rowrec

    qs, ts, cnts, mv0s, j_rem, m, n = recs = records(kind, B, mrows)
    if kind.startswith("diff"):
        assert (np.abs(m - n) == BN.HB - 2).all()
    got = _windows(*BN.fetch_rows(*BN.emit_rows(*_tensors(*recs))))
    want = _emit_rowrec(qs, ts, cnts, mv0s, j_rem)
    assert len(got) == len(want) == B
    for w, ((gq, gt), (wq, wt)) in enumerate(zip(got, want)):
        assert gq.dtype == wq.dtype == np.uint8
        np.testing.assert_array_equal(gq, wq, err_msg=f"q of window {w}")
        np.testing.assert_array_equal(gt, wt, err_msg=f"t of window {w}")


def test_twin_on_records_of_a_band_fill():
    """K1 and K2's twins on noisy windows, then the twin: rows equal to
    `_emit_rowrec`'s on the same records, and each row pair spells its
    window once the gaps are dropped."""
    from hinge_tpu.ops.pallas_band_nw import _emit_rowrec

    qs, ts = noisy_windows(np.random.default_rng(5), 24, 80, 240)
    buf, m, n = BN.pack_block(qs, ts)
    args = [torch.from_numpy(a) for a in (m, n)]
    q = torch.from_numpy(np.concatenate(qs))
    t = torch.from_numpy(np.concatenate(ts))
    mrows = int(m.max())
    moves = BN.band_fill(BN._padded(q, args[0], mrows),
                         BN._padded(t, args[1], int(n.max())), *args,
                         mrows=mrows)
    recs = BN.row_traceback(moves, *args)
    got = _windows(*BN.fetch_rows(*BN.emit_rows(*recs, *args, q, t)))
    want = _emit_rowrec(qs, ts, *(x.numpy() for x in recs))
    for w, ((gq, gt), (wq, wt)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gq, wq, err_msg=f"q of window {w}")
        np.testing.assert_array_equal(gt, wt, err_msg=f"t of window {w}")
        np.testing.assert_array_equal(gq[gq != BN.GAP], qs[w])
        np.testing.assert_array_equal(gt[gt != BN.GAP], ts[w])


def test_records_that_do_not_fit_raise():
    """A window whose records do not fit its lengths (an up move too
    many, a negative j_rem, m past mrows) gets no columns and makes
    fetch_rows raise; the others keep their rows."""
    recs = records("random", 8, 100, seed=3)
    good = _windows(*BN.fetch_rows(*BN.emit_rows(*_tensors(*recs))))
    for bad, w_bad in (("up", 2), ("j_rem", 2), ("m", 7)):
        args = _tensors(*recs)
        _break(args, bad, w_bad)
        meta, rows = BN.emit_rows(*args)
        assert int(meta[-1]) == 1
        assert int(meta[w_bad + 1] - meta[w_bad]) == 0
        with pytest.raises(ValueError, match="do not fit"):
            BN.fetch_rows(meta, rows)
        b = meta[:-1].numpy()
        total = int(b[-1])
        for w in set(range(8)) - {w_bad}:
            np.testing.assert_array_equal(rows[b[w]:b[w + 1]].numpy(),
                                          good[w][0])
            np.testing.assert_array_equal(
                rows[total + b[w]:total + b[w + 1]].numpy(), good[w][1])


def _break(args, how, w):
    """Records of window w that no longer fit its lengths, the other
    windows' offsets into q and t unchanged."""
    if how == "up":
        mv0s = args[1]
        mv0s[w, 0] = 0 if int(mv0s[w, 0]) == 1 else 1
    elif how == "j_rem":
        args[2][w] = -1
    else:
        args[3][w] = args[0].shape[1] + 1  # past mrows


def test_wrapper_validates_arguments():
    args = _tensors(*records("random", 4, 50))
    with pytest.raises(TypeError):
        BN.emit_rows(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError, match="want"):
        BN.emit_rows(args[0], args[1][:3], *args[2:])
    with pytest.raises(ValueError, match="no kernel"):
        BN._launch_on(torch.device("cpu"))


@pytest.mark.parametrize("mrows,threads,stage", [
    (1, 32, 160), (128, 32, 400), (129, 64, 416), (1000, 256, 2144),
    (1100, 256, 2352), (8000, 256, 16144), (9000, 256, BN.EMIT_MAX_STAGE)])
def test_launch_plan(mrows, threads, stage):
    assert BN.emit_plan(mrows) == (threads, stage)
    assert threads % 32 == 0 and stage % 16 == 0


def test_entry_point_matches_its_signature():
    """csrc/emit_rows.cu's extern "C" entry point takes as many arguments
    as ops/_build.SIGNATURES binds (ctypes would pass the wrong words
    otherwise, which only a card could show)."""
    import re

    from hinge_tpu_torch.ops import _build

    src = open(f"{_build.CSRC_DIR}/emit_rows.cu").read()
    found = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert found == {"hinge_emit_rows":
                     len(_build.SIGNATURES["hinge_emit_rows"])}


# ---------------------------------------------------------------------------
# a numpy model of K2e's launches
# ---------------------------------------------------------------------------

UNSET = 0xEE  # a byte no launch writes: what torch.empty may hold


def k2e_model(cnts, mv0s, j_rem, m, n, q, t, threads, stage, addr=0):
    """csrc/emit_rows.cu step by step in numpy: the count kernel, the scan
    over windows, then a block a window, a chunk of threads x ITEMS rows at
    a time (each thread's rows consecutive), the chunk's columns through a
    stage shifted to the destination's address mod 16 (the rows buffer at
    `addr`) when they fit it, else straight to the rows.  The rows buffer
    starts as UNSET, as the card's does not start as gaps.  Returns meta,
    the used rows and how many chunks took each path ("staged",
    "direct")."""
    B, mrows = cnts.shape
    cols = np.full(B, -1, np.int64)
    for w in range(B):  # emit_count_kernel
        mb, nb, jr = int(m[w]), int(n[w]), int(j_rem[w])
        if mb < 0 or mb > mrows or nb < 0 or jr < 0:
            continue
        c = jr + mb + int(cnts[w, :mb].astype(np.int64).sum())
        if c - int((mv0s[w, :mb] == 1).sum()) == nb:
            cols[w] = c
    qoff = np.zeros(B, np.int64)
    toff = np.zeros(B, np.int64)
    meta = np.zeros(B + 2, np.int64)
    cq = ct = cc = 0
    for w in range(B):  # emit_scan_kernel, one window at a time
        mq, nt = max(int(m[w]), 0), max(int(n[w]), 0)
        qoff[w], toff[w] = cq, ct
        if cols[w] < 0 or cq + mq > len(q) or ct + nt > len(t):
            cols[w] = -1
            meta[B + 1] += 1
        meta[w] = cc
        cc += max(int(cols[w]), 0)
        cq, ct = cq + mq, ct + nt
    meta[B] = total = cc
    paths = {"staged": 0, "direct": 0}
    rows = np.full(2 * (len(q) + len(t)), UNSET, np.uint8)
    per_chunk = threads * BN.EMIT_ITEMS
    for w in range(B):  # emit_rows_kernel
        if cols[w] < 0:
            continue
        gq, gt = int(meta[w]), total + int(meta[w])
        qb, tb = q[qoff[w]:], t[toff[w]:]
        mb, jr = int(m[w]), int(j_rem[w])
        rows[gq:gq + jr] = BN.GAP
        rows[gt:gt + jr] = tb[:jr]
        col0, ups0 = jr, 0
        for r0 in range(0, mb, per_chunk):
            items = []  # per thread: its live rows' (cnt, up, q)
            for tid in range(threads):
                rb = r0 + tid * BN.EMIT_ITEMS
                items.append([(int(cnts[w, r]), int(mv0s[w, r]) == 1, qb[r])
                              for r in range(rb, min(rb + BN.EMIT_ITEMS, mb))])
            seg = [sum(c + 1 for c, _, _ in it) for it in items]
            nup = [sum(u for _, u, _ in it) for it in items]
            span = sum(seg)
            sq, st = (addr + gq + col0) % 16, (addr + gt + col0) % 16
            staged = span + 16 <= stage
            paths["staged" if staged else "direct"] += 1
            smem = np.full(2 * stage, UNSET, np.uint8)

            def put(col, qc, tc):
                if staged:
                    assert 0 <= sq + col - col0 < stage
                    smem[sq + col - col0] = qc
                    smem[stage + st + col - col0] = tc
                else:
                    rows[gq + col] = qc
                    rows[gt + col] = tc

            for tid, it in enumerate(items):
                c = col0 + sum(seg[:tid])
                u = ups0 + sum(nup[:tid])
                for cnt, up, qv in it:
                    tx = c - u
                    put(c, qv, BN.GAP if up else tb[tx])
                    for k in range(1, cnt + 1):
                        put(c + k, BN.GAP, tb[tx + k - up])
                    c += cnt + 1
                    u += up
            if staged:
                rows[gq + col0:gq + col0 + span] = smem[sq:sq + span]
                rows[gt + col0:gt + col0 + span] = smem[stage + st:
                                                        stage + st + span]
            col0 += span
            ups0 += sum(nup)
    return meta, rows[:2 * total], paths


@pytest.mark.parametrize("kind,B,mrows,threads,stage,addr,direct", [
    ("random", 12, 300, 32, 1024, 0, False),  # 128-row chunks: 3 a window
    ("random", 12, 300, 64, 160, 5, True),    # chunks past the stage
    ("j_rem", 8, 200, 32, 400, 11, False),
    ("all_up", 6, 150, 32, 336, 3, False),
    ("m1", 5, 1, 32, 160, 0, False),
    ("diff_up", 4, 260, 64, 656, 9, False),
    ("one_window", 1, 500, 128, 1152, 15, False)])
def test_model_matches_twin(kind, B, mrows, threads, stage, addr, direct):
    """The model of K2e's launches writes every column the twin writes,
    the same bytes, at chunk edges and past the stage too."""
    qs, ts, cnts, mv0s, j_rem, m, n = recs = records(kind, B, mrows, seed=7)
    q, t = np.concatenate(qs), np.concatenate(ts)
    meta, rows, paths = k2e_model(cnts, mv0s, j_rem, m, n, q, t, threads,
                                  stage, addr)
    assert paths["staged"] > 0
    assert (paths["direct"] > 0) == direct
    want_meta, want_rows = BN.emit_rows_ref(*_tensors(*recs))
    np.testing.assert_array_equal(meta, want_meta.numpy())
    np.testing.assert_array_equal(rows, want_rows.numpy())
    assert not (rows == UNSET).any()


def test_model_counts_records_that_do_not_fit():
    qs, ts, cnts, mv0s, j_rem, m, n = recs = records("random", 6, 80, seed=2)
    n = n.copy()
    n[4] -= 1
    args = _tensors(qs, ts, cnts, mv0s, j_rem, m, n)
    meta, rows, _ = k2e_model(cnts, mv0s, j_rem, m, n,
                              *(np.asarray(a) for a in args[5:]), 32, 400)
    want_meta, want_rows = BN.emit_rows_ref(*args)
    np.testing.assert_array_equal(meta, want_meta.numpy())
    np.testing.assert_array_equal(rows, want_rows.numpy())
    assert meta[-1] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def noisy_windows(rng, count, lo, hi, err=0.13):
    """`count` windows of lo..hi target bases; each query a noisy copy
    (substitutions, insertions, deletions at CLR's rates, err in all),
    cut to at most HB - 2 bases longer than its target."""
    qs, ts = [], []
    for _ in range(count):
        t = rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
        r = rng.random(len(t))
        keep = r >= err * 0.3                         # deletions
        sub = (r >= err * 0.3) & (r < err * 0.4)      # substitutions
        q = np.where(sub, (t + rng.integers(1, 4, len(t))) % 4, t)
        ins = rng.random(len(t)) < err * 0.6          # an insertion after
        pieces = np.stack([q, rng.integers(0, 4, len(t))], 1).astype(np.uint8)
        mask = np.stack([keep, ins], 1)
        q = pieces[mask]
        q = q[:len(t) + BN.HB - 2]
        qs.append(q if len(q) else t[:1].copy())
        ts.append(t)
    return qs, ts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K2e has no CPU mode)")
    return torch.device("cuda")


def _k2e_vs_twin(args):
    before = BN.launches["emit_rows"]
    meta, rows = BN.emit_rows(*args)
    want_meta, want_rows = BN.emit_rows_ref(*args)
    torch.cuda.synchronize()
    assert BN.launches["emit_rows"] == before + 1
    assert torch.equal(meta, want_meta)
    total = int(meta[-2])
    assert torch.equal(rows[:2 * total], want_rows)


@pytest.mark.cuda
def test_cuda_k2e_on_clr_windows(cuda_device):
    """8,192 windows of 800-1,000 bases through K1 and K2 on the card,
    then K2e bit-equal to the twin on the same records."""
    qs, ts = noisy_windows(np.random.default_rng(11), 8192, 800, 1000)
    buf, m, n = BN.pack_block(qs, ts)
    dbuf = torch.from_numpy(buf).to(cuda_device)
    B, sq = len(qs), int(m.sum())
    dm, dn = dbuf[:4 * B].view(torch.int32), dbuf[4 * B:8 * B].view(torch.int32)
    q, t = dbuf[8 * B:8 * B + sq], dbuf[8 * B + sq:]
    mrows = int(m.max())
    moves = BN.band_fill(BN._padded(q, dm, mrows),
                         BN._padded(t, dn, int(n.max())), dm, dn, mrows=mrows)
    recs = BN.row_traceback(moves, dm, dn)
    del moves
    _k2e_vs_twin([*recs, dm, dn, q, t])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,mrows", CASES)
def test_cuda_k2e_edge_cases(cuda_device, kind, B, mrows):
    _k2e_vs_twin(_tensors(*records(kind, B, mrows), dev=cuda_device))


@pytest.mark.cuda
def test_cuda_k2e_past_the_stage(cuda_device):
    """Windows of 9,000 rows: chunks of 1,024 rows, and one window whose
    left runs put a chunk past the stage (straight to device memory)."""
    qs, ts, cnts, mv0s, j_rem, m, n = records("random", 4, 9000, seed=13)
    cnts[0, :1000] = 200
    cols = j_rem + m + cnts.astype(np.int64).sum(1)
    n = (cols - (mv0s == 1).sum(1)).astype(np.int32)
    ts = [np.random.default_rng(w).integers(0, 4, k).astype(np.uint8)
          for w, k in enumerate(n)]
    _k2e_vs_twin(_tensors(qs, ts, cnts, mv0s, j_rem, m, n, dev=cuda_device))


@pytest.mark.cuda
def test_cuda_k2e_records_that_do_not_fit(cuda_device):
    args = _tensors(*records("random", 8, 100, seed=3), dev=cuda_device)
    _break(args, "up", 2)
    meta, rows = BN.emit_rows(*args)
    assert int(meta[-1]) == 1
    with pytest.raises(ValueError, match="do not fit"):
        BN.fetch_rows(meta, rows)
    _k2e_vs_twin(args)


@pytest.mark.cuda
def test_cuda_band_align_batch_equals_cpu(cuda_device):
    """band_align_batch on CUDA (blocks of 40: K1, K2 and K2e a block)
    returns the CPU path's rows; the card made every window's rows."""
    from hinge_tpu_torch.utils.log import record

    qs, ts = noisy_windows(np.random.default_rng(17), 100, 150, 400)
    qs[3], ts[3] = qs[3][:10], ts[3]  # past the band: the Myers path
    before = dict(BN.launches)
    with record("cuda") as call:
        got = BN.band_align_batch(qs, ts, device=cuda_device, max_batch=40)
    want = BN.band_align_batch(qs, ts, device="cpu", max_batch=40)
    for w, ((gq, gt), (wq, wt)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gq, wq, err_msg=f"q of window {w}")
        np.testing.assert_array_equal(gt, wt, err_msg=f"t of window {w}")
    pairs = call.counters["band_nw.pairs"]
    assert pairs == 99
    assert call.counters["band_nw.rows_on_card"] == pairs
    for k in ("band_fill", "row_traceback", "emit_rows"):
        assert BN.launches[k] == before[k] + 3
