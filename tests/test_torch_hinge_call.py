"""hinge_tpu_torch.ops.hinge_call against hinge_tpu.ops.hinge_call.

Seeded numpy pileups and hinge tasks go through the jitted JAX kernel and
the torch port on the CPU, with the per-task scan order (`ordidx`) and
without it (the two-key stable argsort branch); bridged flags and support
counts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hinge_tpu.config import nominal_config
from hinge_tpu.ops import hinge_call as J
from hinge_tpu_torch.ops import hinge_call as T

F = nominal_config().filter
KW = dict(theta=F.theta, htl=F.hinge_tolerance_length, hbl=F.hinge_bin,
          hrut=F.hinge_unbridged, hbpt=F.hinge_min_pileup)


def _problem(seed, n_reads=12, n_tasks=60):
    """read_rows with clustered match ends (so supporters exist and
    pileups trip both the fail and the success scans) and tasks near
    them, some overhangs exactly at theta."""
    rng = np.random.default_rng(seed)
    read_rows = {}
    for r in range(n_reads):
        n = int(rng.integers(0, 40))
        centre = rng.integers(1000, 9000)
        a0 = (centre + rng.integers(-400, 400, n)).astype(np.int32)
        a1 = (a0 + rng.integers(500, 4000, n)).astype(np.int32)
        lo = rng.integers(0, 900, n).astype(np.int32)
        ro = rng.integers(0, 900, n).astype(np.int32)
        lo[rng.random(n) < 0.1] = F.theta
        ro[rng.random(n) < 0.1] = F.theta
        read_rows[r] = (a0, a1, lo, ro)
    tasks, pos, grad = [], [], []
    for _ in range(n_tasks):
        r = int(rng.integers(0, n_reads))
        a0, a1, _, _ = read_rows[r]
        g = int(rng.choice([-1, 1]))
        if len(a0):
            ref = a1 if g == -1 else a0
            p = int(ref[rng.integers(0, len(ref))]) + int(rng.integers(-60, 60))
        else:
            p = int(rng.integers(0, 9000))
        tasks.append((r, len(tasks)))
        pos.append(p)
        grad.append(g)
    pos = np.array(pos, np.int32)
    grad = np.array(grad, np.int32)
    m0 = (pos - rng.integers(0, 600, n_tasks)).astype(np.int32)
    m1 = (pos + rng.integers(0, 600, n_tasks)).astype(np.int32)
    return tasks, pos, grad, m0, m1, read_rows


def test_call_hinges_with_ordidx():
    outcomes = []
    for seed in range(4):
        tasks, pos, grad, m0, m1, rows = _problem(seed)
        jb, js = J.call_hinges_device(tasks, pos, grad, m0, m1, rows, **KW)
        tb, ts = T.call_hinges_device(tasks, pos, grad, m0, m1, rows, **KW,
                                      device="cpu")
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tb, jb)
        assert js.dtype == ts.dtype == np.int32
        outcomes.append(jb[js > 0])
    outcomes = np.concatenate(outcomes)
    assert outcomes.any() and not outcomes.all()  # both scan outcomes hit


def test_hinge_kernel_without_ordidx():
    bridged = []
    for seed in range(4, 8):
        tasks, pos, grad, m0, m1, rows = _problem(seed)
        m0 = (pos - 150).astype(np.int32)  # supporters near the mask end
        m1 = (pos + 150).astype(np.int32)
        P = 64
        cols = np.zeros((4, len(rows), P), np.int32)
        valid = np.zeros((len(rows), P), bool)
        for r, vals in rows.items():
            n = len(vals[0])
            for c in range(4):
                cols[c, r, :n] = vals[c]
            valid[r, :n] = True
        rid = np.array([r for r, _ in tasks], np.int32)
        args = (pos, grad, m0, m1, rid, *cols, valid)
        jb, js = J._hinge_kernel(*(jnp.asarray(a) for a in args), **KW)
        tb, ts = T._hinge_kernel(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in args), **KW)
        assert ts.dtype == torch.int32 and tb.dtype == torch.bool
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        bridged.append(np.asarray(jb)[np.asarray(js) > 0])
    bridged = np.concatenate(bridged)
    assert bridged.any() and not bridged.all()  # both scan outcomes hit


def test_task_scan_orders_and_introsort_perm_carry_over():
    tasks, pos, grad, m0, m1, rows = _problem(6)
    want = J.task_scan_orders(tasks, pos, grad, rows, 64, theta=F.theta,
                              htl=F.hinge_tolerance_length)
    got = T.task_scan_orders(tasks, pos, grad, rows, 64, theta=F.theta,
                             htl=F.hinge_tolerance_length)
    np.testing.assert_array_equal(got, want)
    keys = np.random.default_rng(0).integers(0, 5, 200)  # many exact ties
    for desc in (False, True):
        np.testing.assert_array_equal(T.introsort_perm(keys, desc),
                                      J.introsort_perm(keys, desc))
