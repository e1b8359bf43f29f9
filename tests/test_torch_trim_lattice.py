"""The trim lattice of hinge_tpu_torch.ops.classify against hinge_tpu's
jitted ops and the native C trim, on the CPU, tolerance 0.

Inputs: __graft_entry__._synth_traced_batch (a consistent trace lattice)
and the conftest noisy_sim overlaps; random read masks cut into the
overlaps so that both trim predicates bite on both strands.  The port's
functions get the port's own OverlapStore, carried over by
hinge_tpu_torch.data.carry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from hinge_tpu.data.overlaps import OverlapStore
from hinge_tpu.ops import classify as J
from hinge_tpu.ops.pairs import _native_trim
from hinge_tpu_torch.data import carry
from hinge_tpu_torch.ops import classify as T
from hinge_tpu_torch.ops import pairs as TP


def _synth_store(seed):
    """_synth_traced_batch as an OverlapStore: trace pairs (0, disp)."""
    b = G._synth_traced_batch(n_reads=32, n_ov=400, seed=seed)
    tw = b["tw"]
    trace = np.zeros(2 * tw.disp.size, np.uint16)
    trace[1::2] = tw.disp
    rl = b["read_len"]
    return OverlapStore.from_arrays(
        tspace=100, a_id=b["a_id"], b_id=b["b_id"], a_len=rl[b["a_id"]],
        b_len=rl[b["b_id"]], a_start=b["a_start"], a_end=b["a_end"],
        b_start=b["b_start"], b_end=b["b_end"], rc=b["rc"],
        tlen=2 * tw.npairs, trace=trace), rl


def _masks(ov, read_len, seed):
    rng = np.random.default_rng(seed)
    es = (rng.random(len(read_len)) * read_len * 0.3).astype(np.int32)
    ee = (read_len - rng.random(len(read_len)) * read_len * 0.3).astype(np.int32)
    return es[ov.a_id], ee[ov.a_id], es[ov.b_id], ee[ov.b_id]


def _port(ov):
    return carry.overlap_store_from_arrays(vars(ov))


def _walk(ov):
    tw = T.build_trace_walk(_port(ov))
    seg_id, k_local, _ = T.make_point_index(tw.npairs)
    return (tw.npairs, tw.pair_off, tw.cum, seg_id, k_local)


def _cols(ov):
    return (ov.a_start, ov.a_end, ov.b_start, ov.b_end, ov.rc)


def _torch_trim(ov, masks):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = T.trim_overlaps(*map(t, _cols(ov) + masks + _walk(ov)),
                          tspace=T.TRIM_GRID)
    return [x.numpy() for x in out]


def _jax_trim(ov, masks):
    out = J.trim_overlaps(*map(jnp.asarray, _cols(ov) + masks + _walk(ov)),
                          tspace=J.TRIM_GRID)
    return [np.array(x) for x in out]


@pytest.mark.parametrize("seed", [1, 2])
def test_trim_matches_hinge_tpu_on_synth(seed):
    ov, rl = _synth_store(seed)
    masks = _masks(ov, rl, seed)
    for got, want in zip(_torch_trim(ov, masks), _jax_trim(ov, masks)):
        np.testing.assert_array_equal(got, want)


def test_lattice_points_match_hinge_tpu():
    ov, _ = _synth_store(3)
    npairs, pair_off, cum, seg_id, k_local = _walk(ov)
    args = _cols(ov) + (npairs, pair_off, cum, seg_id, k_local)
    got = T.lattice_points(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in args), 100)
    want = J._lattice_points(*map(jnp.asarray, args), 100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("source", ["synth", "noisy_sim"])
def test_trim_matches_native(source, request):
    if source == "synth":
        ov, rl = _synth_store(4)
    else:
        sim = request.getfixturevalue("noisy_sim")
        ov, rl = sim["overlaps"], sim["read_store"].length
    masks = _masks(ov, rl, 5)
    native = _native_trim(ov, *masks, T.TRIM_GRID)
    if native is None:
        pytest.skip("native toolchain unavailable")
    for got, want in zip(_torch_trim(ov, masks), native):
        np.testing.assert_array_equal(got, want)


def test_add_types_matches_hinge_tpu():
    ov, rl = _synth_store(6)
    masks = _masks(ov, rl, 6)
    eff = _jax_trim(ov, masks)[:4]
    for over in ((300, -300), (600, 100)):
        args = tuple(eff) + masks + (ov.rc,) + over
        want = np.asarray(J.add_types_asymmetric(
            *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))
        got = T.add_types_asymmetric(
            *(torch.from_numpy(np.ascontiguousarray(a))
              if isinstance(a, np.ndarray) else a for a in args))
        assert len(set(want.tolist())) > 2
        np.testing.assert_array_equal(got.numpy(), want)


def test_process_alignments_lattice_matches_native(noisy_sim):
    """On the same rows and masks, the trim lattice on the CPU
    (pairs._lattice_trim) equals the native trim field by field, and
    process_alignments returns what the native trim gives."""
    ov, rs = noisy_sim["overlaps"], noisy_sim["read_store"]
    rng = np.random.default_rng(8)
    rl = rs.length
    es = (rng.random(len(rl)) * rl * 0.3).astype(np.int32)
    ee = (rl - rng.random(len(rl)) * rl * 0.3).astype(np.int32)
    rows = np.arange(0, ov.n, 2)
    pov = _port(ov)
    sub = pov.take(rows)
    masks = (es[sub.a_id], ee[sub.a_id], es[sub.b_id], ee[sub.b_id])
    native = TP._native_trim(sub, *masks, T.TRIM_GRID)
    lattice = TP._lattice_trim(sub, *masks, "cpu")
    for f, g, w in zip(("eams", "eame", "ebms", "ebme", "active"),
                       lattice, native):
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert len(set(native[4].tolist())) == 2
    got = TP.process_alignments(pov, rows, es, ee, 500, 300, -300, True)
    for f, w in zip(("eff_a_match_start", "eff_a_match_end",
                     "eff_b_match_start", "eff_b_match_end"), native):
        np.testing.assert_array_equal(getattr(got, f), w, err_msg=f)
    too_short = (((native[3] - native[2]) < 500)
                 | ((native[1] - native[0]) < 500))
    np.testing.assert_array_equal(got.active, native[4] & ~too_short)
    np.testing.assert_array_equal(
        got.weight, (native[1] - native[0]) + (native[3] - native[2]))
