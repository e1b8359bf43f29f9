"""The port's sharded functions (hinge_tpu_torch.parallel.sharding,
ops.consensus_vote.sharded_vote_tallies, parallel.dryrun) against
hinge_tpu's on the same inputs, tolerance 0.

The port's mesh is N shards on the CPU; hinge_tpu's runs over the 8
virtual CPU devices that tests/conftest.py sets up, with the mesh shapes
of tests/test_sharding.py and tests/test_consensus_vote.py.  The stage
files of filter, maximal and layout, and assemble()'s consensus and GFA,
under HINGE_SHARDED=1 with 8 CPU shards must equal the port's
single-device run and hinge_tpu's 8-device run byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hinge_tpu.parallel import sharding as JS
from hinge_tpu_torch.data.carry import overlap_store_from_arrays
from hinge_tpu_torch.parallel import sharding as TS
from hinge_tpu_torch.stages import filter as filter_mod
from hinge_tpu_torch.stages import layout as layout_mod
from hinge_tpu_torch.stages import maximal as maximal_mod

DEV = "cpu"


def _jax_mesh(n_dev, rec_axis=None):
    if len(jax.devices()) < n_dev:
        pytest.fail("conftest sets up 8 virtual devices")
    return JS.make_mesh(n_dev, rec_axis=rec_axis)


@pytest.fixture(scope="module")
def filter_data():
    from hinge_tpu.data.simulator import SimParams, simulate

    _, _, rs, ov = simulate(SimParams(genome_len=50_000, coverage=15.0, seed=5))
    sel = ov.a_id != ov.b_id
    return dict(a_id=ov.a_id[sel], a_start=ov.a_start[sel],
                a_end=ov.a_end[sel], read_len=rs.length)


@pytest.fixture(scope="module")
def ovdata():
    from hinge_tpu.data.simulator import SimParams, simulate

    _, _, rs, ov = simulate(SimParams(genome_len=50_000, coverage=12.0, seed=7))
    return rs, ov.take(np.nonzero(ov.a_id != ov.b_id)[0])


def test_make_mesh_factorisation():
    """sharding.py:49-53's rule, and the shard count's sources."""
    for n, want in ((8, (4, 2)), (4, (2, 2)), (2, (2, 1)), (6, (3, 2)),
                    (3, (3, 1)), (1, (1, 1))):
        mesh = TS.make_mesh(n, device=DEV)
        assert (mesh.shape["reads"], mesh.shape["recs"]) == want
        assert mesh.size == n and all(d.type == "cpu" for _, d in mesh.local_shards())
    assert TS.make_mesh(8, rec_axis=1, device=DEV).shape == {"reads": 8, "recs": 1}
    with pytest.raises(ValueError):
        TS.make_mesh(6, rec_axis=4, device=DEV)


def test_stage_mesh_switch(monkeypatch):
    monkeypatch.delenv("HINGE_MESH_SHARDS", raising=False)
    monkeypatch.delenv("HINGE_SHARDED", raising=False)
    assert TS.stage_mesh(DEV) is None
    monkeypatch.setenv("HINGE_SHARDED", "1")
    assert TS.shard_count(DEV) == 1 and TS.stage_mesh(DEV) is None
    monkeypatch.setenv("HINGE_MESH_SHARDS", "4")
    assert TS.stage_mesh(DEV).size == 4
    monkeypatch.setenv("HINGE_SHARDED", "0")
    assert TS.stage_mesh(DEV) is None


@pytest.mark.parametrize("n_dev,rec_axis", [(8, 2), (8, 1), (4, 4)])
def test_shard_records_matches_hinge_tpu(filter_data, n_dev, rec_axis):
    d = filter_data
    args = (d["a_id"], d["a_start"], d["a_end"], len(d["read_len"]))
    want = JS.shard_records(*args, _jax_mesh(n_dev, rec_axis))
    got = TS.shard_records(*args, TS.make_mesh(n_dev, rec_axis, device=DEV))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_read_range_matches_hinge_tpu():
    from hinge_tpu.parallel.distributed import host_read_range as jrange
    from hinge_tpu_torch.parallel.distributed import host_read_range, init_distributed

    assert init_distributed() == (0, 1)
    for n_reads in (1, 7, 32, 1001):
        for count in (1, 2, 3, 8):
            for i in range(count):
                assert host_read_range(n_reads, i, count) == jrange(n_reads, i, count)


@pytest.mark.parametrize("n_dev,rec_axis", [(8, 2), (8, 1), (4, 4)])
def test_sharded_filter_matches_hinge_tpu(filter_data, n_dev, rec_axis):
    d = filter_data
    nb = int(d["read_len"].max()) // 40 + 3
    args = (d["a_id"], d["a_start"], d["a_end"], d["read_len"])
    j_cov, j_masks, j_ann, j_chunk = JS.run_sharded_filter(
        *args, _jax_mesh(n_dev, rec_axis), nb=nb)
    t_cov, t_masks, t_ann, t_chunk = TS.run_sharded_filter(
        *args, TS.make_mesh(n_dev, rec_axis, device=DEV), nb=nb)
    assert t_chunk == j_chunk
    for got, want in ((t_cov, j_cov), (t_masks, j_masks), (t_ann, j_ann)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_profiles_match_hinge_tpu(filter_data):
    d = filter_data
    n_reads = len(d["read_len"])
    kw = dict(nb=int(d["read_len"].max()) // 40 + 3, reso=40, cut_off=300)
    args = (d["a_id"], d["a_start"], d["a_end"], n_reads)
    want = JS.run_sharded_profiles(*args, _jax_mesh(8), **kw)
    got = TS.run_sharded_profiles(*args, TS.make_mesh(8, device=DEV), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _eff_masks(rs):
    lo = rs.length // 10
    return lo.astype(np.int32), (rs.length - lo).astype(np.int32)


@pytest.mark.parametrize("n_dev,rec_axis", [(8, 2), (8, 1), (4, 1)])
def test_sharded_classify_matches_hinge_tpu(ovdata, n_dev, rec_axis):
    from hinge_tpu.ops import classify as JCL
    from hinge_tpu.ops.pairs import top_k_per_pair

    rs, ov = ovdata
    eff_s, eff_e = _eff_masks(rs)
    sub = ov.take(top_k_per_pair(ov, 2))
    tw = JCL.build_trace_walk(sub)
    args = (sub.a_start, sub.a_end, sub.b_start, sub.b_end, sub.rc,
            eff_s[sub.a_id], eff_e[sub.a_id], eff_s[sub.b_id], eff_e[sub.b_id],
            tw)
    kw = dict(tspace=ov.tspace, aln_threshold=400, theta=300, theta2=600)
    want = JS.run_sharded_classify(*args, _jax_mesh(n_dev, rec_axis), **kw)
    got = TS.run_sharded_classify(*args, TS.make_mesh(n_dev, rec_axis, device=DEV), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_matching_position_matches_hinge_tpu(ovdata, n_dev):
    from hinge_tpu.ops import classify as JCL

    _, ov = ovdata
    tw = JCL.build_trace_walk(ov)
    rng = np.random.default_rng(3)
    nq = 512
    ov_idx = rng.integers(0, ov.n, nq).astype(np.int32)
    frac = rng.random(nq)
    pos = (ov.a_start[ov_idx] + frac * (ov.a_end[ov_idx] - ov.a_start[ov_idx])).astype(np.int32)
    args = (ov_idx, pos, ov.a_start, ov.a_end, ov.b_start, ov.b_end, ov.rc, tw)
    want = JS.run_sharded_matching_position(*args, _jax_mesh(n_dev), tspace=ov.tspace)
    got = TS.run_sharded_matching_position(*args, TS.make_mesh(n_dev, device=DEV),
                                           tspace=ov.tspace)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_top_k_matches_hinge_tpu(ovdata, n_shards):
    _, ov = ovdata
    port_ov = overlap_store_from_arrays(vars(ov))
    np.testing.assert_array_equal(TS.sharded_top_k_per_pair(port_ov, 2, n_shards),
                                  JS.sharded_top_k_per_pair(ov, 2, n_shards))


def _hinge_inputs(seed=3, R=16, Pw=32, T=96):
    rng = np.random.default_rng(seed)
    ams = rng.integers(0, 2000, (R, Pw)).astype(np.int32)
    ame = (ams + rng.integers(100, 2000, (R, Pw))).astype(np.int32)
    lov = rng.integers(0, 1500, (R, Pw)).astype(np.int32)
    rov = rng.integers(0, 1500, (R, Pw)).astype(np.int32)
    valid = rng.random((R, Pw)) < 0.9
    pos = rng.integers(200, 3500, T).astype(np.int32)
    grad = rng.choice(np.array([-1, 1], np.int32), T)
    m0 = rng.integers(0, 200, T).astype(np.int32)
    m1 = (pos + rng.integers(200, 1500, T)).astype(np.int32)
    rid = rng.integers(0, R, T).astype(np.int32)
    return (pos, grad, m0, m1, rid, ams, ame, lov, rov, valid)


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_hinge_call_matches_hinge_tpu(n_dev):
    args = _hinge_inputs(T=101)
    kw = dict(theta=300, htl=300, hbl=200, hrut=6, hbpt=7)
    want = JS.run_sharded_hinge_call(*args, _jax_mesh(n_dev), **kw)
    got = TS.run_sharded_hinge_call(*args, TS.make_mesh(n_dev, device=DEV), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_vote_matches_hinge_tpu(n_dev):
    from hinge_tpu.ops.consensus_vote import sharded_vote_tallies as jvote
    from hinge_tpu_torch.ops.consensus_vote import sharded_vote_tallies as tvote
    from hinge_tpu_torch.stages.consensus import _vote_tallies
    from tests.test_consensus_vote import _flat, _random_rows

    rng = np.random.default_rng(11)
    n = 24
    rows_a, rows_b = _random_rows(rng, n)
    fa, fb, sl = _flat(rows_a, rows_b)
    pos0 = rng.integers(0, 50, n).astype(np.int64)
    want = jvote(_jax_mesh(n_dev), fa, fb, sl, pos0, 2200, alen_bucket=1024)
    got = tvote(TS.make_mesh(n_dev, device=DEV), fa, fb, sl, pos0, 2200,
                alen_bucket=1024)
    for g, w, r in zip(got, want, _vote_tallies(fa, fb, sl, pos0, 2200)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_sharded_falcon_tally_matches_hinge_tpu():
    rng = np.random.default_rng(9)
    tags = rng.integers(0, 5, (4099, 6)).astype(np.int32)
    tags[:, 0] = rng.integers(-3, 703, 4099)
    tags[:, 1] = rng.integers(0, 3, 4099)
    np.testing.assert_array_equal(
        TS.run_sharded_falcon_tally(TS.make_mesh(8, device=DEV), tags, 700),
        JS.run_sharded_falcon_tally(_jax_mesh(8), tags, 700))


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_wave_align_matches_hinge_tpu(n_dev):
    rng = np.random.default_rng(8)
    qs, ts = [], []
    for _ in range(2 * n_dev + 3):
        q = rng.integers(0, 4, int(rng.integers(0, 240)), dtype=np.uint8)
        t = q.copy()
        if len(t) > 10:
            t[rng.integers(0, len(t), 4)] = rng.integers(0, 4, 4)
        qs.append(q)
        ts.append(t)
    want = JS.run_sharded_wave_align(_jax_mesh(n_dev), qs, ts)
    got = TS.run_sharded_wave_align(TS.make_mesh(n_dev, device=DEV), qs, ts)
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("n_dev", [8, 4])
def test_dryrun_multichip_on_cpu_shards(n_dev):
    """The eight families, each equal to the port's single-device op."""
    from hinge_tpu_torch.parallel.dryrun import dryrun_multichip

    checked = dryrun_multichip(n_dev, device=DEV)
    assert sorted(checked) == sorted([
        "filter", "classify", "matching_position", "hinge_call", "top_k",
        "vote", "wave_align", "falcon_tally"])
    assert all(v > 0 for v in checked.values())


def test_entry_matches_hinge_tpu():
    """entry()'s single-device filter chain equals __graft_entry__.entry's."""
    import __graft_entry__ as G
    from hinge_tpu_torch.parallel.dryrun import entry

    jfn, jargs = G.entry()
    tfn, targs = entry(DEV)
    for g, w in zip(tfn(*targs), jax.jit(jfn)(*(jnp.asarray(a) for a in jargs))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


STAGE_FILES = [
    "asm.mas", "asm.cmas", "asm.repeat.txt", "asm.hinges.txt", "asm.cov.flag",
    "asm.self.flag", "asm.coverage.txt",
    "asm.max", "asm.contained.txt",
    "asm.edges.hinges", "asm.edges.hinges2", "asm.hinge.list",
]
OUTPUTS = ["asm.consensus.fasta", "asm_consensus.gfa"]


def _count_calls(monkeypatch, targets):
    """Wrap module.name for each (module, name) and count its calls."""
    calls = {}
    for module, name in targets.items():
        fn = getattr(module, name)
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


def test_assemble_under_sharding_matches_single_and_hinge_tpu(tmp_path, monkeypatch):
    """HINGE_SHARDED=1 with 8 CPU shards: the 12 stage files of filter,
    maximal and layout, the consensus and the GFA byte-equal to the port's
    single-device run and to hinge_tpu's run on its 8 virtual devices."""
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.io.fasta import write_fasta
    from hinge_tpu.io.las import write_las
    from hinge_tpu.pipeline import assemble as assemble_jax
    from hinge_tpu_torch.pipeline import assemble as assemble_torch

    # the repeat gives the layout hinges, so its matching-position queries run
    _, _, rs, ov = simulate(SimParams(genome_len=40_000, coverage=16.0,
                                      mean_read_len=4500, std_read_len=900,
                                      sub_rate=0.01,
                                      repeats=((5_000, 25_000, 3_000),),
                                      seed=33))
    fasta, las = str(tmp_path / "r.fasta"), str(tmp_path / "r.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    quiet = dict(fasta=fasta, las=las, log=lambda *a: None)
    monkeypatch.delenv("HINGE_SHARDED", raising=False)
    res = assemble_torch(workdir=str(tmp_path / "single"), device=DEV, **quiet)
    assert res["contigs"]
    monkeypatch.setenv("HINGE_SHARDED", "1")
    monkeypatch.setenv("HINGE_MESH_SHARDS", "8")
    calls = _count_calls(monkeypatch, {
        filter_mod: "run_sharded_profiles", maximal_mod: "sharded_top_k_per_pair",
        layout_mod: "run_sharded_matching_position"})
    assemble_torch(workdir=str(tmp_path / "mesh8"), device=DEV, **quiet)
    assert all(calls.values()), calls
    assemble_jax(workdir=str(tmp_path / "jax8"), **quiet)
    for name in STAGE_FILES + OUTPUTS:
        single = (tmp_path / "single" / name).read_bytes()
        assert (tmp_path / "mesh8" / name).read_bytes() == single, name
        assert (tmp_path / "jax8" / name).read_bytes() == single, name
