"""hinge_tpu_torch.bench, the port's measurement entry points, against
the repo-root JAX scripts they twin, on the CPU, tolerance 0 throughout:
the synthetic inputs, bench.py's device chain (as hinge_tpu ops), the
byte accounts, the sharded step, the window-DP windows and the K3 twin's
rows, the multi-process step on gloo, the draft A/B, the profile table,
and that an entry point without a card raises before it does any work."""

import ast
import hashlib
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from hinge_tpu_torch.bench import bench as B
from hinge_tpu_torch.bench import bench_window_dp as W
from hinge_tpu_torch.device import to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: the chain's test size: about 512 reads and 20,000 records
N_READS, N_OV = 512, 20_000


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT))


def _nested_defs(path, outer, names, ns):
    """exec the defs `names` nested in `outer` of the file at `path` into
    `ns` (nothing else of the file runs)."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    body = [n for n in fn.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def test_synth_equals_bench_py():
    for got, want in zip(B.synth(), jbench.synth()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = B.synth_hinge(), jbench.synth_hinge()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_step_equals_hinge_tpu_chain():
    """B.step on the CPU against bench.py's own chain (:93-126, its
    `_finish` and `step` defs run with hinge_tpu's ops), same inputs."""
    from hinge_tpu.ops import coverage as C
    from hinge_tpu.ops.hinge_call import _hinge_kernel

    a_id, a_start, a_end, _ = B.synth(n_reads=N_READS, n_ov=N_OV)
    hg = B.synth_hinge()
    ns = _nested_defs(ROOT / "bench.py", "bench_device", ("_finish", "step"), dict(
        jax=jax, jnp=jnp, C=C, _hinge_kernel=_hinge_kernel, nb=B.NB,
        hg={k: jnp.asarray(v) for k, v in hg.items()}, N_READS=N_READS,
        RESO=B.RESO, CUT_OFF=B.CUT_OFF, MIN_COV=B.MIN_COV))
    want = ns["step"](*(jnp.asarray(x) for x in (a_id, a_start, a_end)))
    got = B.step(*(to_device(x, CPU) for x in (a_id, a_start, a_end)),
                 {k: to_device(v, CPU) for k, v in hg.items()},
                 n_reads=N_READS)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)
    # masks on every read and bridged tasks (bench.py's pileups rise too
    # gently for any repeat annotation: its sum is 0 on both sides)
    assert bool((got[2] > 0).all()) and int(got[4]) > 0


def test_sol_account_and_comms_model_equal_bench_py():
    got, want = B.sol_account(), jbench.sol_account()
    assert got["components_bytes"] == want["components_bytes"]
    assert got["hbm_bytes_per_iter"] == want["hbm_bytes_per_iter"] == 596_352_512
    assert got["bytes_per_record"] == want["bytes_per_record"] == 298.2
    # the H100's HBM, not the v5e's
    assert got["hbm_bw_bytes_per_s"] == 3_350_000_000_000
    assert got["sol_records_per_s"] == int(3.35e12 / (596_352_512 / B.N_OV))
    small = dict(n_ov=N_OV, n_reads=N_READS, nb=B.NB, n_tasks=64, pileup_w=16)
    assert (B.sol_account(**small)["components_bytes"]
            == jbench.sol_account(**small)["components_bytes"])
    for n in (1, 2, 8, 64):
        for rc in (B.N_READS, 4096):
            assert B.comms_model(n, rc, B.NB) == jbench.comms_model(n, rc, B.NB)
        assert (B.comms_model(n, 8192, B.NB, rec_axis=1)
                == jbench.comms_model(n, 8192, B.NB, rec_axis=1))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_step_equals_single_device(n_shards):
    """bench's sharded step at n logical CPU shards: coverage, masks and
    annotations equal to the single-device chain's."""
    from hinge_tpu_torch.parallel.dryrun import _filter_chain
    from hinge_tpu_torch.parallel.sharding import prepare_filter_step

    a_id, a_start, a_end, read_len = B.synth(n_reads=N_READS, n_ov=N_OV)
    mesh = B.logical_mesh(n_shards, CPU)
    assert mesh.size == n_shards
    step, args, _ = prepare_filter_step(a_id, a_start, a_end, read_len, mesh,
                                        B.NB)
    cov, masks, ann = step(*args)
    want = _filter_chain(*(to_device(x, CPU) for x in (a_id, a_start, a_end)),
                         n_reads=N_READS, nb=B.NB)
    assert torch.equal(cov[:N_READS], want[0])
    assert torch.equal(masks[:N_READS], torch.stack(want[1:3], dim=1))
    assert torch.equal(ann[:N_READS], want[3])


def test_windows_equal_bench_window_dp_generator():
    """windows(64) against the JAX script's generator: its `mutate` def
    and its loop, taken from the file's syntax tree and run alone (the
    script imports jax and times at module level)."""
    path = ROOT / "bench_window_dp.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "mutate")
            or (isinstance(n, ast.For) and ast.unparse(n.iter) == "range(N)")
            or (isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "(qs, ts)")]
    assert len(keep) == 3
    ns = dict(np=np, N=64, rng=np.random.default_rng(0))
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    qs, ts = W.windows(64)
    assert len(qs) == len(ns["qs"]) == 64
    for a, b in zip(qs + ts, ns["qs"] + ns["ts"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_k3_twin_rows_equal_c_rows():
    from hinge_tpu_torch.ops import myers as MY
    from hinge_tpu_torch.ops import wavefront as WF

    qs, ts = W.windows(64)
    got = WF.align_exact_batch_device(qs, ts, device="cpu")
    want = MY.align_exact_batch(qs, ts)
    assert W._rows_equal(got, want)
    assert W._rows_equal(want, MY.align_exact_batch(qs, ts, W.C_BAND))


def test_window_dp_run_gates_on_cpu():
    """The whole window-DP row set on 8 windows: every gate passes and
    the K3 row's edits equal the C row's."""
    qs, ts = W.windows(8)
    out = W.run(qs, ts, device="cpu")
    assert out["k3_rows_equal_c"] and out["band_nw_rows_equal_twins"]
    assert out["k3_warm"]["edits"] == out["c_dw_banded"]["edits"]


def test_multihost_two_gloo_ranks_give_single_device_masks():
    from hinge_tpu_torch.bench.bench_multihost import run_point
    from hinge_tpu_torch.parallel.dryrun import single_device_masks

    res = run_point(2, device="cpu", n_reads=N_READS, n_ov=N_OV,
                    timeout_s=120)
    a_id, a_start, a_end, _ = B.synth(n_reads=N_READS, n_ov=N_OV)
    want = single_device_masks(CPU, a_id, a_start, a_end, N_READS, B.NB)
    assert res["nproc"] == 2 and res["dist_backend"] == "gloo"
    assert res["mesh"] == {"reads": 2, "recs": 1}
    assert res["masks_sha256"] == hashlib.sha256(
        want.astype(np.int32).tobytes()).hexdigest()
    assert res["iters"] >= 5 and res["step_s"] > 0


def test_draft_ab_c_arm_equals_in_process_draft(tmp_path, monkeypatch):
    """The draft A/B on a 60 kb genome on the CPU: the C arm's FASTA
    equals run_draft in this process under HINGE_PARITY_ALIGN=1, and both
    arms report their contigs."""
    from hinge_tpu_torch.bench import bench_draft_ab as AB
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.io.dazz_db import read_db
    from hinge_tpu_torch.io.las import read_las
    from hinge_tpu_torch.stages.draft import run_draft

    wd = str(tmp_path / "ab")
    AB.prepare(wd, 60_000, 30.0, device="cpu")
    arms = AB.compare(wd, device="cpu")
    assert set(arms) == {"dw_banded_c", "band_nw"}
    for res in arms.values():
        assert res["n_contigs"] > 0 and res["longest"] > 50_000
        assert res["launches"] == {"band_fill": 0, "row_traceback": 0,
                                   "emit_rows": 0}

    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    rs = read_db(os.path.join(wd, "X.db"))
    ov = read_las(os.path.join(wd, "X.las"), read_lengths=rs.length)
    mx = np.zeros(rs.n_reads, bool)
    mx[[int(line.split()[0]) for line in open(os.path.join(wd, "X.max"))]] = True
    out = str(tmp_path / "inproc.fasta")
    run_draft(rs, [ov], nominal_config(), mx, os.path.join(wd, "X.edges.list"),
              out_fasta=out, device="cpu")
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == arms["dw_banded_c"]["fasta_sha256"]


def test_profile_prints_a_table_per_stage(capsys):
    from hinge_tpu_torch.bench import profile_mapcons as P

    walls, tables = P.main(["60000", "--device", "cpu"])
    out = capsys.readouterr().out
    for stage in P.PROFILED:
        assert f"[{stage}]" in out and walls[stage] > 0
        assert 0 < len(tables[stage]) <= P.TOP
        cum, own, calls, where = tables[stage][0]
        assert cum >= own >= 0 and calls >= 1
    assert "run_draft" in out and "map_reads_to_targets" in out
    assert "run_consensus" in out and "run_clip" in out
    assert os.environ.get("HINGE_DEVICE_VOTE") is None


def test_e2e_reads_equal_simulate_and_the_entry_is_complete():
    """bench_e2e's reads-only simulation gives `simulate`'s reads, and its
    entry (traced) on a 100 kb genome on the CPU has every field."""
    from hinge_tpu_torch.bench import bench_e2e as E
    from hinge_tpu_torch.data.simulator import SimParams, simulate

    genome, rs = E.simulate_reads(40_000, 10.0)
    g2, _, rs2, _ = simulate(SimParams(genome_len=40_000, coverage=10.0, seed=0))
    assert np.array_equal(genome, g2) and rs.names == rs2.names
    assert all(np.array_equal(rs.get_bases(i), rs2.get_bases(i))
               for i in range(rs.n_reads))
    e = E.run(100_000, 20.0, device="cpu", profile=True)
    assert e["kind"] == "e2e_assemble" and e["backend"] == "cpu"
    assert e["n_contigs"] > 0 and e["longest_contig_frac"] > 0.9
    assert {"overlap", "filter", "draft", "consensus"} <= set(e["stages"])
    assert e["device_busy_s"] == 0.0 and e["launches"] == {}


def test_bench_without_a_card_raises_before_any_work(tmp_path):
    """`python -m hinge_tpu_torch.bench` asks for cuda by default: without
    a card it raises DeviceError at once, before the numpy baseline, and
    prints no result."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hinge_tpu_torch.bench"],
                       capture_output=True, text=True, timeout=60, env=_env(),
                       cwd=str(tmp_path))
    assert time.perf_counter() - t0 < 30
    assert r.returncode != 0
    assert "DeviceError" in r.stderr and r.stdout == ""


def test_tree_ab_runs_trees_in_turns_with_equal_records(tmp_path):
    """bench_tree_ab on a 40 kb genome on the CPU, this tree against
    itself: four child runs in the order other, this, this, other, each
    importing the package of its tree, with one records digest and one
    consensus; without a card the entry point raises before any work."""
    from hinge_tpu_torch.bench import bench_tree_ab as TA

    e = TA.run(TA.ROOT, 40_000, 20, device="cpu")
    assert [r["tree"] for r in e["runs"]] == list(TA.ORDER)
    assert e["outputs_equal"] and len({r["records_sha256"] for r in e["runs"]}) == 1
    assert len({r["assemble"]["consensus_sha256"] for r in e["runs"]}) == 1
    for r in e["runs"]:
        assert r["package"] == os.path.join(TA.ROOT, "hinge_tpu_torch")
        assert r["records"] > 0 and r["join"]["blocks"] == 1
        assert r["join"]["anchors"] >= r["join"]["kept"] > 0
    r = subprocess.run([sys.executable, "-m", "hinge_tpu_torch.bench.bench_tree_ab",
                        TA.ROOT], capture_output=True, text=True, timeout=60,
                       env=_env(), cwd=str(tmp_path))
    assert r.returncode != 0
    assert "DeviceError" in r.stderr and r.stdout == ""
