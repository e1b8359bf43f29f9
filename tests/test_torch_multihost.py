"""The port's sharded filter step across two processes on gloo: each
process holds 2 logical CPU shards as whole 'reads' rows of a (4, 1)
mesh (the shape of tests/test_multihost.py), so the step's all_gather
crosses the process boundary.  The masks must equal the single-device
masks of the port and of hinge_tpu; the workers import no jax.  A layout
in which the processes own unequal numbers of rows raises ValueError."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the worker (hinge_tpu_torch.parallel.dryrun's), run so that the
#: interpreter reports afterwards whether jax or hinge_tpu got loaded
WORKER = """
import runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
runpy.run_module("hinge_tpu_torch.parallel.dryrun", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hinge_tpu"))
print("LOADED", loaded)
"""


def _run_workers(tmp_path, shards):
    from hinge_tpu_torch.parallel.dryrun import _free_port

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, "worker", str(i), "2", str(port),
             "cpu", str(shards[i]), str(tmp_path / f"masks{i}.npy")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_sharded_filter(tmp_path):
    from hinge_tpu.ops import coverage as C
    from hinge_tpu_torch.parallel.dryrun import worker_inputs

    outs = _run_workers(tmp_path, (2, 2))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i}: {err[-2000:]}"
        assert f"MULTIPROCESS_OK {i}/2 backend=gloo shards=4" in out, out
        assert "LOADED []" in out, out
    a_id, a_start, a_end, read_len, nb = worker_inputs()
    n_reads = len(read_len)
    cov_cut = C.profile_coverage(jnp.asarray(a_id), jnp.asarray(a_start),
                                 jnp.asarray(a_end), jnp.int32(300),
                                 n_reads=n_reads, nb=nb, reso=40)
    me, ms_, cnt = C.pileup_stats(jnp.asarray(a_id), jnp.asarray(a_start),
                                  jnp.asarray(a_end), n_reads=n_reads, nb=1,
                                  reso=40)
    ne_cut = C.n_entries_from_max_event(
        jnp.maximum(me - 300, ms_ + 300), cnt, 40)
    ms, mev, _, _ = C.coverage_mask(jnp.maximum(cov_cut - 5, 0), ne_cut, reso=40)
    want = np.stack([np.asarray(ms), np.asarray(mev)], 1)
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"masks{i}.npy"), want)


def test_unequal_rows_per_process_raise(tmp_path):
    outs = _run_workers(tmp_path, (2, 1))
    for i, (rc, out, err) in enumerate(outs):
        assert rc != 0, f"worker {i} accepted an unequal layout: {out}"
        assert "ValueError" in err and "whole 'reads' rows" in err, err[-2000:]


def test_dryrun_main_on_cpu_shards(monkeypatch, capsys):
    """`python -m hinge_tpu_torch.parallel.dryrun cpu`: entry(), the eight
    families over HINGE_MESH_SHARDS CPU shards and the multi-process step
    with one rank per visible device (one CPU: world 1)."""
    from hinge_tpu_torch.parallel.dryrun import main

    monkeypatch.setenv("HINGE_MESH_SHARDS", "4")
    main(["cpu"])
    out = capsys.readouterr().out
    assert "entry ok" in out and "dryrun_multichip(4) ok on cpu" in out, out
    assert "MULTIPROCESS_OK 0/1 backend=gloo shards=2" in out, out
