"""Port of `bench.py`: the north-star metric, overlap-pileup records/s/chip, on the card.

Primary metric: overlap-pileup records/s/chip over the filter stage's
device scope (filter.cpp:585-1070), bench.py's chain as the port's torch
ops: pileup coverage x2 + pileup stats + n_entries + masks + repeat
annotation + the hinge-calling op (`ops/hinge_call._hinge_kernel`).
vs_baseline compares with bench.py's vectorised numpy stand-in for the
reference's scalar C++ event loops, run on this host's CPU.  sol_frac
is the measured rate over the H100's HBM speed of light for the same
bytes (`sol_account`).

Output protocol (bench.py's): stdout carries only compact JSON lines;
the primary line is printed first (flush) and again last.  The detail
(speed-of-light account, e2e stage breakdown, scaling curve) goes to
BENCH_DETAIL_torch.json at the repository root.  Every unprefixed field
was measured by this run on the device it names; `recorded_*` fields come
from the port's own record (docs/bench_recorded_torch.json).  A failure
raises: nothing falls back to the CPU.

    python -m hinge_tpu_torch.bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hinge_tpu_torch.bench import RECORD, ROOT, card, child_env, sync
from hinge_tpu_torch.device import resolve_device, to_device

N_READS = 16_384
N_OV = 2_000_000
N_TASKS = 2_048       # (read, annotation) hinge-calling tasks
PILEUP_W = 128        # padded pileup width per hinge task
MAXLEN = 30_000
RESO = 40
CUT_OFF = 300
MIN_COV = 5
NB = MAXLEN // RESO + 3
#: the e2e section's workload (bench.py's HINGE_BENCH_E2E_* defaults)
E2E_GENOME = 1_200_000
E2E_COV = 25.0
E2E_TIMEOUT_S = 1800
#: the scaling section's logical shards of one device
SHARDS = (1, 2, 4)

#: H100 SXM HBM3 bandwidth (bytes/s), NVIDIA's data sheet; the pileup
#: chain is scatter/scan shaped with no matmuls, so HBM is its ceiling
HBM_BYTES_S = 3.35e12

DETAIL = os.path.join(ROOT, "BENCH_DETAIL_torch.json")


def synth(seed=0, n_reads=N_READS, n_ov=N_OV):
    """bench.py:47, verbatim (sizes as arguments, bench.py's by default)."""
    rng = np.random.default_rng(seed)
    a_id = np.sort(rng.integers(0, n_reads, n_ov)).astype(np.int32)
    read_len = rng.integers(MAXLEN // 2, MAXLEN, n_reads).astype(np.int32)
    lo = rng.integers(0, MAXLEN // 2, n_ov)
    span = rng.integers(1000, MAXLEN // 2, n_ov)
    a_start = lo.astype(np.int32)
    a_end = np.minimum(lo + span, read_len[a_id]).astype(np.int32)
    return a_id, a_start, a_end, read_len


def synth_hinge(seed=2):
    """Padded (read, annotation) hinge-calling batch (filter.cpp:838-1070);
    bench.py:58, verbatim."""
    rng = np.random.default_rng(seed)
    R = 512  # distinct reads carrying annotations
    ams = rng.integers(0, MAXLEN // 2, (R, PILEUP_W)).astype(np.int32)
    ame = (ams + rng.integers(500, MAXLEN // 2, (R, PILEUP_W))).astype(np.int32)
    lov = rng.integers(0, 4000, (R, PILEUP_W)).astype(np.int32)
    rov = rng.integers(0, 4000, (R, PILEUP_W)).astype(np.int32)
    valid = rng.random((R, PILEUP_W)) < 0.9
    rid = rng.integers(0, R, N_TASKS).astype(np.int32)
    pos_a = rng.integers(500, MAXLEN - 500, N_TASKS).astype(np.int32)
    grad = rng.choice(np.array([-1, 1], np.int32), N_TASKS)
    m0 = rng.integers(0, 500, N_TASKS).astype(np.int32)
    m1 = (pos_a + rng.integers(500, 5000, N_TASKS)).astype(np.int32)
    return dict(pos_a=pos_a, grad=grad, m0=m0, m1=m1, rid=rid,
                ams=ams, ame=ame, lov=lov, rov=rov, valid=valid)


def step(a_id, a_start, a_end, hg, *, n_reads=N_READS, nb=NB):
    """One iteration of bench.py's device chain (:99-126) on the tensors'
    device; returns its `_finish` tuple (:93-97): (coverage sum, mask
    start, mask end, annotation sum, bridged count, support sum)."""
    from hinge_tpu_torch.ops.hinge_call import _hinge_kernel
    from hinge_tpu_torch.parallel.dryrun import _filter_chain

    cov, ms, mev, ann = _filter_chain(a_id, a_start, a_end, n_reads=n_reads,
                                      nb=nb, reso=RESO, cut_off=CUT_OFF,
                                      min_cov=MIN_COV)
    bridged, support = _hinge_kernel(
        hg["pos_a"], hg["grad"], hg["m0"], hg["m1"], hg["rid"],
        hg["ams"], hg["ame"], hg["lov"], hg["rov"], hg["valid"],
        theta=300, htl=300, hbl=200, hrut=6, hbpt=7,
    )
    return (cov.sum(), ms, mev, ann.to(torch.int32).sum(), bridged.sum(),
            support.sum())


def bench_device(a_id, a_start, a_end, read_len, *, device):
    """(records/s, seconds an iteration) of `step` on `device`: a warm-up,
    then iterations calibrated to ~1 s, synchronised around the loop
    (bench.py:76)."""
    dev = resolve_device(device)
    hg = {k: to_device(v, dev) for k, v in synth_hinge().items()}
    args = tuple(to_device(x, dev) for x in (a_id, a_start, a_end))
    step(*args, hg)
    sync(dev)
    t0 = time.perf_counter()
    step(*args, hg)
    sync(dev)
    probe = time.perf_counter() - t0
    iters = max(3, int(1.0 / max(probe, 1e-4)))
    t0 = time.perf_counter()
    for _ in range(iters):
        step(*args, hg)
    sync(dev)
    dt = (time.perf_counter() - t0) / iters
    return len(a_id) / dt, dt


def sol_account(n_ov=N_OV, n_reads=N_READS, nb=None, n_tasks=N_TASKS,
                pileup_w=PILEUP_W):
    """Speed-of-light account for the device chain (bench.py:149, term
    for term): the bytes each op must move through HBM per iteration,
    crediting perfect fusion of elementwise work into its producing pass,
    over the H100's HBM bandwidth (HBM_BYTES_S).

      * profile_coverage x2: read the 3 record columns (12B/rec), scatter
        +1/-1 into the grid (2 read-modify-write int32 = 16B/rec), then
        one read+write cumsum pass over the (reads x nb) grid.
      * pileup_stats: record columns + 3 segment-reduce RMWs/record.
      * n_entries / masks / annotation: per-read vectors are negligible;
        the mask + annotation ops each make one read pass over a grid
        (annotation reads both grids and writes an int8 mask).
      * hinge_call: n_tasks x pileup_w int32 columns, ~5 arrays.
      * final reductions: one read pass over the base grid."""
    if nb is None:
        nb = MAXLEN // RESO + 3
    grid = n_reads * nb * 4  # one (reads x nb) int32 grid pass, bytes
    comp = {
        "record_columns_reads": 3 * 4 * n_ov * 3,  # 2 profiles + stats
        "scatter_rmw": (2 * 8) * n_ov * 2,         # 2 events x RMW x 2 grids
        "stats_rmw": 3 * 8 * n_ov,                 # max/min/count segments
        "cumsum_grid_passes": 2 * 2 * grid,        # rw over both grids
        "mask_grid_read": grid,
        "annotation_grid_reads": 2 * grid + n_reads * (nb - 1),
        "hinge_call": 5 * 4 * n_tasks * pileup_w,
        "final_reductions": grid,
    }
    total = sum(comp.values())
    per_record = total / n_ov
    sol_rps = HBM_BYTES_S / per_record
    return {
        "hbm_bytes_per_iter": int(total),
        "bytes_per_record": round(per_record, 1),
        "sol_records_per_s": int(sol_rps),
        "sol_s_per_iter": total / HBM_BYTES_S,
        "hbm_bw_bytes_per_s": int(HBM_BYTES_S),
        "components_bytes": {k: int(v) for k, v in comp.items()},
    }


def bench_numpy_baseline(a_id, a_start, a_end, read_len, iters=1):
    """Same computation, vectorized numpy on host (reference-CPU stand-in);
    bench.py:197, verbatim."""
    nb = MAXLEN // RESO + 3

    def step():
        cov = np.zeros((N_READS, nb + 1), dtype=np.int32)
        for cutoff, arr in ((0, None), (CUT_OFF, None)):
            grid = np.zeros((N_READS, nb + 1), dtype=np.int32)
            sb = np.clip((a_start + cutoff) // RESO + 1, 0, nb)
            eb = np.clip((a_end - cutoff) // RESO + 1, 0, nb)
            np.add.at(grid, (a_id, sb), 1)
            np.add.at(grid, (a_id, eb), -1)
            c = np.cumsum(grid[:, :nb], axis=1)
            if cutoff == 0:
                cov0 = c
            else:
                covc = c
        red = np.maximum(covc - MIN_COV, 0)
        pos = red > 0
        # longest-run scan (vectorized flush detection)
        prev = np.zeros_like(pos)
        prev[:, 1:] = pos[:, :-1]
        flush = (~pos) & prev
        return cov0.sum() + int(flush.sum())

    t0 = time.perf_counter()
    for _ in range(iters):
        s = step()
    dt = (time.perf_counter() - t0) / iters
    return N_OV / dt, dt


def run_e2e(genome_len, coverage, *, device):
    """FASTA -> consensus assemble() on `device` (bench.py:282), in a
    child interpreter (`bench_e2e`) so that the pipeline's log stays off
    this process's stdout: wall seconds, the per-stage walls and the
    reconstruction quality.  Raises when the child fails or times out."""
    import subprocess

    r = subprocess.run(
        [sys.executable, "-m", "hinge_tpu_torch.bench.bench_e2e",
         str(genome_len), str(coverage), "--device", str(device)],
        capture_output=True, text=True, timeout=E2E_TIMEOUT_S,
        env=child_env())
    for line in r.stdout.splitlines():
        if r.returncode == 0 and line.startswith("E2E "):
            e = json.loads(line[len("E2E "):])
            return {"wall_s": e["wall_s"], "stages": e["stages"],
                    "n_reads": e["workload"]["n_reads"],
                    "genome_mb": e["workload"]["genome_mb"],
                    "coverage_x": coverage, "n_contigs": e["n_contigs"],
                    "longest_contig_frac": e["longest_contig_frac"],
                    "peak_device_bytes": e["peak_device_bytes"]}
    raise RuntimeError(f"e2e child failed (rc {r.returncode}): "
                       f"{r.stderr[-2000:] or 'no E2E line'}")


def logical_mesh(n_shards, dev):
    """`n_shards` logical shards of the one device `dev`, laid out in
    ('reads', 'recs') as `parallel.sharding.make_mesh` lays them out."""
    from hinge_tpu_torch.parallel.sharding import Mesh

    rec_axis = 2 if n_shards % 2 == 0 and n_shards > 2 else 1
    return Mesh([[dev] * rec_axis for _ in range(n_shards // rec_axis)])


def bench_sharded_step(mesh, iters=3):
    """(records/s, seconds a step, reads a shard) of the sharded filter
    step over `mesh` on synth()'s records, iterations calibrated to ~1 s
    (bench.py:317).  The step takes the (R, S, pad) host blocks and
    places them on the shards' devices, so each step includes that copy."""
    from hinge_tpu_torch.parallel.sharding import prepare_filter_step

    recs = synth()
    fstep, args, reads_chunk = prepare_filter_step(*recs, mesh, NB)
    devs = {d for row in mesh.devices for d in row}

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            fstep(*args)
        for d in devs:
            sync(d)
        return (time.perf_counter() - t0) / k

    run(1)
    iters = max(iters, int(1.0 / max(run(1), 1e-4)))
    dt = run(iters)
    return len(recs[0]) / dt, dt, reads_chunk


def comms_model(n_devices: int, reads_chunk: int, nb: int, rec_axis=None):
    """Analytic per-step collective volume of sharded_filter_step (bytes
    MOVED per device, ring-collective accounting): the psum'd pileup grids
    and record stats ride the 'recs' axis, the mask all_gather rides
    'reads'.  bench.py:369, verbatim."""
    if rec_axis is None:
        rec_axis = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    R = n_devices // rec_axis
    S = rec_axis
    b = 0
    # psum over 'recs': 2 grids (reads_chunk x nb int32) + 3 stat vectors
    if S > 1:
        ring = 2 * (S - 1) / S  # ring all-reduce traffic factor
        b += ring * (2 * reads_chunk * nb + 3 * reads_chunk) * 4
    # all_gather masks over 'reads': (reads_chunk, 2) int32 per device
    if R > 1:
        b += (R - 1) * reads_chunk * 2 * 4
    return int(b)


def _scaling(device):
    """records/s of the sharded filter step at 1, 2 and 4 logical shards
    of one device, and at one shard a card when several cards are
    visible, each beside comms_model's collective bytes a step for its
    mesh (bench.py:391).  The multi-process rows are bench_multihost's."""
    from hinge_tpu_torch.parallel.sharding import make_mesh

    dev = resolve_device(device)
    meshes = {f"{n} logical": logical_mesh(n, dev) for n in SHARDS}
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if cards > 1:
        meshes[f"{cards} cards"] = make_mesh(cards, device="cuda")
    rows = {}
    for label, mesh in meshes.items():
        rps, dt, reads_chunk = bench_sharded_step(mesh)
        rows[label] = {
            "records_per_s": round(rps), "step_s": dt,
            "mesh": dict(mesh.shape),
            "comms_model_bytes_per_step_per_device": comms_model(
                mesh.size, reads_chunk=reads_chunk, nb=NB,
                rec_axis=mesh.shape["recs"]),
        }
    one = rows["1 logical"]["records_per_s"]
    for row in rows.values():
        row["vs_one_shard"] = round(row["records_per_s"] / one, 3)
    return {"rows": rows,
            "one_shard_a_card": ("measured" if cards > 1 else
                                 f"not run: {cards} card visible")}


def _recorded():
    """The port's record of out-of-band runs (docs/bench_recorded_torch.json)."""
    if os.path.exists(RECORD):
        with open(RECORD) as f:
            return json.load(f)
    return None


def headline(device):
    """(primary line, sol account): the numpy baseline and the device
    chain on synth()'s records."""
    dev = resolve_device(device)
    a_id, a_start, a_end, read_len = synth()
    base_rps, _ = bench_numpy_baseline(a_id, a_start, a_end, read_len)
    rps, dt = bench_device(a_id, a_start, a_end, read_len, device=dev)
    sol = sol_account()
    primary = {
        "metric": "overlap_pileup_records_per_s_per_chip",
        "value": round(rps),
        "unit": "records/s",
        "s_per_iter": dt,
        "vs_baseline": round(rps / base_rps, 2),
        "baseline_records_per_s": round(base_rps),
        **card(dev),
        "sol_records_per_s": sol["sol_records_per_s"],
        "sol_frac": round(rps / sol["sol_records_per_s"], 4),
        "chain": "coverage+masks+annotation+hinge_call (trim/classify is native-C in production)",
    }
    return primary, sol


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m hinge_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    primary, sol = headline(dev)
    rec = _recorded()
    for entry in rec or ():
        if entry.get("kind") == "e2e_assemble":
            primary["recorded_e2e_wall_s"] = entry.get("wall_s")
            primary["recorded_e2e_genome_mb"] = entry["workload"]["genome_mb"]
    # the headline lands now; the sections below take minutes
    print(json.dumps(primary), flush=True)

    e2e = run_e2e(E2E_GENOME, E2E_COV, device=dev.type)
    scaling = _scaling(dev)
    enriched = dict(primary, sol_account=sol, e2e=e2e, scaling=scaling)
    if rec is not None:
        enriched["recorded"] = rec
    with open(DETAIL, "w") as f:
        json.dump(enriched, f, indent=1)
    primary["e2e_wall_s"] = e2e["wall_s"]
    primary["scaling_vs_one_shard"] = {
        k: v["vs_one_shard"] for k, v in scaling["rows"].items()}
    # last stdout line: the same compact primary object (tail-parse safe)
    print(json.dumps(primary), flush=True)
    return primary


if __name__ == "__main__":
    main()
