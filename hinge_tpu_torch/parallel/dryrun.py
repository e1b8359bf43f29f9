"""The sharded device programs on synthetic inputs: port of `__graft_entry__.py` (entry, dryrun_multichip).

entry():             the single-device filter chain (pileup, mask and
                     annotation ops) on a synthetic overlap batch.
dryrun_multichip(n): the sharded device portions of EIGHT families over an
                     n-shard ('reads', 'recs') mesh on small shapes, each
                     checked equal to the port's single-device op: the
                     filter pileup/mask/annotation chain (psum/pmax/
                     all_gather), the maximal/layout trim+classify
                     lattice, the layout stage's GetMatchingPosition
                     queries, hinge calling, the per-(A,B) top-k at --mlas
                     shard boundaries, the consensus column vote (one
                     table psum), the draft window aligner (the DW_banded
                     wave, K3 on CUDA, batch-sharded) and the falcon
                     align-tag tally (rows sharded + table psum).
filter_worker():     one process of the multi-process filter step (one
                     rank per device, `shards` logical shards each),
                     checked against the single-device masks:
                     `python -m hinge_tpu_torch.parallel.dryrun worker
                     <rank> <world> <port> <device> <shards> [out.npy]`.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from hinge_tpu_torch.device import resolve_device, to_device


def _synth_batch(n_reads=64, n_ov=2048, maxlen=8000, seed=0):
    rng = np.random.default_rng(seed)
    a_id = np.sort(rng.integers(0, n_reads, n_ov)).astype(np.int32)
    read_len = rng.integers(maxlen // 2, maxlen, n_reads).astype(np.int32)
    lo = rng.integers(0, maxlen // 2, n_ov)
    span = rng.integers(1000, maxlen // 2, n_ov)
    a_start = lo.astype(np.int32)
    a_end = np.minimum(lo + span, read_len[a_id]).astype(np.int32)
    return a_id, a_start, a_end, read_len


def _filter_chain(a_id, a_start, a_end, *, n_reads, nb, reso=40, cut_off=300,
                  min_cov=5):
    """The single-device filter chain: (cov, mask start, mask end, ann)."""
    from hinge_tpu_torch.ops import coverage as C

    cov = C.profile_coverage(a_id, a_start, a_end, 0, n_reads=n_reads, nb=nb,
                             reso=reso)
    cov_cut = C.profile_coverage(a_id, a_start, a_end, cut_off,
                                 n_reads=n_reads, nb=nb, reso=reso)
    me, mst, cnt = C.pileup_stats(a_id, a_start, a_end, n_reads=n_reads)
    ne = C.n_entries_from_max_event(me, cnt, reso)
    ne_cut = C.n_entries_from_max_event(
        torch.maximum(me - cut_off, mst + cut_off), cnt, reso)
    ms, mev, _, _ = C.coverage_mask(torch.clamp(cov_cut - min_cov, min=0),
                                    ne_cut, reso=reso)
    ann = C.repeat_annotation_mask(
        cov, ne, ms, mev, min_cov, reso=reso, coverage_fraction=3,
        min_thresh=10, max_thresh=20, no_hinge_region=500)
    return cov, ms, mev, ann


def entry(device="cuda"):
    """(filter_step, example_args): the single-device filter chain and a
    synthetic overlap batch on `device`."""
    n_reads, reso = 64, 40
    a_id, a_start, a_end, read_len = _synth_batch(n_reads=n_reads)
    nb = int(read_len.max()) // reso + 3
    dev = resolve_device(device)

    def filter_step(a_id, a_start, a_end):
        return _filter_chain(a_id, a_start, a_end, n_reads=n_reads, nb=nb,
                             reso=reso)

    return filter_step, tuple(to_device(x, dev) for x in (a_id, a_start, a_end))


def _synth_traced_batch(n_reads=32, n_ov=512, maxlen=4000, tspace=100, seed=1):
    """Synthetic overlap batch WITH a consistent trace-point lattice."""
    from hinge_tpu_torch.ops.classify import TraceWalk

    rng = np.random.default_rng(seed)
    a_id, a_start, a_end, read_len = _synth_batch(n_reads, n_ov, maxlen, seed)
    b_id = rng.integers(0, n_reads, n_ov).astype(np.int32)
    rc = rng.integers(0, 2, n_ov).astype(np.int32)
    span = a_end - a_start
    b_start = rng.integers(0, 200, n_ov).astype(np.int32)
    b_end = np.minimum(b_start + span + rng.integers(-50, 50, n_ov),
                       read_len[b_id]).astype(np.int32)
    b_end = np.maximum(b_end, b_start + 1)
    # pairs: one per lattice interval (interior multiples of tspace + end)
    npairs = ((a_end - 1) // tspace - a_start // tspace + 1).astype(np.int32)
    npairs = np.maximum(npairs, 1)
    pair_off = np.zeros(n_ov, dtype=np.int64)
    np.cumsum(npairs[:-1], out=pair_off[1:])
    total = int(npairs.sum())
    # displacements: spread the b-span uniformly over the pairs
    disp = np.zeros(total, dtype=np.int32)
    for i in range(n_ov):
        P = npairs[i]
        bs = b_end[i] - b_start[i]
        d = np.full(P, bs // P, dtype=np.int32)
        d[: bs % P] += 1
        disp[pair_off[i] : pair_off[i] + P] = d
    csum = np.cumsum(disp, dtype=np.int64)
    seg_start = csum[pair_off] - disp[pair_off]
    cum = (csum - np.repeat(seg_start, npairs)).astype(np.int32)
    tw = TraceWalk(npairs=npairs, pair_off=pair_off, disp=disp, cum=cum)
    return dict(
        a_id=a_id, b_id=b_id, a_start=a_start, a_end=a_end,
        b_start=b_start, b_end=b_end, rc=rc, read_len=read_len, tw=tw,
        tspace=tspace,
    )


def _equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"dryrun_multichip: {name} differs from the "
                             "single-device op")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The eight sharded families over an n_devices-shard mesh (logical
    shards round-robin over the devices of `device`'s type), each equal to
    the port's single-device op on the same inputs, or AssertionError.
    Returns the families' names -> the count of values compared."""
    from hinge_tpu_torch.ops import classify as CL
    from hinge_tpu_torch.parallel.sharding import (
        make_mesh,
        run_sharded_classify,
        run_sharded_filter,
        run_sharded_matching_position,
    )

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, device=dev)
    dv = lambda a: to_device(np.asarray(a), dev)  # noqa: E731
    host = lambda x: x.cpu().numpy()  # noqa: E731
    checked = {}

    # --- stage 1 (filter): pileup/mask/annotation chain with collectives ---
    a_id, a_start, a_end, read_len = _synth_batch(n_reads=32, n_ov=512, maxlen=4000)
    cov, masks, ann, reads_chunk = run_sharded_filter(
        a_id, a_start, a_end, read_len, mesh
    )
    n_reads = len(read_len)
    nb = int(read_len.max()) // 40 + 3
    r_cov, r_ms, r_mev, r_ann = (host(x) for x in _filter_chain(
        dv(a_id), dv(a_start), dv(a_end), n_reads=n_reads, nb=nb))
    _equal("filter coverage", host(cov)[:n_reads], r_cov)
    _equal("filter masks", host(masks)[:n_reads], np.stack([r_ms, r_mev], 1))
    _equal("filter annotations", host(ann)[:n_reads], r_ann)
    if r_cov.sum() <= 0:
        raise AssertionError("dryrun_multichip: empty pileup")
    checked["filter"] = r_cov.size + 2 * r_ms.size + r_ann.size

    # --- stage 2 (maximal) device portion: trim + classify lattice ---
    d = _synth_traced_batch(n_reads=32, n_ov=256, maxlen=4000)
    tw = d["tw"]
    eff_s = (d["read_len"] // 10).astype(np.int32)
    eff_e = (d["read_len"] - d["read_len"] // 10).astype(np.int32)
    ears, eare = eff_s[d["a_id"]], eff_e[d["a_id"]]
    ebrs, ebre = eff_s[d["b_id"]], eff_e[d["b_id"]]
    got = run_sharded_classify(
        d["a_start"], d["a_end"], d["b_start"], d["b_end"], d["rc"],
        ears, eare, ebrs, ebre, tw, mesh,
        tspace=d["tspace"], aln_threshold=400, theta=300, theta2=600,
    )
    seg_id, k_local, _ = CL.make_point_index(tw.npairs)
    cols = [dv(x) for x in (d["a_start"], d["a_end"], d["b_start"], d["b_end"],
                            d["rc"], ears, eare, ebrs, ebre)]
    ref = CL.trim_overlaps(*cols, dv(tw.npairs), dv(tw.pair_off), dv(tw.cum),
                           dv(seg_id), dv(k_local), tspace=d["tspace"])
    ref_type = CL.add_types_asymmetric(*ref[:4], *cols[5:9], cols[4], 300, 600)
    too_short = ((ref[3] - ref[2]) < 400) | ((ref[1] - ref[0]) < 400)
    active = ref[4] & ~too_short
    ref = [host(x) for x in (*ref[:4], active,
                             torch.where(active, ref_type, CL.NOT_ACTIVE))]
    for name, g, w in zip(("eams", "eame", "ebms", "ebme", "active", "mtype"),
                          got, ref):
        _equal(f"classify {name}", g, w)
    checked["classify"] = 6 * len(d["a_id"])

    # --- stage 3 (layout) device portion: GetMatchingPosition queries ---
    rng = np.random.default_rng(0)
    nq = 128
    ov_idx = rng.integers(0, len(d["a_id"]), nq).astype(np.int32)
    pos = ((d["a_start"][ov_idx] + d["a_end"][ov_idx]) // 2).astype(np.int32)
    got = run_sharded_matching_position(
        ov_idx, pos, d["a_start"], d["a_end"], d["b_start"], d["b_end"],
        d["rc"], tw, mesh, tspace=d["tspace"],
    )
    ref = CL.matching_position(
        dv(ov_idx), dv(pos), *cols[:5], dv(tw.npairs), dv(tw.pair_off),
        dv(tw.cum), tspace=d["tspace"])
    _equal("matching position", got, host(ref))
    checked["matching_position"] = nq

    # --- stage 1 (filter) hinge calling: task rows sharded over the mesh ---
    from hinge_tpu_torch.ops.hinge_call import _hinge_kernel
    from hinge_tpu_torch.parallel.sharding import run_sharded_hinge_call

    hrng = np.random.default_rng(3)
    R, Pw, T = 16, 32, 96
    ams = hrng.integers(0, 2000, (R, Pw)).astype(np.int32)
    ame = (ams + hrng.integers(100, 2000, (R, Pw))).astype(np.int32)
    lov = hrng.integers(0, 1500, (R, Pw)).astype(np.int32)
    rov = hrng.integers(0, 1500, (R, Pw)).astype(np.int32)
    hvalid = hrng.random((R, Pw)) < 0.9
    h_pos = hrng.integers(200, 3500, T).astype(np.int32)
    h_grad = hrng.choice(np.array([-1, 1], np.int32), T)
    h_m0 = hrng.integers(0, 200, T).astype(np.int32)
    h_m1 = (h_pos + hrng.integers(200, 1500, T)).astype(np.int32)
    h_rid = hrng.integers(0, R, T).astype(np.int32)
    kw = dict(theta=300, htl=300, hbl=200, hrut=6, hbpt=7)
    sb, ss = run_sharded_hinge_call(
        h_pos, h_grad, h_m0, h_m1, h_rid, ams, ame, lov, rov, hvalid,
        mesh, **kw)
    rb, rs_ = _hinge_kernel(*(dv(x) for x in (
        h_pos, h_grad, h_m0, h_m1, h_rid, ams, ame, lov, rov, hvalid)), **kw)
    _equal("hinge call bridged", sb, host(rb))
    _equal("hinge call support", ss, host(rs_))
    checked["hinge_call"] = 2 * T

    # --- stage 2 (maximal) per-(A,B) top-k at --mlas shard boundaries ---
    from hinge_tpu_torch.data.overlaps import OverlapStore
    from hinge_tpu_torch.ops.pairs import top_k_per_pair
    from hinge_tpu_torch.parallel.sharding import sharded_top_k_per_pair

    order = np.argsort(d["a_id"], kind="stable")
    n_ov = len(d["a_id"])
    ovs = OverlapStore(
        a_id=d["a_id"][order], b_id=d["b_id"][order],
        a_len=d["read_len"][d["a_id"]][order],
        b_len=d["read_len"][d["b_id"]][order],
        a_start=d["a_start"][order], a_end=d["a_end"][order],
        b_start=d["b_start"][order], b_end=d["b_end"][order],
        rc=d["rc"][order], diffs=np.zeros(n_ov, np.int32),
        tlen=np.zeros(n_ov, np.int32),
        trace_off=np.zeros(n_ov, np.int64),
        trace=np.zeros(0, np.uint16), tspace=d["tspace"],
    )
    ref = top_k_per_pair(ovs, 2)
    _equal("top-k", sharded_top_k_per_pair(ovs, 2, n_devices), ref)
    checked["top_k"] = len(ref)

    # --- stage 8 (consensus) column vote: chunk-parallel with table psum ---
    from hinge_tpu_torch.ops.consensus_vote import sharded_vote_tallies
    from hinge_tpu_torch.stages.consensus import GAP, _vote_tallies

    vrng = np.random.default_rng(5)
    rows_a, rows_b = [], []
    for _ in range(24):
        L = int(vrng.choice([0, 50, 215, 600, 1200]))
        ra = vrng.integers(0, 5, L).astype(np.uint8)
        if vrng.random() < 0.3 and L > 120:
            ra[: vrng.integers(90, 115)] = GAP
        rows_a.append(ra)
        rows_b.append(vrng.integers(0, 5, L).astype(np.uint8))
    fa = np.concatenate(rows_a)
    fb = np.concatenate(rows_b)
    sl = np.array([len(r) for r in rows_a], np.int64)
    vp0 = vrng.integers(0, 50, len(sl)).astype(np.int64)
    valen = 1800
    vref = _vote_tallies(fa, fb, sl, vp0, valen)
    vgot = sharded_vote_tallies(mesh, fa, fb, sl, vp0, valen, alen_bucket=1024)
    for name, a, b in zip(("scores", "cov", "ins_score", "ins_scores"), vgot, vref):
        _equal(f"vote {name}", a, b)
    checked["vote"] = sum(x.size for x in vref)

    # --- stage 5 (draft) window aligner: batch sharded over the mesh ---
    from hinge_tpu_torch.ops.wavefront import align_exact_batch_device
    from hinge_tpu_torch.parallel.sharding import run_sharded_wave_align

    wrng = np.random.default_rng(8)
    qs, ts = [], []
    for _ in range(2 * n_devices + 3):
        q = wrng.integers(0, 4, int(wrng.integers(0, 240)), dtype=np.uint8)
        t = q.copy()
        if len(t) > 10:
            t[wrng.integers(0, len(t), 4)] = wrng.integers(0, 4, 4)
        qs.append(q)
        ts.append(t)
    wgot = run_sharded_wave_align(mesh, qs, ts)
    wref = align_exact_batch_device(qs, ts, device=dev)
    for i, ((ga, gb), (ra, rb)) in enumerate(zip(wgot, wref)):
        _equal(f"wave rows of window {i}", np.concatenate([ga, gb]),
               np.concatenate([ra, rb]))
    checked["wave_align"] = len(qs)

    # --- stage 8 (consensus) falcon align-tag tally: rows sharded + psum ---
    from hinge_tpu_torch.parallel.sharding import run_sharded_falcon_tally

    frng = np.random.default_rng(9)
    t_len = 700
    tags = frng.integers(0, 5, (4096, 6)).astype(np.int32)
    tags[:, 0] = frng.integers(0, t_len, 4096)
    tags[:, 1] = frng.integers(0, 3, 4096)
    fgot = run_sharded_falcon_tally(mesh, tags, t_len)
    d0 = tags[tags[:, 1] == 0, 0]
    fref = np.zeros(t_len, np.int64)
    np.add.at(fref, d0[(d0 >= 0) & (d0 < t_len)], 1)
    _equal("falcon tally", fgot, fref)
    checked["falcon_tally"] = t_len
    return checked


def worker_inputs():
    """The multi-process filter step's data set, identical on every
    process: (a_id, a_start, a_end, read_len, nb)."""
    rng = np.random.default_rng(42)
    n_reads, n_ov, maxlen, reso = 32, 512, 4000, 40
    a_id = np.sort(rng.integers(0, n_reads, n_ov)).astype(np.int32)
    read_len = rng.integers(maxlen // 2, maxlen, n_reads).astype(np.int32)
    lo = rng.integers(0, maxlen // 2, n_ov)
    span = rng.integers(1000, maxlen // 2, n_ov)
    a_start = lo.astype(np.int32)
    a_end = np.minimum(lo + span, read_len[a_id]).astype(np.int32)
    return a_id, a_start, a_end, read_len, maxlen // reso + 3


@contextlib.contextmanager
def joined(rank: int, world: int, port: int, device: str):
    """This process as rank `rank` of a `world`-process group on
    localhost:`port`: NCCL on CUDA with card `rank`, gloo on the CPU.
    Yields the rank's device and leaves the group on exit."""
    import torch.distributed as dist

    from hinge_tpu_torch.parallel.distributed import init_distributed

    dev = torch.device("cuda", rank) if torch.device(device).type == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pi, pc = init_distributed(f"localhost:{port}", world, rank, device=dev)
    try:
        if (pi, pc) != (rank, world):
            raise AssertionError(f"rank/world {(pi, pc)} != {(rank, world)}")
        yield dev
    finally:
        dist.destroy_process_group()


def process_filter_step(dev, shards, a_id, a_start, a_end, read_len, nb):
    """(mesh, step, host arguments) of the sharded filter step across the
    process group, this process holding `shards` logical shards of `dev`
    as whole 'reads' rows."""
    from hinge_tpu_torch.parallel.sharding import prepare_filter_step, process_mesh

    mesh = process_mesh([dev] * shards)
    step, args, _ = prepare_filter_step(a_id, a_start, a_end, read_len, mesh, nb)
    return mesh, step, args


def single_device_masks(dev, a_id, a_start, a_end, n_reads, nb) -> np.ndarray:
    """The single-device filter chain's masks on `dev`, (n_reads, 2)."""
    _, ms, mev, _ = _filter_chain(
        *(to_device(x, dev) for x in (a_id, a_start, a_end)),
        n_reads=n_reads, nb=nb)
    return np.stack([ms.cpu().numpy(), mev.cpu().numpy()], 1)


def filter_worker(rank: int, world: int, port: int, device: str,
                  shards: int = 2, out: str = "") -> str:
    """One process of the multi-process sharded filter step: joins the
    group (NCCL on CUDA, gloo on the CPU), holds `shards` logical shards
    of its device as whole 'reads' rows of a (shards * world, 1) mesh,
    runs the step, and checks the all-gathered masks against the
    single-device masks (and writes them to `out`, an .npy path)."""
    import torch.distributed as dist

    from hinge_tpu_torch.parallel.distributed import host_read_range

    with joined(rank, world, port, device) as dev:
        a_id, a_start, a_end, read_len, nb = worker_inputs()
        n_reads = len(read_len)
        mesh, step, args = process_filter_step(dev, shards, a_id, a_start,
                                               a_end, read_len, nb)
        _, masks, _ = step(*args)
        masks = masks.cpu().numpy()[:n_reads]
        _equal("multi-process masks", masks, single_device_masks(
            dev, a_id, a_start, a_end, n_reads, nb))
        if out:
            np.save(out, masks)
        lo_r, hi_r = host_read_range(n_reads, rank, world)
        backend = dist.get_backend()
    return (f"MULTIPROCESS_OK {rank}/{world} backend={backend} "
            f"shards={mesh.size} range=[{lo_r},{hi_r})")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess(world: int, device: str, shards: int = 2,
                     timeout: float = 300.0):
    """Start `world` filter_worker processes (rank r on device r of
    `device`'s type) on one free localhost port and wait for them.
    Returns (masks of every rank, each rank's OK line); raises when a rank
    fails or the ranks' masks differ.  Every process is stopped."""
    import os
    import subprocess
    import tempfile

    import hinge_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        hinge_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"masks{r}.npy") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hinge_tpu_torch.parallel.dryrun", "worker",
             str(r), str(world), str(port), device, str(shards), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp) for r in range(world)]
        results = []
        try:
            for p in procs:
                results.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        lines = []
        for r, (p, (out, err)) in enumerate(zip(procs, results)):
            if p.returncode != 0 or f"MULTIPROCESS_OK {r}/{world}" not in out:
                raise AssertionError(f"rank {r} failed (rc {p.returncode}): "
                                     f"{out[-1000:]} {err[-2000:]}")
            lines.append(out.strip().splitlines()[-1])
        masks = [np.load(o) for o in outs]
    if any(not np.array_equal(m, masks[0]) for m in masks):
        raise AssertionError("the ranks' masks differ")
    return masks, lines


def main(argv) -> None:
    """`worker ...`: one rank of the multi-process filter step.  Else, on
    `device` (argv[0], default cuda): entry(), dryrun_multichip over one
    shard per visible device (HINGE_MESH_SHARDS=N for N logical shards),
    and the multi-process filter step with one rank per visible device."""
    import time

    from hinge_tpu_torch.parallel.sharding import _visible_devices, shard_count

    if argv and argv[0] == "worker":
        if len(argv) < 6:
            raise SystemExit("usage: python -m hinge_tpu_torch.parallel.dryrun "
                             "worker <rank> <world> <port> <device> <shards> "
                             "[out.npy]")
        print(filter_worker(int(argv[1]), int(argv[2]), int(argv[3]), argv[4],
                            int(argv[5]), argv[6] if len(argv) > 6 else ""),
              flush=True)
        return
    device = argv[0] if argv else "cuda"
    fn, args = entry(device)
    print("entry ok:", [tuple(o.shape) for o in fn(*args)], flush=True)
    n = shard_count(device)
    t0 = time.perf_counter()
    checked = dryrun_multichip(n, device=device)
    print(f"dryrun_multichip({n}) ok on {device} "
          f"({time.perf_counter() - t0:.3f}s): {checked}", flush=True)
    world = len(_visible_devices(device))
    t0 = time.perf_counter()
    _, lines = run_multiprocess(world, device)
    print(f"multi-process filter step ok, world {world} "
          f"({time.perf_counter() - t0:.3f}s with process start-up): "
          + "; ".join(lines), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
