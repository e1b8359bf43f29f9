"""Port of `bench_multihost.py`: measured multi-process scaling of the sharded filter step, one rank a card on NCCL.

Each rank joins a `torch.distributed` group (`parallel/dryrun.joined`:
NCCL on CUDA with one card a rank, gloo on the CPU), holds one shard of
its device as a whole 'reads' row of a (world, 1) mesh, checks the
all-gathered masks against the single-device chain's, and times
`sharded_filter_step` on bench's records (2,000,000 records of 16,384
reads by default); rank 0 prints the result.  The orchestrator prints
world 1 and every world from 2 up to the cards visible, beside
comms_model's collective bytes a step; a world that cannot run (NCCL
takes one rank a card) is printed as not run, with the reason.  A rank
that fails or times out raises.

    python -m hinge_tpu_torch.bench.bench_multihost [--device cuda|cpu]
    python -m hinge_tpu_torch.bench.bench_multihost worker <rank> <world> <port> <device> [n_reads n_ov]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import torch

from hinge_tpu_torch.bench import card, child_env, sync
from hinge_tpu_torch.bench.bench import N_OV, N_READS, NB, comms_model, synth
from hinge_tpu_torch.device import resolve_device


def worker(rank: int, world: int, port: int, device: str, n_reads=N_READS,
           n_ov=N_OV):
    """One rank: the step's masks checked, then timed over ~2 s (at least
    5 steps; every rank runs rank 0's count, since each step's
    collectives must meet)."""
    import torch.distributed as dist

    from hinge_tpu_torch.parallel.dryrun import (
        joined, process_filter_step, single_device_masks,
    )

    with joined(rank, world, port, device) as dev:
        a_id, a_start, a_end, read_len = synth(n_reads=n_reads, n_ov=n_ov)
        mesh, step, args = process_filter_step(dev, 1, a_id, a_start, a_end,
                                               read_len, NB)
        _, masks, _ = step(*args)
        masks = masks.cpu().numpy()[:n_reads]
        want = single_device_masks(dev, a_id, a_start, a_end, n_reads, NB)
        if masks.shape != want.shape or not (masks == want).all():
            raise AssertionError(f"rank {rank}: the sharded masks differ "
                                 "from the single-device masks")
        sync(dev)
        t0 = time.perf_counter()
        step(*args)
        sync(dev)
        probe = time.perf_counter() - t0
        iters = torch.tensor([max(5, int(2.0 / max(probe, 1e-4)))], device=dev)
        dist.broadcast(iters, 0)
        iters = int(iters.item())
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*args)
        sync(dev)
        dt = (time.perf_counter() - t0) / iters
        if rank == 0:
            print("MH_RESULT " + json.dumps(
                {"nproc": world, "rps": n_ov / dt, "step_s": dt,
                 "iters": iters, "dist_backend": dist.get_backend(),
                 "mesh": dict(mesh.shape),
                 "masks_sha256": hashlib.sha256(masks.tobytes()).hexdigest(),
                 **card(dev)}), flush=True)


def run_point(nproc: int, *, device, n_reads=N_READS, n_ov=N_OV,
              timeout_s: float = 600):
    """Run `nproc` ranks; rank 0's result.  Raises when a rank fails,
    times out or rank 0 prints no result; every process is stopped."""
    from hinge_tpu_torch.parallel.dryrun import _free_port

    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "hinge_tpu_torch.bench.bench_multihost",
             "worker", str(i), str(nproc), port, str(device), str(n_reads),
             str(n_ov)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=child_env())
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {i} of {nproc} failed (rc "
                               f"{p.returncode}): {e[-2000:]}")
    for line in outs[0][0].splitlines():
        if line.startswith("MH_RESULT "):
            return json.loads(line[len("MH_RESULT "):])
    raise RuntimeError(f"rank 0 of {nproc} printed no result")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "worker":
        worker(int(argv[1]), int(argv[2]), int(argv[3]), argv[4],
               *(int(x) for x in argv[5:7]))
        return None
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_multihost",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 2
    out = {"metric": "multiprocess_filter_step", **card(dev), "rows": {}}
    r1 = run_point(1, device=dev.type)
    for world in range(1, max(cards, 2) + 1):
        if world > cards:
            out["rows"][str(world)] = {
                "not_run": f"NCCL takes one rank a card; {cards} card visible"}
            continue
        r = r1 if world == 1 else run_point(world, device=dev.type)
        row = {"rps": round(r["rps"]), "step_s": r["step_s"],
               "rps_per_device": round(r["rps"] / world),
               "dist_backend": r["dist_backend"],
               "model_collective_bytes_per_step_per_device": comms_model(
                   world, reads_chunk=-(-N_READS // world), nb=NB,
                   rec_axis=1)}
        if world > 1:
            # measured cross-process overhead a step against the model
            overhead = max(r["step_s"] - r1["step_s"], 0.0)
            row["measured_overhead_s_per_step"] = overhead
            if overhead > 0:
                row["implied_transfer_GBps"] = (
                    row["model_collective_bytes_per_step_per_device"]
                    / overhead / 1e9)
        out["rows"][str(world)] = row
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
