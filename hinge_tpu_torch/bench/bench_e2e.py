"""Port of `bench_tpu_e2e.py`: the end-to-end assemble() wall on the card, recorded in the port's own file.

Simulates a genome and its reads (`SimParams(genome_len, coverage,
seed=0)`, error-free as in the JAX script; the simulator's genome, reads
and read store only, which are `simulate`'s reads without its overlap
records), writes them as FASTA and runs `pipeline.assemble()` from the
FASTA alone on the device, so the built-in overlapper runs.  Prints one
entry: the walls per stage (`utils/log.timings`), n_contigs,
longest_contig_frac, n_reads, the peak device memory, and the stages
that the launch counters saw on the device.  --profile traces the run
(`utils/log.torch_trace`) and adds the device's busy share: the union of
the trace's kernel, copy and set spans over the traced wall.  --record
appends the entry to docs/bench_recorded_torch.json.

    python -m hinge_tpu_torch.bench.bench_e2e [genome_len] [coverage]
        [--device cuda|cpu] [--record] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from hinge_tpu_torch.bench import card, record, sync
from hinge_tpu_torch.device import resolve_device

#: the stage whose device programs each launch counter counts (the
#: filter, maximal and layout ops run on the device too, uncounted)
COUNTED = (("draft", "hinge_tpu_torch.ops.band_nw"),
           ("overlap", "hinge_tpu_torch.overlap.device_join"),
           ("consensus", "hinge_tpu_torch.ops.consensus_vote"))
#: chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def simulate_reads(genome_len, coverage, **errors):
    """`simulate(SimParams(genome_len, coverage, seed=0, **errors))`'s
    genome and read store, without its overlap records."""
    from hinge_tpu_torch.data import simulator as S

    p = S.SimParams(genome_len=genome_len, coverage=coverage, seed=0,
                    **errors)
    rng = np.random.default_rng(p.seed)
    genome = S.make_genome(p, rng)
    reads = S.sample_reads(p, rng, genome)
    return genome, S.make_read_store(reads, p, rng)


def busy_seconds(trace_json: str) -> float:
    """Seconds in which the device ran anything: the union of the trace's
    device spans (kernels, copies, sets on every stream)."""
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def assemble_fasta(fasta, workdir, genome_len, *, device, trace_dir="",
                   join_stats=None) -> dict:
    """One assemble() from `fasta` into `workdir` on `device`, with the
    launch counters zeroed and the peak memory reset before it (its log
    lines go to the pipeline's logger); the wall, the stage walls, the
    outputs' measures and the launches."""
    import importlib

    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import timings

    dev = resolve_device(device)
    counters = [(stage, importlib.import_module(mod).launches)
                for stage, mod in COUNTED]
    for _, c in counters:
        for k in c:
            c[k] = 0
    before = timings()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = assemble(fasta=fasta, workdir=workdir, device=dev,
                   log=lambda *a: None, trace_dir=trace_dir,
                   join_stats=join_stats)
    sync(dev)
    wall = time.perf_counter() - t0
    longest = max((len(s) for _, s in res["contigs"]), default=0)
    launches = {}
    for stage, c in counters:
        for k, v in c.items():
            if v:
                launches.setdefault(stage, {})[k] = v
    return {
        "wall_s": round(wall, 3),
        "stages": {k: round(v - before.get(k, 0.0), 3)
                   for k, v in timings().items() if v - before.get(k, 0.0) > 0},
        "n_contigs": len(res["contigs"]),
        "longest_contig_frac": round(longest / genome_len, 4),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "device_stages": sorted(launches),
        "launches": launches,
    }


def write_reads(path, rs) -> None:
    """`rs`'s reads as FASTA."""
    from hinge_tpu_torch.io.fasta import write_fasta

    write_fasta(path, ((rs.names[i], rs.get_seq(i))
                       for i in range(rs.n_reads)))


def run(genome_len, coverage, *, device, profile=False) -> dict:
    """Assemble the simulated reads from FASTA on `device`; the entry."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, rs = simulate_reads(genome_len, coverage)
        fasta = os.path.join(tmp, "reads.fasta")
        write_reads(fasta, rs)
        n_reads = rs.n_reads
        del rs
        setup = time.perf_counter() - t0
        trace = os.path.join(tmp, "trace") if profile else ""
        got = assemble_fasta(fasta, os.path.join(tmp, "asm"), genome_len,
                             device=dev, trace_dir=trace)
        busy = busy_seconds(os.path.join(trace, "trace.json")) if profile else None
    entry = {
        "kind": "e2e_assemble",
        **card(dev),
        "workload": {"genome_mb": round(genome_len / 1e6, 2),
                     "coverage_x": coverage, "n_reads": n_reads,
                     "seed": 0, "input": "fasta"},
        "setup_s": round(setup, 3),
        **got,
    }
    if profile:
        entry["traced"] = True
        entry["device_busy_s"] = round(busy, 6)
        entry["device_busy_share"] = busy / got["wall_s"]
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_e2e",
        description=__doc__.splitlines()[0])
    ap.add_argument("genome_len", nargs="?", type=int, default=4_600_000)
    ap.add_argument("coverage", nargs="?", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(card(dev)), flush=True)
    entry = run(args.genome_len, args.coverage, device=dev,
                profile=args.profile)
    if args.record:
        record(entry)
    print(("RECORDED " if args.record else "E2E ") + json.dumps(entry),
          flush=True)
    return entry


if __name__ == "__main__":
    main()
