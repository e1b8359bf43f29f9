"""The FASTA path under the host defaults and under the CUDA defaults, in alternating runs on the card.

Two arms of `pipeline.assemble()` from FASTA on one simulated read set
(`bench_e2e.simulate_reads`: seed 0, error-free, or with chip_smoke.py
phase 5's read errors under --errors):

- c:       HINGE_DEVICE_JOIN=0 HINGE_DEVICE_VOTE=0, the C join and the
           native C vote (the defaults before the device ones);
- device:  both switches unset, which on CUDA is the device join
           (overlap/device_join.py) and the device vote
           (ops/consensus_vote.py).

The runs go in the order c, device, device, c, in one process, after
one warm-up run of each arm on a 300 kb genome (kernel and native
builds, the CUDA context).  Each run reports its wall, the stage
walls (`utils/log.timings`), the device join's counters and per-phase
host walls (`bench.join_stats` of the call's record), the launch
counts, the peak device memory, n_contigs, longest/genome and the
sha256 of the draft and consensus FASTA; every
run must give the same contigs and FASTA bytes.  Then the join alone: the
C join (`map_reads_to_targets(half_pairs=True)`) and the device join on
the same reads must give equal half-pair records on every column and
trace byte; both walls and the join's peak device memory are reported.
Each run's entry and the whole entry are printed as JSON lines; --record
appends the whole entry to docs/bench_recorded_torch.json.

    python -m hinge_tpu_torch.bench.bench_defaults_ab [genome_len] [coverage]
        [--errors] [--device cuda|cpu] [--record]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import tempfile
import time

import torch

from hinge_tpu_torch.bench import (READ_ERRORS, assert_stores_equal, card,
                                   join_stats, record, sync)
from hinge_tpu_torch.bench.bench_e2e import (assemble_fasta, simulate_reads,
                                             write_reads)
from hinge_tpu_torch.device import resolve_device
from hinge_tpu_torch.utils import log as L

SWITCHES = ("HINGE_DEVICE_JOIN", "HINGE_DEVICE_VOTE")
ARMS = {"c": {"HINGE_DEVICE_JOIN": "0", "HINGE_DEVICE_VOTE": "0"},
        "device": {}}
ORDER = ("c", "device", "device", "c")
#: the genome of the warm-up runs
WARMUP_LEN = 300_000


@contextlib.contextmanager
def arm_switches(arm):
    """The environment of `arm`: both switches cleared, then the arm's."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(ARMS[arm])
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_arm(arm, fasta, workdir, genome_len, *, device) -> dict:
    """One assemble() from `fasta` under `arm`'s switches; its entry."""
    with arm_switches(arm):
        got = assemble_fasta(fasta, workdir, genome_len, device=device)
    return {
        "arm": arm, **got, "device_join": join_stats(L.last_call()),
        "draft_sha256": _sha256(os.path.join(workdir, "asm.draft.fasta")),
        "consensus_sha256": _sha256(
            os.path.join(workdir, "asm.consensus.fasta")),
    }


def check_join(rs, *, device) -> dict:
    """The C join and the device join on `rs`: equal half-pair records
    (raises where they differ), both walls, the device join's counters
    and per-phase host walls (`join_stats`), its peak device memory, and
    the read bases."""
    from hinge_tpu_torch.overlap import device_join as DJ
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets

    dev = resolve_device(device)
    targets = [rs.get_bases(i) for i in range(rs.n_reads)]
    t0 = time.perf_counter()
    ref = map_reads_to_targets(targets, rs, half_pairs=True)
    c_s = time.perf_counter() - t0
    del targets
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with L.record("join") as call:
        got = DJ.overlap_base_records(rs, device=dev)
        sync(dev)
    dev_s = time.perf_counter() - t0
    if got is None:
        raise AssertionError(f"the device join's gate refused the reads: "
                             f"{DJ.join_gate(rs, 15, 12, 500, device=dev)}")
    assert_stores_equal(got, ref)
    return {"records": ref.n, "trace_values": len(ref.trace), "equal": True,
            "c_join_s": c_s, "device_join_s": dev_s,
            "device_join": join_stats(call),
            "read_bases": int(rs.length.sum()),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}


def run(genome_len, coverage, *, device, errors=False,
        log=lambda *a: None) -> dict:
    """The alternating runs and the join check; the entry.  Raises when
    two runs' outputs differ."""
    dev = resolve_device(device)
    err = READ_ERRORS if errors else {}
    with tempfile.TemporaryDirectory() as tmp:
        warm = os.path.join(tmp, "warm.fasta")
        write_reads(warm, simulate_reads(WARMUP_LEN, coverage, **err)[1])
        for arm in ARMS:
            run_arm(arm, warm, os.path.join(tmp, f"warm_{arm}"), WARMUP_LEN,
                    device=dev)
        t0 = time.perf_counter()
        _, rs = simulate_reads(genome_len, coverage, **err)
        fasta = os.path.join(tmp, "reads.fasta")
        write_reads(fasta, rs)
        setup = time.perf_counter() - t0
        runs = []
        for i, arm in enumerate(ORDER):
            runs.append(run_arm(arm, fasta, os.path.join(tmp, f"run{i}"),
                                genome_len, device=dev))
            log(json.dumps({"run": i, **runs[-1]}))
        join = check_join(rs, device=dev)
        log(json.dumps({"join": join}))
    keys = ("n_contigs", "longest_contig_frac", "draft_sha256",
            "consensus_sha256")
    for r in runs[1:]:
        for k in keys:
            if r[k] != runs[0][k]:
                raise AssertionError(f"{k} differs between the {runs[0]['arm']}"
                                     f" and the {r['arm']} run")
    return {
        "kind": "defaults_ab", **card(dev),
        "workload": {"genome_mb": round(genome_len / 1e6, 2),
                     "coverage_x": coverage, "n_reads": rs.n_reads,
                     "seed": 0, "input": "fasta", **err},
        "arms": ARMS, "setup_s": setup, "order": list(ORDER), "runs": runs,
        "outputs_equal": True, "join": join,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_defaults_ab",
        description=__doc__.splitlines()[0])
    ap.add_argument("genome_len", nargs="?", type=int, default=4_600_000)
    ap.add_argument("coverage", nargs="?", type=float, default=30.0)
    ap.add_argument("--errors", action="store_true",
                    help="chip_smoke.py phase 5's read errors")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(card(dev)), flush=True)
    entry = run(args.genome_len, args.coverage, device=dev,
                errors=args.errors,
                log=lambda line: print(line, flush=True))
    if args.record:
        record(entry)
    print(("RECORDED " if args.record else "AB ") + json.dumps(entry),
          flush=True)
    return entry


if __name__ == "__main__":
    main()
