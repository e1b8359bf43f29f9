"""Port of `bench_draft_ab.py`: the draft stage's whole-stage A/B, the C DW_banded aligner against band-NW (K1/K2/K2e), on the card.

`prepare` simulates the workload with the port's simulator (or takes a
read store and a .las), writes X.db (with the qual track) and X.las, and
runs the port's verbs (`python -m hinge_tpu_torch.cli`) through
draft-path with the nominal config (`config.nominal_config`, which the
verbs take when --config is empty).  Each arm then runs `run_draft` in a
child process of its own on the device, with one switch pinned:

- dw_banded_c:  HINGE_PARITY_ALIGN=1 (the exact C DW_banded path);
- band_nw:      HINGE_FAST_ALIGN=1 (band-NW, K1/K2/K2e on CUDA).

Each arm reports the draft wall, n_contigs, the longest contig, the
draft FASTA's sha256 and the K1/K2/K2e launch counts.  On CUDA the C
arm must launch none of them and the band-NW arm all three; a failed or
timed-out arm raises.  The default workload is chip_smoke.py phase 5's,
4.6 Mb at 30x with read errors (the JAX script's reads were error-free,
on which the draft aligns no window).  --record appends the result to
docs/bench_recorded_torch.json.

    python -m hinge_tpu_torch.bench.bench_draft_ab [genome_len] [coverage]
        [--device cuda|cpu] [--record]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from hinge_tpu_torch.bench import READ_ERRORS, card, child_env, record, sync
from hinge_tpu_torch.device import resolve_device

ARMS = {
    "dw_banded_c": {"HINGE_PARITY_ALIGN": "1"},
    "band_nw": {"HINGE_FAST_ALIGN": "1"},
}
KERNELS = ("band_fill", "row_traceback", "emit_rows")
#: seconds a verb or an arm may take before it counts as failed
TIMEOUT_S = 1200


def prepare(workdir, genome_len, coverage, *, device, rs=None, las=None):
    """X.db, X.las and the verbs' files through draft-path in `workdir`.
    `rs` and `las` (a .las path), when given, are the reads and overlaps;
    else the workload is simulated with the port's simulator (seed 0,
    READ_ERRORS)."""
    from hinge_tpu_torch.io.dazz_db import write_db
    from hinge_tpu_torch.io.las import write_las

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    if rs is None:
        from hinge_tpu_torch.data.simulator import SimParams, simulate

        _, _, rs, ov = simulate(SimParams(genome_len=genome_len,
                                          coverage=coverage, seed=0,
                                          **READ_ERRORS))
        write_las(os.path.join(workdir, "X.las"), ov)
        del ov
    else:
        os.symlink(os.path.abspath(las), os.path.join(workdir, "X.las"))
    write_db(os.path.join(workdir, "X.db"), rs)
    io_ = ["--db", "X.db", "--las", "X.las", "-x", "X"]
    on = ["--device", str(dev)]
    for argv in (["filter", *io_, *on], ["maximal", *io_, *on],
                 ["layout", *io_, "--out", "X", *on],
                 ["clip", "X.edges.hinges", "X.hinge.list", "1"],
                 ["draft-path", ".", "X", "X1.G2.graphml", "--db", "X.db"]):
        r = subprocess.run([sys.executable, "-m", "hinge_tpu_torch.cli", *argv],
                           cwd=workdir, env=child_env(), capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(f"hinge {argv[0]} failed (rc {r.returncode}): "
                               f"{r.stderr[-2000:]}")


def arm(workdir, device, out):
    """The child's work: run_draft on the prepared inputs, writing
    `out`.fasta; returns the arm's result."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.io.dazz_db import read_db
    from hinge_tpu_torch.io.las import read_las
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.stages.draft import run_draft

    dev = resolve_device(device)
    d = workdir
    rs = read_db(os.path.join(d, "X.db"))
    ov = read_las(os.path.join(d, "X.las"), read_lengths=rs.length)
    mx = np.zeros(rs.n_reads, bool)
    with open(os.path.join(d, "X.max")) as f:
        mx[[int(line.split()[0]) for line in f]] = True
    fasta = os.path.join(d, out + ".fasta")
    for k in BN.launches:
        BN.launches[k] = 0
    t0 = time.perf_counter()
    contigs = run_draft(rs, [ov], nominal_config(), mx,
                        os.path.join(d, "X.edges.list"), out_fasta=fasta,
                        device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    with open(fasta, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    lens = sorted((len(s) for _, s in contigs), reverse=True)
    return {"wall_s": wall, **card(dev), "n_contigs": len(contigs),
            "longest": lens[0] if lens else 0, "fasta_sha256": sha,
            "launches": {k: BN.launches[k] for k in KERNELS}}


def run_arm(workdir, pin_env, *, device, out):
    """One arm in a child process with `pin_env` set; raises when the
    child fails, times out or prints no result."""
    env = child_env()
    env.update(pin_env)
    r = subprocess.run(
        [sys.executable, "-m", "hinge_tpu_torch.bench.bench_draft_ab", "arm",
         workdir, str(device), out],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    for line in r.stdout.splitlines():
        if r.returncode == 0 and line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    raise RuntimeError(f"draft arm {out} failed (rc {r.returncode}): "
                       f"{r.stderr[-2000:] or 'no result line'}")


def compare(workdir, *, device) -> dict:
    """Both arms on the prepared `workdir`; on CUDA, raises unless the C
    arm launched no kernel and the band-NW arm all three."""
    dev = resolve_device(device)
    arms = {name: run_arm(workdir, pin, device=dev, out=f"X.{name}")
            for name, pin in ARMS.items()}
    if dev.type == "cuda":
        if any(arms["dw_banded_c"]["launches"].values()):
            raise AssertionError(f"the C arm launched band-NW kernels: "
                                 f"{arms['dw_banded_c']['launches']}")
        if not all(arms["band_nw"]["launches"].values()):
            raise AssertionError(f"the band-NW arm did not launch all "
                                 f"three kernels: {arms['band_nw']['launches']}")
    return arms


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "arm":
        res = arm(*argv[1:4])
        print("AB_RESULT " + json.dumps(res), flush=True)
        return res
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_draft_ab",
        description=__doc__.splitlines()[0])
    ap.add_argument("genome_len", nargs="?", type=int, default=4_600_000)
    ap.add_argument("coverage", nargs="?", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        prepare(wd, args.genome_len, args.coverage, device=dev)
        setup = time.perf_counter() - t0
        arms = compare(wd, device=dev)
    entry = {"kind": "draft_stage_ab", **card(dev),
             "workload": {"genome_mb": round(args.genome_len / 1e6, 2),
                          "coverage_x": args.coverage, "seed": 0,
                          **READ_ERRORS},
             "setup_s": setup, "arms": arms}
    for name, res in arms.items():
        print(name, "->", json.dumps(res), flush=True)
    if args.record:
        record(entry)
    print(("RECORDED " if args.record else "AB ") + json.dumps(entry),
          flush=True)
    return entry


if __name__ == "__main__":
    main()
