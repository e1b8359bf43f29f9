"""Readings for the limits of a cell's comparison: the program's own
numbers over many seeds, and those of the control and the planted
faults (control.ARMS) over some of them, on the chip at the cell's own
size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        --arms votes_skipped,contigs_shuffled --arm-seeds 11,12

For each seed it makes the cell's inputs, runs one assemble() as the
program and, for the arms' seeds, one under each arm and every fault of
the outputs (control.ON_OUTPUTS) on the program's outputs, and prints
one JSON line of the reference's numbers each (`"arm": "program"` or the
arm's or fault's name).  The benchmark's own runs never enter an arm.  A limit
lies above the program's largest reading and below the smallest
reading of the arm that fails it (PERF.md gives the readings each limit
was set from).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spec  # noqa: E402

harness.pin_threads()
from benchmark import control  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--arms", default="")
    ap.add_argument("--arm-seeds", default="")
    args = ap.parse_args(argv)
    from benchmark.reference.judge import Reference
    from benchmark.traffic.generate import make_inputs

    bench = spec.benchmark()
    cell = spec.Cell(args.workload, bench)
    harness.cache_dirs(spec.ROOT)
    import torch  # noqa: F401

    harness.pin_threads()
    harness.build_port("cuda")
    arm_seeds = {int(x) for x in args.arm_seeds.split(",") if x}
    arm_names = [x for x in args.arms.split(",") if x]
    for name in arm_names:
        if name not in control.ARMS:
            raise SystemExit(f"no arm {name!r}; arms: {sorted(control.ARMS)}")
    for seed in (int(x) for x in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="hinge_calib_")
        try:
            paths, truth = make_inputs(cell.config, cell.mix, seed,
                                       os.path.join(tmp, "inputs"))
            harness.quiet_port_logger(os.path.join(tmp, "log"))
            ref = Reference(truth)
            arms = [("program", None)]
            if seed in arm_seeds:
                arms += [(name, control.ARMS[name]) for name in arm_names]
            for arm, ctx in arms:
                runner = harness.Runner(cell, paths, tmp)
                t0 = time.perf_counter()
                if ctx is None:
                    got = runner.call()
                else:
                    with ctx():
                        got = runner.call()
                row = {"cell": cell.name, "seed": seed, "arm": arm,
                       "wall_s": got[0] if got else None}
                if got:
                    out = runner.outputs[runner.digests[0]]
                    row.update(ref.judge(out))
                    row["contigs"] = sorted((len(x) for x in out["consensus"]),
                                            reverse=True)[:12]
                row["elapsed_s"] = time.perf_counter() - t0
                print(json.dumps(row), flush=True)
                if arm != "program" or seed not in arm_seeds or not got:
                    continue
                for name, (fault, numbers) in control.ON_OUTPUTS.items():
                    t0 = time.perf_counter()
                    row = {"cell": cell.name, "seed": seed, "arm": name,
                           **ref.judge(fault(out), only=numbers),
                           "elapsed_s": time.perf_counter() - t0}
                    print(json.dumps(row), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
