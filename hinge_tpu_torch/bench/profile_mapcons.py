"""Port of `profile_mapcons.py`: cProfile of the host stages, extended from map and consensus to clip and draft.

The JAX script profiles map + consensus with the true genome as the
draft.  This twin runs the whole pipeline (`pipeline.assemble`'s body)
on the 4.6 Mb / 30x workload with read errors (chip_smoke.py phase 5's:
reads + .las) and profiles four of its stages in their real context:
`run_clip`, `run_draft` (ladder building, the falcon vote, band-NW row
emission), `map_reads_to_targets` (onto the draft's contigs) and
`run_consensus`.  For each it prints the stage wall and a per-function
table, the top 20 by cumulative seconds, with own seconds and calls.
As in the JAX script, passing --device puts the consensus vote on that
device (HINGE_DEVICE_VOTE=1); without it the device ops run on cuda and
the vote on the host.

    python -m hinge_tpu_torch.bench.profile_mapcons [genome_len] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import os
import pstats
import tempfile
import time

from hinge_tpu_torch.bench import READ_ERRORS, card, sync
from hinge_tpu_torch.device import resolve_device

PROFILED = ("clip", "draft", "map", "consensus")
TOP = 20


def table(prof: cProfile.Profile):
    """[(cumulative s, own s, calls, function)] of the TOP functions by
    cumulative seconds."""
    rows = []
    for (path, line, func), (_, calls, own, cum, _) in pstats.Stats(prof).stats.items():
        where = func if path == "~" else f"{func} ({_short(path)}:{line})"
        rows.append((cum, own, calls, where))
    rows.sort(key=lambda r: -r[0])
    return rows[:TOP]


def _short(path):
    parts = path.split(os.sep)
    for anchor in ("hinge_tpu_torch", "site-packages", "dist-packages"):
        if anchor in parts:
            return "/".join(parts[parts.index(anchor) + (anchor != "hinge_tpu_torch"):])
    return "/".join(parts[-2:])


def profile(genome_len, coverage, *, device, device_vote=False,
            log=lambda *a: None):
    """Run the pipeline on the simulated workload (the consensus vote on
    `device` when `device_vote`); returns ({stage: wall}, {stage: table})
    for the PROFILED stages."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las
    from hinge_tpu_torch.pipeline import _assemble_body
    from hinge_tpu_torch.utils.log import stage_timer

    dev = resolve_device(device)
    walls, tables = {}, {}

    @contextlib.contextmanager
    def profiled(name, logger=None):
        prof = cProfile.Profile() if name in PROFILED else None
        t0 = time.perf_counter()
        with stage_timer(name, logger):
            if prof:
                prof.enable()
            try:
                yield
            finally:
                if prof:
                    prof.disable()
                    sync(dev)
                    walls[name] = time.perf_counter() - t0
                    tables[name] = table(prof)

    with tempfile.TemporaryDirectory() as tmp:
        _, _, rs, ov = simulate(SimParams(genome_len=genome_len,
                                          coverage=coverage, seed=0,
                                          **READ_ERRORS))
        fasta, las = os.path.join(tmp, "reads.fasta"), os.path.join(tmp, "reads.las")
        write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
        write_las(las, ov)
        del rs, ov
        wd = os.path.join(tmp, "asm")
        os.makedirs(wd)
        vote = os.environ.get("HINGE_DEVICE_VOTE")
        if device_vote:
            os.environ["HINGE_DEVICE_VOTE"] = "1"
        try:
            _assemble_body(fasta, "", "", las, wd, False, False,
                           os.path.join(wd, "asm"), nominal_config(), log,
                           profiled, 12, dev)
        finally:
            if vote is None:
                os.environ.pop("HINGE_DEVICE_VOTE", None)
            else:
                os.environ["HINGE_DEVICE_VOTE"] = vote
    return walls, tables


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.profile_mapcons",
        description=__doc__.splitlines()[0])
    ap.add_argument("genome_len", nargs="?", type=int, default=4_600_000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda")
    vote = args.device is not None
    print(json.dumps({**card(dev), "device_vote": vote}), flush=True)
    walls, tables = profile(args.genome_len, 30.0, device=dev,
                            device_vote=vote,
                            log=lambda *a: print(*a, flush=True))
    for stage in PROFILED:
        print(f"\n[{stage}] {walls[stage]:.3f}s under cProfile; top {TOP} "
              f"by cumulative s", flush=True)
        print(f"{'cum s':>9} {'own s':>9} {'calls':>9}  function")
        for cum, own, calls, where in tables[stage]:
            print(f"{cum:9.3f} {own:9.3f} {calls:9d}  {where}")
    print(json.dumps({"profile_walls_s": walls}), flush=True)
    return walls, tables


if __name__ == "__main__":
    main()
