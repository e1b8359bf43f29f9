"""Command-line entry of the torch/CUDA port.

    python -m hinge_tpu_torch.cli assemble --fasta reads.fasta --las reads.las \\
        --workdir out --device cuda [--timings] [--trace DIR]

Only the one-shot `assemble` subcommand is ported; it takes hinge_tpu's
`assemble` flags plus --device.  The per-stage subcommands wait (ROADMAP
queue item 1); `python -m hinge_tpu.cli` keeps them.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def cmd_assemble(args):
    """One-shot pipeline: reads + overlaps -> consensus GFA."""
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import timings

    assemble(
        fasta=args.fasta, paf=args.paf, db=args.db, las=args.las,
        config=args.config, workdir=args.workdir, nanopore=args.nanopore,
        norevcomp=args.norevcomp, trace_dir=args.trace, device=args.device,
    )
    if args.timings:
        for name, dt in timings().items():
            print(f"[timing] {name}: {dt:.2f}s")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="hinge-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("assemble")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--paf", default="")
    sp.add_argument("--db", default="")
    sp.add_argument("--las", default="")
    sp.add_argument("--config", "-c", default="")
    sp.add_argument("--workdir", "-w", default=".")
    sp.add_argument("--nanopore", action="store_true")
    sp.add_argument("--norevcomp", action="store_true")
    sp.add_argument("--trace", default="",
                    help="write a torch profiler trace to this dir")
    sp.add_argument("--timings", action="store_true",
                    help="print per-stage wall times at the end")
    sp.add_argument("--device", default="cuda",
                    help="torch device for the device stages (default cuda; "
                    "cpu runs their plain torch versions)")
    sp.set_defaults(func=cmd_assemble)
    args = ap.parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
