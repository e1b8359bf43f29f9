"""The `hinge` verb table of bin/hinge, pointed at the port's CLI.

Maps the reference's subcommand surface (`src/hinge:8-58`) onto
hinge_tpu_torch.cli, so a user of the reference invokes the same verbs:

    python -m hinge_tpu_torch.hinge filter --db X --las X.las -x X --config nominal.ini
    python -m hinge_tpu_torch.hinge clip X.edges.hinges X.hinge.list 1
    ...

An unknown verb prints the hinge(1) pointer and exits 1, like the
reference.  The verbs that reach a device op take --device (default cuda).
"""

import sys

#: bin/hinge's VERBS table: reference verb -> the CLI's subcommand
VERBS = {
    "filter": ["filter"],
    "maximal": ["maximal"],
    "layout": ["layout"],
    "clip": ["clip"],
    "clip-nanopore": ["clip-nanopore"],
    "draft-path": ["draft-path"],
    "draft": ["draft"],
    "correct-head": ["correct-head"],
    "correct_head": ["correct-head"],
    "consensus": ["consensus"],
    "fasta2q": ["fasta2q"],
    "gfa": ["gfa"],
    "visualize": ["visualize"],
    "visualise": ["visualize"],
    "condense": ["condense"],
    "split_las": ["split_las"],
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in VERBS:
        print("See hinge(1) for usage information.", file=sys.stderr)
        return 1
    from hinge_tpu_torch.cli import main as cli_main

    return cli_main(VERBS[argv[0]] + argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
