"""The port's version of tests/test_golden.py::_build.

filter -> maximal -> layout -> clip -> draft-path through hinge_tpu_torch
on a chosen device, on the golden dataset; the 11 files it writes must be
byte-equal to tests/golden/.  Imports neither jax nor hinge_tpu, so
chip_smoke.py can run it on the card.
"""

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
#: tests/test_golden.py's list of the files the five stages write
FILES = [
    "G.mas", "G.cmas", "G.repeat.txt", "G.hinges.txt", "G.max",
    "G.contained.txt", "G.edges.hinges", "G.edges.hinges2", "G.hinge.list",
    "G.killed.hinges", "G.edges.list",
]


#: tests/test_golden.py's dataset
PARAMS = dict(genome_len=30_000, coverage=14.0, mean_read_len=4000,
              std_read_len=900, seed=77)


def build(tmpdir: str, device, params=PARAMS, prefix="G") -> str:
    """The five stages on `params`' reads and overlaps into
    `tmpdir`/`prefix`.*; returns that prefix."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.stages.clip import run_clip
    from hinge_tpu_torch.stages.draft_path import run_draft_path
    from hinge_tpu_torch.stages.filter import run_filter
    from hinge_tpu_torch.stages.layout import load_marked, run_layout
    from hinge_tpu_torch.stages.maximal import run_maximal

    genome, reads, rs, ov = simulate(SimParams(**params))
    cfg = nominal_config()
    prefix = os.path.join(tmpdir, prefix)
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix, device=device)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix,
                       device=device)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix, device=device,
    )
    graphs = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1",
                      cfg, write_viz=False)
    run_draft_path(graphs["G2"], rs.length, out_edges_list=prefix + ".edges.list")
    return prefix


def mismatches(tmpdir: str, files=FILES, golden_dir=GOLDEN_DIR):
    """Golden files whose bytes differ from the ones build() wrote."""
    bad = []
    for f in files:
        with open(os.path.join(tmpdir, f), "rb") as got, \
                open(os.path.join(golden_dir, f), "rb") as want:
            if got.read() != want.read():
                bad.append(f)
    return bad
