"""Write the repeat path's golden files and the yeast manifest with hinge_tpu.

    JAX_PLATFORMS=cpu python -m tests.make_golden_repeats [--golden] [--manifest]

--golden rewrites tests/golden_repeats/R.* (case (a)'s filter ->
draft-path files, seconds); --manifest rewrites
tests/golden_repeats/yeast_w303.json (simulating the 12.07 Mb yeast
workload and assembling it on the CPU: ~11 minutes and ~10 GB of host
memory).  With neither flag, both.  hinge_tpu is imported only inside the
functions, so importing this module needs no jax.
"""

import json
import os
import sys
import tempfile
import time

from tests import torch_golden_repeats as GR


def build_golden(out_dir: str) -> str:
    """hinge_tpu's filter -> draft-path on case (a) into `out_dir`; returns
    the prefix (the port's twin is torch_golden_repeats.build)."""
    import numpy as np

    from hinge_tpu.config import nominal_config
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.stages.clip import run_clip
    from hinge_tpu.stages.draft_path import run_draft_path
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import run_maximal

    _, _, rs, ov = simulate(GR.case_a_params(SimParams))
    cfg = nominal_config()
    prefix = os.path.join(out_dir, GR.PREFIX)
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    graphs = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1",
                      cfg, write_viz=False)
    run_draft_path(graphs["G2"], rs.length, out_edges_list=prefix + ".edges.list")
    return prefix


def write_golden(golden_dir: str = GR.GOLDEN_DIR) -> None:
    import shutil

    os.makedirs(golden_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        build_golden(tmp)
        for name in GR.GOLDEN_FILES:
            shutil.copy(os.path.join(tmp, name), os.path.join(golden_dir, name))


def build_manifest(tmp: str, log=print) -> dict:
    """Simulate the yeast workload with hinge_tpu, write it as FASTA +
    .las in `tmp`, assemble it there with the demo ini under
    HINGE_PARITY_ALIGN=1 with graphml by networkx's ElementTree serializer
    (torch_golden_repeats.etree_graphml), and describe every file."""
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.io.fasta import write_fasta
    from hinge_tpu.io.las import write_las
    from hinge_tpu.pipeline import assemble

    p = GR.yeast_params(SimParams)
    t0 = time.perf_counter()
    genome, _, rs, ov = simulate(p)
    fasta, las = os.path.join(tmp, "reads.fasta"), os.path.join(tmp, "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    n_reads, n_records = int(rs.n_reads), int(ov.n)
    del rs, ov
    log(f"simulated {n_reads} reads, {n_records} records "
        f"({time.perf_counter() - t0:.1f}s)")
    ini = os.path.join(tmp, "yeast.ini")
    with open(ini, "w") as f:
        f.write(GR.YEAST_DEMO_INI)
    wd = os.path.join(tmp, "asm")
    old = os.environ.get("HINGE_PARITY_ALIGN")
    os.environ["HINGE_PARITY_ALIGN"] = "1"
    try:
        t0 = time.perf_counter()
        with GR.etree_graphml():
            res = assemble(fasta=fasta, las=las, config=ini, workdir=wd,
                           log=lambda *a: None)
        log(f"assembled ({time.perf_counter() - t0:.1f}s)")
    finally:
        if old is None:
            os.environ.pop("HINGE_PARITY_ALIGN")
        else:
            os.environ["HINGE_PARITY_ALIGN"] = old
    G = res["graphs"].get("G3", res["graphs"]["G2"])
    lengths = sorted((len(s) for _, s in res["contigs"]), reverse=True)
    return {
        "what": "hinge_tpu.pipeline.assemble on the yeast W303-scale "
                "workload (tests/torch_golden_repeats.py), FASTA + .las, "
                "the demo ini, HINGE_PARITY_ALIGN=1, graphml by networkx's "
                "ElementTree serializer; written by "
                "tests/make_golden_repeats.py",
        "params": GR.params_record(p),
        "n_reads": n_reads, "n_records": n_records,
        "inputs": {n: GR.file_record(os.path.join(tmp, n))
                   for n in ("reads.fasta", "reads.las")},
        "files": {n: GR.file_record(os.path.join(wd, n))
                  for n in GR.workdir_files(wd)},
        "final_graph": "G3" if "G3" in res["graphs"] else "G2",
        "hinged_edges": GR.hinged_edges(G),
        "contigs": len(lengths), "longest": lengths[0] if lengths else 0,
        "coverage": GR.coverage_fractions(genome, res["contigs"], p),
    }


def write_manifest(path: str = GR.MANIFEST, log=print) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        man = build_manifest(tmp, log=log)
    with open(path, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
    return man


def main(argv) -> int:
    both = not ({"--golden", "--manifest"} & set(argv))
    if both or "--golden" in argv:
        write_golden()
        print(f"wrote {len(GR.GOLDEN_FILES)} files to {GR.GOLDEN_DIR}")
    if both or "--manifest" in argv:
        man = write_manifest()
        print(f"wrote {GR.MANIFEST}: {len(man['files'])} files, "
              f"{man['hinged_edges']} hinged edges, {man['contigs']} contigs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
