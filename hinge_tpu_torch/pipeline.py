"""One-shot end-to-end assembly driver on a torch device.

Port of `hinge_tpu/pipeline.py`:

    filter -> maximal -> layout -> clip -> draft-path -> draft ->
    correct-head -> map (built-in) -> consensus -> gfa

Each stage writes the reference's intermediate files into the workdir, as
in hinge_tpu.  The device is explicit: `device="cuda"` (the default) needs
a CUDA card and raises without one; `device="cpu"` runs every device op
as plain torch on the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np


def assemble(
    fasta: str = "",
    paf: str = "",
    db: str = "",
    las: str = "",
    config: str = "",
    workdir: str = ".",
    nanopore: bool = False,
    norevcomp: bool = False,
    prefix: str = "asm",
    log=print,
    trace_dir: str = "",
    overlap_w: int = 12,
    device="cuda",
    join_stats: Optional[dict] = None,
) -> dict:
    """Assemble reads (+ overlaps) into X_consensus.gfa on `device`.

    Arguments as for hinge_tpu.pipeline.assemble; trace_dir, when set,
    wraps the run in a torch profiler trace written there; join_stats,
    when given, gathers the device join's per-phase stats
    (device_join.overlap_base_records).  Per-stage wall times accumulate
    in hinge_tpu_torch.utils.log.timings()."""
    from hinge_tpu_torch.config import Config, nominal_config
    from hinge_tpu_torch.device import resolve_device
    from hinge_tpu_torch.utils.log import get_logger, stage_timer, torch_trace

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    p = os.path.join(workdir, prefix)
    cfg = Config.from_ini(config) if config else nominal_config()
    logger = get_logger(os.path.join(workdir, "log"))
    if log is print:
        # default: the logger's stdout+file dual sink is the console output
        log = logger.info
    else:
        _log = log

        def log(msg):
            _log(msg)
            logger.info(msg)

    with torch_trace(trace_dir):
        return _assemble_body(
            fasta, paf, db, las, workdir, nanopore, norevcomp, p, cfg, log,
            stage_timer, overlap_w, dev, join_stats,
        )


def _assemble_body(fasta, paf, db, las, workdir, nanopore, norevcomp, p, cfg,
                   log, stage_timer, overlap_w, device,
                   join_stats=None) -> dict:
    from hinge_tpu_torch.data.overlaps import str_to_codes
    from hinge_tpu_torch.io.dazz_db import read_db
    from hinge_tpu_torch.io.fasta import correct_head, read_fasta
    from hinge_tpu_torch.io.las import read_las
    from hinge_tpu_torch.io.paf import read_paf
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.stages.clip import run_clip
    from hinge_tpu_torch.stages.draft_path import run_draft_path
    from hinge_tpu_torch.stages.gfa import run_gfa
    from hinge_tpu_torch.stages.consensus import run_consensus
    from hinge_tpu_torch.stages.draft import run_draft
    from hinge_tpu_torch.stages.filter import run_filter
    from hinge_tpu_torch.stages.layout import load_marked, run_layout
    from hinge_tpu_torch.stages.maximal import run_maximal

    t0 = time.time()
    if db:
        rs = read_db(db)
    elif fasta:
        rs = read_fasta(fasta)
    else:
        raise ValueError("need --fasta or --db")
    if las:
        parts = [read_las(las, read_lengths=rs.length)]
    elif paf:
        parts = [read_paf(paf)]
    else:
        # no overlapper output provided: run the built-in all-vs-all
        # overlapper (the device join on CUDA, the C join on the CPU;
        # mapper.use_device_join)
        from hinge_tpu_torch.overlap.mapper import overlap_reads

        t_ovl = time.time()
        with stage_timer("overlap"):
            parts = [overlap_reads(rs, w=overlap_w, device=device,
                                   stats=join_stats)]
        log(f"[assemble] built-in overlapper: {parts[0].n} overlaps "
            f"({time.time()-t_ovl:.1f}s)")
    has_db = bool(las) or not paf
    log(f"[assemble] {rs.n_reads} reads, {sum(x.n for x in parts)} overlaps "
        f"on {device} ({time.time()-t0:.1f}s)")

    t = time.time()
    with stage_timer("filter"):
        fres = run_filter(rs, parts, cfg, out_prefix=p, device=device)
    log(f"[assemble] filter done ({time.time()-t:.1f}s)")

    t = time.time()
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    with stage_timer("maximal"):
        mres = run_maximal(rs, parts, cfg, eff_s, eff_e, out_prefix=p,
                           has_db=has_db, device=device)
    log(f"[assemble] maximal: {int(mres.active.sum())}/{rs.n_reads} reads "
        f"({time.time()-t:.1f}s)")

    t = time.time()
    with stage_timer("layout"):
        lres = run_layout(
            rs, parts, cfg, eff_s, eff_e, mres.active,
            load_marked(p + ".repeat.txt"), load_marked(p + ".hinges.txt"),
            out_prefix=p, filter_prefix=p, has_db=has_db, device=device,
        )
    log(f"[assemble] layout: {len(lres.edges_hinges)} edges ({time.time()-t:.1f}s)")

    t = time.time()
    with stage_timer("clip"):
        graphs = run_clip(p + ".edges.hinges", p + ".hinge.list", "1", cfg,
                          nanopore=nanopore, write_viz=False)
    G_final = graphs.get("G3", graphs["G2"])
    log(f"[assemble] clip: {len(G_final)} graph nodes ({time.time()-t:.1f}s)")

    t = time.time()
    with stage_timer("draft_path"):
        lines, _ = run_draft_path(
            G_final, rs.length,
            out_edges_list=p + ".edges.list", out_graphml=p + "_draft.graphml",
        )
    with stage_timer("draft"):
        contigs = run_draft(rs, parts, cfg, mres.active, lines,
                            out_fasta=p + ".draft.fasta", device=device)
    log(f"[assemble] draft: {len(contigs)} contigs ({time.time()-t:.1f}s)")

    t = time.time()
    draft_fasta = p + ".draft.fasta"
    cons_fasta = p + ".consensus.fasta"
    if norevcomp:
        from hinge_tpu_torch.io.fasta import select_single_strand

        draft_fasta = p + ".draft.norevcomp.fasta"
        select_single_strand(p + ".draft.fasta", draft_fasta, mode="even")
        contigs = contigs[::2]
        cons_fasta = p + ".norevcomp_consensus.fasta"
    correct_head(draft_fasta, p + ".draft.pb.fasta",
                 os.path.join(workdir, "draft_map.txt"))
    targets = [str_to_codes(seq) for _, seq in contigs]
    with stage_timer("map"):
        aln = map_reads_to_targets(targets, rs)
    with stage_timer("consensus"):
        cons = run_consensus(contigs, rs, aln, cfg, out_fasta=cons_fasta,
                             device=device)
    log(f"[assemble] consensus: {len(cons)} contigs ({time.time()-t:.1f}s)")

    with stage_timer("gfa"):
        gfa_lines = run_gfa(
            p + "_draft.graphml", os.path.join(workdir, "draft_map.txt"),
            cons_fasta,
            out_gfa=p + "_consensus.gfa",
        )
    log(f"[assemble] total {time.time()-t0:.1f}s -> {p}_consensus.gfa")
    return dict(contigs=cons, draft=contigs, graphs=graphs, gfa=gfa_lines)
