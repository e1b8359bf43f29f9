"""Port of hinge_tpu/utils/sweep.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, the device passed down to every assembly, and the
reference source tree of the parity column taken from REF (the variable
refbuild/build.sh reads).

Accuracy sweep: assemble a grid of simulated genomes and report
contiguity per cell — the framework's equivalent of the reference's NCTC
batch report (the reference's README.md:175,
scripts/compute_n50_from_draft.py:8-27 over batch directories), runnable
offline against the simulator instead of downloaded datasets.

One command:  python -m hinge_tpu_torch.cli sweep --out accuracy_sweep --device cuda
writes <out>.json (machine) and <out>.md (human) with, per cell:
N50, contig count, longest-contig fraction of the genome, assembled-base
fraction, and the assemble() wall.  The grid crosses repeat structure x
coverage x read length; every cell must assemble (cells that raise are
reported as failed rather than aborting the sweep).  An error of the device
itself (no card, a kernel that fails to build or launch, a CUDA runtime
error) is not a failed cell: it propagates and ends the sweep.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: (name, repeats builder[, expect_hinges]) — repeat tuples are
#: (src_start, dst_start, len).  A profile with expect_hinges=True carries
#: a repeat LONGER than every read (unbridgeable): HINGE's headline
#: capability (the reference's README.md:168-173) is resolving exactly
#: these, so the cell FAILS (at cov >= 20, where the support thresholds
#: can trigger) unless the final graph contains hinged edges —
#: a broken hinge path cannot pass this report (2-3kb repeats are all
#: read-bridged, so they alone leave the repeat axis inert).
REPEAT_PROFILES: List[Tuple] = [
    ("plain", lambda L: ()),
    ("repeat1", lambda L: ((L // 8, L // 2, 3_000),)),
    ("dense", lambda L: ((L // 10, L // 2, 3_000),
                         (L // 5, 7 * L // 10, 2_500),
                         (3 * L // 10, 4 * L // 5, 2_000))),
    # 25kb repeat vs <=8kb reads — the test_repeat_resolution.py structure
    ("unbridged", lambda L: ((L // 8, L // 2, 25_000),), True),
]

COVERAGES = (15.0, 30.0)
READ_LENS = (4_500, 8_000)


def _cell(genome_len: int, cov: float, rlen: int, repeats, seed: int,
          expect_hinges: bool = False, *, device) -> Dict:
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.graph.analysis import comp_n50
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.pipeline import assemble

    p = SimParams(genome_len=genome_len, coverage=cov, mean_read_len=rlen,
                  std_read_len=max(600, rlen // 5), seed=seed,
                  repeats=repeats)
    genome, reads, rs, ov = simulate(p)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, ((rs.names[i], rs.get_seq(i))
                            for i in range(rs.n_reads)))
        n_reads = rs.n_reads
        del reads, rs, ov
        t0 = time.perf_counter()
        res = assemble(fasta=fasta, workdir=tmp, log=lambda *a: None,
                       device=device)
        wall = time.perf_counter() - t0
    lengths = sorted((len(s) for _, s in res["contigs"]), reverse=True)
    longest = lengths[0] if lengths else 0
    G = res["graphs"].get("G3", res["graphs"]["G2"])
    hinged = sum(1 for _, _, d in G.edges(data=True)
                 if d.get("hinge_edge") == 1)
    out = {
        "n_reads": n_reads,
        "n_contigs": len(lengths),
        "n50": comp_n50(lengths),
        "longest_frac": round(longest / genome_len, 3),
        "assembled_frac": round(sum(lengths) / genome_len, 3),
        "hinged_edges": hinged,
        "wall_s": round(wall, 1),
    }
    # the hinge-support thresholds (HINGE_MIN_SUPPORT=7 etc.) need
    # adequate coverage to trigger; at cov15 even the reference's own
    # parameters leave long-repeat boundaries below support, so the hard
    # failure is scoped to cov >= 20 (lower-coverage cells still REPORT
    # hinged_edges so a regression remains visible in the table)
    if expect_hinges and cov >= 20 and hinged == 0:
        raise AssertionError(
            "unbridged-repeat cell produced no hinged edges in the final "
            "graph — the hinge calling/filtering/layout path is broken "
            f"(metrics were {out})")
    return out


#: stage files byte-compared against the reference binaries per parity cell
_PARITY_FILTER = ["X.mas", "X.cmas", "X.coverage.txt", "X.repeat.txt",
                  "X.hinges.txt", "X.cov.flag", "X.self.flag",
                  "X.homologous.txt"]
_PARITY_MAXIMAL = ["X.max", "X.contained.txt"]
_PARITY_HINGING = ["X.edges.hinges", "X.edges.hinges2", "X.hinge.list",
                   "X.killed.hinges", "X.edges.1", "X.edges.2",
                   "X.edges.greedy", "X.edges.skipped", "X.deadends.txt",
                   "X.hgraph"]


def _ref_parity_cell(rname: str, repeats, seed: int,
                     genome_len: int = 60_000, cov: float = 20.0,
                     rlen: int = 4_500, *, device) -> Dict:
    """One reference-binary parity check per repeat profile: both
    pipelines consume the identical simulated X.db/X.las; every filter/
    maximal/hinging stage file must byte-match, the reference
    draft_assembly consumes the port's X.edges.list, and the two draft
    FASTAs (and their N50s) must be identical: the accuracy report's
    per-profile reference-parity column."""
    import shutil
    import subprocess

    from hinge_tpu_torch.cli import main as cli_main
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.graph.analysis import comp_n50
    from hinge_tpu_torch.io.dazz_db import write_db
    from hinge_tpu_torch.io.las import write_las

    # the reference source tree, named by REF as refbuild/build.sh reads it
    ref_src = os.environ.get("REF", "")
    if not ref_src:
        return {"ok": False, "error": "REF is not set: the reference "
                "source tree that refbuild/build.sh compiles"}
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    refbuild = os.path.join(repo, "refbuild")
    r = subprocess.run(["bash", os.path.join(refbuild, "build.sh")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        return {"ok": False, "error": "refbuild failed: " + r.stderr[-300:]}
    bins = os.path.join(refbuild, "bin")

    def run_ref(d, binary, *extra):
        rr = subprocess.run(
            [os.path.join(bins, binary), "--db", "X", "--las", "X.las",
             "-x", "X", "--config", "nominal.ini", *extra],
            cwd=d, capture_output=True, text=True, timeout=300)
        if rr.returncode != 0:
            raise RuntimeError(f"{binary}: rc={rr.returncode} "
                               f"{rr.stderr[-200:]}")

    def run_host(d, argv):
        old = os.getcwd()
        os.chdir(d)
        try:
            rc = cli_main(argv)
            if rc != 0:
                raise RuntimeError(f"cli {argv[0]} rc={rc}")
        finally:
            os.chdir(old)

    def run_mine(d, argv):
        run_host(d, argv + ["--device", str(device)])

    with tempfile.TemporaryDirectory() as base:
        ref_d = os.path.join(base, "ref")
        my_d = os.path.join(base, "mine")
        os.makedirs(ref_d)
        os.makedirs(my_d)
        p = SimParams(genome_len=genome_len, coverage=cov,
                      mean_read_len=rlen, std_read_len=max(600, rlen // 5),
                      seed=seed, repeats=repeats)
        genome, reads, rs, ov = simulate(p)
        write_db(os.path.join(ref_d, "X.db"), rs)
        write_las(os.path.join(ref_d, "X.las"), ov)
        shutil.copy(os.path.join(ref_src, "utils", "nominal.ini"),
                    os.path.join(ref_d, "nominal.ini"))
        for f in os.listdir(ref_d):
            os.link(os.path.join(ref_d, f), os.path.join(my_d, f))

        run_ref(ref_d, "Reads_filter")
        run_mine(my_d, ["filter", "--db", "X", "--las", "X.las",
                        "--prefix", "X", "--config", "nominal.ini"])
        run_ref(ref_d, "get_maximal_reads")
        run_mine(my_d, ["maximal", "--db", "X", "--las", "X.las",
                        "--prefix", "X", "--config", "nominal.ini"])
        run_ref(ref_d, "hinging", "-o", "X")
        run_mine(my_d, ["layout", "--db", "X", "--las", "X.las",
                        "--prefix", "X", "--config", "nominal.ini",
                        "--out", "X"])
        files = _PARITY_FILTER + _PARITY_MAXIMAL + _PARITY_HINGING
        n_eq = 0
        first_diff = ""
        for name in files:
            fa, fb = os.path.join(ref_d, name), os.path.join(my_d, name)
            if (os.path.exists(fa) and os.path.exists(fb)
                    and open(fa, "rb").read() == open(fb, "rb").read()):
                n_eq += 1
            elif not first_diff:
                first_diff = name

        run_host(my_d, ["clip", "X.edges.hinges", "X.hinge.list", "1"])
        run_host(my_d, ["draft-path", ".", "X", "X1.G2.graphml",
                        "--db", "X"])
        shutil.copy(os.path.join(my_d, "X.edges.list"),
                    os.path.join(ref_d, "X.edges.list"))
        run_ref(ref_d, "draft_assembly", "--out", "X.draft",
                "--path", "X.edges.list")
        run_mine(my_d, ["draft", "--db", "X", "--las", "X.las",
                        "--prefix", "X", "--config", "nominal.ini",
                        "--out", "X.draft"])
        fa = open(os.path.join(ref_d, "X.draft.fasta"), "rb").read()
        fb = open(os.path.join(my_d, "X.draft.fasta"), "rb").read()
        draft_equal = fa == fb
    lens_ref = _fasta_lengths(fa)
    lens_my = _fasta_lengths(fb)
    return {
        "ok": n_eq == len(files) and draft_equal,
        "stage_files_equal": f"{n_eq}/{len(files)}",
        "first_diff": first_diff,
        "draft_fasta_equal": draft_equal,
        "n50_ref": comp_n50(lens_ref),
        "n50_mine": comp_n50(lens_my),
    }


def _fasta_lengths(raw: bytes):
    lens, cur = [], 0
    for line in raw.split(b"\n"):
        if line.startswith(b">"):
            if cur:
                lens.append(cur)
            cur = 0
        else:
            cur += len(line.strip())
    if cur:
        lens.append(cur)
    return sorted(lens, reverse=True)


def run_sweep(genome_len: int = 400_000, seed: int = 0,
              out_prefix: Optional[str] = None,
              log=print, ref_parity: bool = False, *, device) -> Dict:
    from hinge_tpu_torch.device import is_device_error

    cells = []
    for prof in REPEAT_PROFILES:
        rname, rfn = prof[0], prof[1]
        expect_hinges = bool(prof[2]) if len(prof) > 2 else False
        for cov in COVERAGES:
            for rlen in READ_LENS:
                key = f"{rname}/cov{cov:g}/len{rlen}"
                try:
                    m = _cell(genome_len, cov, rlen, rfn(genome_len), seed,
                              expect_hinges=expect_hinges, device=device)
                    m["ok"] = True
                except Exception as e:  # report, don't abort the sweep
                    if is_device_error(e):
                        raise
                    m = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                m["cell"] = key
                m["repeats"] = rname
                m["coverage"] = cov
                m["read_len"] = rlen
                cells.append(m)
                log(f"[sweep] {key}: " + (
                    f"n50={m['n50']} contigs={m['n_contigs']} "
                    f"longest={m['longest_frac']} hinged={m['hinged_edges']} "
                    f"({m['wall_s']}s)"
                    if m["ok"] else m["error"]))
    parity = []
    if ref_parity:
        for prof in REPEAT_PROFILES:
            rname, rfn = prof[0], prof[1]
            glen = 60_000
            try:
                pm = _ref_parity_cell(rname, rfn(glen), seed, genome_len=glen,
                                      device=device)
            except Exception as e:
                if is_device_error(e):
                    raise
                pm = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            pm["profile"] = rname
            parity.append(pm)
            log(f"[sweep/parity] {rname}: " + (
                f"stage files {pm.get('stage_files_equal')} draft_equal="
                f"{pm.get('draft_fasta_equal')} n50 {pm.get('n50_ref')}=="
                f"{pm.get('n50_mine')}" if pm["ok"]
                else pm.get("error", "differs: "
                            + str(pm.get("first_diff")))))
    report = {
        "genome_len": genome_len,
        "seed": seed,
        "date": time.strftime("%Y-%m-%d"),
        "cells": cells,
        "n_ok": sum(1 for c in cells if c["ok"]),
        "n_cells": len(cells),
    }
    if parity:
        report["ref_parity"] = parity
        report["ref_parity_ok"] = sum(1 for c in parity if c["ok"])
    if out_prefix:
        with open(out_prefix + ".json", "w") as f:
            json.dump(report, f, indent=1)
        with open(out_prefix + ".md", "w") as f:
            f.write(_to_markdown(report))
        log(f"[sweep] wrote {out_prefix}.json / .md")
    return report


def _to_markdown(report: Dict) -> str:
    lines = [
        f"# Accuracy sweep — {report['genome_len']/1e6:g}Mb genomes, "
        f"seed {report['seed']} ({report['date']})",
        "",
        "Per-cell contiguity of `assemble()` across repeat structure x "
        "coverage x read length (the NCTC-batch-report equivalent, run on "
        "the built-in simulator).  Contig counts/fractions include BOTH "
        "strands per assembled sequence (the pipeline emits forward + "
        "reverse-complement contigs adjacently, like the reference draft "
        "stage), so a perfectly assembled circular genome reads as 2 "
        "contigs and assembled/genome ~ 2.0.",
        "",
        "The `unbridged` profile carries a 25kb exact repeat LONGER than "
        "every read — HINGE's headline capability is resolving exactly "
        "these (reference README.md:168-173); its cov>=20 cells FAIL "
        "unless the final graph contains hinged edges, so a broken hinge "
        "path cannot pass this report (cov15 cells sit below the "
        "HINGE_MIN_SUPPORT thresholds and report the count only).",
        "",
        "| cell | reads | contigs | N50 | longest/genome | assembled/genome | hinged edges | wall |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in report["cells"]:
        if c["ok"]:
            lines.append(
                f"| {c['cell']} | {c['n_reads']} | {c['n_contigs']} | "
                f"{c['n50']} | {c['longest_frac']} | {c['assembled_frac']} | "
                f"{c.get('hinged_edges', '—')} | {c['wall_s']}s |")
        else:
            lines.append(
                f"| {c['cell']} | — | — | — | — | — | — | {c['error']} |")
    lines.append("")
    lines.append(f"{report['n_ok']}/{report['n_cells']} cells assembled.")
    lines.append("")
    if report.get("ref_parity"):
        lines += [
            "## Reference-binary parity (one scale: 60kb / cov20 / 4.5kb reads)",
            "",
            "Both pipelines consume the identical simulated `X.db`/`X.las`; "
            "all 20 filter/maximal/hinging stage files are byte-compared, "
            "the reference `draft_assembly` consumes hinge_tpu_torch's "
            "`X.edges.list`, and the draft FASTAs + N50s must match.",
            "",
            "| profile | stage files byte-equal | draft fasta | N50 (ref == ours) |",
            "|---|---|---|---|",
        ]
        for c in report["ref_parity"]:
            if "error" in c:
                lines.append(f"| {c['profile']} | — | — | {c['error']} |")
            else:
                lines.append(
                    f"| {c['profile']} | {c['stage_files_equal']}"
                    f"{(' (first diff: ' + c['first_diff'] + ')') if c['first_diff'] else ''} | "
                    f"{'identical' if c['draft_fasta_equal'] else 'DIFFERS'} | "
                    f"{c['n50_ref']} == {c['n50_mine']} |")
        lines.append("")
        lines.append(f"{report['ref_parity_ok']}/{len(report['ref_parity'])} "
                     "profiles fully parity-clean.")
        lines.append("")
    return "\n".join(lines)
