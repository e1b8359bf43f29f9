"""Copied from hinge_tpu/stages/gfa.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Stage 9 — GFA export (`hinge gfa`, reference `scripts/get_consensus_gfa.py`).

Joins consensus contigs back onto the draft graph via draft_map.txt
(rows marked Deleted by correct-head shift contig indices, :43-59) and
writes GFA1: one S line per kept node, `L +/+ 0M` per edge (:79-92).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import networkx as nx


def run_gfa(
    draft_graphml_path: str,
    draft_map_path: str,
    consensus_fasta_path: str,
    out_gfa: Optional[str] = None,
) -> List[str]:
    g = nx.read_graphml(draft_graphml_path)

    del_contigs = []
    with open(draft_map_path) as f:
        for idx, line in enumerate(f):
            t = line.split()
            if len(t) >= 2 and t[1] == "Deleted":
                del_contigs.append(idx)

    consensus_contigs: List[str] = []
    del_ptr = 0
    with open(consensus_fasta_path) as f:
        for line in f:
            if line[0] != ">":
                while del_ptr < len(del_contigs):
                    if len(consensus_contigs) == del_contigs[del_ptr]:
                        consensus_contigs.append("")
                        del_ptr += 1
                    else:
                        break
                consensus_contigs.append(line.strip())

    nodes_to_keep = [
        x
        for x in g.nodes()
        if int(g.nodes[x].get("contig_id", -1)) < len(consensus_contigs)
        and int(g.nodes[x].get("contig_id", -1)) >= 0
        and consensus_contigs[int(g.nodes[x]["contig_id"])] != ""
    ]
    h = g.subgraph(nodes_to_keep)

    lines = ["H\tVN:Z:1.0"]
    for vert in h.nodes():
        i = int(h.nodes[vert]["contig_id"])
        lines.append(f"S\t{vert}\t{consensus_contigs[i]}")
    for u, v in h.edges():
        lines.append(f"L\t{u}\t+\t{v}\t+\t0M")

    if out_gfa is not None:
        with open(out_gfa, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
    return lines
