"""Copied from hinge_tpu/graph/groundtruth.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Ground-truth annotation: map reads to a reference and color the graph.

Reference workflow: `scripts/run_mapping.py:13-41` maps reads to a
reference with a DALIGNER fork (LA4Awesome) and writes `X.mapping.json`;
`add_groundtruth` (pruning_and_clipping.py:894-1018) then colors nodes by
chromosome/position and marks `false_positive` edges — HINGE's accuracy
evaluation mechanism (SURVEY.md §4).

Here the mapping comes from the built-in minimizer mapper, and the color
scheme uses a fixed RGB table (the reference pulls matplotlib color names).
mapping.json format matches the reference consumer: read-id string ->
[[aln_start, aln_end, chr_index], ...].
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Set

import networkx as nx
import numpy as np

# matplotlib color-name RGBs used by the reference (pruning:986)
_COLOUR_LIST = [
    (255, 0, 0), (124, 252, 0), (0, 191, 255), (255, 20, 147),
    (255, 140, 0), (128, 0, 128), (255, 215, 0), (0, 0, 205),
    (139, 69, 19), (0, 100, 0),
]


def run_mapping(reads_store, reference_store, out_json: Optional[str] = None) -> Dict:
    """Map every read to the reference contigs; write mapping.json."""
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets

    targets = [reference_store.get_bases(i) for i in range(reference_store.n_reads)]
    aln = map_reads_to_targets(targets, reads_store, min_span=500)
    mapping: Dict[str, List[List[int]]] = {}
    # keep the longest hit per read first (the reference consumer reads [0])
    order = np.argsort(-(aln.a_end - aln.a_start), kind="stable")
    for k in order:
        rid = str(int(aln.b_id[k]))
        ent = [int(aln.a_start[k]), int(aln.a_end[k]), int(aln.a_id[k])]
        mapping.setdefault(rid, []).append(ent)
    if out_json is not None:
        with open(out_json, "w") as f:
            json.dump(mapping, f)
    return mapping


def add_groundtruth(
    g: nx.DiGraph, mapping: Dict, in_hinges: Set[str], out_hinges: Set[str]
) -> nx.DiGraph:
    """pruning_and_clipping.py:894-1018 — chr/aln coords/normpos/color per
    node + false_positive flags per edge."""
    chr_length: Dict[int, int] = {}
    for node in g.nodes():
        base = node.split("_")[0].lstrip("B")
        g.nodes[node]["normpos"] = 0
        if base in mapping:
            g.nodes[node]["chr"] = mapping[base][0][2] + 1
            g.nodes[node]["aln_start"] = min(mapping[base][0][0], mapping[base][0][1])
            g.nodes[node]["aln_end"] = max(mapping[base][0][0], mapping[base][0][1])
        else:
            g.nodes[node]["chr"] = 0
            g.nodes[node]["aln_start"] = 1
            g.nodes[node]["aln_end"] = 1
        g.nodes[node]["hinge"] = 1 if (node in in_hinges or node in out_hinges) else 0
        c = g.nodes[node]["chr"]
        chr_length[c] = max(chr_length.get(c, 1), g.nodes[node]["aln_end"])

    chr_set = [c for c, _ in sorted(chr_length.items(), key=lambda kv: -kv[1])]
    max_chr_len1 = max(g.nodes[x]["aln_end"] for x in g.nodes()) if len(g) else 1
    mult = 10 ** len(str(max_chr_len1))
    for index, chrom in enumerate(chr_set):
        nodes = [x for x in g.nodes() if g.nodes[x]["chr"] == chrom]
        if not nodes:
            continue
        max_len = max(g.nodes[x]["aln_end"] for x in nodes)
        if index < len(_COLOUR_LIST):
            red, green, blue = _COLOUR_LIST[index]
        else:
            rng = np.random.default_rng(index)
            red, blue = int(rng.integers(0, 256)), int(rng.integers(0, 256))
            green = max(0, min(255, 200 - int((0.2126 * red + 0.0722 * blue) / 0.7152)))
        red_bk, green_bk, blue_bk = max(red - 100, 0), max(green - 100, 0), max(blue - 100, 0)
        for node in nodes:
            lam = g.nodes[node]["aln_end"] / float(max_len)
            g.nodes[node]["normpos"] = g.nodes[node]["chr"] * mult + lam * mult
            nr = (1 - lam) * red + lam * red_bk
            ng = (1 - lam) * green + lam * green_bk
            nb = (1 - lam) * blue + lam * blue_bk
            g.nodes[node]["color"] = "#%02X%02X%02X" % (int(nr), int(ng), int(nb))
            g.nodes[node]["color_r"] = nr
            g.nodes[node]["color_g"] = ng
            g.nodes[node]["color_b"] = nb

    for u, v in g.edges():
        nu, nv = g.nodes[u], g.nodes[v]
        if (
            nu["aln_start"] < nv["aln_start"] < nu["aln_end"]
            or nu["aln_start"] < nv["aln_end"] < nu["aln_end"]
        ):
            g.edges[u, v]["false_positive"] = 0
        else:
            g.edges[u, v]["false_positive"] = 1
    return g
