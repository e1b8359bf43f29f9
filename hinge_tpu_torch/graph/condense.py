"""Copied from hinge_tpu/graph/condense.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Graph condensation for visualization / N50 (`hinge condense`).

Reference: `scripts/condense_graph.py` — in-degree-0 trimming iterations
followed by simple-path merging; and
`scripts/condense_graph_create_gfa_compute_n50.py:16-70` for overlap-aware
length accounting + N50.
"""

from __future__ import annotations

from typing import List, Optional

import networkx as nx


def _merge_path(g: nx.DiGraph, in_node, node, out_node):
    node_id = g.graph["aval"]
    g.graph["aval"] += 1
    g.add_node(
        str(node_id),
        count=g.nodes[in_node]["count"] + g.nodes[node]["count"] + g.nodes[out_node]["count"],
        read=g.nodes[in_node]["read"] + "_" + g.nodes[node]["read"] + "_" + g.nodes[out_node]["read"],
    )
    for e in list(g.in_edges(in_node)):
        g.add_edge(e[0], str(node_id))
    for e in list(g.out_edges(out_node)):
        g.add_edge(str(node_id), e[1])
    g.remove_node(in_node)
    g.remove_node(node)
    g.remove_node(out_node)


def merge_simple_path(g: nx.DiGraph):
    for node in list(g.nodes()):
        if not g.has_node(node):
            continue
        if g.in_degree(node) == 1 and g.out_degree(node) == 1:
            in_node = list(g.in_edges(node))[0][0]
            out_node = list(g.out_edges(node))[0][1]
            if g.out_degree(in_node) == 1 and g.in_degree(out_node) == 1:
                if in_node != node and out_node != node and in_node != out_node:
                    _merge_path(g, in_node, node, out_node)


def condense_graph(G: nx.DiGraph, n_trim_iter: int = 5, n_merge_iter: int = 5) -> nx.DiGraph:
    """condense_graph.py:run — trim in-degree-0 nodes, merge simple paths."""
    g = G.copy()
    for node in g.nodes():
        g.nodes[node]["count"] = 1
        g.nodes[node]["read"] = str(node)
    for _ in range(n_trim_iter):
        for node in list(g.nodes()):
            if g.has_node(node) and g.in_degree(node) == 0:
                g.remove_node(node)
    g.graph["aval"] = 1000000000
    for _ in range(n_merge_iter):
        merge_simple_path(g)
    return g


def _merge_path_ov(g: nx.MultiDiGraph, in_node, node, out_node):
    """Overlap-aware 3-node merge
    (condense_graph_create_gfa_compute_n50.py:29-70)."""
    node_id = g.graph["aval"]
    g.graph["aval"] += 1
    overlap1 = g[in_node][node][0]["overlap"]
    overlap2 = g[node][out_node][0]["overlap"]
    length = (
        g.nodes[in_node]["length"] + g.nodes[node]["length"]
        + g.nodes[out_node]["length"] - overlap1 - overlap2
    )
    g.add_node(str(node_id), length=length,
               aln_strand=g.nodes[node].get("aln_strand", 5))
    for e in list(g.in_edges(in_node)):
        g.add_edge(e[0], str(node_id), overlap=g[e[0]][e[1]][0]["overlap"])
    for e in list(g.out_edges(out_node)):
        g.add_edge(str(node_id), e[1], overlap=g[e[0]][e[1]][0]["overlap"])
    g.remove_node(in_node)
    g.remove_node(node)
    g.remove_node(out_node)


def merge_simple_path_ov(g: nx.MultiDiGraph):
    """Strand-compatible simple-path merge
    (condense_graph_create_gfa_compute_n50.py:16-27): aln_strand 5 is the
    unmapped wildcard that merges with anything."""
    for node in list(g.nodes()):
        if not g.has_node(node):
            continue
        if g.in_degree(node) == 1 and g.out_degree(node) == 1:
            in_node = list(g.in_edges(node))[0][0]
            out_node = list(g.out_edges(node))[0][1]
            if g.out_degree(in_node) == 1 and g.in_degree(out_node) == 1:
                if in_node != node and out_node != node and in_node != out_node:
                    s_in = g.nodes[in_node].get("aln_strand", 5)
                    s_mid = g.nodes[node].get("aln_strand", 5)
                    s_out = g.nodes[out_node].get("aln_strand", 5)
                    if (s_in == s_mid or max(s_in, s_mid) == 5) and (
                        s_out == s_mid or max(s_out, s_mid) == 5
                    ):
                        _merge_path_ov(g, in_node, node, out_node)


def condense_gfa_n50(
    edges_path: str,
    mapping_json: Optional[str] = None,
    n_iter: int = 5,
    out_prefix: Optional[str] = None,
):
    """`de_clip` (condense_graph_create_gfa_compute_n50.py:102-227): build
    the multigraph from an edges file (cols: a b weight ... [a0 [a1] [b0
    [b1]; overlap = weight/2, node length from its coord pair), optionally
    annotate aln_strand from mapping.json, iteratively drop degree<2 nodes,
    merge simple paths with overlap-aware lengths, write graphml + a
    Bandage NODE/ARC file, and return the contig N50 over node lengths."""
    from hinge_tpu_torch.graph.analysis import comp_n50

    out_prefix = out_prefix or edges_path.split(".")[0]
    g = nx.MultiDiGraph()
    with open(edges_path) as f:
        for line in f:
            l = line.strip().split()
            if len(l) < 11:
                continue
            g.add_edge(l[0], l[1], overlap=int(l[2]) // 2)
            g.nodes[l[0]]["length"] = int(l[8][:-1]) - int(l[7][1:])
            g.nodes[l[1]]["length"] = int(l[10][:-1]) - int(l[9][1:])
    if mapping_json:
        import json

        mapping = json.load(open(mapping_json))
        for node in g.nodes():
            g.nodes[node]["aln_strand"] = (
                mapping[node][3] if node in mapping else 5
            )
    for _ in range(n_iter):
        for node in list(g.nodes()):
            if g.has_node(node) and g.degree(node) < 2:
                g.remove_node(node)
    g.graph["aval"] = 1000000000
    for _ in range(5):
        merge_simple_path_ov(g)
    nx.write_graphml(g, out_prefix + ".condensed.graphml")
    with open(out_prefix + ".bandage", "w") as fout:
        for cur_node in g.nodes():
            node_str = "A" * g.nodes[cur_node]["length"] + "\n"
            fout.write("NODE " + str(cur_node) + " 0 0 0 0 0\n")
            fout.write(node_str)
            fout.write(node_str)
        for arc in g.edges():
            fout.write("ARC " + str(arc[0]) + " " + str(arc[1]) + " 0\n")
    lengths = [g.nodes[u]["length"] for u in g.nodes()]
    return comp_n50(lengths), g


def compute_n50(lengths: List[int], genome_size: Optional[int] = None) -> int:
    """Standard N50 (accumulate descending to half total). For the
    reference's exact (min+max)/2 variant see graph.analysis.comp_n50."""
    if not lengths:
        return 0
    total = genome_size if genome_size else sum(lengths)
    acc = 0
    for L in sorted(lengths, reverse=True):
        acc += L
        if acc >= total / 2:
            return L
    return 0
