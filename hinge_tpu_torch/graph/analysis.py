"""Copied from hinge_tpu/graph/analysis.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Assembly-graph analysis utilities: N50, unitig extraction, longest path.

Re-implementations of the reference's analysis scripts (behavior, not code):
- `comp_n50`: scripts/compute_n50_from_draft.py:8-27 — the (min+max)/2
  definition over all lengths that split the total in half.
- `n50_from_draft_graphml`: the per-genome core of
  scripts/compute_n50_from_draft.py:60-90 (contig N50 over node segments +
  component N50 over weakly-connected components, segment lengths de-duped
  per component so a contig and its reverse complement count once).
- `unitigs` / `write_unitig_edges`: scripts/unitig.py — maximal simple paths
  between branch vertices plus leftover simple cycles, emitted in the
  reference's `>Unitig<i>` edges.list-like format.
- `longest_path`: scripts/longest_path.py:7-21 — DAG longest path by
  topological-order DP.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import networkx as nx


def comp_n50(contig_lengths: Sequence[int]) -> float:
    """Reference N50 (compute_n50_from_draft.py:8-27): mean of the smallest
    and largest length L such that both the lengths <= L and the lengths
    >= L sum to at least half the total."""
    if len(contig_lengths) == 0:
        return 0
    s = sorted(contig_lengths)
    total = sum(s)
    half = 0.5 * total
    min_n50 = s[-1]
    max_n50 = 0
    # prefix/suffix sums instead of the reference's quadratic re-summing
    prefix = 0
    suffix = total
    for i, v in enumerate(s):
        prefix += v
        if prefix >= half and suffix >= half:
            min_n50 = min(v, min_n50)
            max_n50 = max(v, max_n50)
        suffix -= v
    return 0.5 * (min_n50 + max_n50)


def _node_len(g: nx.DiGraph, u) -> int:
    """Node contig length: `segment` string (the reference NCTC drafts),
    `length` attr, or our draft-path cut span."""
    d = g.nodes[u]
    if "segment" in d:
        return len(d["segment"])
    if "length" in d:
        return int(d["length"])
    if "cut_start" in d and "cut_end" in d:
        return int(d["cut_end"]) - int(d["cut_start"])
    raise ValueError(
        f"node {u!r} carries no segment/length attributes; "
        "compute N50 from the draft FASTA instead"
    )


def n50_from_draft_graphml(path: str) -> Dict[str, float]:
    """Contig + component N50 of a draft graphml
    (compute_n50_from_draft.py:60-90)."""
    g = nx.read_graphml(path)
    contig_lengths = [_node_len(g, u) for u in g.nodes()]
    component_lengths = set()
    for comp in nx.weakly_connected_components(g):
        # set() so a contig and its reverse complement count once
        component_lengths.add(sum({_node_len(g, u) for u in comp}))
    return {
        "contig_n50": comp_n50(contig_lengths),
        "component_n50": comp_n50(sorted(component_lengths)),
        "n_contigs": len(contig_lengths),
        "n_components": len(component_lengths),
        "total_bases": sum(contig_lengths),
    }


def n50_from_fasta(path: str) -> Dict[str, float]:
    """N50 over FASTA record lengths (the reference's hgap branch,
    compute_n50_from_draft.py:96-106)."""
    from hinge_tpu_torch.io.fasta import read_fasta_lengths

    lengths = read_fasta_lengths(path)
    return {
        "contig_n50": comp_n50(lengths),
        "n_contigs": len(lengths),
        "total_bases": sum(lengths),
    }


def unitigs(g: nx.DiGraph) -> List[List[str]]:
    """Maximal unbranched paths (unitig.py:36-76): walk from every branch
    vertex (in/out degree != 1) through degree-1 chains; remaining nodes
    form simple cycles, emitted as closed paths."""
    paths: List[List[str]] = []
    node_set = set(g.nodes())
    branch = {x for x in g if g.in_degree(x) != 1 or g.out_degree(x) != 1}
    used = set(branch)
    for start in branch:
        for vertex in list(g.successors(start)):
            cur_path = [start]
            cur = vertex
            while cur not in branch:
                succ = next(iter(g.successors(cur)))
                cur_path.append(cur)
                cur = succ
            cur_path.append(cur)
            used |= set(cur_path)
            paths.append(cur_path)
    while node_set - used:
        node = sorted(node_set - used)[0]
        # simple cycle: every vertex has out-degree 1 (unitig.py:13-32)
        cur_path = [node]
        cur = next(iter(g.successors(node)))
        while cur != node:
            cur_path.append(cur)
            succs = list(g.successors(cur))
            assert len(succs) == 1, (cur, succs)
            cur = succs[0]
        cur_path.append(cur)
        used |= set(cur_path)
        if len(cur_path) > 1:
            paths.append(cur_path)
    return paths


def write_unitig_edges(g: nx.DiGraph, out_path: str) -> int:
    """`>Unitig<i>` + per-edge raw match coordinates (unitig.py:103-117)."""
    paths = unitigs(g)
    with open(out_path, "w") as f:
        for i, path in enumerate(paths):
            f.write(">Unitig%d\n" % i)
            for j in range(len(path) - 1):
                node_a = path[j].lstrip("B")
                node_b = path[j + 1].lstrip("B")
                d = g.get_edge_data(path[j], path[j + 1])
                weight = (
                    -d["read_a_start_raw"] + d["read_a_end_raw"]
                    - d["read_b_start_raw"] + d["read_b_end_raw"]
                )
                f.write(
                    "%s %s %s %s %d %d %d %d %d\n"
                    % (
                        node_a.split("_")[0], node_a.split("_")[1],
                        node_b.split("_")[0], node_b.split("_")[1],
                        weight,
                        d["read_a_start_raw"], d["read_a_end_raw"],
                        d["read_b_start_raw"], d["read_b_end_raw"],
                    )
                )
    return len(paths)


def longest_path(g: nx.DiGraph) -> List[str]:
    """Longest path in a DAG by topological DP (longest_path.py:7-21)."""
    dist: Dict[str, tuple] = {}
    for node in nx.topological_sort(g):
        pairs = [(dist[v][0] + 1, v) for v in g.pred[node]]
        dist[node] = max(pairs) if pairs else (0, node)
    node, (length, _) = max(dist.items(), key=lambda x: x[1])
    path = []
    while length > 0:
        path.append(node)
        length, node = dist[node]
    return list(reversed(path))


def create_hgraph(
    hgraph_path: str,
    gt: Dict | None = None,
    out_graphml: str | None = None,
) -> tuple:
    """Hinge-graph file -> graphml with activity (and optional ground-truth
    alignment span) node attributes.

    Mirrors scripts/create_hgraph_nogt.py:14-31 (and create_hgraph.py:14-46
    when `gt` — a mapping.json dict {read_id_str: [[start, end, ...], ...]} —
    is given): each `a b pos_a pos_b active rev` line of X.hgraph becomes the
    edge "a_pos_a" -> "b_pos_b"; the source node is marked active=1 and the
    target takes the line's `active` field; with ground truth, each node
    carries aln_start/aln_end = min/max of the read's first mapping span
    (0/0 when unmapped).  Returns (graph, n_weakly_cc, n_strongly_cc).
    """
    g = nx.DiGraph()
    with open(hgraph_path) as f:
        for line in f:
            cols = line.split()
            if len(cols) < 5:
                continue
            u = cols[0] + "_" + cols[2]
            v = cols[1] + "_" + cols[3]
            g.add_node(u)
            g.add_node(v)
            if gt is not None:
                for rid, node in ((cols[0], u), (cols[1], v)):
                    if rid in gt:
                        span = gt[rid][0]
                        g.nodes[node]["aln_start"] = min(span[0], span[1])
                        g.nodes[node]["aln_end"] = max(span[0], span[1])
                    else:
                        g.nodes[node]["aln_start"] = 0
                        g.nodes[node]["aln_end"] = 0
            g.nodes[u]["active"] = 1
            g.nodes[v]["active"] = int(cols[4])
            g.add_edge(u, v)
    if out_graphml is None:
        out_graphml = hgraph_path.split(".")[0] + "_hgraph.graphml"
    nx.write_graphml(g, out_graphml)
    return (
        g,
        nx.number_weakly_connected_components(g),
        nx.number_strongly_connected_components(g),
    )


def connected_trim(
    edges_path: str,
    out_dfs_path: str,
    out_graphml: str | None = None,
    n_iter: int = 15,
) -> nx.DiGraph:
    """Iterated in-degree-0 trimming of an `u->v` edge-list graph.

    Mirrors scripts/connected.py:27-73: parse "u->v" lines, run `n_iter`
    rounds of removing every node whose in-degree is 0 at visit time (the
    reference iterates over a nodes() snapshot while mutating, so removals
    earlier in a round expose new zero-in-degree nodes within the same
    round), write the trimmed graph to graphml and its DFS edge sequence to
    `out_dfs_path`.  Returns the trimmed graph.
    """
    g = nx.DiGraph()
    with open(edges_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, _, v = line.partition("->")
            g.add_edge(u.strip(), v.strip())
    for _ in range(n_iter):
        for node in list(g.nodes()):
            if g.in_degree(node) == 0:
                g.remove_node(node)
    if out_graphml is None:
        out_graphml = edges_path.split(".")[0] + ".graphml"
    nx.write_graphml(g, out_graphml)
    with open(out_dfs_path, "w") as f:
        for edge in nx.dfs_edges(g):
            f.write("{} {}\n".format(edge[0], edge[1]))
    return g
