"""Copied from hinge_tpu/graph/sgraph.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Symmetric string-graph construction and pruning primitives.

Reference: `scripts/pruning_and_clipping.py` (networkx 1.9, Python 2).
Nodes are "<read>_<strand>"; every edge is inserted together with its
reverse-complement mirror, and every pruning operation removes both members
of a mirror pair, keeping the graph strand-symmetric throughout.

Implemented against networkx 3.x: adjacency iteration order is insertion
order in both versions (dicts), so traversal-order-sensitive results
(dead-end paths, z-paths, bubble arms) match the reference's.  Accessors
are adapted (`G.edge[u][v]` -> `G.edges[u, v]`, successor lists
materialized).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Set, Tuple

import networkx as nx


def rev_node(node: str) -> str:
    node_id = node.split("_")[0]
    return node_id + "_" + str(1 - int(node.split("_")[1]))


def _succ(G, n) -> List[str]:
    return list(G.successors(n))


def _pred(G, n) -> List[str]:
    return list(G.predecessors(n))


def build_graph(edge_lines: Iterable[str]) -> Tuple[nx.DiGraph, Dict]:
    """Build the symmetric graph from X.edges.hinges lines
    (pruning_and_clipping.py:1304-1371). Returns (G, Ginfo)."""
    G = nx.DiGraph()
    Ginfo = {}
    for lines in edge_lines:
        t = lines.split()
        if len(t) < 5:
            continue
        u = t[0] + "_" + t[3]
        v = t[1] + "_" + t[4]
        mlen = int(t[2])
        ra_s = int(t[6].lstrip("["))
        ra_e = int(t[7].rstrip("]"))
        rb_s = int(t[8].lstrip("["))
        rb_e = int(t[9].rstrip("]"))
        ra_s_raw = int(t[-4].lstrip("["))
        ra_e_raw = int(t[-3].rstrip("]"))
        rb_s_raw = int(t[-2].lstrip("["))
        rb_e_raw = int(t[-1].rstrip("]"))
        inter = 1 if G.has_edge(u, v) else 0
        G.add_edge(
            u, v, hinge_edge=int(t[5]), intersection=inter, length=mlen, z=0,
            read_a_match_start=ra_s, read_a_match_end=ra_e,
            read_b_match_start=rb_s, read_b_match_end=rb_e,
            read_a_match_start_raw=ra_s_raw, read_a_match_end_raw=ra_e_raw,
            read_b_match_start_raw=rb_s_raw, read_b_match_end_raw=rb_e_raw,
        )
        ru = t[1] + "_" + str(1 - int(t[4]))
        rv = t[0] + "_" + str(1 - int(t[3]))
        G.add_edge(
            ru, rv, hinge_edge=int(t[5]), intersection=inter, length=mlen, z=0,
            read_a_match_start=rb_s, read_a_match_end=rb_e,
            read_b_match_start=ra_s, read_b_match_end=ra_e,
            read_a_match_start_raw=rb_s_raw, read_a_match_end_raw=rb_e_raw,
            read_b_match_start_raw=ra_s_raw, read_b_match_end_raw=ra_e_raw,
        )
        key = (u, v)
        Ginfo[key] = (
            f"{u} {v} {t[2]} "
            f"{int(t[11][:-1]) - int(t[10][1:])} {int(t[13][:-1]) - int(t[12][1:])}"
        )
        Ginfo[(ru, rv)] = (
            f"{ru} {rv} {t[2]} "
            f"{int(t[13][:-1]) - int(t[12][1:])} {int(t[11][:-1]) - int(t[10][1:])}"
        )
    return G, Ginfo


def read_hinge_list(lines: Iterable[str]) -> Tuple[Set[str], Set[str]]:
    """X.hinge.list -> (in_hinges, out_hinges) node sets (:1396-1416)."""
    in_h: Set[str] = set()
    out_h: Set[str] = set()
    for line in lines:
        t = line.split()
        if len(t) < 3:
            continue
        if t[2] == "1":
            in_h.add(t[0] + "_0")
            out_h.add(t[0] + "_1")
        elif t[2] == "-1":
            in_h.add(t[0] + "_1")
            out_h.add(t[0] + "_0")
    return in_h, out_h


def add_annotation(g: nx.DiGraph, in_hinges: Set[str], out_hinges: Set[str]):
    for node in g.nodes():
        if node in in_hinges:
            g.nodes[node]["hinge"] = 1
        elif node in out_hinges:
            g.nodes[node]["hinge"] = -1
        else:
            g.nodes[node]["hinge"] = 0
    return g


def add_chimera_flags(g: nx.DiGraph, prefix: str):
    """Mark CFLAG from X.cov.flag (:1056-1105)."""
    for node in g.nodes():
        g.nodes[node]["CFLAG"] = False
    node_set = set(g.nodes())
    try:
        f = open(prefix + ".cov.flag")
    except OSError:
        return g
    with f:
        for line in f:
            name = line.strip()
            if name + "_0" in node_set:
                g.nodes[name + "_0"]["CFLAG"] = True
                g.nodes[name + "_1"]["CFLAG"] = True
    return g


def mark_skipped_edges(G: nx.DiGraph, skipped_path: str):
    """(:1021-1037)"""
    try:
        f = open(skipped_path)
    except OSError:
        return
    with f:
        for lines in f:
            t = lines.split()
            if len(t) < 5:
                continue
            u, v = t[0] + "_" + t[3], t[1] + "_" + t[4]
            if G.has_edge(u, v):
                G.edges[u, v]["skipped"] = 1
                ru, rv = t[1] + "_" + str(1 - int(t[4])), t[0] + "_" + str(1 - int(t[3]))
                G.edges[ru, rv]["skipped"] = 1


def dead_end_clipping_sym(G: nx.DiGraph, threshold: int) -> nx.DiGraph:
    """(:197-262)"""
    H = G.copy()
    # node-insertion order, not set(...): H.nodes() is already unique, and
    # py3 string-set iteration is hash-randomized across runs (py2's — the
    # reference's — string hash was fixed), so a set here would make clip
    # output depend on PYTHONHASHSEED
    start_nodes = [x for x in H.nodes() if H.in_degree(x) == 0]
    for st_node in start_nodes:
        if not H.has_node(st_node):
            continue
        cur_path = [st_node]
        cur_node = st_node
        succ = _succ(H, st_node)
        if len(succ) == 1:
            cur_node = succ[0]
            while (
                H.in_degree(cur_node) == 1
                and H.out_degree(cur_node) == 1
                and len(cur_path) < threshold + 2
            ):
                cur_path.append(cur_node)
                cur_node = _succ(H, cur_node)[0]
                if len(cur_path) > threshold + 1:
                    break
        if len(cur_path) <= threshold and (
            H.in_degree(cur_node) > 1 or H.out_degree(cur_node) == 0
        ):
            for vertex in cur_path:
                H.remove_node(vertex)
                H.remove_node(rev_node(vertex))
    return H


def z_clipping_sym(
    G: nx.DiGraph, threshold: int, in_hinges: Set[str], out_hinges: Set[str]
) -> Tuple[nx.DiGraph, nx.DiGraph]:
    """(:331-390). Returns (H, G0) where G0 carries z annotations."""
    H = G.copy()
    G0 = G.copy()
    start_nodes = [
        x for x in H.nodes() if H.out_degree(x) > 1 and x not in out_hinges
    ]
    for st_node in start_nodes:
        if not H.has_node(st_node):
            continue
        for sec_node in _succ(H, st_node):
            # a prior arm's removal can delete st_node (via its mirror) or
            # this sec_node; the reference crashes there (nx1.9 degree of a
            # missing node) — skipping is the only defined continuation
            if not H.has_node(st_node):
                break
            if not H.has_node(sec_node):
                continue
            if H.out_degree(st_node) == 1:
                break
            cur_node = sec_node
            cur_path = [[st_node, cur_node]]
            while H.in_degree(cur_node) == 1 and H.out_degree(cur_node) == 1:
                nxt = _succ(H, cur_node)[0]
                cur_path.append([cur_node, nxt])
                cur_node = nxt
                if len(cur_path) > threshold + 1:
                    break
            if (
                len(cur_path) <= threshold
                and H.in_degree(cur_node) > 1
                and H.out_degree(st_node) > 1
                and cur_node not in in_hinges
            ):
                for e in cur_path:
                    G0.edges[e[0], e[1]]["z"] = 1
                    G0.edges[rev_node(e[1]), rev_node(e[0])]["z"] = 1
                    try:
                        H.remove_edge(e[0], e[1])
                        H.remove_edge(rev_node(e[1]), rev_node(e[0]))
                    except nx.NetworkXError:
                        pass
                for j in range(len(cur_path) - 1):
                    G0.nodes[cur_path[j][1]]["z"] = 1
                    G0.nodes[rev_node(cur_path[j][1])]["z"] = 1
                    try:
                        H.remove_node(cur_path[j][1])
                        H.remove_node(rev_node(cur_path[j][1]))
                    except nx.NetworkXError:
                        pass
    return H, G0


def bubble_bursting_sym(H: nx.DiGraph, threshold: int) -> nx.DiGraph:
    """(:561-622) — in place, like the reference."""
    start_nodes = [x for x in H.nodes() if H.out_degree(x) == 2]
    for st_node in start_nodes:
        if not H.has_node(st_node) or H.out_degree(st_node) < 2:
            continue
        succ = _succ(H, st_node)
        sec_node = succ[0]
        cur_node = sec_node
        cur_path = [[st_node, cur_node]]
        while H.in_degree(cur_node) == 1 and H.out_degree(cur_node) == 1:
            nxt = _succ(H, cur_node)[0]
            cur_path.append([cur_node, nxt])
            cur_node = nxt
            if len(cur_path) > threshold + 1:
                break
        end_node0 = cur_node
        cur_node = succ[1]
        alt_path = [[st_node, cur_node]]
        while H.in_degree(cur_node) == 1 and H.out_degree(cur_node) == 1:
            nxt = _succ(H, cur_node)[0]
            alt_path.append([cur_node, nxt])
            cur_node = nxt
            if len(alt_path) > threshold + 1:
                break
        if (
            len(cur_path) <= threshold
            and len(alt_path) <= threshold
            and end_node0 == cur_node
        ):
            for e in cur_path:
                H.remove_edge(e[0], e[1])
                H.remove_edge(rev_node(e[1]), rev_node(e[0]))
            for j in range(len(cur_path) - 1):
                H.remove_node(cur_path[j][1])
                H.remove_node(rev_node(cur_path[j][1]))
    return H


_EDGE_COPY_KEYS = (
    "length",
    "read_a_match_start", "read_a_match_end",
    "read_b_match_start", "read_b_match_end",
    "read_a_match_start_raw", "read_a_match_end_raw",
    "read_b_match_start_raw", "read_b_match_end_raw",
)


def _copy_edge(g, src, dst):
    return {k: g.edges[src[0], src[1]][k] for k in _EDGE_COPY_KEYS}


def resolve_rep(g: nx.DiGraph, rep_path: List[str], in_node: str, out_node: str):
    """Duplicate a repeat path with 'B'-prefixed copies (:625-701)."""
    prefix = "B"
    g.add_edge(in_node, prefix + rep_path[0], **_copy_edge(g, (in_node, rep_path[0]), None))
    g.remove_edge(in_node, rep_path[0])
    g.add_edge(prefix + rep_path[-1], out_node, **_copy_edge(g, (rep_path[-1], out_node), None))
    g.remove_edge(rep_path[-1], out_node)
    g.add_edge(
        rev_node(prefix + rep_path[0]), rev_node(in_node),
        **_copy_edge(g, (rev_node(rep_path[0]), rev_node(in_node)), None),
    )
    g.remove_edge(rev_node(rep_path[0]), rev_node(in_node))
    g.add_edge(
        rev_node(out_node), rev_node(prefix + rep_path[-1]),
        **_copy_edge(g, (rev_node(out_node), rev_node(rep_path[-1])), None),
    )
    g.remove_edge(rev_node(out_node), rev_node(rep_path[-1]))
    for i in range(len(rep_path) - 1):
        g.add_edge(
            prefix + rep_path[i], prefix + rep_path[i + 1],
            **_copy_edge(g, (rep_path[i], rep_path[i + 1]), None),
        )
        g.add_edge(
            rev_node(prefix + rep_path[i + 1]), rev_node(prefix + rep_path[i]),
            **_copy_edge(g, (rev_node(rep_path[i + 1]), rev_node(rep_path[i])), None),
        )


def loop_resolution(
    g: nx.DiGraph, max_nodes: int, flank: int, max_plasmid_length: int
) -> nx.DiGraph:
    """Tandem/plasmid loop resolution (:705-836) — mutates g in place."""
    starting_nodes = [x for x in g.nodes() if g.out_degree(x) == 2]
    for st_node in starting_nodes:
        if not g.has_node(st_node) or g.out_degree(st_node) != 2:
            continue
        for first_node in _succ(g, st_node):
            if g.out_degree(st_node) != 2:
                continue
            other_successor = [x for x in _succ(g, st_node) if x != first_node]
            if not other_successor:
                continue
            other_successor = other_successor[0]
            next_node = first_node
            loop_len = 0
            prev_edge = g.edges[st_node, next_node]
            node_cnt = 0
            in_node = st_node
            while (
                g.in_degree(next_node) == 1
                and g.out_degree(next_node) == 1
                and node_cnt < max_nodes
            ):
                node_cnt += 1
                in_node = next_node
                next_node = _succ(g, next_node)[0]
                loop_len += abs(
                    g.edges[in_node, next_node]["read_a_match_start"]
                    - prev_edge["read_b_match_start"]
                )
                prev_edge = g.edges[in_node, next_node]
            if node_cnt >= max_nodes:
                continue
            len_in_loop = loop_len
            first_node_of_repeat = next_node

            if g.in_degree(next_node) == 2:
                preds = [x for x in _pred(g, next_node) if x != in_node]
                if not preds:
                    continue
                prev_node = preds[0]
                node_cnt = 0
                while g.in_degree(prev_node) == 1 and g.out_degree(prev_node) == 1:
                    node_cnt += 1
                    prev_node = _pred(g, prev_node)[0]
                    if node_cnt >= flank:
                        break
                if node_cnt < flank:
                    continue

            next_node = other_successor
            node_cnt = 0
            while g.in_degree(next_node) == 1 and g.out_degree(next_node) == 1:
                node_cnt += 1
                next_node = _succ(g, next_node)[0]
                if node_cnt >= flank:
                    break
            if node_cnt < flank:
                continue

            rep = [first_node_of_repeat]
            next2 = first_node_of_repeat
            node_cnt = 0
            if g.in_degree(next2) == 2 and g.out_degree(next2) == 1:
                nd = _succ(g, next2)[0]
                rep.append(nd)
                prev_edge = g.edges[next2, nd]
                next_double_node = nd
            else:
                next_double_node = next2
                if g.in_degree(next_double_node) == 1 and g.out_degree(next_double_node) == 1:
                    raise AssertionError("loop_resolution invariant")
            while (
                g.in_degree(next_double_node) == 1
                and g.out_degree(next_double_node) == 1
                and node_cnt < max_nodes
            ):
                node_cnt += 1
                nd = _succ(g, next_double_node)[0]
                loop_len += abs(
                    g.edges[next_double_node, nd]["read_a_match_start"]
                    - prev_edge["read_b_match_start"]
                )
                next_double_node = nd
                rep.append(next_double_node)
            if next_double_node == st_node and loop_len > max_plasmid_length:
                resolve_rep(g, rep, in_node, other_successor)
                continue
    return g


def y_pruning(G: nx.DiGraph, flank: int) -> nx.DiGraph:
    """Aggressive pruning of chimeric Y-fork targets (:841-888)."""
    H = G.copy()
    y_nodes = [x for x in H.nodes() if H.out_degree(x) > 1 and H.in_degree(x) == 1]
    for st_node in y_nodes:
        if not H.has_node(st_node):
            continue
        preds = _pred(H, st_node)
        if not preds:
            continue
        prev_node = preds[0]
        node_cnt = 0
        while H.in_degree(prev_node) == 1 and H.out_degree(prev_node) == 1:
            node_cnt += 1
            prev_node = _pred(H, prev_node)[0]
            if node_cnt >= flank:
                break
        if node_cnt < flank:
            continue
        for vert in _succ(H, st_node):
            if H.nodes[vert].get("CFLAG", False):
                try:
                    H.remove_edge(st_node, vert)
                    H.remove_edge(rev_node(vert), rev_node(st_node))
                except nx.NetworkXError:
                    pass
    return H


def merge_path(g: nx.DiGraph, in_node: str, node: str, out_node: str):
    """(:399-410)"""
    if (
        g.edges[in_node, node]["intersection"] == 1
        and g.edges[node, out_node]["intersection"] == 1
    ):
        g.add_edge(in_node, out_node, hinge_edge=-1, intersection=1, z=0)
    else:
        g.add_edge(in_node, out_node, hinge_edge=-1, intersection=0, z=0)
    g.remove_node(node)


def random_condensation_sym(G: nx.DiGraph, n_nodes: int, seed: Optional[int] = 0) -> nx.DiGraph:
    """Visualization-only sparsification (:456-498). The reference uses an
    unseeded RNG (non-deterministic output, SURVEY.md §7); we default to a
    fixed seed so runs are reproducible."""
    g = G.copy()
    rng = random.Random(seed) if seed is not None else random
    max_iter = 20000
    it = 0
    while len(g) > n_nodes and it < max_iter:
        it += 1
        nodes = list(g.nodes())
        node = nodes[rng.randrange(len(g))]
        if g.in_degree(node) == 1 and g.out_degree(node) == 1:
            in_node = list(g.in_edges(node))[0][0]
            out_node = list(g.out_edges(node))[0][1]
            if g.out_degree(in_node) == 1 and g.in_degree(out_node) == 1:
                if in_node != node and out_node != node and in_node != out_node:
                    try:
                        merge_path(g, in_node, node, out_node)
                        merge_path(g, rev_node(out_node), rev_node(node), rev_node(in_node))
                    except (nx.NetworkXError, KeyError):
                        pass
    return g


def connect_strands(g: nx.DiGraph) -> nx.DiGraph:
    """(:1109-1116) — adds both strand-bridging edges per node, in place."""
    for node in list(g.nodes()):
        revn = rev_node(node)
        g.add_edge(node, revn)
        g.add_edge(revn, node)
    return g
