"""Copied from hinge_tpu/stages/draft_path.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, and the graphml write in a span (`draft_path.graphml`;
utils/log.py).  It differs from hinge_tpu's in logic but not in output:
X_draft.graphml is written by the port's own serializer (io/graphml.py),
which writes the bytes `nx.write_graphml` writes on the same host.

Stage 5a — contig path extraction (`hinge draft-path`).

Reference: `scripts/get_draft_path.py`.  Consumes the pruned G2 graph,
computes per-node cut coordinates at junctions, merges linear chains into
contig paths, and emits `X.edges.list` records:

    O a as a as cut_start cut_end     one-read contig
    D a as b bs w cut_start cut_end   two-read contig
    S a as b bs w cut_start           contig start edge
    T a as b bs w                     through edge
    E a as b bs w cut_end             contig end edge

Each contig is followed by its reverse complement (rev_comp_contig=True in
the reference).  Also writes X_draft.graphml with contig_id per node.

Read bases come from the ReadStore (the reference shells out to DBshow,
get_draft_path.py:70-81).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import networkx as nx
import numpy as np

from hinge_tpu_torch.data.overlaps import ReadStore
from hinge_tpu_torch.io import graphml
from hinge_tpu_torch.utils.log import span
from hinge_tpu_torch.graph.sgraph import rev_node


def _vid(vert: str) -> int:
    return int(vert.split("_")[0].lstrip("B"))


def merge_nodes(g: nx.DiGraph, in_node: str, out_node: str):
    """(get_draft_path.py:21-51)"""
    weight = str(g.edges[in_node, out_node]["length"])
    if "path" in g.nodes[in_node]:
        path1 = g.nodes[in_node]["path"]
        wpath1 = g.nodes[in_node]["weightspath"]
    else:
        path1 = in_node
        wpath1 = ""
    if "path" in g.nodes[out_node]:
        path2 = g.nodes[out_node]["path"]
        wpath2 = ";" + g.nodes[out_node]["weightspath"]
    else:
        path2 = out_node
        wpath2 = ""
    g.nodes[in_node]["path"] = path1 + ";" + path2
    if wpath1 == "":
        g.nodes[in_node]["weightspath"] = weight + wpath2
    else:
        g.nodes[in_node]["weightspath"] = wpath1 + ";" + weight + wpath2
    for nodeB in list(g.successors(out_node)):
        g.add_edge(in_node, nodeB, length=g.edges[out_node, nodeB]["length"])
    g.nodes[in_node]["cut_end"] = g.nodes[out_node]["cut_end"]
    g.remove_node(out_node)


def run_draft_path(
    in_graph: nx.DiGraph,
    read_len: np.ndarray,
    out_edges_list: Optional[str] = None,
    out_graphml: Optional[str] = None,
):
    """Returns (edges.list lines, out_graph)."""
    out_graph = in_graph.copy()

    def rlen(vert: str) -> int:
        return int(read_len[_vid(vert)])

    # cut coordinates at junctions (:104-128)
    for vert in out_graph.nodes():
        vert_id, vert_or = vert.split("_")
        vert_len = int(read_len[int(vert_id.lstrip("B"))])
        out_graph.nodes[vert]["cut_start"] = 0
        out_graph.nodes[vert]["cut_end"] = vert_len
        base0 = vert_id + "_0"
        if out_graph.in_degree(vert) > 1:
            if vert_or == "0":
                out_graph.nodes[vert]["cut_start"] = max(
                    out_graph.edges[x, vert]["read_b_match_start"]
                    for x in out_graph.predecessors(vert)
                )
            else:
                out_graph.nodes[vert]["cut_start"] = vert_len - min(
                    out_graph.edges[base0, x]["read_a_match_start"]
                    for x in out_graph.successors(base0)
                )
        if out_graph.out_degree(vert) > 1:
            if vert_or == "0":
                out_graph.nodes[vert]["cut_end"] = min(
                    out_graph.edges[vert, x]["read_a_match_start"]
                    for x in out_graph.successors(vert)
                )
            else:
                out_graph.nodes[vert]["cut_end"] = vert_len - max(
                    out_graph.edges[x, base0]["read_b_match_start"]
                    for x in out_graph.predecessors(base0)
                )

    # merge linear chains (:135-158)
    nodes_to_merge = [
        x
        for x in out_graph.nodes()
        if out_graph.in_degree(x) == 1
        and out_graph.out_degree(list(out_graph.predecessors(x))[0]) == 1
    ]
    while nodes_to_merge:
        cur_node = nodes_to_merge[0]
        prev_node = list(out_graph.predecessors(cur_node))[0]
        if prev_node != cur_node:
            merge_nodes(out_graph, prev_node, cur_node)
        else:
            out_graph.nodes[cur_node]["path"] = (
                out_graph.nodes[cur_node]["path"] + ";" + cur_node
            )
            out_graph.nodes[cur_node]["weightspath"] = (
                out_graph.nodes[cur_node]["weightspath"]
                + ";"
                + str(out_graph.edges[prev_node, cur_node]["length"])
            )
            out_graph.nodes[cur_node]["cut_end"] = rlen(cur_node)
        nodes_to_merge.pop(0)

    # emit contigs (:191-435)
    lines: List[str] = []
    contig_no = 0
    printed: Dict[str, int] = {}

    def sp(node):
        return node.split("_")[0].lstrip("B"), node.split("_")[1]

    for vertex in list(out_graph.nodes()):
        if rev_node(vertex) in printed:
            out_graph.nodes[vertex]["contig_id"] = printed[rev_node(vertex)] + 1
            continue

        if "path" not in out_graph.nodes[vertex]:
            out_graph.nodes[vertex]["contig_id"] = contig_no + 1
            lines.append(f">Unitig{contig_no}")
            printed[vertex] = contig_no
            contig_no += 1
            a, ao = sp(vertex)
            lines.append(
                f"O {a} {ao} {a} {ao} "
                f"{out_graph.nodes[vertex]['cut_start']} {out_graph.nodes[vertex]['cut_end']}"
            )
            lines.append(f">Unitig{contig_no}")
            contig_no += 1
            vrc = rev_node(vertex)
            b, bo = sp(vrc)
            lines.append(
                f"O {b} {bo} {b} {bo} "
                f"{out_graph.nodes[vrc]['cut_start']} {out_graph.nodes[vrc]['cut_end']}"
            )
            continue

        node_list = out_graph.nodes[vertex]["path"].split(";")
        weights_list = out_graph.nodes[vertex]["weightspath"].split(";")

        if (
            out_graph.in_degree(vertex) != 1
            and out_graph.out_degree(vertex) != 1
            and len(node_list) == 2
        ):
            out_graph.nodes[vertex]["contig_id"] = contig_no
            lines.append(f">Unitig{contig_no}")
            printed[node_list[0]] = contig_no
            printed[node_list[1]] = contig_no
            contig_no += 1
            a, ao = sp(node_list[0])
            b, bo = sp(node_list[1])
            lines.append(
                f"D {a} {ao} {b} {bo} {weights_list[0]} "
                f"{out_graph.nodes[vertex]['cut_start']} {out_graph.nodes[vertex]['cut_end']}"
            )
            lines.append(f">Unitig{contig_no}")
            contig_no += 1
            ra, rao = sp(rev_node(node_list[1]))
            rb, rbo = sp(rev_node(node_list[0]))
            la = rlen(rev_node(node_list[1]))
            lb = rlen(rev_node(node_list[0]))
            lines.append(
                f"D {ra} {rao} {rb} {rbo} {weights_list[0]} "
                f"{la - out_graph.nodes[vertex]['cut_end']} "
                f"{lb - out_graph.nodes[vertex]['cut_start']}"
            )
            continue

        if len(node_list) != len(weights_list) + 1:
            continue
        for curnode in node_list:
            printed[curnode] = contig_no
        out_graph.nodes[vertex]["contig_id"] = contig_no
        lines.append(f">Unitig{contig_no}")
        contig_no += 1

        preds = list(out_graph.predecessors(vertex))
        succs = list(out_graph.successors(vertex))

        if out_graph.in_degree(vertex) == 1 and preds[0] != vertex:
            prev_contig = preds[0]
            cut_start = out_graph.nodes[prev_contig]["cut_end"]
            if "path" in out_graph.nodes[prev_contig]:
                nodeA = out_graph.nodes[prev_contig]["path"].split(";")[-1]
            else:
                nodeA = prev_contig
            nodeB = node_list[0]
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"S {a} {ao} {b} {bo} "
                f"{out_graph.edges[prev_contig, vertex]['length']} {cut_start}"
            )
            if len(node_list) > 2:
                a, ao = sp(node_list[0])
                b, bo = sp(node_list[1])
                lines.append(f"T {a} {ao} {b} {bo} {weights_list[0]}")
        else:
            a, ao = sp(node_list[0])
            b, bo = sp(node_list[1])
            lines.append(
                f"S {a} {ao} {b} {bo} {weights_list[0]} "
                f"{out_graph.nodes[vertex]['cut_start']}"
            )

        for i in range(1, len(weights_list) - 1):
            a, ao = sp(node_list[i])
            b, bo = sp(node_list[i + 1])
            lines.append(f"T {a} {ao} {b} {bo} {weights_list[i]}")

        if out_graph.out_degree(vertex) == 1 and succs[0] != vertex:
            if len(node_list) > 2:
                a, ao = sp(node_list[len(weights_list) - 1])
                b, bo = sp(node_list[len(weights_list)])
                lines.append(f"T {a} {ao} {b} {bo} {weights_list[-1]}")
            next_contig = succs[0]
            cut_end = out_graph.nodes[next_contig]["cut_start"]
            nodeA = node_list[len(weights_list)]
            if "path" in out_graph.nodes[next_contig]:
                nodeB = out_graph.nodes[next_contig]["path"].split(";")[0]
            else:
                nodeB = next_contig
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"E {a} {ao} {b} {bo} "
                f"{out_graph.edges[vertex, next_contig]['length']} {cut_end}"
            )
        else:
            a, ao = sp(node_list[len(weights_list) - 1])
            b, bo = sp(node_list[len(weights_list)])
            lines.append(
                f"E {a} {ao} {b} {bo} {weights_list[-1]} "
                f"{out_graph.nodes[vertex]['cut_end']}"
            )

        # reverse-complement contig (rev_comp_contig=True)
        lines.append(f">Unitig{contig_no}")
        contig_no += 1

        if out_graph.out_degree(vertex) == 1 and succs[0] != vertex:
            next_contig = succs[0]
            nodeB = rev_node(node_list[len(weights_list)])
            if "path" in out_graph.nodes[next_contig]:
                nodeA = rev_node(out_graph.nodes[next_contig]["path"].split(";")[0])
            else:
                nodeA = rev_node(next_contig)
            cut_start = rlen(nodeA) - out_graph.nodes[next_contig]["cut_start"]
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"S {a} {ao} {b} {bo} "
                f"{out_graph.edges[vertex, next_contig]['length']} {cut_start}"
            )
            if len(node_list) > 2:
                a, ao = sp(rev_node(node_list[len(weights_list)]))
                b, bo = sp(rev_node(node_list[len(weights_list) - 1]))
                lines.append(f"T {a} {ao} {b} {bo} {weights_list[-1]}")
        else:
            nodeA = rev_node(node_list[len(weights_list)])
            nodeB = rev_node(node_list[len(weights_list) - 1])
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"S {a} {ao} {b} {bo} {weights_list[-1]} "
                f"{rlen(nodeA) - out_graph.nodes[vertex]['cut_end']}"
            )

        for i in range(len(weights_list) - 1, 1, -1):
            a, ao = sp(rev_node(node_list[i]))
            b, bo = sp(rev_node(node_list[i - 1]))
            lines.append(f"T {a} {ao} {b} {bo} {weights_list[i - 1]}")

        if out_graph.in_degree(vertex) == 1 and preds[0] != vertex:
            if len(node_list) > 2:
                a, ao = sp(rev_node(node_list[1]))
                b, bo = sp(rev_node(node_list[0]))
                lines.append(f"T {a} {ao} {b} {bo} {weights_list[0]}")
            prev_contig = preds[0]
            nodeA = rev_node(node_list[0])
            if "path" in out_graph.nodes[prev_contig]:
                nodeB = rev_node(out_graph.nodes[prev_contig]["path"].split(";")[-1])
            else:
                nodeB = rev_node(prev_contig)
            cut_end = rlen(nodeB) - out_graph.nodes[prev_contig]["cut_end"]
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"E {a} {ao} {b} {bo} "
                f"{out_graph.edges[prev_contig, vertex]['length']} {cut_end}"
            )
        else:
            nodeB = rev_node(node_list[0])
            nodeA = rev_node(node_list[1])
            a, ao = sp(nodeA)
            b, bo = sp(nodeB)
            lines.append(
                f"E {a} {ao} {b} {bo} {weights_list[0]} "
                f"{rlen(nodeB) - out_graph.nodes[vertex]['cut_start']}"
            )

    if out_edges_list is not None:
        with open(out_edges_list, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
    if out_graphml is not None:
        with span("draft_path.graphml"):
            graphml.write_graphml(out_graph, out_graphml)
    return lines, out_graph
