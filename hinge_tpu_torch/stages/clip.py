"""Copied from hinge_tpu/stages/clip.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, and the graph work and each graphml write in spans
(`clip.graphs`, `clip.graphml`; utils/log.py).  It differs from hinge_tpu's
in logic but not in output: the graphml files are written by the port's own
serializer (io/graphml.py), which writes the bytes `nx.write_graphml` writes
on the same host.

Stage 4 — graph pruning & clipping (`hinge clip` / `clip-nanopore`).

Reference: `scripts/pruning_and_clipping.py:1243-1536` (and the nanopore
variant which always uses bubble(20) + dead-end(20), `_nanopore.py:1466-67`).

Flow: build symmetric graph from X.edges.hinges -> annotate hinges /
chimera flags / skipped edges -> G0 = dead_end(10) -> G1,G0 = z_clip(6) ->
bubble + dead_end (profile-dependent) -> write G0/G1 -> G2 = loop
resolution -> write G2 (the artifact draft-path consumes) -> optional G3 =
y_pruning for aggressive profiles. Gs/G2s/Gc/G2c are visualization-only
condensations (unseeded RNG in the reference; seeded here).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.graph import sgraph as S
from hinge_tpu_torch.io import graphml
from hinge_tpu_torch.utils.log import span


def _write_graphml(G, path: str) -> None:
    with span("clip.graphml"):
        graphml.write_graphml(G, path)


def run_clip(
    edges_path: str,
    hinge_list_path: str,
    suffix: str,
    cfg: Config,
    nanopore: bool = False,
    write_viz: bool = True,
    mapping_json: Optional[str] = None,
) -> dict:
    prefix = edges_path.split(".")[0]
    with span("clip.graphs"):
        with open(edges_path) as f:
            G, Ginfo = S.build_graph(f)
        with open(hinge_list_path) as f:
            in_hinges, out_hinges = S.read_hinge_list(f)

        S.add_annotation(G, in_hinges, out_hinges)
        if os.path.isfile(prefix + ".cov.flag"):
            S.add_chimera_flags(G, prefix)
        if os.path.isfile(prefix + ".edges.skipped"):
            S.mark_skipped_edges(G, prefix + ".edges.skipped")
        if mapping_json:
            from hinge_tpu_torch.graph.groundtruth import add_groundtruth

            with open(mapping_json) as f:
                add_groundtruth(G, json.load(f), in_hinges, out_hinges)

        G0 = G.copy()
        G0 = S.dead_end_clipping_sym(G0, 10)
        G1, G0 = S.z_clipping_sym(G0, 6, set(), set())
        if nanopore or cfg.layout.del_telomeres:
            G1 = S.bubble_bursting_sym(G1, 20)
            G1 = S.dead_end_clipping_sym(G1, 20)
        else:
            G1 = S.bubble_bursting_sym(G1, 10)
            G1 = S.dead_end_clipping_sym(G1, 5)

    _write_graphml(G0, f"{prefix}{suffix}.G0.graphml")
    _write_graphml(G1, f"{prefix}{suffix}.G1.graphml")

    with span("clip.graphs"):
        G2 = G1.copy()
        S.loop_resolution(G2, 500, 50, cfg.layout.max_plasmid_length)
    _write_graphml(G2, f"{prefix}{suffix}.G2.graphml")

    out = {"G0": G0, "G1": G1, "G2": G2}

    if write_viz:
        with span("clip.graphs"):
            Gs = S.random_condensation_sym(G1, 1000)
            G2s = S.random_condensation_sym(G2, 1000)
        _write_graphml(Gs, f"{prefix}{suffix}.Gs.graphml")
        _write_graphml(G2s, f"{prefix}{suffix}.G2s.graphml")
        with span("clip.graphs"):
            Gc = S.connect_strands(Gs)
        _write_graphml(Gc, f"{prefix}{suffix}.Gc.graphml")
        with span("clip.graphs"):
            G2c = S.connect_strands(G2s)
        _write_graphml(G2c, f"{prefix}{suffix}.G2c.graphml")

    if cfg.layout.aggressive_pruning:
        with span("clip.graphs"):
            G3 = S.y_pruning(G2, 10)
            G3 = S.dead_end_clipping_sym(G3, 10)
        _write_graphml(G3, f"{prefix}{suffix}.G3.graphml")
        out["G3"] = G3
        if write_viz:
            with span("clip.graphs"):
                G3s = S.random_condensation_sym(G3, 1000)
                G3c = S.connect_strands(G3s)
            _write_graphml(G3s, f"{prefix}{suffix}.G3s.graphml")
            _write_graphml(G3c, f"{prefix}{suffix}.G3c.graphml")
    return out
