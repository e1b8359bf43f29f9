"""The port's graphml serializer (hinge_tpu_torch/io/graphml.py) against
networkx's two writers, on the CPU, tolerance 0.

Under each binding of `nx.write_graphml` (networkx's ElementTree writer
`write_graphml_xml`, and `write_graphml_lxml`, which takes lxml where it
imports), the port's `write_graphml` writes the bytes networkx writes,
and writes them itself (its counters say so):

- (a) clip's G0-G3 and its viz graphs (Gs, G2s, Gc, G2c, G3s, G3c) on
  the golden repeat workload (tests/golden_repeats/R.*) and on the 150 kb
  rrn circle (tests/torch_golden_repeats.py), clip-nanopore with
  aggressive pruning;
- (b) the rrn circle's X_draft.graphml graph from assemble();
- (c) made-up graphs that reach every rule of the layouts.

Where a value is outside what it emits, or `nx.write_graphml` is bound to
neither writer, the port hands the file to `nx.write_graphml`.
"""

import dataclasses
import gzip
import os
import shutil
import sys
from unittest import mock

import networkx as nx
import numpy as np
import pytest
from networkx.readwrite import graphml as nx_graphml

from hinge_tpu_torch.io import graphml as GM
from hinge_tpu_torch.utils.log import record
from tests import torch_golden_repeats as GR

WRITERS = {"etree": nx_graphml.write_graphml_xml,
           "lxml": nx_graphml.write_graphml_lxml}
#: the graphs run_clip writes with nanopore, write_viz and aggressive pruning
CLIP_GRAPHS = ("G0", "G1", "G2", "Gs", "G2s", "Gc", "G2c", "G3", "G3s", "G3c")
WORKLOAD_GRAPHS = ([f"golden.{g}" for g in CLIP_GRAPHS]
                   + [f"rrn.{g}" for g in CLIP_GRAPHS] + ["rrn.draft"])


def both_bytes(G, writer, tmp_path):
    """(networkx's bytes, the port's bytes, the port's counters) for G
    with `nx.write_graphml` bound to `writer`."""
    a, b = str(tmp_path / "nx.graphml"), str(tmp_path / "port.graphml")
    with mock.patch.object(nx, "write_graphml", writer):
        nx.write_graphml(G.copy(), a)
        with record("graphml") as call:
            GM.write_graphml(G.copy(), b)
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read(), g.read(), call.counters


def assert_written_alike(G, writer, tmp_path):
    want, got, counters = both_bytes(G, writer, tmp_path)
    assert got == want
    assert counters == {"graphml.files": 1, "graphml.bytes": len(got)}


@pytest.fixture(scope="module")
def workload_graphs(tmp_path_factory):
    """{workload.graph: graph} as the port's stages hand them to the
    serializer."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.stages.clip import run_clip

    seen = {}
    write = GM.write_graphml

    def spy(G, path):
        seen[os.path.basename(path)] = G.copy()
        write(G, path)

    cfg = nominal_config()
    cfg = dataclasses.replace(cfg, layout=dataclasses.replace(
        cfg.layout, aggressive_pruning=True))
    out = {}
    golden = tmp_path_factory.mktemp("graphml_golden")
    for f in os.listdir(GR.GOLDEN_DIR):
        if f.startswith(GR.PREFIX + "."):
            shutil.copy(os.path.join(GR.GOLDEN_DIR, f), golden)
    rrn = tmp_path_factory.mktemp("graphml_rrn")
    _, _, rs, ov = simulate(GR.rrn_params(SimParams))
    fasta, las = str(rrn / "reads.fasta"), str(rrn / "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    with mock.patch.object(GM, "write_graphml", spy):
        for name, prefix in (("golden", str(golden / GR.PREFIX)),
                             ("rrn", None)):
            if prefix is None:
                wd = str(rrn / "w")
                assemble(fasta=fasta, las=las, workdir=wd,
                         log=lambda *a: None, device="cpu")
                out["rrn.draft"] = seen.pop("asm_draft.graphml")
                prefix = os.path.join(wd, "asm")
            seen.clear()
            run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "v",
                     cfg, nanopore=True, write_viz=True)
            base = os.path.basename(prefix)
            for g in CLIP_GRAPHS:
                out[f"{name}.{g}"] = seen.pop(f"{base}v.{g}.graphml")
            assert not seen
    return out


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("name", WORKLOAD_GRAPHS)
def test_workload_graph_byte_equal(workload_graphs, name, writer, tmp_path):
    G = workload_graphs[name]
    assert G.number_of_nodes() > 0
    assert_written_alike(G, WRITERS[writer], tmp_path)


def _graph_attrs():
    G = nx.DiGraph(name="asm", id="g1", cov=30, frac=0.5, ok=True)
    G.add_edge("a", "b", w=1)
    return G


def _mixed_types():
    G = nx.DiGraph()
    G.add_node("a", x=1)
    G.add_node("b", x=1.5)
    G.add_node("c", x=True)
    G.add_node("d", x=2)
    G.add_edge("a", "b", x=0.25)
    G.add_edge("b", "c", x=False)
    G.add_edge("c", "d", x=7)
    return G


def _numpy_scalars():
    G = nx.DiGraph()
    G.add_node(np.int64(3), a=np.int32(-4), b=np.int64(2**40),
               c=np.float64(0.1), d=np.float32(0.1), e=np.uint8(255))
    G.add_node(4, a=4, c=0.1)
    G.add_edge(np.int64(3), 4, w=np.int64(9), f=np.float64(1e-7))
    return G


def _strings():
    s = "& < > \" ' \n \t \r é ß 漢 ]]>"
    G = nx.DiGraph(note=s)
    G.add_node(s, path=s, empty="", plain="x")
    G.add_node("b", path="", plain=s)
    G.add_edge(s, "b", label=s)
    G.add_edge("b", s, label="")
    G.add_node("c", **{"name & <key>": 1})
    return G


def _self_loop():
    G = nx.DiGraph()
    G.add_edge("a", "a", w=3)
    G.add_edge("a", "b")
    return G


def _undirected():
    G = nx.Graph()
    G.add_edge(2, 1, w=1.0)
    G.add_edge(1, 3)
    G.add_node(9)
    return G


def _nodes_only():
    G = nx.DiGraph()
    G.add_nodes_from(["x", "y", 0, (1, 2)])
    G.add_edge("x", "y")
    return G


def _defaults():
    G = nx.MultiDiGraph(node_default={"color": "red", "e": ""},
                        edge_default={"w": 7})
    G.add_node(1, color="blue", e="x")
    G.add_node(2)
    G.add_edge(1, 2, w=3)
    G.add_edge(1, 2, key="k<&", w=4)
    return G


MADE_UP = {
    "empty_directed": nx.DiGraph,
    "empty_undirected": nx.Graph,
    "graph_id_only": lambda: nx.DiGraph(id="only"),
    "nodes_without_attributes": _nodes_only,
    "graph_attributes": _graph_attrs,
    "one_name_int_float_bool": _mixed_types,
    "numpy_scalars": _numpy_scalars,
    "escaped_and_non_ascii_strings": _strings,
    "self_loop": _self_loop,
    "undirected": _undirected,
    "multigraph_keys_and_defaults": _defaults,
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("case", sorted(MADE_UP))
def test_made_up_graph_byte_equal(case, writer, tmp_path):
    assert_written_alike(MADE_UP[case](), WRITERS[writer], tmp_path)


def test_graph_id_is_popped_as_networkx_does(tmp_path):
    G, H = _graph_attrs(), _graph_attrs()
    nx.write_graphml(G, str(tmp_path / "a.graphml"))
    GM.write_graphml(H, str(tmp_path / "b.graphml"))
    assert "id" not in G.graph and H.graph == G.graph


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_unsupported_value_is_delegated(writer, tmp_path):
    """A list value: the file goes to nx.write_graphml, which raises its
    own error (NetworkXError from ElementTree's writer, TypeError from
    lxml's), and the call counts one delegated file."""
    G = nx.DiGraph()
    G.add_node("a", reads=[1, 2])
    with mock.patch.object(nx, "write_graphml", WRITERS[writer]):
        with pytest.raises((nx.NetworkXError, TypeError)) as want:
            nx.write_graphml(G.copy(), str(tmp_path / "nx.graphml"))
        with record("graphml") as call, pytest.raises(want.type) as got:
            GM.write_graphml(G.copy(), str(tmp_path / "port.graphml"))
    assert str(got.value) == str(want.value)
    assert call.counters == {"graphml.delegated": 1}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_character_xml_forbids_is_delegated(writer, tmp_path):
    """ElementTree writes a control character raw, lxml raises: the port
    hands the file over and does the same."""
    G = nx.DiGraph()
    G.add_node("a", s="bell\x07")
    w = WRITERS[writer]
    with mock.patch.object(nx, "write_graphml", w):
        try:
            nx.write_graphml(G.copy(), str(tmp_path / "nx.graphml"))
            want = (tmp_path / "nx.graphml").read_bytes()
        except ValueError:
            want = ValueError
        with record("graphml") as call:
            try:
                GM.write_graphml(G.copy(), str(tmp_path / "port.graphml"))
                got = (tmp_path / "port.graphml").read_bytes()
            except ValueError:
                got = ValueError
    assert got == want
    assert call.counters["graphml.delegated"] == 1
    assert "graphml.files" not in call.counters


def test_other_binding_is_delegated(tmp_path):
    """A caller's own nx.write_graphml writes the file."""
    calls = []

    def own(G, path):
        calls.append(path)
        nx_graphml.write_graphml_xml(G, path)

    G = _self_loop()
    path = str(tmp_path / "port.graphml")
    with mock.patch.object(nx, "write_graphml", own), record("g") as call:
        GM.write_graphml(G, path)
    assert calls == [path]
    assert call.counters == {"graphml.delegated": 1,
                             "graphml.bytes": os.path.getsize(path)}


def test_compressed_path_is_delegated(tmp_path):
    G = _mixed_types()
    nx.write_graphml(G.copy(), str(tmp_path / "nx.graphml"))
    with record("g") as call:
        GM.write_graphml(G.copy(), str(tmp_path / "port.graphml.gz"))
    with gzip.open(tmp_path / "port.graphml.gz") as f:
        assert f.read() == (tmp_path / "nx.graphml").read_bytes()
    assert call.counters["graphml.delegated"] == 1


def test_lxml_binding_without_lxml_writes_etree(tmp_path):
    """write_graphml_lxml falls back to ElementTree where lxml does not
    import (the card's host): so does the port."""
    G = _strings()
    with mock.patch.dict(sys.modules, {"lxml": None, "lxml.etree": None}):
        assert GM.layout() is GM.ETREE
        assert_written_alike(G, nx_graphml.write_graphml_lxml, tmp_path)
    want, _, _ = both_bytes(G, nx_graphml.write_graphml_xml, tmp_path)
    assert (tmp_path / "port.graphml").read_bytes() == want


def test_layout_follows_the_binding():
    with mock.patch.object(nx, "write_graphml", nx_graphml.write_graphml_xml):
        assert GM.layout() is GM.ETREE
    with mock.patch.object(nx, "write_graphml", nx_graphml.write_graphml_lxml):
        assert GM.layout() is GM.LXML
    with mock.patch.object(nx, "write_graphml", lambda G, p: None):
        assert GM.layout() is None
