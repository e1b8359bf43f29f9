"""HINGE's repeat path, the port against hinge_tpu on the CPU, tolerance 0.

The same seeded inputs, simulated by hinge_tpu and written as FASTA +
.las, go through hinge_tpu.pipeline.assemble and the port's
assemble(device="cpu") with HINGE_PARITY_ALIGN=1 on both sides; every
file either writes, but the log, must be byte-equal:

- (a) tests/test_repeat_resolution.py's workload (a 25 kb repeat longer
  than every read): hinged edges in the final graph on both sides;
- (b) tests/test_multichrom.py's chromosomes with the yeast demo ini
  (del_telomere, aggressive_pruning): telomere flags and G3 on both sides;
- (c) (b)'s data with the plural del_telomeres key, which takes the
  clip stage's telomere profile;
- (d) (a) under HINGE_SHARDED=1 HINGE_MESH_SHARDS=4: the port's files
  equal its single-device run's, and the layout's matching-position
  queries reach the mesh.

Also: hinge_tpu and the port reproduce the golden files of case (a)
(tests/golden_repeats/), the two simulators agree on the yeast
workload's shape at a small size, and the yeast manifest
(tests/golden_repeats/yeast_w303.json, which chip_smoke.py holds the card
to) describes the workload this module defines; rebuilding the manifest
is the one `slow` test.
"""

import json
import os

import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import write_las
from tests import torch_golden_repeats as GR
from tests.test_multichrom import PARAMS as MULTICHROM
from tests.test_multichrom import YEAST_DEMO_INI

#: the demo ini with the plural key, which the clip and layout stages read
PLURAL_INI = YEAST_DEMO_INI.replace("del_telomere = 1", "del_telomeres = 1")


def write_inputs(tmp, params):
    _, _, rs, ov = simulate(params)
    fasta, las = str(tmp / "reads.fasta"), str(tmp / "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    return fasta, las


def write_ini(tmp, text, name):
    path = str(tmp / name)
    with open(path, "w") as f:
        f.write(text)
    return path


def assemble_port(fasta, las, workdir, ini=""):
    from hinge_tpu_torch.pipeline import assemble

    return assemble(fasta=fasta, las=las, config=ini, workdir=workdir,
                    log=lambda *a: None, device="cpu")


def assemble_both(tmp, fasta, las, ini=""):
    """hinge_tpu's and the port's assemble() with HINGE_PARITY_ALIGN=1;
    returns {side: (workdir, result)}."""
    from hinge_tpu.pipeline import assemble as assemble_jax

    ref, port = str(tmp / "jax"), str(tmp / "torch")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_PARITY_ALIGN", "1")
        res_ref = assemble_jax(fasta=fasta, las=las, config=ini, workdir=ref,
                               log=lambda *a: None)
        res_port = assemble_port(fasta, las, port, ini)
    return {"jax": (ref, res_ref), "torch": (port, res_port)}


def assert_same_files(ref, port):
    names = GR.workdir_files(ref)
    assert GR.workdir_files(port) == names
    for name in names:
        with open(os.path.join(ref, name), "rb") as f, \
                open(os.path.join(port, name), "rb") as g:
            assert g.read() == f.read(), name
    return names


def final_graph(res):
    return res["graphs"].get("G3", res["graphs"]["G2"])


@pytest.fixture(scope="module")
def case_a(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repeats_a")
    fasta, las = write_inputs(tmp, GR.case_a_params(SimParams))
    return dict(tmp=tmp, fasta=fasta, las=las,
                runs=assemble_both(tmp, fasta, las))


@pytest.fixture(scope="module")
def multichrom(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repeats_mc")
    fasta, las = write_inputs(tmp, MULTICHROM)
    return dict(tmp=tmp, fasta=fasta, las=las)


def test_case_a_hinged_edges_byte_equal(case_a):
    (ref, res_ref), (port, res_port) = case_a["runs"].values()
    names = assert_same_files(ref, port)
    assert "asm_consensus.gfa" in names and "asm1.G2.graphml" in names
    for res in (res_ref, res_port):
        assert GR.hinged_edges(final_graph(res)) >= 1
    with open(os.path.join(port, "asm.hgraph")) as f:
        assert f.read().strip(), "no matching hinges in the hinge graph"


def test_multichrom_demo_ini_byte_equal(multichrom):
    tmp = multichrom["tmp"] / "demo"
    tmp.mkdir()
    ini = write_ini(tmp, YEAST_DEMO_INI, "yeast.ini")
    runs = assemble_both(tmp, multichrom["fasta"], multichrom["las"], ini)
    assert_same_files(runs["jax"][0], runs["torch"][0])
    for wd, res in runs.values():
        for flag in ("asm.cov.flag", "asm.self.flag"):
            with open(os.path.join(wd, flag)) as f:
                assert f.read().split(), flag
        assert os.path.isfile(os.path.join(wd, "asm1.G3.graphml"))
        assert "G3" in res["graphs"]


def test_multichrom_plural_del_telomeres_byte_equal(multichrom, monkeypatch):
    """The plural key takes clip's telomere profile (bubbles and dead ends
    of 20) and the layout's telomere kill, on both sides."""
    from hinge_tpu_torch.stages import clip as clip_mod

    tmp = multichrom["tmp"] / "plural"
    tmp.mkdir()
    ini = write_ini(tmp, PLURAL_INI, "plural.ini")
    depths = []
    bubble = clip_mod.S.bubble_bursting_sym

    def spy(G, depth):
        depths.append(depth)
        return bubble(G, depth)

    monkeypatch.setattr(clip_mod.S, "bubble_bursting_sym", spy)
    runs = assemble_both(tmp, multichrom["fasta"], multichrom["las"], ini)
    assert depths == [20]
    assert_same_files(runs["jax"][0], runs["torch"][0])
    assert all("G3" in res["graphs"] for _, res in runs.values())


def test_pinned_graphml_serializer_byte_equal(multichrom, tmp_path):
    """The yeast manifest is written, and the card held to it, with
    networkx's graphml serializer pinned to ElementTree
    (GR.etree_graphml), whether lxml imports or not: under the pin the
    port writes hinge_tpu's bytes, the graphml files among them."""
    ini = write_ini(tmp_path, YEAST_DEMO_INI, "yeast.ini")
    with GR.etree_graphml():
        runs = assemble_both(tmp_path, multichrom["fasta"], multichrom["las"],
                             ini)
    (ref, _), (port, _) = runs.values()
    names = assert_same_files(ref, port)
    assert [n for n in names if n.endswith(".graphml")] == [
        "asm1.G0.graphml", "asm1.G1.graphml", "asm1.G2.graphml",
        "asm1.G3.graphml", "asm_draft.graphml"]


@pytest.mark.parametrize("writer", ["write_graphml_lxml"])
def test_pinned_graphml_serializer_twin_byte_equal(multichrom, tmp_path,
                                                   writer):
    """test_pinned_graphml_serializer_byte_equal under networkx's other
    writer: with lxml (where it imports, as here) the port's serializer
    writes hinge_tpu's graphml bytes too."""
    from unittest import mock

    import networkx as nx
    from networkx.readwrite import graphml

    ini = write_ini(tmp_path, YEAST_DEMO_INI, "yeast.ini")
    with mock.patch.object(nx, "write_graphml", getattr(graphml, writer)):
        runs = assemble_both(tmp_path, multichrom["fasta"], multichrom["las"],
                             ini)
    (ref, _), (port, _) = runs.values()
    names = assert_same_files(ref, port)
    assert [n for n in names if n.endswith(".graphml")] == [
        "asm1.G0.graphml", "asm1.G1.graphml", "asm1.G2.graphml",
        "asm1.G3.graphml", "asm_draft.graphml"]


def test_case_a_sharded_equals_single_device(case_a, monkeypatch):
    from hinge_tpu_torch.stages import layout as layout_mod

    queries = []
    fn = layout_mod.run_sharded_matching_position

    def spy(ov_idx, *a, **kw):
        queries.append(len(ov_idx))
        return fn(ov_idx, *a, **kw)

    monkeypatch.setattr(layout_mod, "run_sharded_matching_position", spy)
    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    monkeypatch.setenv("HINGE_SHARDED", "1")
    monkeypatch.setenv("HINGE_MESH_SHARDS", "4")
    wd = str(case_a["tmp"] / "sharded")
    assemble_port(case_a["fasta"], case_a["las"], wd)
    assert sum(queries) > 0
    assert_same_files(case_a["runs"]["torch"][0], wd)


def test_hinge_tpu_reproduces_golden_repeats(tmp_path):
    from tests.make_golden_repeats import build_golden

    build_golden(str(tmp_path))
    assert GR.mismatches(str(tmp_path)) == []


def test_port_reproduces_golden_repeats(tmp_path):
    GR.build(str(tmp_path), device="cpu")
    assert GR.mismatches(str(tmp_path)) == []


def test_demo_ini_copy():
    assert GR.YEAST_DEMO_INI == YEAST_DEMO_INI


def test_simulators_agree_on_the_yeast_shape(tmp_path, monkeypatch):
    """Chromosomes, telomere blocks and reads, cross-chromosome repeats
    and read errors (the yeast workload's features, at 3 x 60 kb): the
    port's simulator, in one process (one core) and in three forked ones
    (three cores), and its writers give hinge_tpu's bytes."""
    import dataclasses

    from hinge_tpu_torch.data.simulator import SimParams as PortParams
    from hinge_tpu_torch.data.simulator import simulate as port_simulate
    from hinge_tpu_torch.io.fasta import write_fasta as port_fasta
    from hinge_tpu_torch.io.las import write_las as port_las

    kw = dict(chromosomes=(60_000, 50_000, 40_000), telomere_len=6_000,
              telomere_unit=400, telomere_cross_cap=900, coverage=10.0,
              mean_read_len=8_000, std_read_len=1_600,
              extra_reads=((0, 14_000, 0), (135_000, 14_000, 1)),
              repeats=((20_000, 80_000, 12_000), (30_000, 120_000, 6_000)),
              seed=4, **GR.READ_ERRORS)
    ref_fasta, ref_las = write_inputs(tmp_path, SimParams(**kw))
    for cores in (1, 3):
        monkeypatch.setattr(os, "cpu_count", lambda: cores)
        _, _, rs, ov = port_simulate(PortParams(**kw))
        port_fasta(str(tmp_path / "port.fasta"),
                   ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
        port_las(str(tmp_path / "port.las"), ov)
        assert ov.n > 1000 and (ov.a_id == ov.b_id).any()
        assert GR.sha256(tmp_path / "port.fasta") == GR.sha256(ref_fasta)
        assert GR.sha256(tmp_path / "port.las") == GR.sha256(ref_las), cores
    assert dataclasses.asdict(PortParams(**kw)) == dataclasses.asdict(SimParams(**kw))


def test_yeast_manifest_describes_the_workload():
    """The manifest chip_smoke.py checks the card against was made from
    the workload this module defines, and shows the repeat path."""
    from hinge_tpu_torch.data.simulator import SimParams as PortParams

    with open(GR.MANIFEST) as f:
        man = json.load(f)
    assert man["params"] == GR.params_record(GR.yeast_params(SimParams))
    assert man["params"] == GR.params_record(GR.yeast_params(PortParams))
    assert sum(GR.YEAST_CHROMOSOMES) == 12_071_326
    starts = GR.chrom_starts()
    assert GR.yeast_repeats()[0] == (starts[3] + 400_000, starts[6] + 300_000,
                                     25_000)
    assert set(GR.POST_DRAFT) < set(man["files"])
    assert "asm1.G3.graphml" in man["files"] and man["final_graph"] == "G3"
    assert man["hinged_edges"] >= 1 and man["contigs"] >= 16
    assert min(man["coverage"]) >= 0.9


@pytest.mark.slow
def test_yeast_manifest_rebuilds(tmp_path):
    """hinge_tpu rebuilds the committed manifest exactly (~8 minutes and
    ~10 GB of host memory: the 12.07 Mb simulation and its assembly)."""
    from tests.make_golden_repeats import build_manifest

    with open(GR.MANIFEST) as f:
        want = json.load(f)
    got = json.loads(json.dumps(build_manifest(str(tmp_path),
                                               log=lambda *a: None)))
    assert got == want
