"""The port's graph tools, small utilities, QV codec, intrinsic QV and
accuracy sweep against hinge_tpu's, on the same inputs.

Each tool runs through both CLIs in process (`hinge_tpu.cli.main` and
`hinge_tpu_torch.cli.main`), in a directory of its own per package that
holds the same input files; every file it writes and its printed summary
must be byte-equal.  The inputs are those of tests/test_analysis_tools.py,
tests/test_analysis_utils.py and tests/test_merge_hinges.py.
"""

import contextlib
import filecmp
import io
import json
import os
import shutil

import numpy as np
import pytest

import chip_smoke
import hinge_tpu.cli as HC
import hinge_tpu_torch.cli as TC
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.dazz_db import write_db
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import read_las, write_las
from hinge_tpu_torch.data.carry import (overlap_store_from_arrays,
                                        read_store_from_arrays)
from tests.test_qv_codec import _make_quiva


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """One directory of tool inputs: the 60 kb / one-repeat layout of
    tests/test_merge_hinges.py run through hinge_tpu's chain up to
    draft-path (with its ground-truth mapping), plus the literal inputs of
    the analysis tests."""
    d = tmp_path_factory.mktemp("tools_in")
    genome, reads, rs, ov = simulate(SimParams(
        genome_len=60_000, coverage=20.0, mean_read_len=5000,
        std_read_len=1200, repeats=((5_000, 35_000, 3_000),), seed=7))
    write_db(str(d / "reads.db"), rs)
    write_las(str(d / "reads.las"), ov)
    write_fasta(str(d / "reads.fasta"),
                ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_fasta(str(d / "genome.fasta"), [("1", "".join(
        "ACGT"[b] for b in genome))])
    with open(d / "X.mapping.json", "w") as f:
        json.dump({str(i): [[int(r.start), int(r.end), 0]]
                   for i, r in enumerate(reads)}, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_JAX_CACHE", "0")
        mp.chdir(d)
        io_ = ["--db", "reads", "--las", "reads.las", "-x", "X"]
        for argv in (["filter", *io_], ["maximal", *io_],
                     ["layout", *io_, "--out", "X"],
                     ["clip", "X.edges.hinges", "X.hinge.list", "1"],
                     ["draft-path", ".", "X", "X1.G2.graphml", "--db", "reads"]):
            with contextlib.redirect_stdout(io.StringIO()):
                assert HC.main(argv) == 0
    # unitig reads the raw match coordinates under the attribute names of
    # the reference's unitig.py (read_a_start_raw, ...)
    (d / "X1.G2.raw.graphml").write_text(chip_smoke.unitig_input(
        (d / "X1.G2.graphml").read_text()))
    (d / "small.hgraph").write_text("3 7 1200 450 1 0\n7 9 450 880 0 1\n")
    (d / "arrows.txt").write_text("a->b\nb->c\nc->d\ne->f\nf->e\n")
    (d / "tri.edges").write_text("1 2\n2 3\n3 1\n")
    (d / "cycle.edges").write_text("".join(
        f"{i} {(i + 1) % 6} 2000 x x x x [0 5000] [0 5000]\n" for i in range(6)))
    (d / "ends_gt.txt").write_text("0 1 1000 6000\n1 1 40000 45000\n"
                                   "2 1 95000 99000\n3 1 99000 100000\n")
    (d / "ends.edges").write_text("0 1 x\n1 2 x\n1 1 y\n")
    rng = np.random.default_rng(4)
    rep = _rand_seq(rng, 150)
    (d / "rep_genome.fasta").write_text(
        ">1 chr\n" + _rand_seq(rng, 300) + rep + _rand_seq(rng, 250) + rep
        + _rand_seq(rng, 200) + "\n")
    (d / "rep_gt.txt").write_text("0 0 320 900\n1 0 10 120\n")
    (d / "pairs.fa").write_text(">c0\nACGT\n>c0_rc\nACGT\n>c1\nGGGG\n>c1_rc\nCCCC\n")
    return d


#: (case id, argv, files it must write); run in a copy of the inputs
TOOLS = [
    ("condense", ["condense", "X1.G2.graphml", "--out", "C.graphml"],
     ["C.graphml"]),
    ("condense-default-out", ["condense", "X_draft.graphml"],
     ["X_draft.condensed.graphml"]),
    ("visualize", ["visualize", "X.edges.hinges", "V.graphml"], ["V.graphml"]),
    ("visualise", ["visualise", "X.edges.list", "V2.graphml"], ["V2.graphml"]),
    ("n50-graphml", ["n50", "X_draft.graphml"], []),
    ("n50-fasta", ["n50", "reads.fasta"], []),
    ("unitig", ["unitig", "X1.G2.raw.graphml", "--out", "U.edges.list"],
     ["U.edges.list"]),
    ("unitig-default-out", ["unitig", "X1.G2.raw.graphml"], ["X1.edges.list"]),
    ("hgraph", ["hgraph", "small.hgraph", "--gt", "X.mapping.json",
                "--out", "H.graphml"], ["H.graphml"]),
    ("create-hgraph", ["create-hgraph", "X.hgraph", "--out", "H2.graphml"],
     ["H2.graphml"]),
    ("connected", ["connected", "arrows.txt", "dfs.txt", "--out", "K.graphml"],
     ["dfs.txt", "K.graphml"]),
    ("merge-hinges", ["merge-hinges", "X.edges.hinges2", "X.hgraph",
                      "X.hinge.list", "--gt", "X.mapping.json", "--prefix", "M"],
     ["M.G0_merged.graphml", "M.G0s_merged.graphml", "M.G1_merged.graphml",
      "M.Gs_merged.graphml", "M_hgraph2.graphml"]),
    ("merge-hinges-nogt", ["merge_hinges", "X.edges.hinges2", "X.hgraph",
                           "X.hinge.list", "--prefix", "N", "--seed", "3"],
     ["N.G0_merged.graphml", "N.G1_merged.graphml", "N_hgraph2.graphml"]),
    ("condense-gfa", ["condense-gfa", "cycle.edges", "--out-prefix", "c"],
     ["c.condensed.graphml", "c.bandage"]),
    ("condense-gfa-layout", ["condense-gfa", "X.edges.hinges2",
                             "--out-prefix", "CG"],
     ["CG.condensed.graphml", "CG.bandage"]),
    ("bandage", ["bandage", "tri.edges", "tri.bandage"], ["tri.bandage"]),
    ("bandage-layout", ["bandage", "X.edges.hinges", "X.bandage"],
     ["X.bandage"]),
    ("clip-ends", ["clip-ends", "ends_gt.txt", "ends.edges", "--out",
                   "ends.clipped"], ["ends.clipped"]),
    ("repeat-annotate", ["repeat-annotate", "rep_genome.fasta", "rep_gt.txt",
                         "rep.annot.txt", "--min-len", "100", "--repeats",
                         "reps.txt"], ["rep.annot.txt", "reps.txt"]),
    ("single-strand-even", ["single-strand", "pairs.fa", "even.fa"],
     ["even.fa"]),
    ("norevcomp-first", ["norevcomp", "pairs.fa", "first.fa", "--mode",
                         "first"], ["first.fa"]),
    ("fasta2q", ["fasta2q", "reads.fasta", "reads.fq"], ["reads.fq"]),
    ("fasta2fastq", ["fasta2fastq", "reads.fasta", "reads.fastq"],
     ["reads.fastq"]),
    ("split_las", ["split_las", "reads.las", "--max-records", "2000"],
     ["reads.1.las", "reads.2.las"]),
    ("gt", ["gt", "genome.fasta", "--fasta", "reads.fasta", "--out",
            "map.json"], ["map.json"]),
]


def _files(wd):
    """Each file of `wd` (not its log/ directory) with its mtime."""
    return {f: os.stat(os.path.join(wd, f)).st_mtime_ns for f in os.listdir(wd)
            if os.path.isfile(os.path.join(wd, f))}


def _run_tool(main, wd, argv):
    """Run one verb in `wd`: the files it wrote and what it printed."""
    before = _files(wd)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_JAX_CACHE", "0")
        mp.chdir(wd)
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
    after = _files(wd)
    return sorted(f for f in after if before.get(f) != after[f]), buf.getvalue()


@pytest.mark.parametrize("argv, outputs", [t[1:] for t in TOOLS],
                         ids=[t[0] for t in TOOLS])
def test_tool_outputs_equal(inputs, tmp_path, argv, outputs):
    ref_wd, port_wd = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(inputs, ref_wd)
    shutil.copytree(inputs, port_wd)
    ref_files, ref_out = _run_tool(HC.main, ref_wd, argv)
    port_files, port_out = _run_tool(TC.main, port_wd, argv)
    assert port_files == ref_files
    assert set(outputs) <= set(ref_files), ref_files
    for name in ref_files:
        assert filecmp.cmp(os.path.join(ref_wd, name),
                           os.path.join(port_wd, name), shallow=False), name
    assert port_out == ref_out and ref_out


def test_split_then_merge_las_roundtrips(inputs, tmp_path):
    """split_las then merge_las through the port's CLI gives back every
    record of the original (in LAmerge's order), column for column and
    trace value for value, and hinge_tpu's merged file byte for byte."""
    files = {}
    for name, main in (("ref", HC.main), ("port", TC.main)):
        wd = str(tmp_path / name)
        os.makedirs(wd)
        shutil.copy(inputs / "reads.las", wd)
        _run_tool(main, wd, ["split_las", "reads.las", "--max-records", "3000"])
        parts = sorted((f for f in os.listdir(wd) if f.startswith("reads.")
                        and f != "reads.las"), key=lambda f: int(f.split(".")[1]))
        assert len(parts) >= 2
        _run_tool(main, wd, ["merge-las", "merged.las", *parts])
        files[name] = os.path.join(wd, "merged.las")
    assert filecmp.cmp(files["ref"], files["port"], shallow=False)
    orig = read_las(str(inputs / "reads.las"))
    chip_smoke.check_las_roundtrip(orig, read_las(files["port"]))
    # the check sees a lost record and a changed trace value
    with pytest.raises(AssertionError, match="records"):
        chip_smoke.check_las_roundtrip(orig, orig.take(np.arange(1, orig.n)))
    bad = orig.take(np.lexsort((orig.a_start, orig.rc, orig.b_id, orig.a_id)))
    bad.trace = bad.trace.copy()
    bad.trace[int(bad.trace_off[5])] += 1
    with pytest.raises(AssertionError, match="trace"):
        chip_smoke.check_las_roundtrip(orig, bad)


def test_las_byte_traces_wrap_as_in_hinge_tpu(inputs, tmp_path):
    """At tspace <= 125 a `.las` holds trace values as bytes: both packages'
    write_las write the same file for a store with a value > 255, and it
    reads back wrapped to a byte.  (The map verb's draft.las goes through
    this; chip_smoke.py phase 8 checks the chain's consensus with it.)"""
    from hinge_tpu_torch.io.las import read_las as port_read_las
    from hinge_tpu_torch.io.las import write_las as port_write_las

    ov = read_las(str(inputs / "reads.las"))
    assert ov.tspace <= 125
    ov.trace = ov.trace.copy()
    k = int(ov.trace_off[3])
    ov.trace[k] = 300
    ref, port = str(tmp_path / "ref.las"), str(tmp_path / "port.las")
    write_las(ref, ov)
    port_write_las(port, overlap_store_from_arrays(vars(ov)))
    assert filecmp.cmp(ref, port, shallow=False)
    back = port_read_las(port)
    assert int(back.trace[int(back.trace_off[3])]) == 300 & 0xFF


def test_draw_writes_png(inputs, tmp_path):
    wd = str(tmp_path)
    shutil.copytree(inputs, wd, dirs_exist_ok=True)
    _, out = _run_tool(TC.main, wd, ["draw", "reads.las", "0", "--db", "reads",
                                     "--out", "p.png"])
    assert out.startswith("[draw] read 0: ") and not out.startswith(
        "[draw] read 0: 0 ")
    with open(os.path.join(wd, "p.png"), "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(os.path.join(wd, "p.png")) > 1000


@pytest.mark.parametrize("tspace", [100, 37])
def test_intrinsic_qv_equal(inputs, tspace):
    from hinge_tpu.io.dazz_db import read_db
    from hinge_tpu.ops import intrinsic_qv as ref_qv
    from hinge_tpu_torch.ops import intrinsic_qv as port_qv

    rs = read_db(str(inputs / "reads.db"), load_qual=False)
    ov = read_las(str(inputs / "reads.las"), read_lengths=rs.length)
    want = ref_qv.compute_intrinsic_qv(ov, rs.length, tspace)
    got = port_qv.compute_intrinsic_qv(overlap_store_from_arrays(vars(ov)),
                                       rs.length, tspace)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (want[1] < 51).any()
    prs = read_store_from_arrays(vars(rs))
    pov = overlap_store_from_arrays(vars(ov))
    assert port_qv.attach_intrinsic_qv(prs, pov, tspace) is prs
    ref_qv.attach_intrinsic_qv(rs, ov, tspace)
    np.testing.assert_array_equal(prs.qv_off, rs.qv_off)
    np.testing.assert_array_equal(prs.qv_val, rs.qv_val)


def _quiva_entries(tmp_path, with_runs, seed):
    rng = np.random.default_rng(seed)
    n_reads, mean_len = (300, 800) if with_runs else (20, 500)
    raw = _make_quiva(str(tmp_path / "in.quiva"), n_reads, mean_len, rng,
                      with_runs)
    return [dict(del_qv=d, del_tag=t, ins_qv=i, mrg_qv=m, sub_qv=s)
            for d, t, i, m, s in raw]


@pytest.mark.parametrize("with_runs", [False, True], ids=["plain", "runs"])
@pytest.mark.parametrize("writer", ["port", "hinge_tpu"])
def test_qvs_cross_decode(tmp_path, with_runs, writer):
    """A `.qvs` written by one package decodes with the other's reader to
    the same streams, and both encoders write the same bytes."""
    from hinge_tpu.io import qv as ref_qv
    from hinge_tpu_torch.io import qv as port_qv

    entries = _quiva_entries(tmp_path, with_runs, 23 + with_runs)
    paths = {w: str(tmp_path / f"{w}.qvs") for w in ("port", "hinge_tpu")}
    enc = port_qv.write_quiva_qvs(paths["port"], entries)
    ref_qv.write_quiva_qvs(paths["hinge_tpu"], entries)
    assert filecmp.cmp(paths["port"], paths["hinge_tpu"], shallow=False)
    assert (enc.del_char >= 0 and enc.sub_char >= 0) == with_runs
    reader = ref_qv if writer == "port" else port_qv
    rlens = [len(e["del_qv"]) for e in entries]
    assert reader.read_quiva_qvs(paths[writer], rlens) == entries


def test_read_db_qvs_on_written_db(tmp_path):
    """read_db_qvs decodes a DB written by the port's write_db with a `.qvs`
    from the port's encoder, equal to hinge_tpu's reader and to the input."""
    from hinge_tpu.io.qv import read_db_qvs as ref_read_db_qvs
    from hinge_tpu_torch.data.simulator import SimParams as PSimParams
    from hinge_tpu_torch.data.simulator import simulate as psimulate
    from hinge_tpu_torch.io import read_db_qvs
    from hinge_tpu_torch.io.dazz_db import _db_paths, write_db as pwrite_db
    from hinge_tpu_torch.io.qv import write_quiva_qvs

    _, _, rs, _ = psimulate(PSimParams(genome_len=15_000, coverage=4.0, seed=2))
    db = str(tmp_path / "reads.db")
    pwrite_db(db, rs)
    rng = np.random.default_rng(23)
    entries = []
    for i in range(rs.n_reads):
        rlen = int(rs.length[i])
        streams = [bytes(bytearray(int(x) for x in a)) for a in (
            rng.integers(0x21, 0x68, rlen), rng.choice(list(b"acgt"), rlen),
            rng.integers(0x21, 0x68, rlen), rng.integers(0x21, 0x68, rlen),
            rng.integers(0x21, 0x68, rlen))]
        entries.append(dict(zip(("del_qv", "del_tag", "ins_qv", "mrg_qv",
                                 "sub_qv"), streams)))
    _, idx_path, _ = _db_paths(db)
    write_quiva_qvs(idx_path[: -len(".idx")] + ".qvs", entries)
    got = read_db_qvs(db)
    assert got == entries
    assert ref_read_db_qvs(db) == got


def _toy_sweep(SW, monkeypatch, out, **kw):
    monkeypatch.setattr(SW, "REPEAT_PROFILES", [("plain", lambda L: ())])
    monkeypatch.setattr(SW, "COVERAGES", (14.0,))
    monkeypatch.setattr(SW, "READ_LENS", (4000, 99))  # 99 -> failing cell
    return SW.run_sweep(genome_len=60_000, seed=3, out_prefix=out,
                        log=lambda *a: None, **kw)


def test_sweep_cell_equal(tmp_path, monkeypatch):
    """tests/test_sweep.py's toy grid: one cell that assembles, one that
    fails; the same report fields as hinge_tpu's, all but wall_s."""
    from hinge_tpu.utils import sweep as ref_sw
    from hinge_tpu_torch.utils import sweep as port_sw

    want = _toy_sweep(ref_sw, monkeypatch, str(tmp_path / "ref"))
    got = _toy_sweep(port_sw, monkeypatch, str(tmp_path / "port"),
                     device="cpu")
    for c in want["cells"] + got["cells"]:
        c.pop("wall_s", None)
    assert got == want
    assert [c["ok"] for c in got["cells"]] == [True, False]
    assert json.load(open(tmp_path / "port.json"))["n_ok"] == 1


@pytest.mark.parametrize("fails_with, recorded", [
    ("ValueError", True), ("DeviceError", False), ("OutOfMemoryError", False)])
def test_sweep_records_cell_errors_but_not_device_errors(
        tmp_path, monkeypatch, fails_with, recorded):
    """A cell that raises is a failed cell of the report; an error of the
    device (no card, a kernel that fails to build or launch, out of device
    memory) ends the sweep."""
    import torch

    from hinge_tpu_torch.device import DeviceError
    from hinge_tpu_torch.utils import sweep as port_sw

    exc = {"ValueError": ValueError, "DeviceError": DeviceError,
           "OutOfMemoryError": torch.cuda.OutOfMemoryError}[fails_with]

    def cell(*a, **kw):
        raise exc("cell failed")

    monkeypatch.setattr(port_sw, "_cell", cell)
    if recorded:
        rep = _toy_sweep(port_sw, monkeypatch, None, device="cpu")
        assert [c["error"] for c in rep["cells"]] == \
            ["ValueError: cell failed"] * 2
    else:
        with pytest.raises(exc, match="cell failed"):
            _toy_sweep(port_sw, monkeypatch, None, device="cpu")
