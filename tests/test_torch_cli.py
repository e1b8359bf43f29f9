"""The port's `hinge` command surface against hinge_tpu's.

The per-stage chain (filter ... gfa) runs in process through
`hinge_tpu.cli.main(argv)` and `hinge_tpu_torch.cli.main(argv + ["--device",
"cpu"])` on the same reads, written as DAZZ_DB `.db` (with its qual track)
+ `.las` and as FASTA + `.las`; every file each verb writes must be
byte-equal, and so must its printed summary.  Both sides pin
HINGE_PARITY_ALIGN=1 (the draft aligner) and HINGE_JAX_CACHE=0.
"""

import argparse
import contextlib
import filecmp
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import hinge_tpu.cli as HC
import hinge_tpu_torch.cli as TC
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.dazz_db import write_db
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import write_las

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"HINGE_PARITY_ALIGN": "1", "HINGE_JAX_CACHE": "0"}
CHAIN = ("filter", "maximal", "layout", "clip", "draft-path", "draft",
         "correct-head", "map", "consensus", "gfa")
#: the verbs that reach a device op and take --device
DEVICE_VERBS = ("filter", "maximal", "layout", "draft", "consensus",
                "overlap", "assemble", "sweep")
#: files each chain verb must write (beside any others it writes)
REQUIRED = {
    "filter": ["X.mas", "X.cmas", "X.repeat.txt", "X.hinges.txt",
               "X.cov.flag", "X.self.flag", "X.coverage.txt"],
    "maximal": ["X.max"],
    "layout": ["X.edges.hinges", "X.hinge.list"],
    "clip": ["X1.G0.graphml", "X1.G1.graphml", "X1.G2.graphml"],
    "draft-path": ["X.edges.list", "X_draft.graphml"],
    "draft": ["X.draft.fasta"],
    "correct-head": ["X.draft.pb.fasta", "draft_map.txt"],
    "map": ["draft.las"],
    "consensus": ["X.consensus.fasta"],
    "gfa": ["X_consensus.gfa"],
}
#: every subcommand name of hinge_tpu/cli.py, aliases included
SUBCOMMANDS = (
    "filter", "maximal", "layout", "clip", "clip-nanopore", "draft-path",
    "draft", "correct-head", "correct_head", "map", "consensus", "gfa",
    "condense", "visualize", "visualise", "split_las", "merge_las",
    "merge-las", "fasta2q", "overlap", "gt", "n50", "unitig", "fasta2fastq",
    "clip-ends", "bandage", "condense-gfa", "draw", "hgraph", "create-hgraph",
    "connected", "repeat-annotate", "repeat_annotate", "merge-hinges",
    "merge_hinges", "single-strand", "norevcomp", "assemble", "sweep",
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_cli_pipeline.py's 40 kb / 16x reads, with read errors and
    300 bp of bad-QV read ends so the filter's QV mask has work."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    _, _, rs, ov = simulate(SimParams(
        genome_len=40_000, coverage=16.0, mean_read_len=4500,
        std_read_len=900, seed=33, sub_rate=0.01, ins_rate=0.005,
        del_rate=0.005, bad_end_len=300))
    d = dict(tmp=tmp, db=str(tmp / "reads.db"), las=str(tmp / "reads.las"),
             fasta=str(tmp / "reads.fasta"))
    write_db(d["db"], rs)
    write_las(d["las"], ov)
    write_fasta(d["fasta"], ((rs.names[i], rs.get_seq(i))
                             for i in range(rs.n_reads)))
    return d


def _chain_argvs(kind, data):
    las = data["las"]
    inp = ["--db", data["db"]] if kind == "db" else ["--fasta", data["fasta"]]
    reads = data["db"] if kind == "db" else data["fasta"]
    return [
        ["filter", *inp, "--las", las, "-x", "X"],
        ["maximal", *inp, "--las", las, "-x", "X"],
        ["layout", *inp, "--las", las, "-x", "X", "--out", "X"],
        ["clip", "X.edges.hinges", "X.hinge.list", "1"],
        ["draft-path", ".", "X", "X1.G2.graphml", *inp],
        ["draft", *inp, "--las", las, "-x", "X", "--out", "X.draft"],
        ["correct-head", "X.draft.fasta", "X.draft.pb.fasta", "draft_map.txt"],
        ["map", "X.draft.fasta", *inp, "--out", "draft.las"],
        ["consensus", "X.draft.fasta", reads, "draft.las", "X.consensus.fasta"],
        ["gfa", ".", "X", "X.consensus.fasta"],
    ]


def _snapshot(wd):
    return {f: os.stat(os.path.join(wd, f)).st_mtime_ns for f in os.listdir(wd)
            if os.path.isfile(os.path.join(wd, f))}


def _run_chain(main, wd, argvs, extra):
    """Run the chain in `wd`; per verb, the files it wrote and its stdout."""
    os.makedirs(wd)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.chdir(wd)
        for argv in argvs:
            before = _snapshot(wd)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv + (extra if argv[0] in DEVICE_VERBS else []))
            assert rc == 0, argv
            after = _snapshot(wd)
            out[argv[0]] = (sorted(f for f in after if before.get(f) != after[f]),
                            buf.getvalue())
    return out


@pytest.fixture(scope="module")
def chain_runs(data):
    """get(kind): both packages' chains on one input kind, run once."""
    runs = {}

    def get(kind):
        if kind not in runs:
            argvs = _chain_argvs(kind, data)
            ref_wd = str(data["tmp"] / f"ref_{kind}")
            port_wd = str(data["tmp"] / f"port_{kind}")
            ref = _run_chain(HC.main, ref_wd, argvs, [])
            port = _run_chain(TC.main, port_wd, argvs, ["--device", "cpu"])
            runs[kind] = dict(kind=kind, ref_wd=ref_wd, port_wd=port_wd,
                              ref=ref, port=port)
        return runs[kind]

    return get


@pytest.fixture(params=["db", "fasta"])
def chains(request, chain_runs):
    return chain_runs(request.param)


@pytest.mark.parametrize("verb", CHAIN)
def test_chain_verb_writes_equal_files(chains, verb):
    """Each verb of the chain writes the same files as hinge_tpu's, byte for
    byte, and prints the same summary."""
    ref_files, ref_out = chains["ref"][verb]
    port_files, port_out = chains["port"][verb]
    assert port_files == ref_files
    for name in REQUIRED[verb]:
        assert name in ref_files, (verb, name, ref_files)
    for name in ref_files:
        assert filecmp.cmp(os.path.join(chains["ref_wd"], name),
                           os.path.join(chains["port_wd"], name),
                           shallow=False), (chains["kind"], verb, name)
    assert port_out == ref_out


def test_read_mas_equal(chains):
    from hinge_tpu.stages.maximal import read_mas as ref_read_mas
    from hinge_tpu_torch.stages.maximal import read_mas

    path = os.path.join(chains["port_wd"], "X.mas")
    n = 1 + max(int(line.split()[0]) for line in open(path))
    got, want = read_mas(path, n + 3), ref_read_mas(path, n + 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] > got[0]).any()


def _chain_equals_assemble(chain_wd, asm_wd):
    """The chain's files equal, byte for byte, to the file of the same
    name (prefix X -> asm) that assemble() wrote."""
    equal = set()
    for name in os.listdir(chain_wd):
        other = os.path.join(asm_wd, chip_smoke.assemble_name(name))
        if os.path.isfile(other) and filecmp.cmp(
                os.path.join(chain_wd, name), other, shallow=False):
            equal.add(name)
    return equal


def test_chain_equals_assemble_as_in_hinge_tpu(data, chain_runs, tmp_path,
                                               monkeypatch):
    """The stage files that hinge_tpu's CLI chain and its
    assemble(db=, las=) write equal are equal between the port's two runs
    too; chip_smoke.py phase 8 compares exactly that list on the card."""
    chains = chain_runs("db")
    from hinge_tpu.pipeline import assemble as ref_assemble
    from hinge_tpu_torch.pipeline import assemble

    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    ref_wd, port_wd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_assemble(db=data["db"], las=data["las"], workdir=ref_wd,
                 log=lambda *a: None)
    assemble(db=data["db"], las=data["las"], workdir=port_wd,
             log=lambda *a: None, device="cpu")
    ref_eq = _chain_equals_assemble(chains["ref_wd"], ref_wd)
    port_eq = _chain_equals_assemble(chains["port_wd"], port_wd)
    assert port_eq == ref_eq
    assert ref_eq == set(chip_smoke.CHAIN_EQUALS_ASSEMBLE)


def _parser_of(main, monkeypatch):
    """The ArgumentParser that `main` builds, caught at parse_args."""
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    with monkeypatch.context() as mp:
        mp.setenv("HINGE_JAX_CACHE", "0")
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(SystemExit):
            main([])
    sub = next(a for a in seen[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _flags(parser):
    return sorted((tuple(a.option_strings), a.dest, str(a.nargs),
                   repr(a.default), a.required, repr(a.type),
                   repr(a.choices), repr(a.const))
                  for a in parser._actions
                  if not isinstance(a, argparse._HelpAction))


@pytest.fixture(scope="module")
def parsers():
    with pytest.MonkeyPatch.context() as mp:
        return _parser_of(HC.main, mp), _parser_of(TC.main, mp)


def test_subcommand_names_equal(parsers):
    ref, port = parsers
    assert sorted(port) == sorted(ref) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommand_flags_equal(parsers, name):
    """Same flags, positionals and defaults as hinge_tpu's subcommand; the
    device verbs add only --device, default cuda."""
    ref, port = parsers
    got = _flags(port[name])
    dev = [f for f in got if f[0] == ("--device",)]
    if name in DEVICE_VERBS:
        assert dev == [(("--device",), "device", "None", "'cuda'", False,
                        "None", "None", "None")]
    else:
        assert dev == []
    assert [f for f in got if f not in dev] == _flags(ref[name])


def test_hinge_verb_table(tmp_path):
    """`python -m hinge_tpu_torch.hinge` has bin/hinge's verb table: every
    verb's --help exits 0; no verb or an unknown one exits 1 with the
    hinge(1) pointer."""
    from hinge_tpu_torch.hinge import VERBS

    assert VERBS == runpy.run_path(os.path.join(ROOT, "bin", "hinge"),
                                   run_name="bin_hinge")["VERBS"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = [sys.executable, "-m", "hinge_tpu_torch.hinge"]
    procs = {verb: subprocess.Popen(run + [verb, "--help"], env=env,
                                    cwd=str(tmp_path), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for verb in VERBS}
    for extra in ([], ["no-such-verb"]):
        r = subprocess.run(run + extra, capture_output=True, text=True,
                           env=env, cwd=str(tmp_path), timeout=120)
        assert r.returncode == 1 and "hinge(1)" in r.stderr
    for verb, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (verb, err[-400:])
        assert "usage:" in out


@pytest.mark.parametrize("argv", [
    ["filter"], ["maximal"], ["layout", "--out", "X"], ["draft", "--out", "X"],
    ["consensus", "d.fasta", "r.fasta", "d.las", "c.fasta"],
    ["overlap", "--out", "o.las"], ["assemble"], ["sweep"],
], ids=lambda a: a[0])
def test_device_verb_without_card_raises(argv, tmp_path, monkeypatch):
    """A device verb run without --device asks for CUDA, and raises
    before it reads any input when there is no card."""
    from hinge_tpu_torch.device import DeviceError

    assert argv[0] in DEVICE_VERBS
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="is_available"):
        TC.main(argv)
    assert os.listdir(tmp_path) == []
