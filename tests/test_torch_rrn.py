"""HINGE's repeat path on a circle with a seven-copy repeat family, from
FASTA through the built-in overlapper, the port against hinge_tpu on the
CPU.

The workload is tests/torch_golden_repeats.py's "rrn": a 150 kb circular
genome carrying seven identical 5 kb copies (E. coli K-12's rrn operons
at a thirtieth of its length), read at 30x, with two read profiles:

- `bridged`: the E. coli cells' 8 kb reads, most of which span a copy:
  the filter calls hinges at the copies and the layout kills them;
- `unbridged`: 3 kb reads, shorter than a copy: hinges survive into
  hinge.list and the layout chooses hinged edges.

Each profile's reads go through hinge_tpu's assemble() and the port's
(the C join, and the device join's CPU twin, HINGE_DEVICE_JOIN=1), with
HINGE_PARITY_ALIGN=1 on every side, and:

- every file, edges.hinges, hinge.list and the clip graphml among them,
  is byte-equal to hinge_tpu's, and the twin's to the C join's;
- every hinge the filter calls lies inside a copy or within the layout's
  hinge_slack of one, by the simulator's map of each read base to the
  genome;
- the recorder's hinge counters equal what hinges.txt, hinge.list and
  edges.hinges hold, the same on both joins, and the spans
  `filter.hinges` and `layout.hinge_graph` sit in their stages.
"""

import os

import numpy as np
import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu_torch.config import nominal_config
from hinge_tpu_torch.stages.layout import load_marked
from tests import torch_golden_repeats as GR
from tests.test_torch_repeats import assert_same_files

#: the recorder's hinge counters
COUNTERS = ("filter.in_hinges", "filter.out_hinges", "layout.hinges_killed",
            "layout.hinged_edges")


def _assemble_port(fasta, workdir, join):
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import last_call

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_DEVICE_JOIN", join)
        assemble(fasta=fasta, workdir=workdir, log=lambda *a: None,
                 device="cpu")
    return last_call()


@pytest.fixture(scope="module", params=sorted(GR.RRN_READS))
def rrn(request, tmp_path_factory):
    """The profile's simulated reads, and the workdirs and (for the port)
    recorded calls of hinge_tpu's assemble() and the port's on each
    join."""
    from hinge_tpu.pipeline import assemble as assemble_jax

    tmp = tmp_path_factory.mktemp("rrn_" + request.param)
    _, reads, rs, _ = simulate(GR.rrn_params(SimParams, request.param))
    fasta = str(tmp / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_PARITY_ALIGN", "1")
        assemble_jax(fasta=fasta, workdir=str(tmp / "jax"), log=lambda *a: None)
        for name, join in (("c_join", "0"), ("twin", "1")):
            wd = str(tmp / name)
            runs[name] = (wd, _assemble_port(fasta, wd, join))
    return dict(profile=request.param, reads=reads, jax=str(tmp / "jax"),
                runs=runs)


def _lines(workdir, name):
    with open(os.path.join(workdir, "asm" + name)) as f:
        return [ln.split() for ln in f if ln.strip()]


def test_rrn_files_equal_hinge_tpus(rrn):
    names = assert_same_files(rrn["jax"], rrn["runs"]["c_join"][0])
    assert {"asm.edges.hinges", "asm.hinge.list", "asm1.G0.graphml",
            "asm1.G1.graphml", "asm1.G2.graphml"} <= set(names)
    assert_same_files(rrn["runs"]["c_join"][0], rrn["runs"]["twin"][0])
    wd = rrn["jax"]
    hinged = sum(t[5] == "1" for t in _lines(wd, ".edges.hinges"))
    if rrn["profile"] == "unbridged":
        assert _lines(wd, ".hinge.list") and hinged >= 1
    else:
        assert sum(len(t) > 1 for t in _lines(wd, ".hinges.txt")) >= 7


def test_rrn_hinges_lie_at_the_copies(rrn):
    """A hinge at read position p maps to the genome through the read's
    base map (reversed on the reverse strand); it lies inside a copy or
    within hinge_slack of one, on the circle."""
    slack = nominal_config().layout.hinge_slack
    copies = np.array(GR.rrn_copies())
    n = 0
    for t in _lines(rrn["runs"]["c_join"][0], ".hinges.txt"):
        r = rrn["reads"][int(t[0])]
        for pos in map(int, t[1::2]):
            k = min(pos, len(r.gmap) - 1)
            g = int(r.gmap[k if r.strand == 0 else len(r.gmap) - 1 - k])
            g %= GR.RRN_GENOME
            outside = np.maximum(np.maximum(copies[:, 0] - g, g - copies[:, 1]), 0)
            assert outside.min() <= slack, (t[0], pos, g)
            n += 1
    assert n > 0


@pytest.mark.parametrize("join", ["c_join", "twin"])
def test_rrn_hinge_counters_equal_the_files(rrn, join):
    wd, call = rrn["runs"][join]
    c = call.counters
    kinds = [int(x) for t in _lines(wd, ".hinges.txt") for x in t[2::2]]
    assert c["filter.in_hinges"] == kinds.count(1) > 0
    assert c["filter.out_hinges"] == kinds.count(-1) > 0
    marked = sum(len(v) for v in load_marked(os.path.join(wd, "asm.hinges.txt")).values())
    assert c["layout.hinges_killed"] == marked - len(_lines(wd, ".hinge.list"))
    assert c["layout.hinged_edges"] == sum(
        t[5] == "1" for t in _lines(wd, ".edges.hinges"))
    other = rrn["runs"]["twin" if join == "c_join" else "c_join"][1]
    assert {k: c[k] for k in COUNTERS} == {k: other.counters[k] for k in COUNTERS}
    spans = {sp.id: sp for sp in call.spans}
    for name, stage in (("filter.hinges", "filter"),
                        ("layout.hinge_graph", "layout")):
        got = call.named(name)
        assert got and all(spans[sp.parent].name == stage for sp in got)
        assert call.self_s(name) >= 0
