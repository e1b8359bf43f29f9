"""A tiny rrn-style cell through a whole run on the CPU: the E. coli rrn
configuration cut to a 150 kb circle that keeps seven 5 kb copies of one
source, read as the `ecoli_rrn_fasta` cell reads it (FASTA only, the
built-in overlapper), judged under that cell's limits (but one that the
tiny genome reads high on its own) and reporting that cell's per-layer
metrics."""

import argparse
import json
import os
import time

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny

#: the tiny circle and its copies: a source and six destinations
GENOME = 150_000
SRC, DST, LEN = 100_000, (8_000, 30_000, 52_000, 74_000, 122_000, 140_000), 5_000
LIKE = "ecoli_rrn_fasta"


def make_rrn_root(dst: str) -> str:
    """tiny.make_root's checkout with a `tiny_rrn` configuration and a
    `tiny_rrn_fasta` cell carrying LIKE's mix, limits (but ovl_false) and
    metrics."""
    root = tiny.make_root(dst)
    bdir = os.path.join(root, "benchmark")
    like = spec.Cell(LIKE, spec.benchmark())
    cfg = dict(like.config, name="tiny_rrn", chromosomes=[["tiny", GENOME]],
               repeats=[{"src": ["tiny", SRC], "dst": ["tiny", d], "len": LEN}
                        for d in DST])
    with open(os.path.join(bdir, "configs", "tiny_rrn.json"), "w") as f:
        json.dump(cfg, f)
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "tiny_rrn", "source": "test",
                             "file": "benchmark/configs/tiny_rrn.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_rrn_fasta", "config": "tiny_rrn",
                               "traffic": like.entry["traffic"], "chips": 1,
                               "why": "test"})
    # ovl_false is the genome's own: seven copies in 150 kb make records
    # between copies 0.64 of the records here (0.04-0.07 at 4.64 Mb)
    limits = {k: v for k, v in like.limits.items() if k != "ovl_false"}
    with open(os.path.join(bdir, "workloads", "tiny_rrn_fasta.json"), "w") as f:
        json.dump({"limits": limits}, f)
    for m in bench["per_layer"]:
        if LIKE in m["workloads"]:
            m["workloads"].append("tiny_rrn_fasta")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def root(tmp_path, monkeypatch):
    r = make_rrn_root(str(tmp_path))
    monkeypatch.setattr(spec, "ROOT", r)
    return r


def _run(root, capsys, trace_flag):
    bench = spec.benchmark(root)
    cell = spec.Cell("tiny_rrn_fasta", bench, root)
    args = argparse.Namespace(workload=cell.name, seed=2_200_019_977,
                              seconds=0.5, trace=trace_flag)
    tmp = os.path.join(root, "run")
    os.makedirs(tmp, exist_ok=True)
    rc = harness.run_cell(cell, bench, args, tmp, time.perf_counter(),
                          device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, cell, bench, json.loads(out[-1])


def test_tiny_rrn_cell_keeps_the_copies(root):
    from benchmark.traffic.generate import make_inputs

    cell = spec.Cell("tiny_rrn_fasta", spec.benchmark(root), root)
    _, truth = make_inputs(cell.config, cell.mix, 3, os.path.join(root, "in"))
    g = truth.genome
    assert truth.circular and g.shape[0] == GENOME
    for d in DST:
        assert (g[d:d + LEN] == g[SRC:SRC + LEN]).all()


def test_tiny_rrn_cell_is_correct_under_its_limits(root, capsys):
    rc, cell, bench, line = _run(root, capsys, 0)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits) and "ovl_missed" in cell.limits
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end(bench)}


def test_tiny_rrn_traced_line_reads_every_listed_metric(root, capsys,
                                                         monkeypatch):
    # both timed ops run on the CPU under these switches (their twins)
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    monkeypatch.setenv("HINGE_FAST_ALIGN", "1")
    # the CPU has no device memory counter: stand one in
    monkeypatch.setattr(harness, "_peak", lambda cuda: 1 << 20)
    rc, cell, bench, line = _run(root, capsys, 1)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer(bench)}
