"""Cells, configurations, mixes and per-layer metrics are found by name
from their files, and new ones dropped in as files are taken up; the
shipped BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import spec
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_and_metric_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"], bench)
        assert os.path.isfile(cell.ini)
        assert cell.mix["input"] in ("fasta", "las")
        assert cell.end_to_end(bench) and cell.per_layer(bench)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        for w in m["workloads"]:
            assert w in {c["name"] for c in bench["workloads"]}


def test_benchmark_json_keeps_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_config_mix_and_metric_are_taken_up_as_files(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "traffic", "mixes", "dummy_mix.json"), "w") as f:
        json.dump({"input": "fasta", "coverage": 5.0}, f)
    with open(os.path.join(bdir, "metrics", "dummy.count.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {"name": "dummy_cell", "config": "tiny", "traffic": "dummy_mix",
            "chips": 1, "why": "a cell added as files"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "dummy.count", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "pipeline", "moves": "assemble_s",
                               "workloads": ["dummy_cell"]})
    with open(os.path.join(bdir, "workloads", "dummy_cell.json"), "w") as f:
        json.dump({"limits": {"cons_err": 0.1}}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    got = spec.Cell("dummy_cell", spec.benchmark(root), root)
    assert got.config["name"] == "tiny" and got.mix["coverage"] == 5.0
    assert [m["name"] for m in got.per_layer(spec.benchmark(root))] == ["dummy.count"]
    assert spec.reader("dummy.count", root)({}) == 42.0


def test_a_cell_is_its_benchmark_json_entry_and_its_limits(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bdir = os.path.join(root, "benchmark")
    assert set(spec.load_json(os.path.join(bdir, "workloads",
                                           "tiny_fasta.json"))) == {"limits"}
    bench = spec.benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == "tiny_fasta":
            w["chips"] = 4
    cell = spec.Cell("tiny_fasta", bench, root)
    assert cell.chips == 4 and cell.mix["input"] == "fasta"
    with pytest.raises(KeyError):
        spec.Cell("no_such_cell", spec.benchmark(root), root)


def test_a_mix_changes_the_configurations_reads():
    from benchmark.traffic import generate

    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "ecoli_k12_pacbio.json"))
    p = generate.sim_params(cfg, {"input": "fasta"}, 5)
    assert (p.sub_rate, p.ins_rate, p.del_rate, p.coverage) == (
        cfg["sub_rate"], cfg["ins_rate"], cfg["del_rate"], cfg["coverage"])
    p = generate.sim_params(cfg, {"input": "fasta", "sub_rate": 0.001}, 5)
    assert p.sub_rate == 0.001 and p.ins_rate == cfg["ins_rate"]
