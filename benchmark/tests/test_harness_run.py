"""The arithmetic of a run: `assemble_s` over whole calls, the device's
busy union and idle gaps from a trace, and a result line with exactly
the contract's keys, from the rest of a run driven on the CPU."""

import argparse
import json
import os
import time

import pytest

from benchmark import harness, spec, trace
from benchmark.tests import tiny


def test_window_counts_every_call_that_starts_in_time():
    now = [0.0]
    walls = iter([3.0, 4.0, 5.0, 6.0])

    def call():
        w = next(walls)
        now[0] += w
        return (w, {}, None)

    got = harness.window(call, 10.0, clock=lambda: now[0])
    # calls start at 0, 3 and 7 s; the fourth would start at 12 s
    assert got == [3.0, 4.0, 5.0]
    assert sum(got) / len(got) == 4.0
    assert harness.window(lambda: None, 10.0) == []


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_busy_union_and_idle_gaps_by_stage():
    events = [
        _x(trace.WINDOW_SPAN, 0, 100, "user_annotation"),
        _x("stage.a", 0, 40, "user_annotation"),
        _x("stage.b", 40, 50, "user_annotation"),
        _x("k1", 10, 10, "kernel"), _x("k2", 15, 15, "kernel"),
        _x("Memcpy HtoD", 50, 10, "gpu_memcpy"),
        _x("k1", 95, 20, "kernel"),  # runs past the window's end
        _x("cpu op", 0, 100, "cpu_op"),
    ]
    got = trace.summary(events)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(35e-6)
    idle = dict(got["idle_gaps"])
    assert idle["a"] == pytest.approx(20e-6)  # [0, 10) and [30, 40)
    assert idle["b"] == pytest.approx(40e-6)  # [40, 50) and [60, 90)
    assert idle["pipeline"] == pytest.approx(5e-6)  # [90, 95)
    assert dict(got["device_ops"]) == pytest.approx(
        {"k1": 30e-6, "k2": 15e-6, "Memcpy HtoD": 10e-6})


def _run(root, name, capsys, trace_flag=0, seconds=0.5, seed=11):
    bench = spec.benchmark(root)
    cell = spec.Cell(name, bench, root)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace_flag)
    tmp = os.path.join(root, "run")
    os.makedirs(tmp, exist_ok=True)
    rc = harness.run_cell(cell, bench, args, tmp, time.perf_counter(),
                          device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, cell, bench, (json.loads(out[-1]) if out else None)


@pytest.fixture
def root(tmp_path, monkeypatch):
    r = tiny.make_root(str(tmp_path))
    monkeypatch.setattr(spec, "ROOT", r)
    return r


def test_result_line_has_the_contracts_keys(root, capsys):
    rc, cell, bench, line = _run(root, "tiny_fasta", capsys)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end(bench)}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_reads_every_listed_metric(root, capsys, monkeypatch):
    # both timed ops run on the CPU under these switches (their twins)
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    monkeypatch.setenv("HINGE_FAST_ALIGN", "1")
    # the CPU has no device memory counter: stand one in
    monkeypatch.setattr(harness, "_peak", lambda cuda: 1 << 20)
    rc, cell, bench, line = _run(root, "tiny_fasta", capsys, trace_flag=1)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer(bench)}
    assert line["metrics"]["join_thin_roofline"]["value"] > 0
    assert line["metrics"]["draft_align_roofline"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


def test_a_listed_op_that_never_runs_fails_the_run(root, capsys, monkeypatch):
    # on the CPU the C join runs by default, so p3 (thin_rows) never does
    monkeypatch.delenv("HINGE_DEVICE_JOIN", raising=False)
    monkeypatch.setattr(harness, "_peak", lambda cuda: 1 << 20)
    rc, *_, line = _run(root, "tiny_fasta", capsys, trace_flag=1)
    assert rc != 0 and line is None
