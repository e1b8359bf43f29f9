"""The benchmark's data, found by name: the cells and metrics of
BENCHMARK.json, a cell's limits (`workloads/<cell>.json`), its
configuration (the file BENCHMARK.json names), its mix
(`traffic/mixes/<traffic>.json`), its ini, and a per-layer metric's
reader (`metrics/<name>.py`).  No cell, configuration, mix or metric is
named in code: a new one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One cell: its BENCHMARK.json entry, its limits, its configuration,
    mix and ini, resolved from `root`."""

    def __init__(self, name: str, bench: dict, root: str = ROOT):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"(cells: {sorted(entries)})")
        self.name, self.entry, self.root = name, entries[name], root
        bdir = os.path.join(root, "benchmark")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.mix = load_json(os.path.join(bdir, "traffic", "mixes",
                                          self.entry["traffic"] + ".json"))
        self.ini = os.path.join(root, self.config["ini"])
        self.limits = dict(load_json(os.path.join(
            bdir, "workloads", name + ".json"))["limits"])

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self, bench: dict) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self, bench: dict) -> list:
        """The per-layer metrics this cell reports."""
        return [m for m in bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def reader(name: str, root: str = ROOT):
    """The `read(ctx)` function of per-layer metric `name`, from
    `benchmark/metrics/<name>.py`."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    mod_name = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"per-layer metric {name!r} has no reader "
                                f"at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
