"""A checkout-shaped directory for the CPU tests: BENCHMARK.json and
benchmark/ copied, with a tiny configuration (a circular genome of
`genome_len` bases, the E. coli configuration's reads and ini) and a
cell on it for each input form, each carrying the E. coli cell's limits
(but the overlapper's where it does not run) and the per-layer metrics
that the E. coli cell (FASTA) or the yeast cell (.las) lists; and a tiny
repeat configuration (three linear chromosomes with a 25 kb and a 6 kb
repeat and telomeres, the yeast configuration's reads and ini) with a
.las cell carrying the yeast cell's limits."""

import json
import os
import shutil

from benchmark import spec


def make_root(dst: str, genome_len: int = 120_000) -> str:
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = spec.benchmark()
    cfg = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs",
                                      "ecoli_k12_pacbio.json"))
    cfg.update(name="tiny", chromosomes=[["tiny", genome_len]])
    with open(os.path.join(dst, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for form, like in (("fasta", "ecoli_fasta"), ("las", "yeast7_las")):
        name = "tiny_" + form
        cell = {"name": name, "config": "tiny", "traffic": "pacbio_" + form,
                "chips": 1, "why": "test"}
        bench["workloads"].append(cell)
        limits = {k: v for k, v in spec.Cell("ecoli_fasta", spec.benchmark()).limits.items()
                  if form == "fasta" or not k.startswith("ovl_")}
        with open(os.path.join(dst, "benchmark", "workloads", name + ".json"), "w") as f:
            json.dump({"limits": limits}, f)
        for m in bench["per_layer"]:
            if like in m["workloads"]:
                m["workloads"].append(name)
    rep = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs",
                                      "yeast_w303_7chr.json"))
    rep.update(name="tiny_rep",
               chromosomes=[["A", 200_000], ["B", 260_000], ["C", 180_000]],
               repeats=[{"src": ["A", 60_000], "dst": ["B", 100_000], "len": 25_000},
                        {"src": ["A", 150_000], "dst": ["C", 90_000], "len": 6_000},
                        {"src": ["A", 150_000], "dst": ["B", 200_000], "len": 6_000}])
    with open(os.path.join(dst, "benchmark", "configs", "tiny_rep.json"), "w") as f:
        json.dump(rep, f)
    bench["configs"].append({"name": "tiny_rep", "source": "test",
                             "file": "benchmark/configs/tiny_rep.json",
                             "reduced": [], "why": "test"})
    yeast = [w for w in spec.benchmark()["workloads"]
             if w["config"] == "yeast_w303_7chr"][0]
    bench["workloads"].append({"name": "tiny_rep_las", "config": "tiny_rep",
                               "traffic": yeast["traffic"], "chips": 1,
                               "why": "test"})
    limits = spec.Cell(yeast["name"], spec.benchmark()).limits
    # lga50 is the genome's own: the program reads 5 here (three short
    # chromosomes, broken at the repeats), the contigs shuffled 33
    limits["lga50"] = 12
    with open(os.path.join(dst, "benchmark", "workloads", "tiny_rep_las.json"), "w") as f:
        json.dump({"limits": limits}, f)
    for m in bench["per_layer"]:
        if yeast["name"] in m["workloads"]:
            m["workloads"].append("tiny_rep_las")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst
