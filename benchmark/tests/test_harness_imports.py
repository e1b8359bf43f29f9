"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name (hinge_tpu_torch is not hinge_tpu), and the
reference and traffic load nothing of the port either."""

import ast
import os
import subprocess
import sys

from benchmark import harness, spec

BENCH = os.path.join(spec.ROOT, "benchmark")


def _fresh(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(r.stdout.split())


def test_reference_and_traffic_load_nothing_of_the_port_or_jax():
    top = _fresh(
        "import sys; sys.path.insert(0, '.');"
        "import benchmark.reference.judge, benchmark.traffic.generate;"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not top & {"jax", "jaxlib", "flax", "hinge_tpu", "hinge_tpu_torch"}


def test_a_run_loads_the_port_and_not_jax(tmp_path):
    code = (
        "import sys, os, time, argparse; sys.path.insert(0, '.');"
        "from benchmark import harness, spec; from benchmark.tests import tiny;"
        f"r = tiny.make_root({str(tmp_path)!r}); spec.ROOT = r;"
        "b = spec.benchmark(r); c = spec.Cell('tiny_las', b, r);"
        "a = argparse.Namespace(workload='tiny_las', seed=5, seconds=0, trace=0);"
        f"os.makedirs({str(tmp_path / 'w')!r});"
        f"rc = harness.run_cell(c, b, a, {str(tmp_path / 'w')!r}, time.perf_counter(), device='cpu');"
        "print('RC', rc, ' '.join({m.split('.')[0] for m in sys.modules}))")
    top = _fresh(code)
    assert "hinge_tpu_torch" in top and "RC" in top and "0" in top
    assert not top & set(harness.FORBIDDEN)


def test_no_source_imports_jax_or_the_jax_package():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in harness.FORBIDDEN, (f, n)
                    if "reference" in d or "traffic" in d:
                        assert n.split(".")[0] != "hinge_tpu_torch", (f, n)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hinge_tpu_torch_like", sys)
    assert "hinge_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hinge_tpu.x", sys)
    assert harness.forbidden_modules() == ["hinge_tpu"]


def test_without_the_port_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ecoli_fasta", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and r.stdout.strip() == ""
