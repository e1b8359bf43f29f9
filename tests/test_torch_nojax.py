"""hinge_tpu_torch stands alone: it imports neither jax nor hinge_tpu
(it keeps its own copies of the jax-free modules it shares with
hinge_tpu), and every opt-in switch of hinge_tpu runs under the port:
HINGE_SHARDED=1 writes the single-device run's files."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hinge_tpu_torch"


def test_no_jax_import_statements():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


def test_no_hinge_tpu_import_statements():
    """No module of the port, nor chip_smoke.py, nor the port's golden
    builds import hinge_tpu."""
    pat = re.compile(r"^\s*(from|import)\s+hinge_tpu(\.|\s|$)", re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "tests" / "torch_golden.py",
             ROOT / "tests" / "torch_golden_repeats.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert offenders == []


#: every subpackage of the port, so that a missing __init__.py (which
#: walk_packages would silently skip) fails the import walk below
SUBPACKAGES = ("data", "graph", "io", "native", "ops", "overlap",
               "parallel", "stages", "utils")


def test_filter_stage_runs_without_loading_jax(tmp_path):
    """Import every module of the port, run the filter stage on the CPU
    in a fresh interpreter, then the filter verb of the `hinge` verb table
    on the same reads (written as FASTA + .las), and check that neither
    jax nor hinge_tpu got loaded."""
    code = f"""
import importlib, pkgutil, sys
import hinge_tpu_torch
names = [m.name for m in
         pkgutil.walk_packages(hinge_tpu_torch.__path__, "hinge_tpu_torch.")]
for sub in {SUBPACKAGES!r}:
    assert "hinge_tpu_torch." + sub in names, sub
assert "hinge_tpu_torch.overlap.device_join" in names
assert "hinge_tpu_torch.overlap.mapper" in names
for name in names:
    importlib.import_module(name)
from hinge_tpu_torch.config import nominal_config
from hinge_tpu_torch.data.simulator import SimParams, simulate
from hinge_tpu_torch.stages.filter import run_filter
_, _, rs, ov = simulate(SimParams(genome_len=20_000, coverage=10.0,
                                  mean_read_len=4000, std_read_len=800,
                                  seed=5))
res = run_filter(rs, [ov], nominal_config(), out_prefix={str(tmp_path / 'F')!r},
                 device="cpu")
assert res.maskvec.shape == (rs.n_reads, 2)
from hinge_tpu_torch.hinge import main as hinge_main
from hinge_tpu_torch.io.fasta import write_fasta
from hinge_tpu_torch.io.las import write_las
fasta, las = {str(tmp_path / 'r.fasta')!r}, {str(tmp_path / 'r.las')!r}
write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
write_las(las, ov)
assert hinge_main(["filter", "--fasta", fasta, "--las", las, "-x",
                   {str(tmp_path / 'V')!r}, "--device", "cpu"]) == 0
assert open({str(tmp_path / 'V.mas')!r}).read() == \
    open({str(tmp_path / 'F.mas')!r}).read()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m.split(".")[0] == "hinge_tpu"]
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def test_fasta_only_device_path_runs_without_loading_jax(tmp_path):
    """A fresh interpreter runs the fasta-only assembly on the CPU with the
    device join and the device vote, and never loads jax."""
    code = f"""
import os, sys
os.environ["HINGE_DEVICE_JOIN"] = "1"
os.environ["HINGE_DEVICE_VOTE"] = "1"
from hinge_tpu_torch.data.simulator import SimParams, simulate
from hinge_tpu_torch.io.fasta import write_fasta
from hinge_tpu_torch.pipeline import assemble
_, _, rs, _ = simulate(SimParams(genome_len=50_000, coverage=18.0,
                                 mean_read_len=5000, std_read_len=1000,
                                 seed=21))
fasta = {str(tmp_path / 'r.fasta')!r}
write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
res = assemble(fasta=fasta, workdir={str(tmp_path / 'w')!r},
               log=lambda *a: None, device="cpu")
assert res["contigs"]
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m.split(".")[0] == "hinge_tpu"]
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def test_golden_build_and_assemble_without_hinge_tpu(tmp_path):
    """A fresh interpreter imports every module of the port, runs the
    port's golden build and a small assemble() from the port's own
    simulator on the CPU, then the same assemble() with HINGE_SHARDED=1
    over 4 CPU shards (equal files), and never loads hinge_tpu or jax."""
    code = f"""
import importlib, pkgutil, sys
import hinge_tpu_torch
for m in pkgutil.walk_packages(hinge_tpu_torch.__path__, "hinge_tpu_torch."):
    importlib.import_module(m.name)
from tests import torch_golden
torch_golden.build({str(tmp_path)!r}, device="cpu")
assert torch_golden.mismatches({str(tmp_path)!r}) == []
from hinge_tpu_torch.data.simulator import SimParams, simulate
from hinge_tpu_torch.io.fasta import write_fasta
from hinge_tpu_torch.io.las import write_las
from hinge_tpu_torch.pipeline import assemble
_, _, rs, ov = simulate(SimParams(genome_len=30_000, coverage=14.0,
                                  mean_read_len=4000, std_read_len=900,
                                  sub_rate=0.01, seed=77))
fasta, las = {str(tmp_path / 'r.fasta')!r}, {str(tmp_path / 'r.las')!r}
write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
write_las(las, ov)
res = assemble(fasta=fasta, las=las, workdir={str(tmp_path / 'w')!r},
               log=lambda *a: None, device="cpu")
assert res["contigs"]
import os
os.environ["HINGE_SHARDED"] = "1"
os.environ["HINGE_MESH_SHARDS"] = "4"
res = assemble(fasta=fasta, las=las, workdir={str(tmp_path / 'w4')!r},
               log=lambda *a: None, device="cpu")
for name in ("asm.mas", "asm.max", "asm.edges.hinges", "asm.consensus.fasta"):
    assert open({str(tmp_path / 'w4')!r} + "/" + name, "rb").read() == \\
        open({str(tmp_path / 'w')!r} + "/" + name, "rb").read(), name
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("hinge_tpu", "jax"))
assert loaded == [], loaded
print("STANDALONE_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STANDALONE_OK" in r.stdout


#: the stage files of filter, maximal and layout, and the assembly's
#: consensus and GFA
SHARDED_FILES = ("asm.mas", "asm.cmas", "asm.repeat.txt", "asm.hinges.txt",
                 "asm.cov.flag", "asm.self.flag", "asm.coverage.txt",
                 "asm.max", "asm.contained.txt", "asm.edges.hinges",
                 "asm.edges.hinges2", "asm.hinge.list",
                 "asm.consensus.fasta", "asm_consensus.gfa")


@pytest.mark.parametrize("shards", ["1", "4"])
def test_unported_switches_raise(shards, tmp_path, monkeypatch):
    """No opt-in switch of hinge_tpu raises under the port any more.
    HINGE_SHARDED=1 with one CPU shard (the stage mesh is None, as on one
    card) runs the single-device path; with HINGE_MESH_SHARDS=4 the
    filter, maximal and layout stages run over 4 CPU shards.  Both write
    the single-device run's files byte for byte.  HINGE_DEVICE_JOIN and
    HINGE_DEVICE_VOTE: tests/test_torch_slice.py runs them against
    hinge_tpu."""
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las
    from hinge_tpu_torch.pipeline import assemble

    # the test_e2e_assembly.py dataset: it assembles, so consensus votes
    _, _, rs, ov = simulate(SimParams(genome_len=50_000, coverage=18.0,
                                      mean_read_len=5000, std_read_len=1000,
                                      seed=21))
    fasta = str(tmp_path / "r.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    las_path = str(tmp_path / "r.las")
    write_las(las_path, ov)
    monkeypatch.delenv("HINGE_SHARDED", raising=False)
    monkeypatch.delenv("HINGE_MESH_SHARDS", raising=False)
    assemble(fasta=fasta, las=las_path, workdir=str(tmp_path / "single"),
             log=lambda *a: None, device="cpu")
    monkeypatch.setenv("HINGE_SHARDED", "1")
    monkeypatch.setenv("HINGE_MESH_SHARDS", shards)
    res = assemble(fasta=fasta, las=las_path, workdir=str(tmp_path / "w"),
                   log=lambda *a: None, device="cpu")
    assert res["contigs"]
    for name in SHARDED_FILES:
        assert (tmp_path / "w" / name).read_bytes() == \
            (tmp_path / "single" / name).read_bytes(), name


def test_bench_entry_points_import_without_jax(tmp_path):
    """hinge_tpu_torch.bench and every one of its modules (the twins of
    the repo-root JAX scripts, and the port's own A/B entry points) import in
    a fresh interpreter without loading jax or hinge_tpu, and each twin
    names its source script in its first docstring line."""
    code = """
import importlib, pkgutil, sys
import hinge_tpu_torch.bench as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
twins = {"bench": "bench.py", "bench_window_dp": "bench_window_dp.py",
         "bench_e2e": "bench_tpu_e2e.py", "bench_draft_ab": "bench_draft_ab.py",
         "profile_mapcons": "profile_mapcons.py",
         "bench_multihost": "bench_multihost.py"}
own = ["bench_defaults_ab", "bench_tree_ab"]
assert set(names) == {pkg.__name__ + "." + n
                      for n in [*twins, *own, "__main__"]}, names
for name in names:
    mod = importlib.import_module(name)
    short = name.rsplit(".", 1)[1]
    if short in twins:
        assert mod.__doc__.splitlines()[0].startswith(
            f"Port of `{twins[short]}`"), name
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m.split(".")[0] == "hinge_tpu"]
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout
