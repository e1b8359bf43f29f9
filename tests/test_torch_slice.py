"""The port's whole slice against hinge_tpu, on the CPU.

- The port's golden build (tests/torch_golden.py) writes the 11
  tests/golden/ files byte for byte.
- On the test_e2e_assembly.py dataset, with the draft aligner pinned to
  the C DW_banded path on both sides (HINGE_PARITY_ALIGN=1), the port's
  assemble() writes X.draft.fasta, X.consensus.fasta and X_consensus.gfa
  byte-equal to hinge_tpu's.
- On a smaller noisy dataset, with the band-NW aligner forced on both
  sides (HINGE_FAST_ALIGN=1), X.draft.fasta is byte-equal too.
- Fasta-only input (the built-in overlapper), with HINGE_DEVICE_JOIN=1,
  HINGE_DEVICE_VOTE=1 or both on both sides and HINGE_PARITY_ALIGN=1:
  X.consensus.fasta and X_consensus.gfa are byte-equal to hinge_tpu's.
- Without a card, assemble() with its default device raises.
"""

import os

import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import write_las
from tests import torch_golden

OUTPUTS = ("asm.draft.fasta", "asm.consensus.fasta", "asm_consensus.gfa")
#: the tests/test_e2e_assembly.py dataset
E2E = SimParams(genome_len=50_000, coverage=18.0, mean_read_len=5000,
                std_read_len=1000, seed=21)


def test_golden_files_on_cpu(tmp_path):
    torch_golden.build(str(tmp_path), device="cpu")
    assert torch_golden.mismatches(str(tmp_path)) == []


def write_inputs(tmp, params):
    _, _, rs, ov = simulate(params)
    fasta, las = str(tmp / "reads.fasta"), str(tmp / "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    return fasta, las


def write_fasta_only(tmp, params):
    _, _, rs, _ = simulate(params)
    fasta = str(tmp / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    return fasta


def assemble_both(tmp, fasta, las):
    """hinge_tpu's and the port's assemble() on the same inputs; returns
    the two workdirs."""
    from hinge_tpu.pipeline import assemble as assemble_jax
    from hinge_tpu_torch.pipeline import assemble as assemble_torch

    ref, port = str(tmp / "jax"), str(tmp / "torch")
    quiet = lambda *a: None  # noqa: E731
    assemble_jax(fasta=fasta, las=las, workdir=ref, log=quiet)
    assemble_torch(fasta=fasta, las=las, workdir=port, log=quiet,
                   device="cpu")
    return ref, port


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_assemble_matches_hinge_tpu_parity_pinned(tmp_path, monkeypatch):
    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    fasta, las = write_inputs(tmp_path, E2E)
    ref, port = assemble_both(tmp_path, fasta, las)
    for name in OUTPUTS:
        want = read_bytes(os.path.join(ref, name))
        assert len(want) > 1000, name
        assert read_bytes(os.path.join(port, name)) == want, name


@pytest.mark.parametrize("switches", [
    ("HINGE_DEVICE_JOIN",),
    ("HINGE_DEVICE_VOTE",),
    ("HINGE_DEVICE_JOIN", "HINGE_DEVICE_VOTE"),
], ids=["join", "vote", "join+vote"])
def test_fasta_only_device_switches_match_hinge_tpu(switches, tmp_path,
                                                    monkeypatch):
    """The device join and the device vote under the same switches on both
    sides: the port's consensus and GFA equal hinge_tpu's."""
    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    for name in switches:
        monkeypatch.setenv(name, "1")
    fasta = write_fasta_only(tmp_path, E2E)
    ref, port = assemble_both(tmp_path, fasta, "")
    for name in OUTPUTS[1:]:
        want = read_bytes(os.path.join(ref, name))
        assert len(want) > 1000, name
        assert read_bytes(os.path.join(port, name)) == want, name


def test_assemble_without_device_raises_without_cuda(monkeypatch, tmp_path):
    import torch

    from hinge_tpu_torch.pipeline import assemble

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        assemble(fasta="unused.fasta", workdir=str(tmp_path))


def test_draft_matches_hinge_tpu_fast_align(tmp_path, monkeypatch):
    """HINGE_FAST_ALIGN=1 on both sides: hinge_tpu's interpreted Pallas
    band-NW and the port's plain torch twins give the same draft."""
    monkeypatch.setenv("HINGE_FAST_ALIGN", "1")
    fasta, las = write_inputs(tmp_path, SimParams(
        genome_len=20_000, coverage=12.0, mean_read_len=4000,
        std_read_len=800, sub_rate=0.01, seed=33))
    ref, port = assemble_both(tmp_path, fasta, las)
    want = read_bytes(os.path.join(ref, "asm.draft.fasta"))
    assert len(want) > 1000
    assert read_bytes(os.path.join(port, "asm.draft.fasta")) == want


def test_cli_assemble_on_cpu(tmp_path, capsys):
    from hinge_tpu_torch.cli import main

    fasta, las = write_inputs(tmp_path, E2E)
    wd = tmp_path / "cli"
    assert main(["assemble", "--fasta", fasta, "--las", las, "--workdir",
                 str(wd), "--device", "cpu", "--timings"]) == 0
    assert (wd / "asm.consensus.fasta").stat().st_size > 1000
    assert "[timing] draft:" in capsys.readouterr().out


def test_cli_assemble_fasta_only_device_switches(tmp_path, monkeypatch):
    """`cli assemble` on fasta-only input with both device switches writes
    the consensus that the port's default (C join, C vote) path writes."""
    from hinge_tpu_torch.cli import main
    from hinge_tpu_torch.pipeline import assemble

    fasta = write_fasta_only(tmp_path, E2E)
    assemble(fasta=fasta, workdir=str(tmp_path / "c"), log=lambda *a: None,
             device="cpu")
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    monkeypatch.setenv("HINGE_DEVICE_VOTE", "1")
    assert main(["assemble", "--fasta", fasta, "--workdir",
                 str(tmp_path / "dev"), "--device", "cpu"]) == 0
    for name in OUTPUTS[1:]:
        want = read_bytes(str(tmp_path / "c" / name))
        assert len(want) > 1000, name
        assert read_bytes(str(tmp_path / "dev" / name)) == want, name
