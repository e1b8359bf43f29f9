"""The comparison that decides `correct` has teeth: on the CPU, at a size
a test run holds, the rest of a run with the timed path broken
underneath comes out not correct, under the E. coli cells' limits.

- the control (control.votes_skipped: contigs of one read's bases);
- a contig altered where it is produced (every 20th consensus base);
- half of the batch left out (of each contig and its reverse complement
  only the first contig's first half is kept);
- an overlap record altered where it is produced (every 10th record's
  strand flag flipped), and the join's p3 outputs altered where they
  are produced (control.join_spans_shifted, control.join_rows_dropped,
  on the device join's CPU twin), in the cell whose overlapper runs;
- each fault of the outputs (control.ON_OUTPUTS) on a sound call's
  outputs, where the cell has what it alters.

A state left unchanged and an exchange between chips left out are not
faults these cells can have: nothing is trained, and every cell runs on
one chip.  The sound run of each cell comes out correct."""

import argparse
import contextlib
import json
import os
import time

import pytest

from benchmark import control, harness, spec
from benchmark.tests import tiny


def _alter_contigs(results):
    out = []
    for name, seq in results:
        b = bytearray(seq.encode())
        for i in range(0, len(b), 20):
            b[i] = {65: 67, 67: 71, 71: 84, 84: 65}.get(b[i] & 0xDF, 65)
        out.append((name, b.decode()))
    return out


def _half_of_contigs(results):
    return [(name, seq[: len(seq) // 2] if i % 2 == 0 else "")
            for i, (name, seq) in enumerate(results)]


def _records_fault():
    from hinge_tpu_torch.overlap import mapper

    orig = mapper.overlap_reads

    def run(*args, **kwargs):
        ov = orig(*args, **kwargs)
        ov.rc[::10] = 1 - ov.rc[::10]
        return ov
    return mock_attr(mapper, "overlap_reads", run)


@contextlib.contextmanager
def mock_attr(mod, attr, value):
    orig = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


FAULTS = {
    "sound": contextlib.nullcontext,
    "control": control.votes_skipped,
    "contig_altered": lambda: control.consensus_changed(_alter_contigs),
    "half_left_out": lambda: control.consensus_changed(_half_of_contigs),
    "record_altered": _records_fault,
    "join_spans_shifted": control.join_spans_shifted,
    "join_rows_dropped": control.join_rows_dropped,
}
#: the faults of the overlapper, which only the FASTA cell runs
JOIN_FAULTS = ("record_altered", "join_spans_shifted", "join_rows_dropped")
CASES = [(c, f) for c in ("tiny_fasta", "tiny_las", "tiny_rep_las") for f in FAULTS
         if not (f in JOIN_FAULTS and c != "tiny_fasta")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(str(tmp_path_factory.mktemp("root")))
    old, spec.ROOT = spec.ROOT, r
    yield r
    spec.ROOT = old


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_broken_runs_are_not_correct(root, cell_name, fault, capsys, tmp_path,
                                    monkeypatch):
    # p3 runs on the CPU in the device join (its twin), as K4 does on the card
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    bench = spec.benchmark(root)
    cell = spec.Cell(cell_name, bench, root)
    args = argparse.Namespace(workload=cell_name, seed=21, seconds=0.01, trace=0)
    with FAULTS[fault]():
        rc = harness.run_cell(cell, bench, args, str(tmp_path),
                              time.perf_counter(), device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    if fault == "sound":
        assert line["correct"] is True and not over
    else:
        assert line["correct"] is False and over, line["checks"]
        assert line["failed"] >= 1


#: the faults of the outputs each tiny cell can have (only the repeat
#: cell's GFA has links between segments that differ)
TINY_CELLS = ("tiny_fasta", "tiny_las", "tiny_rep_las")
OUTPUT_CASES = [(c, f) for c in TINY_CELLS for f in control.ON_OUTPUTS
                if not (f == "links_rotated" and c != "tiny_rep_las")]


@pytest.fixture(scope="module")
def sound_calls(root, tmp_path_factory):
    """Each tiny cell's Reference, limits and one sound call's outputs."""
    from benchmark.reference.judge import Reference
    from benchmark.traffic.generate import make_inputs

    got = {}
    for name in TINY_CELLS:
        cell = spec.Cell(name, spec.benchmark(root), root)
        tmp = str(tmp_path_factory.mktemp(name))
        paths, truth = make_inputs(cell.config, cell.mix, 23,
                                   os.path.join(tmp, "inputs"))
        runner = harness.Runner(cell, paths, tmp, device="cpu")
        assert runner.call() is not None
        got[name] = (Reference(truth), cell.limits,
                     runner.outputs[runner.digests[0]])
    return got


@pytest.mark.parametrize("cell_name,fault", OUTPUT_CASES)
def test_faults_of_the_outputs_are_not_correct(sound_calls, cell_name, fault):
    from benchmark.reference.judge import verdict

    ref, limits, out = sound_calls[cell_name]
    change, numbers = control.ON_OUTPUTS[fault]
    _, ok = verdict([{"numbers": ref.judge(out), "digest": "a"}], limits)
    assert ok
    rows, ok = verdict([{"numbers": ref.judge(change(out)), "digest": "a"}],
                       limits)
    over = {k for k, v, lim in rows if v > lim}
    assert not ok and over & set(numbers), rows
