"""The port's measurement entry points: torch twins of the repo-root JAX scripts.

Each module is the twin of one script and keeps its function names:

- `bench`            <- bench.py: overlap-pileup records/s/chip, its numpy
                        baseline, speed-of-light account, e2e and scaling
                        sections (`python -m hinge_tpu_torch.bench`);
- `bench_window_dp`  <- bench_window_dp.py: window DP host to host, C
                        DW_banded vs band-NW (K1/K2) vs the wave (K3);
- `bench_e2e`        <- bench_tpu_e2e.py: assemble() from FASTA, walls
                        per stage, appended to docs/bench_recorded_torch.json;
- `bench_draft_ab`   <- bench_draft_ab.py: the draft stage under the C
                        aligner and under band-NW, a child process an arm;
- `profile_mapcons`  <- profile_mapcons.py: cProfile of clip, draft, map
                        and consensus;
- `bench_multihost`  <- bench_multihost.py: the sharded filter step across
                        processes (NCCL, one rank a card; gloo on the CPU).

Two modules have no JAX script: `bench_defaults_ab`, assemble() from
FASTA with the C join and the native vote against the device join and
the device vote (the CUDA defaults), in alternating runs; and
`bench_tree_ab`, the device join and the FASTA path of this tree against
another commit's checkout, in turns, a child process a run.

Each runs as `python -m hinge_tpu_torch.bench.<name>`.  The device is
cuda unless `--device cpu` is passed; without a card every entry point
raises `hinge_tpu_torch.device.DeviceError` before it does any work.  No
entry point falls back to the CPU, and a failed child process raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

#: the repository root (the package's parent directory)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the port's own record of measurements (docs/bench_recorded.json is
#: hinge_tpu's and is never written by the port)
RECORD = os.path.join(ROOT, "docs", "bench_recorded_torch.json")
#: the read errors of the 4.6 Mb / 30x workload that chip_smoke.py's
#: phase 5 runs (tests/conftest.py's noisy_sim rates): with error-free
#: reads every draft ladder window is an identical pair, which the draft
#: short-circuits, so no aligner runs
READ_ERRORS = dict(sub_rate=0.01, ins_rate=0.005, del_rate=0.005)


#: the columns two overlap stores of the same records agree on
STORE_COLUMNS = ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
                 "b_start", "b_end", "rc", "tlen", "trace_off", "trace")


def assert_stores_equal(a, b) -> None:
    """Raise unless overlap stores `a` and `b` hold the same records: the
    count, tspace, every column and every trace value."""
    if a.n != b.n:
        raise AssertionError(f"record count {a.n} != {b.n}")
    for f in STORE_COLUMNS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"the records differ in {f}")
    if a.tspace != b.tspace:
        raise AssertionError(f"tspace {a.tspace} != {b.tspace}")


def card(dev: torch.device) -> dict:
    """What a result was measured on: the backend, and on CUDA the card's
    name and its `nvidia-smi` name/power-limit line."""
    if dev.type != "cuda":
        return {"backend": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.splitlines()[dev.index or 0]}


def child_env() -> dict:
    """This process's environment with the repository first on
    PYTHONPATH, for the child interpreters an entry point starts."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


#: the device join's phase spans, `overlap.<phase>` (overlap/device_join.py)
JOIN_PHASES = ("minimizer", "index", "p1", "p2", "p3", "p4", "fetch")


def join_stats(call):
    """The device join's counters in a finished `utils.log` call (blocks,
    hits, anchors into p3, kept) and, summed over blocks, each phase's
    host wall, `<phase>_host_s` (no phase synchronises, so it holds the
    host's waits for the device that fall in it), and where the call ran
    on CUDA under torch.profiler its stream seconds, `<phase>_stream_s`;
    None when no device join ran in the call."""
    got = {k[len("join."):]: v for k, v in call.counters.items()
           if k.startswith("join.")}
    if not got:
        return None
    for phase in JOIN_PHASES:
        name = "overlap." + phase
        for key, secs in ((phase + "_host_s", call.wall_s(name)),
                          (phase + "_stream_s", call.stream_s(name))):
            if secs is not None:
                got[key] = secs
    return got


def sync(dev: torch.device) -> None:
    """Wait for `dev`'s queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def record(entry: dict) -> None:
    """Append `entry`, dated, to the port's record file."""
    rec = []
    if os.path.exists(RECORD):
        with open(RECORD) as f:
            rec = json.load(f)
    rec.append(dict(entry, date=time.strftime("%Y-%m-%d")))
    with open(RECORD, "w") as f:
        json.dump(rec, f, indent=1)
