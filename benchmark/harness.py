"""One run of one cell: set-up, the measured window, the reference's
verdict, and the result line.

Set-up makes the cell's inputs from the seed (traffic.generate), builds
the port's kernels and native library where they are missing, and makes
one cold `hinge_tpu_torch.pipeline.assemble(..., device="cuda")` call,
which is also the `cold_assemble_s` sample (a per-layer metric).  With
`--trace 0` the window is whole warm calls back to back, each from the
files on disk into a fresh workdir (the previous one deleted), a call
that starts before `--seconds` have passed running to its end;
`assemble_s` is the window's total wall over its calls.  With `--trace
1` the window is one warm call under torch.profiler, with the
benchmark's spans and op timers (probes.py), and the line carries the
cell's per-layer metrics, each read by its reader in metrics/.  Every
call's outputs are judged by the plain reference (reference/judge.py)
once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from benchmark import spec

#: top-level module names that may not be loaded in the process that
#: prints the result: JAX and the JAX package (compared whole, so the
#: port, hinge_tpu_torch, is not taken for hinge_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "hinge_tpu")
#: the prefix of every file assemble() writes in its workdir
PREFIX = "asm"
#: host threads of the process's numeric libraries (OpenMP, BLAS,
#: torch's intra-op pool): fixed, so that a run's host work does not
#: spread with the machine's core count or load
HOST_THREADS = 4
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "NUMEXPR_NUM_THREADS")


def pin_threads() -> None:
    """Fix the host threads: the environment before numpy or torch load,
    torch's pools once it has."""
    for var in THREAD_VARS:
        os.environ[var] = str(HOST_THREADS)
    if "torch" in sys.modules:
        import torch

        torch.set_num_threads(HOST_THREADS)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_dirs(root: str) -> None:
    """Fixed compile-cache directories inside the checkout (the port's
    kernels and native library build into hinge_tpu_torch/build/)."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def build_port(device: str) -> None:
    """Build what the port builds on first use, where it is missing: its
    CUDA kernels (one library a source; for a CUDA device) and its native
    library."""
    import glob

    from hinge_tpu_torch import native
    from hinge_tpu_torch.ops import _build

    if device == "cuda":
        _build.compile_sources(
            sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))),
            _build.BUILD_DIR)
    if native.get_lib() is None:
        raise RuntimeError("the port's native library did not build")


def quiet_port_logger(logdir: str) -> None:
    """Send the port's logger to standard error and `logdir`, so that the
    result line is the last of standard output."""
    import logging

    from hinge_tpu_torch.utils.log import get_logger

    for h in get_logger(logdir).handlers:
        if type(h) is logging.StreamHandler:
            h.stream = sys.stderr


def read_edges(path: str):
    """The (a, b) read ids of each layout edge line."""
    import numpy as np

    with open(path) as f:
        rows = [ln.split()[:2] for ln in f if ln.strip()]
    return np.array(rows, dtype=np.int64).reshape(-1, 2)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


class Runner:
    """Runs assemble() on the cell's inputs and keeps what each call
    produced for the reference: its digest, and its outputs where the
    digest is new."""

    def __init__(self, cell, paths, tmp, device="cuda"):
        self.cell, self.paths, self.tmp, self.device = cell, paths, tmp, device
        self.cuda = device == "cuda"
        self.n = 0
        self.digests = []
        self.outputs = {}
        self.failed_calls = 0

    def call(self, traced=False):
        """One assemble() into a fresh workdir; (wall seconds, stage
        seconds, probes), None when the call raised.  `traced` puts the
        probes' spans and op timers in and the call in a WINDOW_SPAN."""
        import torch

        from benchmark.probes import Probes
        from benchmark.trace import WINDOW_SPAN
        from benchmark.reference.judge import digest
        from hinge_tpu_torch.pipeline import assemble
        from hinge_tpu_torch.utils.log import timings

        wd = os.path.join(self.tmp, f"call{self.n}")
        self.n += 1
        before = timings()
        try:
            span = (torch.profiler.record_function(WINDOW_SPAN) if traced
                    else contextlib.nullcontext())
            with Probes(traced=traced) as probes, span:
                t0 = time.perf_counter()
                res = assemble(
                    fasta=self.paths["fasta"], las=self.paths["las"],
                    config=self.cell.ini, workdir=wd, prefix=PREFIX,
                    device=self.device, log=lambda *a: None)
                if self.cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out = {"draft": [s for _, s in res["draft"]],
                   "consensus": [s for _, s in res["contigs"]],
                   "gfa": list(res["gfa"]),
                   "edges": read_edges(os.path.join(wd, PREFIX + ".edges.hinges")),
                   "records": probes.records}
        except Exception as e:  # a failed call is counted, not fatal
            import traceback

            traceback.print_exc()
            log(f"[bench] call {self.n - 1} failed: {e!r}")
            self.failed_calls += 1
            return None
        finally:
            shutil.rmtree(wd, ignore_errors=True)
        d = digest(out)
        self.digests.append(d)
        self.outputs.setdefault(d, out)
        after = timings()
        stages = {k: v - before.get(k, 0.0) for k, v in after.items()
                  if v - before.get(k, 0.0) > 0}
        return wall, stages, probes


def window(call, seconds: float, clock=time.perf_counter) -> list:
    """The walls of whole calls made back to back: each call that starts
    before `seconds` have passed runs to its end and counts; a failed
    call (None) ends the window."""
    walls = []
    w0 = clock()
    while clock() - w0 < seconds:
        got = call()
        if got is None:
            break
        walls.append(got[0])
        log(f"[bench] warm assemble() {got[0]:.3f}s")
    return walls


def _peak(cuda: bool) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if cuda else 0


def judge(runner, truth, limits):
    """([(name, number, limit)], correct, failed calls) over every call."""
    from benchmark.reference.judge import Reference, verdict

    t0 = time.perf_counter()
    ref = Reference(truth)
    numbers = {d: ref.judge(out) for d, out in runner.outputs.items()}
    readings = [{"numbers": numbers[d], "digest": d} for d in runner.digests]
    if not readings:
        return [], False, runner.failed_calls
    rows, ok = verdict(readings, limits)
    bad_digest = {d for d, nums in numbers.items()
                  if any(nums[k] > lim for k, lim in limits.items() if k in nums)}
    failed = runner.failed_calls + sum(
        d in bad_digest or d != runner.digests[0] for d in runner.digests)
    log(f"[bench] reference judged {len(numbers)} distinct output(s) of "
        f"{len(readings)} call(s) in {time.perf_counter() - t0:.1f}s")
    return rows, ok and runner.failed_calls == 0, failed


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.Cell(args.workload, bench)
    cache_dirs(spec.ROOT)
    pin_threads()
    import torch

    pin_threads()

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[bench] cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    import hinge_tpu_torch.pipeline  # noqa: F401  (fail before set-up)

    tmp = tempfile.mkdtemp(prefix="hinge_bench_")
    try:
        return run_cell(cell, bench, args, tmp, t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cell(cell, bench, args, tmp, t_start, device="cuda") -> int:
    """Set-up, window, verdict and result line of one run on `device`
    ("cuda"; the tests drive the rest of a run with "cpu")."""
    import torch

    from benchmark import trace as T
    from benchmark.traffic.generate import make_inputs

    cuda = device == "cuda"
    paths, truth = make_inputs(cell.config, cell.mix, args.seed,
                               os.path.join(tmp, "inputs"), log=log)
    t0 = time.perf_counter()
    build_port(device)
    log(f"[bench] port built and loaded in {time.perf_counter() - t0:.1f}s")
    quiet_port_logger(os.path.join(tmp, "log"))
    runner = Runner(cell, paths, tmp, device)
    cold = runner.call()
    setup_s = time.perf_counter() - t_start
    log(f"[bench] set-up {setup_s:.3f}s, cold assemble() "
        f"{cold[0] if cold else float('nan'):.3f}s")

    metrics, traced = {}, {}
    if args.trace == 0:
        walls = window(runner.call, args.seconds) if cold else []
        if walls:
            got = {"assemble_s": sum(walls) / len(walls), "setup_s": setup_s}
            metrics = {m["name"]: got[m["name"]] for m in cell.end_to_end(bench)}
        peak = _peak(cuda)
    else:
        peak = _peak(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        got = None
        if cold:
            with prof:
                got = runner.call(traced=True)
        call_peak = _peak(cuda)
        peak = max(peak, call_peak)
        if got is not None:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            log(f"[bench] trace {os.path.getsize(path) / 2**20:.1f} MiB")
            summary = T.summary(T.load(path))
            os.remove(path)
            ctx = {"cold_s": cold[0], "wall_s": got[0], "stages": got[1],
                   "ops": got[2].ops, "trace": summary, "peak_bytes": call_peak}
            for m in cell.per_layer(bench):
                value = spec.reader(m["name"])(ctx)
                if value is None:
                    log(f"[bench] per-layer metric {m['name']} found nothing "
                        f"to read in cell {cell.name}, which lists it")
                    return 4
                metrics[m["name"]] = value
            traced = {"busy_s": summary["busy_s"],
                      "window_s": summary["window_s"]}
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
        del prof
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}

    found = forbidden_modules()
    if found:
        log(f"[bench] modules of JAX or the JAX package are loaded: {found}")
        return 3
    if cuda:
        torch.cuda.empty_cache()
    rows, correct, failed = judge(runner, truth, cell.limits)
    line = {
        "correct": bool(correct and metrics),
        "attempted": runner.n,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **traced},
    }
    if args.trace == 1 and metrics:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    log(f"[bench] card: {card() if cuda else 'cpu'}; host peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'OVER'}")
    print(json.dumps(line), flush=True)
    return 0
