"""Quickest proof that the torch/CUDA port runs on a card.

    python3 chip_smoke.py

Runs hinge_tpu_torch on one CUDA card, phase by phase; any failure raises
and the exit code is nonzero:

1. device  — a CUDA card must be present; prints its name and the
             `nvidia-smi` name/power-limit line;
2. build   — nvcc builds the kernels from hinge_tpu_torch/csrc;
3. kernels — band_fill and row_traceback on ~2048 seeded windows
             (700-1100 bp, 1-15% error, plus edge cases) must be
             bit-equal to their plain torch twins on the same CUDA
             tensors; prints kernel and twin times (CUDA events);
4. golden  — the port's golden build on the card writes the 11
             tests/golden/ files byte for byte;
5. real size — assemble() on a simulated 4.6 Mb genome at 30x with 2%
             read errors (reads + .las overlaps), which must run through
             both kernels and yield a contig >= 0.9 of the genome; prints
             stage times and peak device memory.

Then one JSON line per kernel summary and, last, the device line
{"ok": true, "device": {...}}.  Imports no jax.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

GENOME_LEN = 4_600_000
COVERAGE = 30.0
#: the noisy_sim error rates of tests/conftest.py.  With error-free reads
#: every draft ladder window is an identical pair, which the draft stage
#: short-circuits, so the band-NW kernels would never run.
READ_ERRORS = dict(sub_rate=0.01, ins_rate=0.005, del_rate=0.005)
N_WINDOWS = 2048
KERNELS = {
    "band_fill": ("hinge_tpu_torch/csrc/band_fill.cu",
                  "hinge_tpu/ops/pallas_band_nw.py:88"),
    "row_traceback": ("hinge_tpu_torch/csrc/row_traceback.cu",
                      "hinge_tpu/ops/pallas_band_nw.py:231"),
}


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi.splitlines()[0])


def phase_build():
    from hinge_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.3f}s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.3f}s)")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def _noisy_copy(rng, t, err):
    """t with deletions, substitutions and insertions at rate ~err."""
    r = rng.random(len(t))
    keep = r >= err * 0.4
    base = np.where(r < err * 0.8, rng.integers(0, 4, len(t)), t)
    ins = rng.random(len(t)) < err * 0.3
    vals = np.stack([base, rng.integers(0, 4, len(t))], 1).reshape(-1)
    return vals[np.stack([keep, ins], 1).reshape(-1)].astype(np.uint8)


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(N_WINDOWS - 3):
        t = rng.integers(0, 4, int(rng.integers(700, 1101))).astype(np.uint8)
        q = _noisy_copy(rng, t, float(rng.uniform(0.01, 0.15)))
        qs.append(q[: len(t) + 126])
        ts.append(t)
    t = rng.integers(0, 4, 1026).astype(np.uint8)
    qs += [t[:1], t[:900], t.copy()]        # m = 1, |m - n| = 126, identical
    ts += [t[:3], t, t]
    return qs, ts


def _cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def phase_kernels():
    """Kernels vs twins on the same CUDA tensors at the main-path shape."""
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops import band_nw as BN

    dev = torch.device("cuda")
    qs, ts = _windows()
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    qc = np.zeros((len(qs), m.max()), np.uint8)
    tc = np.zeros((len(ts), n.max()), np.uint8)
    for w in range(len(qs)):
        qc[w, : m[w]] = qs[w]
        tc[w, : n[w]] = ts[w]
    q, t, dm, dn = (to_device(a, dev) for a in (qc, tc, m, n))
    mrows = int(m.max())
    log(f"[kernels] {len(qs)} windows, m {m.min()}..{m.max()}, "
        f"moves ({len(qs)}, {mrows}, {BN.BW}) int8")

    moves = BN.band_fill(q, t, dm, dn, mrows=mrows)
    moves_ref = BN.band_fill_ref(q, t, dm, dn, mrows)
    torch.cuda.synchronize()
    fill_err = _max_abs_err([moves], [moves_ref])
    if not torch.equal(moves, moves_ref):
        bad = (moves != moves_ref).nonzero()[:5].tolist()
        raise AssertionError(f"band_fill differs from its twin at {bad}")
    tb = BN.row_traceback(moves, dm, dn)
    tb_ref = BN.row_traceback_ref(moves, dm, dn)
    torch.cuda.synchronize()
    tb_err = _max_abs_err(tb, tb_ref)
    for name, g, w in zip(("cnts", "mv0s", "j_rem"), tb, tb_ref):
        if not torch.equal(g, w):
            raise AssertionError(f"row_traceback {name} differs from its twin")

    # rows with no non-left lane up to k_e (top = -1; cnt wraps at 256)
    rng = np.random.default_rng(1)
    syn = rng.integers(0, 4, (256, 1100, BN.BW)).astype(np.int8)
    syn[:, ::3, :] = 2
    syn[:16] = 2
    sm = rng.integers(1, 1101, 256).astype(np.int32)
    sn = (sm + rng.integers(-126, 127, 256)).clip(0).astype(np.int32)
    smv, sdm, sdn = (to_device(a, dev) for a in (syn, sm, sn))
    got, want = BN.row_traceback(smv, sdm, sdn), BN.row_traceback_ref(smv, sdm, sdn)
    torch.cuda.synchronize()
    tb_err = max(tb_err, _max_abs_err(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("row_traceback differs from its twin on all-left rows")

    times = {
        "band_fill": (_cuda_ms(lambda: BN.band_fill(q, t, dm, dn, mrows=mrows), 10),
                      _cuda_ms(lambda: BN.band_fill_ref(q, t, dm, dn, mrows), 2)),
        "row_traceback": (_cuda_ms(lambda: BN.row_traceback(moves, dm, dn), 10),
                          _cuda_ms(lambda: BN.row_traceback_ref(moves, dm, dn), 2)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"[kernels] {name}: bit-equal to its twin; kernel {k_ms:.4f} ms, "
            f"plain torch {p_ms:.4f} ms")
    return {"band_fill": fill_err, "row_traceback": tb_err}, times


def phase_golden():
    from tests import torch_golden

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch_golden.build(tmp, device="cuda")
        bad = torch_golden.mismatches(tmp)
    if bad:
        raise AssertionError(f"golden files differ on cuda: {bad}")
    log(f"[golden] 11/11 files byte-equal on cuda "
        f"({time.perf_counter() - t0:.3f}s)")


def phase_real_size():
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.io.fasta import write_fasta
    from hinge_tpu.io.las import write_las
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import timings

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, _, rs, ov = simulate(SimParams(genome_len=GENOME_LEN,
                                          coverage=COVERAGE, seed=0,
                                          **READ_ERRORS))
        fasta, las = os.path.join(tmp, "reads.fasta"), os.path.join(tmp, "reads.las")
        write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
        write_las(las, ov)
        log(f"[real] host set-up: simulated {rs.n_reads} reads, {ov.n} "
            f"overlaps and wrote them in {time.perf_counter() - t0:.3f}s")
        del rs, ov

        for k in BN.launches:
            BN.launches[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = assemble(fasta=fasta, las=las, workdir=os.path.join(tmp, "asm"),
                       device="cuda", log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(BN.launches)
    peak = torch.cuda.max_memory_allocated()
    longest = max((len(s) for _, s in res["contigs"]), default=0)
    log(f"[real] assemble wall {wall:.3f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in timings().items()))
    log(f"[real] peak device memory {peak} bytes; kernel launches {launches}")
    log(f"[real] {len(res['contigs'])} contigs, longest/genome "
        f"{longest / GENOME_LEN:.4f}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")
    if not res["contigs"] or longest / GENOME_LEN < 0.9:
        raise AssertionError(f"assembly too short: longest {longest}")
    return launches


def main():
    phase_device()
    phase_build()
    errs, times = phase_kernels()
    phase_golden()
    launches = phase_real_size()
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
