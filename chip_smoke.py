"""Quickest proof that the torch/CUDA port runs on a card.

    python3 chip_smoke.py

Runs hinge_tpu_torch on one CUDA card, phase by phase; any failure raises
and the exit code is nonzero:

1. device  — a CUDA card must be present; prints its name and the
             `nvidia-smi` name/power-limit line;
2. build   — nvcc builds the kernels from hinge_tpu_torch/csrc;
3. kernels — band_fill and row_traceback on 2048 seeded windows
             (700-1100 bp, 1-15% error, plus edge cases), all-left
             traceback rows, traceback rows of arbitrary int8 codes and
             two 30 kb windows (whose costs would pass 16 bits without
             the fill's rebase) must be bit-equal to their plain torch
             twins on the same CUDA tensors; prints kernel, previous kernel and twin times (CUDA
             events) with each kernel's bound, and both kernels' time
             per 2048 windows at 2048, 4096 and 8192 windows per launch.
             The previous kernels (commit PARENT, before the redesign)
             are built from git history or from `--parent DIR`, and are
             left out when neither has them;
4. golden  — the port's golden build on the card writes the 11
             tests/golden/ files byte for byte;
5. real size — assemble() on a simulated 4.6 Mb genome at 30x with 2%
             read errors (reads + .las overlaps), which must run through
             both kernels and yield a contig >= 0.9 of the genome; prints
             stage times and peak device memory.  Then its largest band-NW
             block (the launch size and the lengths of the main path) is
             checked and timed as in phase 3;
6. device join — on phase 5's reads, the port's device join
             (overlap_base_records on cuda) must give records equal to
             the C join's (map_reads_to_targets, half pairs)
             on every column and trace byte; prints both walls, per-phase
             times, blocks, hits and peak device memory.  Then the trim
             lattice (ops/classify.trim_overlaps) on cuda must equal the
             native trim on the maximal stage's rows of phase 5's .las
             records; prints both times;
7. fasta only — assemble() from the reads alone with HINGE_DEVICE_JOIN=1
             and HINGE_DEVICE_VOTE=1, which must run the device join, the
             device vote and both kernels and yield a contig >= 0.9 of the
             genome; the consensus stage rerun on the same draft with the
             native C vote must write a byte-equal X.consensus.fasta.

Then a JSON line of the ported device programs' times, a JSON line of
kernel summaries (times on phase 5's largest block, bound, share,
launches and windows per launch of phase 5, phase 3's numbers beside
them) and, last, the device line {"ok": true, "device": {...}}.
Imports no jax.
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


def _windows(seed=0, count=N_WINDOWS):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(count - 3):
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


BN_BW = 256
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
#: 32-bit integer operations/s (132 SMs x 64 INT32 lanes x 1.98 GHz)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
#: 16-bit integer operations/s: a 16x2 or DPX instruction does two
INT16_OPS_S = 2 * INT32_OPS_S
#: integer operations a band cell needs, in 16-bit halves (base compare,
#: diag add, the add-mins of up, of the left scan and of C, the left and
#: up tests, the move); a traceback cell, in 32 bits (k <= k_e,
#: move != 2, max)
FILL_OPS_PER_CELL = 8
TB_OPS_PER_CELL = 3
#: the least the card reads from HBM at a time
SECTOR = 32


def _bound(nbytes, nops, ops_s):
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, nops / ops_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def fill_bound(m, n, mrows):
    """Least time for band_fill on these inputs: q and t bytes read once,
    the moves written once; every band cell computed, two to a 16x2
    instruction."""
    B = int(m.numel())
    cells = B * mrows * BN_BW
    nbytes = int(m.sum()) + int(n.sum()) + 8 * B + cells
    return _bound(nbytes, FILL_OPS_PER_CELL * cells, INT16_OPS_S)


def _path_cells(moves, m, n):
    """Along the path that row_traceback_ref walks (the same loop): per
    window, the cells of lanes 0..k_e of its active rows, and the 32-byte
    sectors that hold them; and the path's final j."""
    B, mrows, _ = moves.shape
    lane = torch.arange(BN_BW, dtype=torch.int32, device=moves.device)[None, :]
    j = n.clone()
    cells = torch.zeros(B, dtype=torch.int64, device=moves.device)
    sectors = torch.zeros_like(cells)
    for r in range(min(int(m.max()), mrows) - 1, -1, -1):
        row = moves[:, r].to(torch.int32)
        active = r < m
        k_e = torch.clamp(j - (r + 1) + BN_BW // 2, 0, BN_BW - 1)
        top = torch.where((lane <= k_e[:, None]) & (row != 2),
                          lane * 4 + row, -1).max(dim=1).values
        j = torch.where(active, j - (k_e - (top >> 2))
                        - ((top & 3) == 0).to(torch.int32), j)
        cells += torch.where(active, k_e + 1, 0)
        sectors += torch.where(active, k_e // SECTOR + 1, 0)
    return int(cells.sum()), int(sectors.sum()), j


def traceback_bound(moves, m, n, j_rem):
    """Least time for row_traceback on these inputs: of each active row,
    the sectors that hold lanes 0..k_e on the traceback's path read once
    (what the walk needs), cnts/mv0s/j_rem written once; one pass over
    those cells.  j_rem, the twin's, checks that the path is the twin's."""
    B, mrows, _ = moves.shape
    cells, sectors, j = _path_cells(moves, m, n)
    if not torch.equal(j, j_rem):
        raise AssertionError("the bound's path walk disagrees with the twin")
    nbytes = SECTOR * sectors + 2 * B * mrows + 12 * B
    return _bound(nbytes, TB_OPS_PER_CELL * cells, INT32_OPS_S)

PARENT = "c8c124ed9147a5b1b503950838dd258193d9d71e"


def _parent_sources(tmp):
    """The previous kernel sources (commit PARENT, before the redesign), from
    --parent DIR or from git history; None when neither has them."""
    names = ("band_fill.cu", "row_traceback.cu")
    if "--parent" in sys.argv:
        d = sys.argv[sys.argv.index("--parent") + 1]
        return [os.path.join(d, f) for f in names]
    out = []
    for f in names:
        r = subprocess.run(["git", "show", f"{PARENT}:hinge_tpu_torch/csrc/{f}"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            return None
        path = os.path.join(tmp, f)
        with open(path, "w") as fh:
            fh.write(r.stdout)
        out.append(path)
    return out


class ParentKernels:
    """The previous band_fill and row_traceback, built from their sources into a
    scratch directory, for the A/B in the same process.  Not part of the
    port."""

    def __init__(self, tmp):
        import ctypes

        from hinge_tpu_torch.ops import _build

        srcs = _parent_sources(tmp)
        self.ok = srcs is not None
        if not self.ok:
            return
        libs = _build.compile_sources(srcs, os.path.join(tmp, "parent_build"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self.fill_fn = ctypes.CDLL(libs["band_fill"]).hinge_band_fill
        self.fill_fn.argtypes = [vp, ll, vp, ll, vp, vp, vp, i, i, vp]
        self.tb_fn = ctypes.CDLL(libs["row_traceback"]).hinge_row_traceback
        self.tb_fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp]

    def fill(self, q, t, m, n, mrows):
        moves = torch.empty((q.shape[0], mrows, BN_BW), dtype=torch.int8,
                            device=q.device)
        err = self.fill_fn(q.data_ptr(), q.stride(0), t.data_ptr(), t.stride(0),
                           m.data_ptr(), n.data_ptr(), moves.data_ptr(),
                           q.shape[0], mrows, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous band_fill launch failed: {err}")
        return moves

    def traceback(self, moves, m, n):
        B, mrows, _ = moves.shape
        out = (torch.empty((B, mrows), dtype=torch.uint8, device=moves.device),
               torch.empty((B, mrows), dtype=torch.int8, device=moves.device),
               torch.empty((B,), dtype=torch.int32, device=moves.device))
        err = self.tb_fn(moves.data_ptr(), m.data_ptr(), n.data_ptr(),
                         *(o.data_ptr() for o in out), B, mrows,
                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous row_traceback launch failed: {err}")
        return out


def _pack(qs, ts, dev):
    from hinge_tpu_torch.device import to_device

    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    qc = np.zeros((len(qs), m.max()), np.uint8)
    tc = np.zeros((len(ts), n.max()), np.uint8)
    for w in range(len(qs)):
        qc[w, : m[w]] = qs[w]
        tc[w, : n[w]] = ts[w]
    q, t, dm, dn = (to_device(a, dev) for a in (qc, tc, m, n))
    return q, t, dm, dn, int(m.max())


def check_block(tag, q, t, m, n, mrows, parent, twin_reps=2):
    """Both kernels bit-equal to their twins on one block, then the times
    of the kernels, the previous kernels (when built) and the twins, CUDA events
    on the same tensors.  Returns (errors, times) keyed by kernel."""
    from hinge_tpu_torch.ops import band_nw as BN

    moves = BN.band_fill(q, t, m, n, mrows=mrows)
    moves_ref = BN.band_fill_ref(q, t, m, n, mrows)
    torch.cuda.synchronize()
    if not torch.equal(moves, moves_ref):
        bad = (moves != moves_ref).nonzero()[:5].tolist()
        raise AssertionError(f"{tag}: band_fill differs from its twin at {bad}")
    fill_err = _max_abs_err([moves], [moves_ref])
    del moves_ref
    tb = BN.row_traceback(moves, m, n)
    tb_ref = BN.row_traceback_ref(moves, m, n)
    torch.cuda.synchronize()
    for name, g, w in zip(("cnts", "mv0s", "j_rem"), tb, tb_ref):
        if not torch.equal(g, w):
            raise AssertionError(f"{tag}: row_traceback {name} differs from its twin")
    tb_err = _max_abs_err(tb, tb_ref)
    times = {"band_fill": {}, "row_traceback": {}}
    for rnd in range(2):  # kernel, previous, previous, kernel
        order = ("new", "prev") if rnd == 0 else ("prev", "new")
        for who in order:
            if who == "prev" and not parent.ok:
                continue
            # the launch without the wrapper's length check, whose host
            # sync would put an idle gap between the timed launches
            f = (lambda: BN.launch_band_fill(q, t, m, n, mrows)) if who == "new" \
                else (lambda: parent.fill(q, t, m, n, mrows))
            g = (lambda: BN.row_traceback(moves, m, n)) if who == "new" \
                else (lambda: parent.traceback(moves, m, n))
            times["band_fill"].setdefault(who, []).append(_cuda_ms(f, 10))
            times["row_traceback"].setdefault(who, []).append(_cuda_ms(g, 10))
    if parent.ok:
        if not torch.equal(parent.fill(q, t, m, n, mrows), moves):
            raise AssertionError(f"{tag}: the previous band_fill differs")
    times["band_fill"]["plain"] = [
        _cuda_ms(lambda: BN.band_fill_ref(q, t, m, n, mrows), twin_reps)]
    times["row_traceback"]["plain"] = [
        _cuda_ms(lambda: BN.row_traceback_ref(moves, m, n), twin_reps)]
    bounds = {"band_fill": fill_bound(m, n, mrows),
              "row_traceback": traceback_bound(moves, m, n, tb_ref[2])}
    summary = {}
    for name, d in times.items():
        ms = min(d["new"])
        b_ms, b_by = bounds[name]
        summary[name] = {"ms": ms, "plain_ms": d["plain"][0],
                         "prev_ms": min(d["prev"]) if "prev" in d else None,
                         "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        prev = (f"previous kernel {summary[name]['prev_ms']:.4f} ms ({d['prev']})"
               if "prev" in d else "previous kernel not measured (sources absent)")
        log(f"[{tag}] {name}: bit-equal to its twin; kernel {ms:.4f} ms "
            f"({d['new']}), {prev}, plain torch {d['plain'][0]:.4f} ms; bound "
            f"{b_ms:.4f} ms by {b_by}, share {b_ms / ms:.3f}")
    return {"band_fill": fill_err, "row_traceback": tb_err}, summary


def _check_traceback(what, moves, m, n):
    from hinge_tpu_torch.ops import band_nw as BN

    got, want = BN.row_traceback(moves, m, n), BN.row_traceback_ref(moves, m, n)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"row_traceback differs from its twin on {what}")
    log(f"[kernels] row_traceback bit-equal to its twin on {what}")
    return _max_abs_err(got, want)


def phase_kernels(parent):
    """Kernels vs twins on the same CUDA tensors at the phase-3 shape,
    traceback rows of all-left and of arbitrary codes, and windows long
    enough to need the fill's rebase."""
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops import band_nw as BN

    dev = torch.device("cuda")
    qs, ts = _windows()
    q, t, dm, dn, mrows = _pack(qs, ts, dev)
    log(f"[kernels] {len(qs)} windows, m {int(dm.min())}..{mrows}, "
        f"moves ({len(qs)}, {mrows}, {BN.BW}) int8")
    errs, summary = check_block("kernels", q, t, dm, dn, mrows, parent)

    # rows with no non-left lane up to k_e (top = -1; cnt wraps at 256)
    rng = np.random.default_rng(1)
    syn = rng.integers(0, 4, (256, 1100, BN.BW)).astype(np.int8)
    syn[:, ::3, :] = 2
    syn[:16] = 2
    sm = rng.integers(1, 1101, 256).astype(np.int32)
    sn = (sm + rng.integers(-126, 127, 256)).clip(0).astype(np.int32)
    smv, sdm, sdn = (to_device(a, dev) for a in (syn, sm, sn))
    e = _check_traceback("all-left rows", smv, sdm, sdn)
    # every int8 code: groups of rows with codes outside 0..3 take the
    # kernel's per-cell max
    smv = to_device(rng.integers(-128, 128, syn.shape).astype(np.int8), dev)
    smv[:128] = smv[:128].remainder(4)
    e = max(e, _check_traceback("arbitrary int8 codes", smv, sdm, sdn))
    errs["row_traceback"] = max(errs["row_traceback"], e)

    # windows whose costs would pass the 16-bit INF without the rebase
    lq, lt = [], []
    for w in range(2):
        tt = rng.integers(0, 4, 30_000 + 20 * w).astype(np.uint8)
        lq.append(_noisy_copy(rng, tt, 0.05)[: len(tt) + 100])
        lt.append(tt)
    q2, t2, m2, n2, mr2 = _pack(lq, lt, dev)
    got = BN.band_fill(q2, t2, m2, n2, mrows=mr2)
    want = BN.band_fill_ref(q2, t2, m2, n2, mr2)
    torch.cuda.synchronize()
    errs["band_fill"] = max(errs["band_fill"], _max_abs_err([got], [want]))
    if not torch.equal(got, want):
        raise AssertionError("band_fill differs from its twin on long windows")
    log(f"[kernels] band_fill bit-equal to its twin on {len(lq)} windows of "
        f"{int(m2.min())}..{mr2} rows")
    del q2, t2, got, want
    launch_sizes(dev)
    return errs, summary


def launch_sizes(dev):
    """Kernel time per 2048 windows at several launch sizes, same window
    mix: what band_nw.MAX_BATCH was chosen by."""
    from hinge_tpu_torch.ops import band_nw as BN

    for count in (2048, 4096, 8192):
        q, t, m, n, mrows = _pack(*_windows(5, count), dev)
        fill = _cuda_ms(lambda: BN.launch_band_fill(q, t, m, n, mrows), 5)
        moves = BN.launch_band_fill(q, t, m, n, mrows)
        tb = _cuda_ms(lambda: BN.row_traceback(moves, m, n), 5)
        log(f"[launch] {count} windows per launch: band_fill {fill:.4f} ms "
            f"({fill * 2048 / count:.4f} per 2048), row_traceback {tb:.4f} ms "
            f"({tb * 2048 / count:.4f} per 2048)")
        del moves


class _BlockSpy:
    """Counts the windows band_fill gets and keeps the inputs of the
    largest block (cloned, outside any timing)."""

    def __init__(self, module):
        self.module, self.fn = module, module.band_fill
        self.windows = 0
        self.block = None

    def __enter__(self):
        def spy(q, t, m, n, mrows):
            self.windows += q.shape[0]
            if self.block is None or q.shape[0] * mrows > \
                    self.block[0].shape[0] * self.block[4]:
                self.block = (q.clone(), t.clone(), m.clone(), n.clone(), mrows)
            return self.fn(q, t, m, n, mrows=mrows)

        self.module.band_fill = spy
        return self

    def __exit__(self, *exc):
        self.module.band_fill = self.fn


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


def _zero(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def _stage_diff(before):
    from hinge_tpu_torch.utils.log import timings

    return {k: v - before.get(k, 0.0) for k, v in timings().items()
            if v - before.get(k, 0.0) > 0}


def _check_assembly(tag, res):
    longest = max((len(s) for _, s in res["contigs"]), default=0)
    log(f"[{tag}] {len(res['contigs'])} contigs, longest/genome "
        f"{longest / GENOME_LEN:.4f}")
    if not res["contigs"] or longest / GENOME_LEN < 0.9:
        raise AssertionError(f"{tag}: assembly too short: longest {longest}")


def _check_launches(tag, launches):
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{tag}: the main path never launched {name}")


def phase_real_size(tmp):
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import timings

    t0 = time.perf_counter()
    _, _, rs, ov = simulate(SimParams(genome_len=GENOME_LEN,
                                      coverage=COVERAGE, seed=0,
                                      **READ_ERRORS))
    fasta, las = os.path.join(tmp, "reads.fasta"), os.path.join(tmp, "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    log(f"[real] host set-up: simulated {rs.n_reads} reads, {ov.n} "
        f"overlaps and wrote them in {time.perf_counter() - t0:.3f}s")

    _zero(BN.launches)
    before = timings()
    torch.cuda.reset_peak_memory_stats()
    with _BlockSpy(BN) as spy:
        t0 = time.perf_counter()
        res = assemble(fasta=fasta, las=las, workdir=os.path.join(tmp, "asm"),
                       device="cuda", log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(BN.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[real] assemble wall {wall:.3f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in _stage_diff(before).items()))
    log(f"[real] peak device memory {peak} bytes; kernel launches {launches}; "
        f"{spy.windows} band-NW windows, launch size {BN.MAX_BATCH}")
    _check_assembly("real", res)
    _check_launches("real", launches)
    per_launch = spy.windows / max(launches["band_fill"], 1)
    return launches, per_launch, spy.block, rs, ov, fasta


def _assert_stores_equal(a, b):
    """tests/test_device_join.py's store equality."""
    if a.n != b.n:
        raise AssertionError(f"record count {a.n} != {b.n}")
    for f in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
              "b_start", "b_end", "rc", "tlen", "trace_off", "trace"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"device join differs from the C join: {f}")
    if a.tspace != b.tspace:
        raise AssertionError("tspace differs")


def phase_device_join(rs):
    """The port's device join vs the C join on phase 5's reads; two runs
    of each, the C runs each computing their own minimizers."""
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.overlap import device_join as DJ

    os.environ.pop("HINGE_DEVICE_JOIN", None)
    targets = [rs.get_bases(i) for i in range(rs.n_reads)]
    c_walls, dev_walls, stats = [], [], {}
    for run in range(2):
        if hasattr(rs, "_minimizer_cache"):
            del rs._minimizer_cache
        t0 = time.perf_counter()
        ref = map_reads_to_targets(targets, rs, half_pairs=True)
        c_walls.append(time.perf_counter() - t0)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = DJ.overlap_base_records(rs, device="cuda")
        torch.cuda.synchronize()
        dev_walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        _assert_stores_equal(got, ref)
    # a third device run, synchronised at every phase boundary
    got = DJ.overlap_base_records(rs, device="cuda", stats=stats)
    _assert_stores_equal(got, ref)
    log(f"[join] {ref.n} half-pair records, equal to the C join on every "
        f"column and trace byte ({len(ref.trace)} trace values)")
    log(f"[join] C join wall {c_walls[0]:.3f}s, {c_walls[1]:.3f}s; device "
        f"join wall {dev_walls[0]:.3f}s (first), {dev_walls[1]:.3f}s")
    log("[join] per phase (CUDA-synchronised): " + ", ".join(
        f"{k} {stats[k]:.3f}s" for k in
        ("minimizer", "index", "p1", "p2", "p3", "p4", "fetch")))
    log(f"[join] {stats['blocks']} blocks, {stats['hits']} half-pair seed "
        f"hits; peak device memory {peak} bytes")
    ops = [{"name": "device_join", "source": "hinge_tpu_torch/overlap/device_join.py",
            "replaces": "hinge_tpu/overlap/device_join.py:677",
            "ms": dev_walls[1] * 1e3, "c_ms": c_walls[1] * 1e3,
            "equal": True, "peak_bytes": peak}]
    ops += [{"name": f"device_join.{k}", "ms": stats[k] * 1e3}
            for k in ("minimizer", "index", "p1", "p2", "p3", "p4")]
    return ops


def phase_trim(rs, ov):
    """The trim lattice on cuda vs the native trim, on the maximal stage's
    rows (non-self, top two per pair) with the filter's read masks."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops import classify as CL
    from hinge_tpu_torch.ops import pairs as TP
    from hinge_tpu_torch.stages.filter import run_filter

    fres = run_filter(rs, [ov], nominal_config(), device="cuda")
    es = fres.maskvec[:, 0].astype(np.int32)
    ee = fres.maskvec[:, 1].astype(np.int32)
    sub = ov.take(np.nonzero(ov.a_id != ov.b_id)[0])
    sub = sub.take(TP.top_k_per_pair(sub, 2))
    masks = (es[sub.a_id], ee[sub.a_id], es[sub.b_id], ee[sub.b_id])
    t0 = time.perf_counter()
    native = TP._native_trim(sub, *masks, CL.TRIM_GRID)
    c_ms = (time.perf_counter() - t0) * 1e3
    if native is None:
        raise AssertionError("the native trim library is missing")
    t0 = time.perf_counter()
    got = TP._lattice_trim(sub, *masks, "cuda")
    wall_ms = (time.perf_counter() - t0) * 1e3
    for name, g, w in zip(("eams", "eame", "ebms", "ebme", "active"), got, native):
        if not np.array_equal(g, w):
            raise AssertionError(f"trim lattice differs from the native trim: {name}")
    tw = CL.build_trace_walk(sub)
    seg_id, k_local, _ = CL.make_point_index(tw.npairs)
    args = [to_device(np.asarray(a), "cuda") for a in (
        sub.a_start, sub.a_end, sub.b_start, sub.b_end, sub.rc, *masks,
        tw.npairs, tw.pair_off, tw.cum, seg_id, k_local)]
    op_ms = _cuda_ms(lambda: CL.trim_overlaps(*args, tspace=CL.TRIM_GRID), 5)
    log(f"[trim] {sub.n} rows, {len(seg_id)} lattice points: equal to the "
        f"native trim; lattice op {op_ms:.4f} ms on cuda ({wall_ms:.3f} ms "
        f"with host prep and copies), native trim {c_ms:.3f} ms")
    return [{"name": "trim_lattice", "source": "hinge_tpu_torch/ops/classify.py",
             "replaces": "hinge_tpu/ops/classify.py:126", "ms": op_ms,
             "wall_ms": wall_ms, "c_ms": c_ms, "equal": True}]


class _Timed:
    """Wraps a module function and sums its wall seconds."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_fasta_only(tmp, fasta):
    """assemble() from the reads alone with the device join and the device
    vote, then the consensus stage again with the native C vote."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.data.overlaps import str_to_codes
    from hinge_tpu_torch.io.fasta import read_fasta
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.ops import consensus_vote as CV
    from hinge_tpu_torch.overlap import device_join as DJ
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.stages import consensus as SC
    from hinge_tpu_torch.utils.log import timings

    wd = os.path.join(tmp, "fasta_only")
    os.environ["HINGE_DEVICE_JOIN"] = "1"
    os.environ["HINGE_DEVICE_VOTE"] = "1"
    try:
        _zero(BN.launches, DJ.launches, CV.launches)
        before = timings()
        torch.cuda.reset_peak_memory_stats()
        with _Timed(CV, "vote_tallies_device") as vote:
            t0 = time.perf_counter()
            res = assemble(fasta=fasta, workdir=wd, device="cuda",
                           log=lambda *a: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {**BN.launches, **DJ.launches, **CV.launches}
    finally:
        os.environ.pop("HINGE_DEVICE_JOIN", None)
        os.environ.pop("HINGE_DEVICE_VOTE", None)
    peak = torch.cuda.max_memory_allocated()
    stages = _stage_diff(before)
    log(f"[fasta] assemble wall {wall:.3f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()))
    log(f"[fasta] peak device memory {peak} bytes; launches {launches}")
    _check_assembly("fasta", res)
    _check_launches("fasta", launches)

    # the same draft and alignments through the native C vote
    rs = read_fasta(fasta)
    aln = map_reads_to_targets([str_to_codes(s) for _, s in res["draft"]], rs)
    native_fa = os.path.join(tmp, "native_vote.consensus.fasta")
    with _Timed(SC, "_native_vote_tallies") as cvote:
        t0 = time.perf_counter()
        SC.run_consensus(res["draft"], rs, aln, nominal_config(),
                         out_fasta=native_fa, device="cuda")
        c_cons = time.perf_counter() - t0
    with open(os.path.join(wd, "asm.consensus.fasta"), "rb") as f:
        dev_bytes = f.read()
    with open(native_fa, "rb") as f:
        if f.read() != dev_bytes:
            raise AssertionError("device-vote consensus differs from the "
                                 "native-vote consensus")
    log(f"[fasta] consensus FASTA ({len(dev_bytes)} bytes) byte-equal to the "
        f"native-vote rerun; vote {vote.seconds:.3f}s on cuda over "
        f"{vote.calls} contigs vs native C vote {cvote.seconds:.3f}s; "
        f"consensus stage {stages.get('consensus', 0.0):.3f}s vs {c_cons:.3f}s")
    ops = [{"name": "vote", "source": "hinge_tpu_torch/ops/consensus_vote.py",
            "replaces": "hinge_tpu/ops/consensus_vote.py:168",
            "ms": vote.seconds * 1e3, "c_ms": cvote.seconds * 1e3,
            "equal": True}]
    return launches, ops


def phase_main_block(block, parent):
    """The largest band-NW block of phase 5 (the launch size and the
    window lengths of the main path): kernels vs twins, times, bounds."""
    q, t, m, n, mrows = block
    log(f"[block] phase 5's largest block: {q.shape[0]} windows, m "
        f"{int(m.min())}..{mrows}, moves {q.shape[0] * mrows * BN_BW} bytes")
    return check_block("block", q, t, m, n, mrows, parent, twin_reps=1)


def main():
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        parent = ParentKernels(tmp)
        errs, p3 = phase_kernels(parent)
        phase_golden()
        launches, per_launch, block, rs, ov, fasta = phase_real_size(tmp)
        block_errs, main = phase_main_block(block, parent)
        del block
        ops = phase_device_join(rs)
        ops += phase_trim(rs, ov)
        del ov
        fasta_launches, vote_ops = phase_fasta_only(tmp, fasta)
        ops += vote_ops
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "windows_per_launch": per_launch,
         "max_abs_err": max(errs[name], block_errs[name]),
         **main[name], "library_ms": None,
         "phase3": {k: p3[name][k] for k in ("ms", "prev_ms", "plain_ms",
                                              "bound_ms", "bound_by", "share")}}
        for name, (src, tpu) in KERNELS.items()
    ]
    log(f"[fasta] kernel launches of the fasta-only path: "
        f"{ {k: fasta_launches[k] for k in KERNELS} }")
    print(json.dumps({"device_ops": ops}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
