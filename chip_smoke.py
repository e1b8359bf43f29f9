"""Quickest proof that the torch/CUDA port runs on a card.

    python3 chip_smoke.py [--parent DIR] [--k3-sweep]

--parent DIR holds the previous kernels' sources (band_fill.cu and
row_traceback.cu of commit PARENT, wave_align.cu of commit PREV_K3) where
the checkout has no git history, and may hold thin_rows.cu of commit
PREV_K4 (the checkout keeps a copy of it at PREV_K4_SOURCE).

Runs hinge_tpu_torch on one CUDA card, phase by phase; any failure raises
and the exit code is nonzero.  On cuda the overlap join and the consensus
vote run on the card unless HINGE_DEVICE_JOIN=0 / HINGE_DEVICE_VOTE=0, so
every assemble() and consensus verb below takes the device vote:

1. device  — a CUDA card must be present; prints its name and the
             `nvidia-smi` name/power-limit line;
2. build   — nvcc builds the kernels from hinge_tpu_torch/csrc;
3. kernels — band_fill, row_traceback and emit_rows (K2e, the rows
             from row_traceback's records) on 2048 seeded windows
             (700-1100 bp, 1-15% error, plus edge cases), all-left
             traceback rows, traceback rows of arbitrary int8 codes and
             two 30 kb windows (whose costs would pass 16 bits without
             the fill's rebase) must be bit-equal to their plain torch
             twins on the same CUDA tensors; prints kernel, previous kernel and twin times (CUDA
             events, 10 calls) with each kernel's bound, and K1's and K2's
             time per 2048 windows at 2048, 4096 and 8192 windows per launch.
             The previous kernels (commit PARENT, before the redesign)
             are built from git history or from `--parent DIR`, and are
             left out when neither has them;
4. golden  — the port's golden build on the card writes the 11
             tests/golden/ files byte for byte;
5. real size — assemble() on a simulated 4.6 Mb genome at 30x with 2%
             read errors (reads + .las overlaps), which must run through
             the three band-NW kernels and yield a contig >= 0.9 of the genome; prints
             stage times and peak device memory.  Then its largest band-NW
             block (the launch size and the lengths of the main path) is
             checked and timed as in phase 3;
6. device join — on phase 5's reads, the port's device join
             (overlap_base_records on cuda) must give records equal to
             the C join's (map_reads_to_targets, half pairs)
             on every column and trace byte; prints both walls, per-phase
             times, blocks, hits, p3's anchors in and out and peak device
             memory.  K4 (thin_rows, csrc/thin_rows.cu: a warp a row,
             the greedy step by ballots) and the previous K4 (commit
             PREV_K4, one thread a row; from `--parent DIR`'s
             thin_rows.cu, else the copy at PREV_K4_SOURCE, either checked
             by its sha256; the phase fails without it) must each be
             bit-equal to the twin thin_rows_ref on the same CUDA tensors
             of the join's largest block, and K4 faster than the previous
             K4 in each of four turns (previous, K4, K4, previous); prints
             those times, the parts of each (row bounds, walk, cumsum,
             the host copy of the total, f, other) as device time from a
             torch.profiler trace, the twin's time, K4's bound and both
             kernels' shares.  The same on
             phase 5's reads with reads cut from them interleaved (fewer
             than k + w bases, some prefixes 70 times over, so that index
             buckets overflow).  A read set of MAX_TID reads must make
             overlap_reads on cuda raise under the default switches,
             naming the gate and HINGE_DEVICE_JOIN=0.  Then the trim
             lattice (ops/classify.trim_overlaps) on cuda must equal the
             native trim on the maximal stage's rows of phase 5's .las
             records; prints both times;
7. fasta only — assemble() from the reads alone with HINGE_DEVICE_JOIN
             and HINGE_DEVICE_VOTE unset, which on cuda must run the device
             join, the device vote (their launch counters), K4 and the
             three band-NW kernels
             and yield a contig >= 0.9 of the genome; the consensus stage
             rerun on the same draft with HINGE_DEVICE_VOTE=0 (the native
             C vote) must write a byte-equal X.consensus.fasta;
8. hinge surface — phase 5's reads written as reads.db with their qual
             track (so the filter's QV mask runs on the card) and its
             reads.las, through the per-stage verbs of hinge_tpu_torch.cli
             in this process with --device cuda: filter, maximal, layout,
             clip, draft-path, draft (which must launch the three band-NW kernels),
             correct-head, map, consensus, gfa.  The draft verb again in a
             fresh `python -m hinge_tpu_torch.cli` process must write a
             byte-equal FASTA without rebuilding the kernels; condense,
             n50, unitig, hgraph, merge-hinges, condense-gfa, bandage and
             single-strand must run on the chain's outputs; split_las then
             merge_las must give back reads.las's records exactly; and
             assemble(db=, las=) in a second workdir must write the
             CHAIN_EQUALS_ASSEMBLE files byte-equal to the chain's, with a
             consensus contig >= 0.9 of the genome.  Prints per-verb walls,
             the chain's wall against assemble()'s, the fresh draft's wall
             and peak device memory;
9. sharded — the mesh path, logical shards on the card: (a) the eight
             families of parallel/dryrun.dryrun_multichip(4) on cuda, each
             equal to the port's single-device op (the window aligner
             launching K3); (b) filter, maximal and layout on phase 5's
             reads and .las with HINGE_SHARDED=1 and HINGE_MESH_SHARDS=4,
             whose 12 stage files must be byte-equal to phase 5's, each
             stage's wall printed beside phase 5's; (c) K3 (wave_align) on
             every ladder window phase 5's draft handed to the band-NW
             aligner, whose rows must equal the C DW_banded rows
             (myers.align_exact_batch) byte for byte, through
             run_sharded_wave_align over 4 shards of the card (one K3
             launch a shard), then K3 and the previous K3 (commit PREV_K3,
             one warp a window, from git history or `--parent DIR`'s
             wave_align.cu; left out when neither has it) bit-equal to the
             twin on shard 0's block and on a 256-window block of the same
             CUDA tensors (the two sit on either side of K3's group-width
             choice); prints both kernels' times, taken in turns, the
             twin's on the same block, the bound, the share, the launches
             and peak device memory (with `--k3-sweep`, also K3 at each
             group width and the previous K3 at launch sizes from 256 to
             32,768, which chose wavefront.K3_WIDTHS and WAVE_BATCH); (d) the
             sharded filter step across processes on NCCL, one rank per
             card with 2 logical shards each, whose masks must equal the
             single-device masks;
10. repeats — HINGE's repeat path (tests/torch_golden_repeats.py): (a) the
             filter -> draft-path files of a 300 kb genome with a 25 kb
             repeat longer than every read, byte-equal on cuda to
             tests/golden_repeats/; (b) the yeast W303-scale workload (the
             16 S288C chromosomes, 12.07 Mb, telomeric blocks, four
             unbridged 25 kb repeats and a Ty1-like element, 30x with read
             errors; simulated with a process a CPU core) as FASTA + .las, whose
             sha256 must equal hinge_tpu's manifest
             (tests/golden_repeats/yeast_w303.json), through assemble() on
             cuda with the demo ini: every file written before the draft
             stage must equal the manifest's, and draft -> gfa again under
             HINGE_PARITY_ALIGN=1 too (graphml by networkx's ElementTree
             serializer on both sides); the three band-NW kernels must run
             and be bit-equal to their twins on the draft's largest block, the
             final graph (G3) must hold a hinged edge, matching_position must get
             queries on cuda, and 500 bp probes every 20 kb of each
             chromosome must be >= 0.9 found in the default-switch
             consensus; prints the set-up, stage walls, peak device memory,
             launches, hinged edges, contigs and probe shares; (c) filter,
             maximal and layout on (b)'s reads with HINGE_SHARDED=1 and
             HINGE_MESH_SHARDS=4, every file byte-equal to (b)'s, with
             matching-position queries through the mesh, and the sharded
             hinge call on the filter's hinge tasks equal to the
             single-device op;
11. measurement entry points (hinge_tpu_torch.bench) — (a) bench's
             device chain on its 2,000,000 records: the chain's outputs on
             cuda equal to the same chain on the CPU, then records/s,
             vs_baseline and sol_frac against the H100's HBM speed of
             light, and the sharded step at 1, 2 and 4 logical shards of
             the card; (b) the window-DP twin on its 2,048 windows (C
             DW_banded, band-NW, K3), whose K3 rows must equal the C rows
             and whose band-NW kernel rows must equal the plain twins'
             rows; (c) the draft A/B on phase 5's reads and .las (the
             verbs through draft-path, then each arm in a child process),
             whose band-NW arm must launch K1, K2 and K2e and whose C arm
             must launch none of them.  Each result is printed as a JSON line.

Then a JSON line of the ported device programs' times, a JSON line of
kernel summaries (times on phase 5's largest block, bound, share,
launches and windows per launch of phase 5, phase 3's numbers and
phase 10's launches, windows per launch and numbers on its largest block
beside them; K3's from phase 9; K4's from phase 6, with phase 7's
launches) and, last, the device line {"ok": true,
"device": {...}}.  Imports no jax.
"""

import json
import os
import shutil
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
    "emit_rows": ("hinge_tpu_torch/csrc/emit_rows.cu",
                  "hinge_tpu/ops/pallas_band_nw.py:307 (_emit_rowrec, host numpy)"),
    "wave_align": ("hinge_tpu_torch/csrc/wave_align.cu",
                   "hinge_tpu/ops/wavefront.py:75"),
    "thin_rows": ("hinge_tpu_torch/csrc/thin_rows.cu",
                  "hinge_tpu/overlap/device_join.py:475"),
}
#: the kernels phases 3 and 5 check and time (K3 is phase 9's)
BAND_NW = ("band_fill", "row_traceback", "emit_rows")
#: phase 6's cut reads: fewer than k = 15 bases, 1 to w-1 = 11 k-mers,
#: one window (k + w = 27 is the shortest read hinge_tpu's join takes)
SHORT_LENS = (5, 14, 15, 16, 20, 25, 26)

#: the stage files that hinge_tpu's per-stage CLI chain and its
#: assemble(db=, las=) write byte-equal (tests/test_torch_cli.py shows it on
#: the CPU); phase 8 holds the port's chain and assemble() to the same
CHAIN_EQUALS_ASSEMBLE = (
    "X.cmas", "X.consensus.fasta", "X.contained.txt", "X.cov.flag",
    "X.coverage.txt", "X.deadends.txt", "X.draft.fasta", "X.draft.pb.fasta",
    "X.edges.1", "X.edges.2", "X.edges.greedy", "X.edges.hinges",
    "X.edges.hinges2", "X.edges.list", "X.edges.skipped", "X.filtered.fasta",
    "X.garbage.txt", "X.hgraph", "X.hinge.list", "X.hinges.txt",
    "X.homologous.txt", "X.killed.hinges", "X.mas", "X.max", "X.repeat.txt",
    "X.self.flag", "X1.G0.graphml", "X1.G1.graphml", "X1.G2.graphml",
    "X_consensus.gfa", "X_draft.graphml", "draft_map.txt",
)


def assemble_name(name):
    """The name assemble() (prefix "asm") gives the chain's file `name`
    (prefix "X")."""
    return "asm" + name[1:] if name.startswith("X") else name

LAS_COLUMNS = ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
               "b_start", "b_end", "rc", "diffs", "tlen")


def _record_traces(ov):
    """The trace values of every record, in record order."""
    tlen = ov.tlen.astype(np.int64)
    start = np.repeat(ov.trace_off.astype(np.int64), tlen)
    k = np.arange(int(tlen.sum())) - np.repeat(np.cumsum(tlen) - tlen, tlen)
    return ov.trace[start + k]


def check_las_roundtrip(orig, merged):
    """`merged` (split_las then merge_las) holds exactly the records of
    `orig` in LAmerge's order (a_id, b_id, rc, a_start; ties in file
    order): every column and every trace value equal."""
    want = orig.take(np.lexsort((orig.a_start, orig.rc, orig.b_id, orig.a_id)))
    if merged.n != want.n or merged.tspace != want.tspace:
        raise AssertionError(f"merge_las: {merged.n} records (tspace "
                             f"{merged.tspace}), want {want.n} ({want.tspace})")
    for col in LAS_COLUMNS:
        if not np.array_equal(getattr(merged, col), getattr(want, col)):
            raise AssertionError(f"merge_las: column {col} differs")
    if not np.array_equal(_record_traces(merged), _record_traces(want)):
        raise AssertionError("merge_las: trace values differ")


def unitig_input(graphml):
    """A clip graphml with its raw match coordinates under the attribute
    names the unitig tool reads (read_a_start_raw, ...)."""
    for r in ("a", "b"):
        for end in ("start", "end"):
            graphml = graphml.replace(f'"read_{r}_match_{end}_raw"',
                                      f'"read_{r}_{end}_raw"')
    return graphml


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
    """Time per call of `fn`: CUDA events around `reps` back-to-back calls
    after a warm-up (a kernel shorter than its host call reads the host's
    time between launches).  Every kernel time of this script is taken so."""
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


def emit_bound(m, n, total):
    """Least time for emit_rows on these records: of each window, its
    rows' cnt, mv0 and q bytes, its t bytes and its lengths and j_rem (12
    bytes) read once, its q and t rows (total columns each, all windows)
    and its base written once.  Bytes bound it: its operations are a scan
    over the rows and a few adds a column."""
    B = int(m.numel())
    nbytes = (3 * int(m.sum()) + int(n.sum()) + 12 * B + 2 * total
              + 8 * (B + 2))
    return _bound(nbytes, 0, INT32_OPS_S)


#: K4's bytes: an anchor's q and t read and a kept anchor's (q, t, row)
#: written, int64 each; a row's fr_start, fr_end, Q0, Q1, T0, T1, nb
#: (int64) and okr (bool) written, and the sector of a_row that holds its
#: first anchor read (where the row starts: a_row is sorted, so nothing
#: else of it is needed).  Its operations: the greedy test (a subtract and
#: a compare) a walked anchor, the t test an emitted one bounded by the
#: same count, and the span arithmetic a row
THIN_BYTES_PER_ANCHOR = 16
THIN_BYTES_PER_KEPT = 24
THIN_BYTES_PER_ROW = 7 * 8 + 1 + SECTOR
THIN_OPS_PER_ANCHOR = 4
THIN_OPS_PER_ROW = 16


def thin_bound(n_a, n_f, n_rows):
    """Least time for K4 on one join block of n_a accepted anchors, n_f
    kept ones and n_rows rows: the input it needs read once (q and t of
    every anchor, where each row starts) and its outputs written once,
    against the operations of one walk of each row."""
    nbytes = (THIN_BYTES_PER_ANCHOR * n_a + THIN_BYTES_PER_KEPT * n_f
              + THIN_BYTES_PER_ROW * n_rows)
    nops = THIN_OPS_PER_ANCHOR * n_a + THIN_OPS_PER_ROW * n_rows
    return _bound(nbytes, nops, INT32_OPS_S)


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


#: the commit whose K3 (csrc/wave_align.cu, one warp a window) phase 9c
#: times beside the current one
PREV_K3 = "b79cf98dfa161b24c9bc8bf717b4b4d82c4e48d3"


def _prev_k3_source(tmp):
    """The previous K3 source: wave_align.cu in --parent DIR, else from git
    history at PREV_K3; None when neither has it."""
    if "--parent" in sys.argv:
        path = os.path.join(sys.argv[sys.argv.index("--parent") + 1], "wave_align.cu")
        if os.path.exists(path):
            return path
    r = subprocess.run(["git", "show", f"{PREV_K3}:hinge_tpu_torch/csrc/wave_align.cu"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        return None
    path = os.path.join(tmp, "wave_align.cu")
    with open(path, "w") as fh:
        fh.write(r.stdout)
    return path


class PrevK3:
    """The previous K3 and its wrapper's logic (a warp a window, a full V
    row in shared memory, a band-wide history), built into a scratch
    directory for the A/B in the same process.  Not part of the port."""

    WARPS, SMEM_MAX = 4, 232448

    def __init__(self, tmp):
        import ctypes

        from hinge_tpu_torch.ops import _build

        src = _prev_k3_source(tmp)
        self.ok = src is not None
        if not self.ok:
            log("[wave] previous K3 not timed: no source in --parent DIR or git history")
            return
        lib = _build.compile_sources([src], os.path.join(tmp, "prev_k3_build"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self.fn = ctypes.CDLL(lib["wave_align"]).hinge_wave_align
        self.fn.argtypes = [vp, vp, ll, vp, vp, i, i, i, i, *[vp] * 10]
        self.fn.restype = i

    def __call__(self, q, t, m, n, bt, max_d, kb):
        B, L = q.shape
        a16 = lambda v: -(-v // 16) * 16  # noqa: E731
        if kb > 256 or self.WARPS * (a16((2 * max_d + 2) * 4) + 2 * a16(L)) > self.SMEM_MAX:
            raise ValueError("outside the previous K3's limits")
        dev = q.device
        px = torch.empty((B, 2 * max_d + 2), dtype=torch.int32, device=dev)
        py = torch.empty_like(px)
        aligned = torch.empty((B,), dtype=torch.bool, device=dev)
        fins = torch.empty((3, B), dtype=torch.int32, device=dev)
        Vh = torch.empty((B, max_d, kb), dtype=torch.int16, device=dev)
        kh = torch.empty((2, B, max_d), dtype=torch.int16, device=dev)
        err = self.fn(q.data_ptr(), t.data_ptr(), L, m.data_ptr(), n.data_ptr(),
                      B, bt, max_d, kb, Vh.data_ptr(), kh[0].data_ptr(),
                      kh[1].data_ptr(), px.data_ptr(), py.data_ptr(),
                      aligned.data_ptr(), fins[0].data_ptr(), fins[1].data_ptr(),
                      fins[2].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous wave_align launch failed: {err}")
        return px, py, aligned, fins[0], fins[1], fins[2]


#: the commit whose K4 (csrc/thin_rows.cu, one thread a row) phase 6 times
#: beside the current one; the checkout keeps its source at PREV_K4_SOURCE
#: (byte-equal, PREV_K4_SHA256) for checkouts without git history
PREV_K4 = "0c0885919be50e7585cc8661b0f176d8f911a037"
PREV_K4_SOURCE = "hinge_tpu_torch/bench/prev_thin_rows_0c08859.cu"
PREV_K4_SHA256 = "ce75a76eb1446d2e7f0d66d1a38abfae94e9408bba82d731057c8f9a10e5f67c"
def _prev_k4_source():
    """The previous K4's source: thin_rows.cu in --parent DIR when it is
    there, else the checkout's copy; raises unless it hashes to
    PREV_K4_SHA256."""
    import hashlib

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), PREV_K4_SOURCE)
    if "--parent" in sys.argv:
        cand = os.path.join(sys.argv[sys.argv.index("--parent") + 1], "thin_rows.cu")
        if os.path.exists(cand):
            path = cand
    if not os.path.exists(path):
        raise AssertionError(f"the previous K4's source is missing: {path}")
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    if digest != PREV_K4_SHA256:
        raise AssertionError(f"{path} is not commit {PREV_K4[:7]}'s thin_rows.cu "
                             f"(sha256 {digest})")
    return path


class PrevK4:
    """The previous K4 and its wrapper's logic (the row bounds and the walk,
    one thread a row, in one call; a cumsum and one host sync; a gather),
    built into a scratch directory for the A/B in the same process.  Not
    part of the port."""

    def __init__(self, tmp):
        import ctypes

        from hinge_tpu_torch.ops import _build

        libs = _build.compile_sources([_prev_k4_source()],
                                      os.path.join(tmp, "prev_k4_build"))
        lib = ctypes.CDLL(next(iter(libs.values())))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        self.fns = {}
        for name, argtypes in (
                ("hinge_thin_rows", [vp, vp, vp, *[ll] * 7, *[vp] * 12]),
                ("hinge_thin_rows_gather", [vp, ll, ll, *[vp] * 9])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[name] = fn

    def _call(self, name, *args):
        err = self.fns[name](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous K4 {name} launch failed: {err}")

    def __call__(self, a_row, a_q, a_t, n_rows, k, sub_gap, min_span,
                 min_cnt, tspace):
        """The previous launch_thin_rows."""
        dev = a_row.device
        new = lambda n, dt=torch.int64: torch.empty(n, dtype=dt, device=dev)  # noqa: E731
        n_a = a_row.shape[0]
        r_start, r_end, m = new(n_rows), new(n_rows), new(n_rows)
        Q0, Q1, T0, T1, nb = (new(n_rows) for _ in range(5))
        okr = new(n_rows, torch.bool)
        k_q, k_t = new(n_a), new(n_a)
        ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
        params = [int(x) for x in (k, sub_gap, min_span, min_cnt, tspace)]
        self._call("hinge_thin_rows", *ptr(a_row, a_q, a_t), n_a, n_rows,
                   *params, *ptr(r_start, r_end, k_q, k_t, m, Q0, Q1, T0, T1,
                                 okr, nb))
        fr_end = torch.cumsum(m, 0)
        fr_start = fr_end - m
        n_f, m_min = torch.stack([fr_end[-1], m.min()]).tolist()
        if m_min < 1:
            raise ValueError("previous K4: a row kept no anchor")
        f_q, f_t, f_row = new(n_f), new(n_f), new(n_f)
        self._call("hinge_thin_rows_gather", a_row.data_ptr(), n_a, n_rows,
                   *ptr(r_start, m, fr_start, k_q, k_t, f_q, f_t, f_row))
        return f_q, f_t, f_row, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb


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
    """The three band-NW kernels bit-equal to their twins on one block,
    then the times of the kernels, the previous K1/K2 (when built) and the
    twins, CUDA events on the same tensors.  Returns (errors, times)
    keyed by kernel."""
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
    # K2e on those records and the flat bases the main path sends up
    eargs = (*tb, m, n, _flat(q, m), _flat(t, n))
    meta, rows = BN.emit_rows(*eargs)
    emit_ref = BN.emit_rows_ref(*eargs)
    torch.cuda.synchronize()
    total = int(emit_ref[0][-2])
    emitted = (meta, rows[:2 * total])
    if not all(torch.equal(g, w) for g, w in zip(emitted, emit_ref)):
        raise AssertionError(f"{tag}: emit_rows differs from its twin")
    emit_err = _max_abs_err(emitted, emit_ref)
    del meta, rows, emitted, emit_ref
    times = {"band_fill": {}, "row_traceback": {}, "emit_rows": {}}
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
            if who == "new":
                times["emit_rows"].setdefault(who, []).append(
                    _cuda_ms(lambda: BN.emit_rows(*eargs), 10))
    if parent.ok:
        if not torch.equal(parent.fill(q, t, m, n, mrows), moves):
            raise AssertionError(f"{tag}: the previous band_fill differs")
    times["band_fill"]["plain"] = [
        _cuda_ms(lambda: BN.band_fill_ref(q, t, m, n, mrows), twin_reps)]
    times["row_traceback"]["plain"] = [
        _cuda_ms(lambda: BN.row_traceback_ref(moves, m, n), twin_reps)]
    times["emit_rows"]["plain"] = [
        _cuda_ms(lambda: BN.emit_rows_ref(*eargs), twin_reps)]
    bounds = {"band_fill": fill_bound(m, n, mrows),
              "row_traceback": traceback_bound(moves, m, n, tb_ref[2]),
              "emit_rows": emit_bound(m, n, total)}
    summary = {}
    for name, d in times.items():
        ms = min(d["new"])
        b_ms, b_by = bounds[name]
        summary[name] = {"ms": ms, "plain_ms": d["plain"][0],
                         "prev_ms": min(d["prev"]) if "prev" in d else None,
                         "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        prev = (f"previous kernel {summary[name]['prev_ms']:.4f} ms ({d['prev']})"
                if "prev" in d else "no previous kernel" if name == "emit_rows"
                else "previous kernel not measured (sources absent)")
        log(f"[{tag}] {name}: bit-equal to its twin; kernel {ms:.4f} ms "
            f"({d['new']}), {prev}, plain torch {d['plain'][0]:.4f} ms; bound "
            f"{b_ms:.4f} ms by {b_by}, share {b_ms / ms:.3f}")
    return ({"band_fill": fill_err, "row_traceback": tb_err,
             "emit_rows": emit_err}, summary)


def _flat(x, lens):
    """The windows of padded rows `x` end to end, each cut to its length."""
    return x[torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]]


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


class _WindowSpy:
    """Keeps every ladder window the draft stage hands to band_align_batch
    (the windows phase 9 aligns with K3)."""

    def __init__(self, module):
        self.module, self.fn = module, module.band_align_batch
        self.qs, self.ts = [], []

    def __enter__(self):
        def spy(qs, ts, **kw):
            self.qs.extend(qs)
            self.ts.extend(ts)
            return self.fn(qs, ts, **kw)

        self.module.band_align_batch = spy
        return self

    def __exit__(self, *exc):
        self.module.band_align_batch = self.fn


class _ThinSpy:
    """Keeps the arguments of the device join block whose p3 (thin_rows)
    gets the most anchors; the tensors stay referenced, not copied."""

    def __init__(self, module):
        self.module, self.fn = module, module.thin_rows
        self.block = None

    def __enter__(self):
        def spy(a_row, a_q, a_t, *rest):
            if self.block is None or a_row.shape[0] > self.block[0].shape[0]:
                self.block = (a_row, a_q, a_t, *rest)
            return self.fn(a_row, a_q, a_t, *rest)

        self.module.thin_rows = spy
        return self

    def __exit__(self, *exc):
        self.module.thin_rows = self.fn


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
    with _BlockSpy(BN) as spy, _WindowSpy(BN) as windows:
        t0 = time.perf_counter()
        res = assemble(fasta=fasta, las=las, workdir=os.path.join(tmp, "asm"),
                       device="cuda", log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(BN.launches)
    peak = torch.cuda.max_memory_allocated()
    stages = _stage_diff(before)
    log(f"[real] assemble wall {wall:.3f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()))
    log(f"[real] peak device memory {peak} bytes; kernel launches {launches}; "
        f"{spy.windows} band-NW windows, launch size {BN.MAX_BATCH}")
    _check_assembly("real", res)
    _check_launches("real", launches)
    per_launch = spy.windows / max(launches["band_fill"], 1)
    return (launches, per_launch, spy.block, rs, ov, fasta, stages,
            (windows.qs, windows.ts))


def phase_device_join(rs, tmp):
    """The port's device join vs the C join on phase 5's reads; two runs
    of each, the C runs each computing their own minimizers."""
    from hinge_tpu_torch.bench import assert_stores_equal, join_stats
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.overlap import device_join as DJ
    from hinge_tpu_torch.utils.log import record

    os.environ.pop("HINGE_DEVICE_JOIN", None)
    targets = [rs.get_bases(i) for i in range(rs.n_reads)]
    c_walls, dev_walls = [], []
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
        assert_stores_equal(got, ref)
    # a third device run in a record, under torch.profiler so that each
    # phase span carries its stream seconds (no phase synchronises)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with _ThinSpy(DJ) as thin, prof, record("join") as call:
        got = DJ.overlap_base_records(rs, device="cuda")
    del prof
    stats = join_stats(call)
    assert_stores_equal(got, ref)
    log(f"[join] {ref.n} half-pair records, equal to the C join on every "
        f"column and trace byte ({len(ref.trace)} trace values)")
    log(f"[join] C join wall {c_walls[0]:.3f}s, {c_walls[1]:.3f}s; device "
        f"join wall {dev_walls[0]:.3f}s (first), {dev_walls[1]:.3f}s")
    log("[join] per phase, stream s (host wall s, no syncs): " + ", ".join(
        f"{k} {stats[k + '_stream_s']:.3f} ({stats[k + '_host_s']:.3f})"
        for k in ("minimizer", "index", "p1", "p2", "p3", "p4", "fetch")))
    log(f"[join] {stats['blocks']} blocks, {stats['hits']} half-pair seed "
        f"hits, {stats['anchors']} accepted anchors into p3, "
        f"{stats['kept']} kept; peak device memory {peak} bytes")
    k4 = check_thin_rows(thin.block, stats["blocks"], tmp)
    del thin
    phase_join_short_reads(rs)
    phase_join_gate()
    ops = [{"name": "device_join", "source": "hinge_tpu_torch/overlap/device_join.py",
            "replaces": "hinge_tpu/overlap/device_join.py:677",
            "ms": dev_walls[1] * 1e3, "c_ms": c_walls[1] * 1e3,
            "equal": True, "peak_bytes": peak, "blocks": stats["blocks"],
            "anchors": stats["anchors"], "kept": stats["kept"]}]
    ops += [{"name": f"device_join.{k}",
             "stream_ms": stats[k + "_stream_s"] * 1e3,
             "host_ms": stats[k + "_host_s"] * 1e3}
            for k in ("minimizer", "index", "p1", "p2", "p3", "p4")]
    return ops, k4


#: the parts of a K4 call: each device event of its trace goes to the first
#: part one of whose names it contains, else to "other" (the previous K4's
#: elementwise ops, the stack before its host copy)
K4_PARTS = (("bounds", ("bounds_kernel", "Memset")), ("walk", ("walk_kernel",)),
            ("cumsum", ("Scan",)), ("host_copy", ("Memcpy DtoH",)),
            ("f", ("copy_kernel", "gather_kernel")))


def _k4_parts_ms(run, reps=10):
    """The device time of each part of a call `run()`, the mean of `reps`
    calls in one torch.profiler trace: every kernel, memset and copy the
    card ran, by name (K4_PARTS).  Raises when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    ms = dict.fromkeys([p for p, _ in K4_PARTS] + ["other"], 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for p, names in K4_PARTS
                     if any(n in e.name for n in names)), "other")
        ms[part] += e.time_range.elapsed_us() / 1e3 / reps
    if not ms["walk"] > 0:
        raise AssertionError("torch.profiler's trace holds no walk kernel: "
                             f"{sorted({e.name for e in prof.events()})[:20]}")
    return ms


def _in_turns(a, b):
    """a, b, b, a timed back to back; (mean of a, mean of b, the four)."""
    turns = [_cuda_ms(f, 10) for f in (a, b, b, a)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def check_thin_rows(block, blocks, tmp):
    """K4 and the previous K4 against the twin thin_rows_ref on the same
    CUDA tensors, the largest block of phase 6's join: bit-equal on all 11
    outputs (values, dtypes, shapes), K4 faster in each of four turns; the
    times, each one's parts, the twin's time, K4's bound and shares."""
    from hinge_tpu_torch.overlap import device_join as DJ

    prev = PrevK4(tmp)
    a_row, a_q, a_t, *rest = block
    n_rows = rest[0]
    runs = {"K4": lambda: DJ.launch_thin_rows(a_row, a_q, a_t, *rest),
            "previous K4": lambda: prev(a_row, a_q, a_t, *rest)}
    want = DJ.thin_rows_ref(a_row, a_q, a_t, *rest)
    err = 0
    for who, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{who} differs from its twin on output "
                                     f"{i}: {g.dtype} {tuple(g.shape)} vs "
                                     f"{w.dtype} {tuple(w.shape)}")
        err = max(err, _max_abs_err(got, want))
        del got
    n_a, n_f = a_row.shape[0], want[0].shape[0]
    prev_ms, ms, turns = _in_turns(runs["previous K4"], runs["K4"])
    parts = {who: _k4_parts_ms(run) for who, run in runs.items()}
    plain_ms = _cuda_ms(lambda: DJ.thin_rows_ref(a_row, a_q, a_t, *rest), 3)
    b_ms, b_by = thin_bound(n_a, n_f, n_rows)
    longest = int((want[4] - want[3]).max())
    a_longest = int(torch.bincount(a_row, minlength=n_rows).max())
    singles = int((torch.bincount(a_row, minlength=n_rows) == 1).sum())
    log(f"[join] K4 thin_rows on the largest of {blocks} blocks ({n_a} "
        f"anchors, {n_rows} rows, {singles} of one anchor, longest "
        f"{a_longest}; {n_f} kept, longest {longest}): K4 and the previous "
        f"K4 bit-equal to thin_rows_ref on 11 outputs")
    log("[join] K4 in turns (previous, K4, K4, previous): "
        + ", ".join(f"{x:.4f}" for x in turns) + " ms")
    log(f"[join] K4 {ms:.4f} ms, previous K4 {prev_ms:.4f} ms, twin "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), share "
        f"{b_ms / ms:.4f} (previous {b_ms / prev_ms:.4f})")
    for who, p in parts.items():
        log(f"[join] {who} parts (device ms a call, torch.profiler): "
            + ", ".join(f"{k} {v:.4f}" for k, v in p.items())
            + f"; sum {sum(p.values()):.4f}")
    if not max(turns[1:3]) < min(turns[0], turns[3]):
        raise AssertionError("K4 is not faster than the previous K4 in every "
                             "turn")
    return {"max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / ms, "prev_share": b_ms / prev_ms,
            "turns": {"prev_k4_k4_prev": turns},
            "parts": {"k4": parts["K4"], "prev": parts["previous K4"]},
            "block": {"anchors": n_a, "kept": n_f, "rows": n_rows,
                      "single_rows": singles, "longest_row": a_longest},
            "blocks": blocks}


def with_short_reads(rs, seed=1):
    """`rs`'s reads with reads cut from them interleaved: 30 of each of
    SHORT_LENS bases (fewer than k, one to w-1 k-mers, one window) from
    random places, and 70 copies of the 24-base prefix of 20 reads, which
    overflow their minimizers' index buckets (max_bucket 64)."""
    from hinge_tpu_torch.data.overlaps import ReadStore

    rng = np.random.default_rng(seed)
    cut = []
    for n in SHORT_LENS:
        for r in rng.integers(0, rs.n_reads, 30):
            read = rs.get_bases(int(r))
            s = int(rng.integers(0, len(read) - n))
            cut.append(read[s : s + n])
    cut += [rs.get_bases(int(r))[:24]
            for r in np.linspace(0, rs.n_reads - 1, 20) for _ in range(70)]
    out = []
    for i in range(rs.n_reads):
        out.append(rs.get_bases(i))
        if i < len(cut):
            out.append(cut[i])
    out += cut[rs.n_reads:]
    lens = np.array([len(r) for r in out], np.int32)
    off = np.zeros(len(out) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return ReadStore(length=lens, bases_off=off,
                     bases=np.concatenate(out).astype(np.uint8))


def phase_join_short_reads(rs):
    """Phase 5's reads with reads shorter than k + w among them: the device
    join on cuda must equal the C join record for record."""
    from hinge_tpu_torch.bench import assert_stores_equal
    from hinge_tpu_torch.overlap import device_join as DJ
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets

    srs = with_short_reads(rs)
    n_short = int((srs.length < 27).sum())
    t0 = time.perf_counter()
    ref = map_reads_to_targets([srs.get_bases(i) for i in range(srs.n_reads)],
                               srs, half_pairs=True)
    c_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = DJ.overlap_base_records(srs, device="cuda")
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    if got is None:
        raise AssertionError("the device join refused reads shorter than k + w")
    assert_stores_equal(got, ref)
    log(f"[join] {srs.n_reads} reads, {n_short} of them shorter than k + w "
        f"= 27 bases: {ref.n} records equal to the C join's (device join "
        f"{dev_wall:.3f}s, C join {c_wall:.3f}s)")


def phase_join_gate():
    """Read sets past the device join's MAX_TID gate and past its memory
    gate (200,000 reads of 50 kb, more than the card holds at the join's
    bytes a base; join_gate reads only their lengths): with the switch
    unset, overlap_reads on cuda must raise, naming the gate and
    HINGE_DEVICE_JOIN=0, and never run the C join."""
    from hinge_tpu_torch.data.overlaps import ReadStore
    from hinge_tpu_torch.overlap import device_join as DJ
    from hinge_tpu_torch.overlap import mapper as M

    os.environ.pop("HINGE_DEVICE_JOIN", None)
    real = M.map_reads_to_targets

    def no_c_join(*a, **kw):
        raise AssertionError("the C join ran on a gated input")

    M.map_reads_to_targets = no_c_join
    try:
        for n, length, name in ((DJ.MAX_TID, 30, "MAX_TID"),
                                (200_000, 50_000, "bytes of device memory")):
            lens = np.full(n, length, np.int32)
            off = np.arange(n + 1, dtype=np.int64) * length
            bases = np.zeros(int(off[-1]) if length < 100 else 1, np.uint8)
            rs = ReadStore(length=lens, bases_off=off, bases=bases)
            try:
                M.overlap_reads(rs, device="cuda")
            except ValueError as e:
                if name not in str(e) or "HINGE_DEVICE_JOIN=0" not in str(e):
                    raise AssertionError(f"the gate's error does not name "
                                         f"the gate and HINGE_DEVICE_JOIN=0: "
                                         f"{e}")
                log(f"[join] {n} reads of {length} bases under the default: "
                    f"{e}")
            else:
                raise AssertionError(f"{n} reads of {length} bases ran under "
                                     f"the default")
    finally:
        M.map_reads_to_targets = real


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
    """Wraps a module function and sums its wall seconds; with `count`,
    also sums count(*args, **kwargs) over the calls (queries, tasks), and
    keeps the device types of the tensors it gets first."""

    def __init__(self, module, name, count=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.count = count
        self.seconds = 0.0
        self.calls = 0
        self.items = 0
        self.devices = set()

    def __enter__(self):
        def timed(*a, **kw):
            if self.count is not None:
                self.items += self.count(*a, **kw)
            if a and isinstance(a[0], torch.Tensor):
                self.devices.add(a[0].device.type)
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
    """assemble() from the reads alone with both device switches unset,
    which must run the device join and the device vote, then the consensus
    stage again with HINGE_DEVICE_VOTE=0 (the native C vote)."""
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
    os.environ.pop("HINGE_DEVICE_JOIN", None)
    os.environ.pop("HINGE_DEVICE_VOTE", None)
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
    os.environ["HINGE_DEVICE_VOTE"] = "0"
    try:
        with _Timed(SC, "_native_vote_tallies") as cvote:
            t0 = time.perf_counter()
            SC.run_consensus(res["draft"], rs, aln, nominal_config(),
                             out_fasta=native_fa, device="cuda")
            c_cons = time.perf_counter() - t0
    finally:
        os.environ.pop("HINGE_DEVICE_VOTE", None)
    if cvote.calls == 0:
        raise AssertionError("HINGE_DEVICE_VOTE=0 did not run the native vote")
    with open(os.path.join(wd, "asm.consensus.fasta"), "rb") as f:
        dev_bytes = f.read()
    with open(native_fa, "rb") as f:
        if f.read() != dev_bytes:
            raise AssertionError("device-vote consensus differs from the "
                                 "native-vote consensus")
    log(f"[fasta] consensus FASTA ({len(dev_bytes)} bytes, the default "
        f"switches) byte-equal to the HINGE_DEVICE_VOTE=0 rerun; vote "
        f"{vote.seconds:.3f}s on cuda over {vote.calls} contigs vs native C vote {cvote.seconds:.3f}s; "
        f"consensus stage {stages.get('consensus', 0.0):.3f}s vs {c_cons:.3f}s")
    ops = [{"name": "vote", "source": "hinge_tpu_torch/ops/consensus_vote.py",
            "replaces": "hinge_tpu/ops/consensus_vote.py:168",
            "ms": vote.seconds * 1e3, "c_ms": cvote.seconds * 1e3,
            "equal": True}]
    return launches, ops


def _run_verb(argv, walls, cuda=True):
    """One verb through hinge_tpu_torch.cli.main in this process, timed
    (to the end of its device work); raises when it fails or prints no
    summary."""
    import contextlib
    import io

    from hinge_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + (["--device", "cuda"] if cuda else []))
    torch.cuda.synchronize()
    walls[argv[0]] = walls.get(argv[0], 0.0) + time.perf_counter() - t0
    if rc != 0 or not buf.getvalue().strip():
        raise AssertionError(f"hinge {argv[0]}: rc {rc}, printed "
                             f"{buf.getvalue()!r}")
    return buf.getvalue()


def _require_files(wd, names, verb):
    for name in names:
        if not os.path.isfile(os.path.join(wd, name)):
            raise AssertionError(f"hinge {verb} did not write {name}")


def _lib_mtimes():
    from hinge_tpu_torch.ops import _build

    return {f: os.stat(os.path.join(_build.BUILD_DIR, f)).st_mtime_ns
            for f in os.listdir(_build.BUILD_DIR) if f.endswith(".so")}


def phase_hinge_surface(tmp, rs, las):
    """Phase 8: the per-stage `hinge` chain on reads.db (with the qual
    track) + phase 5's reads.las, the draft verb again in a fresh process,
    the graph tools on the chain's outputs, split_las/merge_las, and
    assemble(db=) in a second workdir, which must write the compared
    stage files byte-equal."""
    from hinge_tpu_torch.io.dazz_db import read_db, write_db
    from hinge_tpu_torch.io.fasta import read_fasta
    from hinge_tpu_torch.io.las import read_las
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.pipeline import assemble

    base = os.path.join(tmp, "surface")
    wd = os.path.join(base, "chain")
    os.makedirs(wd)
    db = os.path.join(base, "reads.db")
    t0 = time.perf_counter()
    write_db(db, rs)
    qv = read_db(db, load_bases=False)
    if not qv.has_qv() or not np.array_equal(qv.qv_val, rs.qv_val):
        raise AssertionError("reads.db lost the qual track")
    log(f"[surface] host set-up: wrote reads.db ({rs.n_reads} reads, "
        f"{len(rs.qv_val)} QV segments) in {time.perf_counter() - t0:.3f}s")

    io_ = ["--db", db, "--las", las, "-x", "X"]
    chain = [
        ["filter", *io_], ["maximal", *io_], ["layout", *io_, "--out", "X"],
        ["clip", "X.edges.hinges", "X.hinge.list", "1"],
        ["draft-path", ".", "X", "X1.G2.graphml", "--db", db],
        ["draft", *io_, "--out", "X.draft"],
        ["correct-head", "X.draft.fasta", "X.draft.pb.fasta", "draft_map.txt"],
        ["map", "X.draft.fasta", "--db", db, "--out", "draft.las"],
        ["consensus", "X.draft.fasta", db, "draft.las", "X.consensus.fasta"],
        ["gfa", ".", "X", "X.consensus.fasta"],
    ]
    device_verbs = {"filter", "maximal", "layout", "draft", "consensus"}
    walls = {}
    old = os.getcwd()
    os.chdir(wd)
    try:
        torch.cuda.reset_peak_memory_stats()
        for argv in chain:
            if argv[0] == "draft":
                _zero(BN.launches)
            _run_verb(argv, walls, cuda=argv[0] in device_verbs)
            if argv[0] == "draft":
                launches = dict(BN.launches)
        peak = torch.cuda.max_memory_allocated()
        _check_launches("surface draft", launches)
        _require_files(wd, CHAIN_EQUALS_ASSEMBLE + ("draft.las",), "chain")
        chain_wall = sum(walls.values())
        log("[surface] chain on cuda: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in walls.items())
            + f"; total {chain_wall:.3f}s; peak device memory {peak} bytes; "
            f"draft launches {launches}")

        # the draft verb as users run it: a fresh interpreter, which loads
        # the kernels built above without building them again
        libs = _lib_mtimes()
        import hinge_tpu_torch

        root = os.path.dirname(os.path.dirname(os.path.abspath(
            hinge_tpu_torch.__file__)))
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "hinge_tpu_torch.cli", "draft", *io_,
             "--out", "X.fresh", "--device", "cuda"],
            cwd=wd, env=env, capture_output=True, text=True, timeout=600)
        fresh_wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"fresh-process draft failed: {r.stderr[-2000:]}")
        if _lib_mtimes() != libs:
            raise AssertionError("the fresh process rebuilt the kernels")
        with open("X.draft.fasta", "rb") as f, open("X.fresh.fasta", "rb") as g:
            if f.read() != g.read():
                raise AssertionError("fresh-process draft FASTA differs from "
                                     "the in-process one")
        log(f"[surface] fresh-process draft: {r.stdout.strip().splitlines()[-1]}"
            f" in {fresh_wall:.3f}s, FASTA byte-equal to the in-process "
            "draft, no kernel rebuilt")

        # the graph tools on the chain's outputs
        with open("X1.G2.graphml") as f, open("X1.G2.raw.graphml", "w") as g:
            g.write(unitig_input(f.read()))
        tools = [
            (["condense", "X1.G2.graphml", "--out", "X1.G2.condensed.graphml"],
             ["X1.G2.condensed.graphml"]),
            (["n50", "X_draft.graphml"], []),
            (["unitig", "X1.G2.raw.graphml", "--out", "X.unitig.list"],
             ["X.unitig.list"]),
            (["hgraph", "X.hgraph", "--out", "X.hgraph.graphml"],
             ["X.hgraph.graphml"]),
            (["merge-hinges", "X.edges.hinges2", "X.hgraph", "X.hinge.list",
              "--prefix", "M"], ["M.G0_merged.graphml", "M.G1_merged.graphml"]),
            (["condense-gfa", "X.edges.hinges2", "--out-prefix", "CG"],
             ["CG.condensed.graphml", "CG.bandage"]),
            (["bandage", "X.edges.hinges", "X.bandage"], ["X.bandage"]),
            (["single-strand", "X.consensus.fasta", "X.single.fasta"],
             ["X.single.fasta"]),
        ]
        tool_walls = {}
        for argv, outs in tools:
            _run_verb(argv, tool_walls, cuda=False)
            _require_files(wd, outs, argv[0])
        log("[surface] tools: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in tool_walls.items()))

        # split_las, merge_las: the merged records are the original's
        n_parts = 4
        t0 = time.perf_counter()
        shutil.copy(las, "parts.las")
        orig = read_las("parts.las")
        _run_verb(["split_las", "parts.las", "--max-records",
                   str(orig.n // n_parts + 1)], tool_walls, cuda=False)
        parts = sorted((f for f in os.listdir(".") if f.startswith("parts.")
                        and f != "parts.las"), key=lambda f: int(f.split(".")[1]))
        if len(parts) < 2:
            raise AssertionError(f"split_las wrote {parts}")
        _run_verb(["merge_las", "merged.las", *parts], tool_walls, cuda=False)
        check_las_roundtrip(orig, read_las("merged.las"))
        log(f"[surface] split_las -> {len(parts)} parts -> merge_las: "
            f"{orig.n} records equal to reads.las on every column and trace "
            f"value ({time.perf_counter() - t0:.3f}s)")
        del orig
    finally:
        os.chdir(old)

    # assemble(db=) in a second workdir
    asm = os.path.join(base, "asm")
    t0 = time.perf_counter()
    res = assemble(db=db, las=las, workdir=asm, device="cuda",
                   log=lambda *a: None)
    torch.cuda.synchronize()
    asm_wall = time.perf_counter() - t0
    differ = []
    for name in CHAIN_EQUALS_ASSEMBLE:
        with open(os.path.join(wd, name), "rb") as f, \
                open(os.path.join(asm, assemble_name(name)), "rb") as g:
            if f.read() != g.read():
                differ.append(name)
    n_wide = check_byte_traces(wd, asm, rs, res["draft"])
    if set(differ) - set(LAS_ROUNDTRIP_FILES) or (differ and not n_wide):
        raise AssertionError(f"chain files differ from assemble()'s: {differ}")
    log(f"[surface] byte-equal to assemble(db=)'s files: " + ", ".join(
        n for n in CHAIN_EQUALS_ASSEMBLE if n not in differ))
    log(f"[surface] map alignments with trace values > 255: {n_wide}; "
        f"differing from assemble(db=)'s: {differ or 'none'}; the chain's "
        f"consensus equals the consensus of assemble()'s alignments with "
        f"byte traces, assemble()'s that of the same alignments unwrapped, "
        f"and each GFA follows from its consensus")
    cons = read_fasta(os.path.join(wd, "X.consensus.fasta"))
    _check_assembly("surface", {"contigs": [
        (cons.names[i], cons.get_seq(i)) for i in range(cons.n_reads)]})
    _check_assembly("surface assemble", res)
    log(f"[surface] chain wall {chain_wall:.3f}s vs assemble(db=) wall "
        f"{asm_wall:.3f}s; fresh-process draft {fresh_wall:.3f}s")
    return launches


#: the chain's files that pass through draft.las, whose trace values are
#: bytes (tspace <= 125): a map alignment with a trace value > 255 comes
#: back wrapped (value & 0xFF), in hinge_tpu's write_las as in the port's,
#: while assemble() keeps the alignments in memory
LAS_ROUNDTRIP_FILES = ("X.consensus.fasta", "X_consensus.gfa")


def check_byte_traces(wd, asm, rs, draft):
    """The consensus verb's input is assemble()'s map alignments after the
    .las byte traces: the chain's X.consensus.fasta equals run_consensus
    on those alignments with every trace value wrapped to a byte, and
    assemble()'s equals it on the same alignments unwrapped; each
    X_consensus.gfa equals run_gfa on assemble()'s draft graph with its own
    consensus.  Returns the count of trace values > 255."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.data.overlaps import str_to_codes
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.stages.consensus import run_consensus
    from hinge_tpu_torch.stages.gfa import run_gfa

    aln = map_reads_to_targets([str_to_codes(seq) for _, seq in draft], rs)
    n_wide = int((aln.trace > 255).sum())
    byte_aln = aln.take(np.arange(aln.n))
    byte_aln.trace = aln.trace.astype(np.uint8).astype(aln.trace.dtype)
    for tag, a, path in (("chain", byte_aln, os.path.join(wd, "X.consensus.fasta")),
                         ("assemble()", aln, os.path.join(asm, "asm.consensus.fasta"))):
        want = os.path.join(os.path.dirname(path), "check.consensus.fasta")
        run_consensus(draft, rs, a, nominal_config(), out_fasta=want,
                      device="cuda")
        with open(want, "rb") as f, open(path, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{tag} consensus is not that of the map "
                                     "alignments it was given")
        got = os.path.join(os.path.dirname(path), "check.gfa")
        run_gfa(os.path.join(asm, "asm_draft.graphml"),
                os.path.join(asm, "draft_map.txt"), path, out_gfa=got)
        gfa = path.replace(".consensus.fasta", "_consensus.gfa")
        with open(got, "rb") as f, open(gfa, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{tag} GFA does not follow from its consensus")
    return n_wide


def phase_main_block(block, parent):
    """The largest band-NW block of phase 5 (the launch size and the
    window lengths of the main path): kernels vs twins, times, bounds."""
    q, t, m, n, mrows = block
    log(f"[block] phase 5's largest block: {q.shape[0]} windows, m "
        f"{int(m.min())}..{mrows}, moves {q.shape[0] * mrows * BN_BW} bytes")
    return check_block("block", q, t, m, n, mrows, parent, twin_reps=1)


#: phase 9's logical shards on the card
MESH_SHARDS = 4
#: the stage files of filter, maximal and layout (the 12 of
#: tests/test_sharded_stage_parity.py), after phase 5's prefix "asm"
SHARDED_STAGE_FILES = tuple("asm." + s for s in (
    "mas", "cmas", "repeat.txt", "hinges.txt", "cov.flag", "self.flag",
    "coverage.txt", "max", "contained.txt", "edges.hinges", "edges.hinges2",
    "hinge.list"))
#: integer operations K3 needs per live diagonal (k and the lane test, the
#: tie rule's two V reads and compare, x0 and y0, the snake's bounds test,
#: the history and V stores, the end test, u, the best-m and band-edge
#: candidates) and per snake byte compare (two clipped indices, two loads,
#: the compare, the count), counted from csrc/wave_align.cu
WAVE_OPS_PER_DIAGONAL = 30
WAVE_OPS_PER_COMPARE = 6
#: the block on which K3 is held bit-equal to its twin and both are timed
TWIN_BLOCK = 256


def phase_sharded_families():
    """Phase 9a: the eight families over MESH_SHARDS logical shards on the
    card, each equal to the port's single-device op."""
    from hinge_tpu_torch.ops import wavefront as W
    from hinge_tpu_torch.parallel.dryrun import dryrun_multichip

    _zero(W.launches)
    t0 = time.perf_counter()
    checked = dryrun_multichip(MESH_SHARDS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(W.launches)
    log(f"[sharded] dryrun_multichip({MESH_SHARDS}) on cuda: every family "
        f"equal to the single-device op ({checked}); {wall:.3f}s; "
        f"launches {launches}")
    _check_launches("sharded families", launches)
    return wall


def run_sharded_stages(wd, rs, parts, cfg):
    """filter, maximal and layout into `wd` (prefix "asm") with
    HINGE_SHARDED=1 over MESH_SHARDS logical shards of the card.  Returns
    the stage walls, the sharded matching-position queries and the peak
    device memory."""
    from hinge_tpu_torch.parallel.sharding import stage_mesh
    from hinge_tpu_torch.stages import filter as SF
    from hinge_tpu_torch.stages import layout as SL
    from hinge_tpu_torch.stages import maximal as SM

    os.makedirs(wd)
    p = os.path.join(wd, "asm")
    os.environ["HINGE_SHARDED"] = "1"
    os.environ["HINGE_MESH_SHARDS"] = str(MESH_SHARDS)
    try:
        mesh = stage_mesh("cuda")
        if mesh is None or mesh.size != MESH_SHARDS or any(
                d.type != "cuda" for _, d in mesh.local_shards()):
            raise AssertionError(f"HINGE_SHARDED=1 gave no {MESH_SHARDS}-shard "
                                 "mesh on the card")
        walls = {}
        torch.cuda.reset_peak_memory_stats()
        with _Timed(SF, "run_sharded_profiles") as prof, \
                _Timed(SM, "sharded_top_k_per_pair") as topk, \
                _Timed(SL, "run_sharded_matching_position",
                       count=lambda ov_idx, *a, **kw: len(ov_idx)) as mpos:
            t0 = time.perf_counter()
            fres = SF.run_filter(rs, parts, cfg, out_prefix=p, device="cuda")
            torch.cuda.synchronize()
            walls["filter"] = time.perf_counter() - t0
            eff_s = fres.maskvec[:, 0].astype(np.int32)
            eff_e = fres.maskvec[:, 1].astype(np.int32)
            t0 = time.perf_counter()
            mres = SM.run_maximal(rs, parts, cfg, eff_s, eff_e, out_prefix=p,
                                  has_db=True, device="cuda")
            torch.cuda.synchronize()
            walls["maximal"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            SL.run_layout(rs, parts, cfg, eff_s, eff_e, mres.active,
                          SL.load_marked(p + ".repeat.txt"),
                          SL.load_marked(p + ".hinges.txt"), out_prefix=p,
                          filter_prefix=p, has_db=True, device="cuda")
            torch.cuda.synchronize()
            walls["layout"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.environ.pop("HINGE_SHARDED", None)
        os.environ.pop("HINGE_MESH_SHARDS", None)
    calls = {"profiles": prof.calls, "top_k": topk.calls,
             "matching_position": mpos.calls}
    if not (prof.calls and topk.calls):
        raise AssertionError(f"the stages skipped the mesh: {calls}")
    log(f"[sharded] HINGE_SHARDED=1 over {MESH_SHARDS} shards of cuda "
        f"({mesh.shape}): mesh calls {calls}, {mpos.items} sharded "
        f"matching-position queries")
    return walls, mpos.items, peak


def _differing(ref_dir, wd, names):
    out = []
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as f, \
                open(os.path.join(wd, name), "rb") as g:
            if f.read() != g.read():
                out.append(name)
    return out


def phase_sharded_stages(tmp, fasta, las, p5_stages):
    """Phase 9b: filter, maximal and layout with HINGE_SHARDED=1 over
    MESH_SHARDS logical shards of the card; the 12 stage files must be
    byte-equal to phase 5's."""
    from hinge_tpu_torch.config import nominal_config
    from hinge_tpu_torch.io.fasta import read_fasta
    from hinge_tpu_torch.io.las import read_las

    t0 = time.perf_counter()
    rs = read_fasta(fasta)
    parts = [read_las(las, read_lengths=rs.length)]
    read_wall = time.perf_counter() - t0
    wd = os.path.join(tmp, "sharded")
    walls, _, peak = run_sharded_stages(wd, rs, parts, nominal_config())
    # the layout queries matching positions only for hinged reads with
    # matches (none on a genome without repeats); phase 10c has them
    differ = _differing(os.path.join(tmp, "asm"), wd, SHARDED_STAGE_FILES)
    if differ:
        raise AssertionError(f"sharded stage files differ from phase 5's: {differ}")
    log(f"[sharded] {len(SHARDED_STAGE_FILES)} stage files byte-equal to "
        "phase 5's")
    log("[sharded] stage walls (phase 5's beside): " + ", ".join(
        f"{k} {v:.3f}s ({p5_stages.get(k, 0.0):.3f}s)" for k, v in walls.items())
        + f"; input read {read_wall:.3f}s; peak device memory {peak} bytes")
    return walls


def wave_bound(stats, d_fin, m, n):
    """Least time for K3 on one block, from the twin's path on it: the true
    bytes of q and t read once, m/n read and the terminal state written
    once, the history of every live step (an int16 x per live diagonal and
    the two int16 band edges) and the path points up to d_fin written once;
    the integer operations of every live diagonal and every snake byte
    compare."""
    B = int(m.numel())
    nbytes = (int((m.to(torch.int64) + n).sum()) + 8 * B + 13 * B
              + 2 * stats["diagonals"] + 4 * stats["steps"]
              + 16 * int((d_fin.to(torch.int64) + 1).sum()))
    nops = (WAVE_OPS_PER_DIAGONAL * stats["diagonals"]
            + WAVE_OPS_PER_COMPARE * stats["compares"])
    return _bound(nbytes, nops, INT32_OPS_S)


def _wave_block(qs, ts, sel):
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops import wavefront as W

    q, t, m, n, max_d, kb = W.pack_block([qs[i] for i in sel],
                                         [ts[i] for i in sel])
    return [to_device(a, "cuda") for a in (q, t, m, n)], max_d, kb


def _wave_shard_block(qs, ts, shards):
    """Shard 0's block of run_sharded_wave_align over `shards` shards, cut
    as it cuts it: the batch padded with empty windows to a multiple of the
    shard count, packed as one block (one L and one max_d), one contiguous
    slice a shard."""
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops import wavefront as W

    pad = (-len(qs)) % shards
    empty = [np.zeros(0, np.uint8)] * pad
    q, t, m, n, max_d, kb = W.pack_block(list(qs) + empty, list(ts) + empty)
    per = len(m) // shards
    return [to_device(a[:per], "cuda") for a in (q, t, m, n)], max_d, kb


def _k3_equal(who, got, want):
    """The terminal state and px/py up to 2*d_fin+2 of a K3 launch against
    the twin's outputs; returns the max abs error (0) or raises."""
    err = 0
    for name, g, w in zip(("aligned", "d_fin", "k_fin", "x_fin"), got[2:], want[2:]):
        if not torch.equal(g, w):
            raise AssertionError(f"{who} {name} differs from its twin")
        err = max(err, _max_abs_err([g], [w]))
    valid = (torch.arange(want[0].shape[1], device=want[0].device)[None, :]
             < 2 * (want[3][:, None] + 1))
    for name, g, w in zip(("px", "py"), got[:2], want[:2]):
        if not torch.equal(torch.where(valid, g, 0), torch.where(valid, w, 0)):
            raise AssertionError(f"{who} {name} differs from its twin")
        err = max(err, _max_abs_err([g[valid]], [w[valid]]))
    return err


def _k3_twin_check(args, max_d, kb, prev=None):
    """K3 (and the previous K3, when built) against the twin on the same
    CUDA tensors.  Returns (max_abs_err, twin outputs, stats of the twin's
    path)."""
    from hinge_tpu_torch.ops import wavefront as W

    got = W.launch_wave_align(*args, 150, max_d=max_d, kb=kb)
    stats = dict(steps=0, diagonals=0, compares=0)
    fwd = W.wave_forward_ref(*args, 150, max_d=max_d, kb=kb, stats=stats)
    px, py = W.wave_backtrack_ref(*fwd, max_d=max_d)
    want = (px, py, *fwd[3:])
    torch.cuda.synchronize()
    err = _k3_equal("K3", got, want)
    del got
    if prev is not None and prev.ok:
        _k3_equal("previous K3", prev(*args, 150, max_d, kb), want)
    return err, want, stats


def _k3_timed(args, max_d, kb, prev=None):
    """K3 (and the previous K3, when built) held bit-equal to the twin on
    one block of CUDA tensors, then timed in turns (K3, previous, previous,
    K3) and beside the twin: (max_abs_err, K3 ms, previous K3 ms or None,
    twin ms, bound ms, bound_by, the twin's path stats)."""
    from hinge_tpu_torch.ops import wavefront as W

    err, want, stats = _k3_twin_check(args, max_d, kb, prev)
    new = lambda: W.launch_wave_align(*args, 150, max_d=max_d, kb=kb)  # noqa: E731
    if prev is not None and prev.ok:
        old = lambda: prev(*args, 150, max_d, kb)  # noqa: E731
        turns = [_cuda_ms(f, 10) for f in (new, old, old, new)]
        ms, prev_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        log(f"[wave] in turns (K3, previous, previous, K3): "
            + ", ".join(f"{x:.4f}" for x in turns) + " ms")
    else:
        ms, prev_ms = _cuda_ms(new, 10), None

    def twin():
        W.wave_backtrack_ref(*W.wave_forward_ref(*args, 150, max_d=max_d, kb=kb),
                             max_d=max_d)

    plain_ms = _cuda_ms(twin, 1)
    b_ms, b_by = wave_bound(stats, want[3], args[2], args[3])
    return err, ms, prev_ms, plain_ms, b_ms, b_by, stats


def phase_wave_kernel(qs, ts, prev):
    """Phase 9c: every ladder window of phase 5's draft through the sharded
    window aligner (run_sharded_wave_align over MESH_SHARDS shards of the
    card, one K3 launch a shard), rows equal to the C DW_banded rows; K3
    and the previous K3 bit-equal to the twin on shard 0's block and on a
    256-window block, and timed in turns and beside the twin on both, with
    the bound, the share and the launches."""
    from hinge_tpu_torch.ops import myers as MY
    from hinge_tpu_torch.ops import wavefront as W
    from hinge_tpu_torch.parallel.sharding import make_mesh, run_sharded_wave_align

    mesh = make_mesh(MESH_SHARDS, device="cuda")
    _zero(W.launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = run_sharded_wave_align(mesh, qs, ts)
    torch.cuda.synchronize()
    k3_wall = time.perf_counter() - t0
    launches = dict(W.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    c_rows = MY.align_exact_batch(qs, ts, 150)
    c_wall = time.perf_counter() - t0
    bad = [i for i, (g, w) in enumerate(zip(rows, c_rows))
           if not (np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]))]
    if bad:
        raise AssertionError(f"K3 rows differ from the C DW_banded rows on "
                             f"{len(bad)} windows, first {bad[:5]}")
    n_aligned = sum(1 for r in rows if len(r[0]))
    log(f"[wave] K3 rows equal to the C DW_banded rows on all {len(qs)} "
        f"ladder windows ({n_aligned} aligned); run_sharded_wave_align over "
        f"{MESH_SHARDS} shards of cuda {k3_wall:.3f}s (with host packing and "
        f"row emission) vs C {c_wall:.3f}s; launches {launches}; peak device "
        f"memory {peak} bytes")
    if launches["wave_align"] != MESH_SHARDS:
        raise AssertionError(f"wave: {launches['wave_align']} K3 launches, "
                             f"want one for each of {MESH_SHARDS} shards")

    # the main path's launch: shard 0's block
    args, max_d, kb = _wave_shard_block(qs, ts, MESH_SHARDS)
    B, L = args[0].shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes = W.k3_lanes(B, sms)
    err, ms, prev_ms, plain_ms, b_ms, b_by, stats = _k3_timed(args, max_d, kb, prev)
    log(f"[wave] K3 on shard 0's block ({B} windows, max_d {max_d}, L {L}, "
        f"{lanes} lanes a window): "
        f"bit-equal to its twin; {ms:.4f} ms per launch, previous K3 "
        f"{_ms_or_none(prev_ms)}, twin {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); "
        f"bound {b_ms:.4f} ms by {b_by}, share {b_ms / ms:.4f} (previous "
        f"{_share_or_none(b_ms, prev_ms)}); twin path {stats}")
    del args

    # the twin beside K3 on the 256 longest windows
    lens = np.array([len(q) + len(t) for q, t in zip(qs, ts)])
    order = np.argsort(lens, kind="stable")
    args, max_d, kb = _wave_block(qs, ts, order[-TWIN_BLOCK:])
    e2, t_ms, t_prev, t_plain, b2_ms, b2_by, _ = _k3_timed(args, max_d, kb, prev)
    err = max(err, e2)
    t_lanes = W.k3_lanes(TWIN_BLOCK, sms)
    log(f"[wave] {TWIN_BLOCK}-window block ({t_lanes} lanes a window): K3 "
        f"bit-equal to its twin; K3 "
        f"{t_ms:.4f} ms, previous K3 {_ms_or_none(t_prev)}, twin "
        f"{t_plain:.4f} ms ({t_plain / t_ms:.1f}x); bound {b2_ms:.4f} ms by "
        f"{b2_by}, share {b2_ms / t_ms:.4f}")
    del args
    if "--k3-sweep" in sys.argv:
        wave_sweep(qs, ts, prev)
    return {"launches": launches["wave_align"], "max_abs_err": err, "ms": ms,
            "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share": b_ms / ms, "windows_per_launch": B,
            "lanes": lanes, "peak_bytes": peak,
            "twin_block": {"windows": TWIN_BLOCK, "lanes": t_lanes,
                           "ms": t_ms, "prev_ms": t_prev,
                           "plain_ms": t_plain, "bound_ms": b2_ms,
                           "bound_by": b2_by, "share": b2_ms / t_ms}}


def _ms_or_none(ms):
    return "not timed" if ms is None else f"{ms:.4f} ms"


def _share_or_none(b_ms, ms):
    return "not timed" if ms is None else f"{b_ms / ms:.4f}"


def wave_sweep(qs, ts, prev):
    """K3 at every group width it is built for, and the previous K3, on
    seeded samples of the ladder windows from 256 to 32,768 a launch, each
    launch's outputs equal to those of the width `k3_lanes` picks: what
    wavefront.K3_WIDTHS's crossovers and WAVE_BATCH were chosen by
    (`--k3-sweep` only)."""
    from hinge_tpu_torch.ops import wavefront as W

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(3)
    for count in (256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 11129, 16384, 32768):
        sel = rng.permutation(len(qs))[: min(count, len(qs))]
        args, max_d, kb = _wave_block(qs, ts, sel)
        B = len(sel)
        pick = W.k3_lanes(B, sms)
        want = W.launch_wave_align(*args, 150, max_d=max_d, kb=kb)
        times = {}
        for lanes, _ in W.K3_WIDTHS:
            run = lambda: W.launch_k3_at(*args, 150, max_d=max_d, kb=kb, lanes=lanes)  # noqa: E731
            _k3_equal(f"K3 at {lanes} lanes", run(), want)
            times[lanes] = _cuda_ms(run, 10)
        prev_ms = None
        if prev is not None and prev.ok:
            _k3_equal("previous K3", prev(*args, 150, max_d, kb), want)
            prev_ms = _cuda_ms(lambda: prev(*args, 150, max_d, kb), 10)
        log(f"[wave] sweep {B} windows a launch ({B / sms:.1f} an SM, max_d "
            f"{max_d}): K3 at " + ", ".join(f"{g} lanes {ms:.4f}" for g, ms in times.items())
            + f" ms; picks {pick} lanes ({times[pick] * 1024 / B:.4f} ms per 1024 "
            f"windows); previous K3 {_ms_or_none(prev_ms)}")
        del args, want


def phase_nccl():
    """Phase 9d: the sharded filter step across processes on NCCL, one
    rank per card with 2 logical shards each; the all-gathered masks must
    equal the single-device masks."""
    from hinge_tpu_torch.parallel.dryrun import (
        run_multiprocess, single_device_masks, worker_inputs,
    )

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    masks, lines = run_multiprocess(world, "cuda")
    wall = time.perf_counter() - t0
    if not all("backend=nccl" in line for line in lines):
        raise AssertionError(f"the ranks did not run on NCCL: {lines}")
    a_id, a_start, a_end, read_len, nb = worker_inputs()
    want = single_device_masks("cuda", a_id, a_start, a_end, len(read_len), nb)
    if not all(np.array_equal(m, want) for m in masks):
        raise AssertionError("NCCL masks differ from the single-device masks")
    log(f"[nccl] world {world} (one rank per card, 2 logical shards each): "
        f"masks equal to the single-device masks on every rank; "
        + "; ".join(lines) + f"; {wall:.3f}s with process start-up")
    return wall


def phase_sharded(tmp, fasta, las, p5_stages, windows, prev):
    """Phase 9: the mesh path on the card (9a-9d)."""
    t0 = time.perf_counter()
    walls = {"families": phase_sharded_families()}
    t1 = time.perf_counter()
    phase_sharded_stages(tmp, fasta, las, p5_stages)
    walls["stages"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    k3 = phase_wave_kernel(*windows, prev)
    walls["wave"] = time.perf_counter() - t1
    walls["nccl"] = phase_nccl()
    log(f"[sharded] phase 9 wall {time.perf_counter() - t0:.3f}s: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in walls.items()))
    return k3


def phase_golden_repeats():
    """Phase 10a: case (a)'s filter -> draft-path files (a 25 kb repeat
    longer than every read) on cuda, byte-equal to tests/golden_repeats/."""
    from hinge_tpu_torch.ops import classify as CL
    from tests import torch_golden_repeats as GR

    with tempfile.TemporaryDirectory() as tmp, \
            _Timed(CL, "matching_position",
                   count=lambda ov_idx, *a, **kw: ov_idx.numel()) as mpos:
        t0 = time.perf_counter()
        GR.build(tmp, device="cuda")
        bad = GR.mismatches(tmp)
    if bad:
        raise AssertionError(f"golden repeat files differ on cuda: {bad}")
    log(f"[repeats] {len(GR.GOLDEN_FILES)}/{len(GR.GOLDEN_FILES)} golden "
        f"repeat files byte-equal on cuda ({time.perf_counter() - t0:.3f}s); "
        f"{mpos.items} matching-position queries")


class _HingeTasks:
    """Keeps the inputs of the filter's largest hinge-calling launch
    (ops/hinge_call._hinge_kernel) as host arrays, for phase 10c."""

    def __init__(self, module):
        self.module, self.fn = module, module._hinge_kernel
        self.args = None

    def __enter__(self):
        def spy(*a, **kw):
            if self.args is None or a[0].numel() > len(self.args[0][0]):
                self.args = ([x.cpu().numpy() for x in a[:10]],
                             {k: kw[k] for k in ("theta", "htl", "hbl", "hrut", "hbpt")})
            return self.fn(*a, **kw)

        self.module._hinge_kernel = spy
        return self

    def __exit__(self, *exc):
        self.module._hinge_kernel = self.fn


def rerun_tail(wd, fasta, las, cfg):
    """draft -> correct-head -> map -> consensus -> gfa again on the
    workdir of assemble() (prefix "asm"), as assemble() runs them, from
    its .max and .edges.list.  Returns the reads and overlaps it read."""
    from hinge_tpu_torch.cli import _read_max
    from hinge_tpu_torch.data.overlaps import str_to_codes
    from hinge_tpu_torch.io.fasta import correct_head, read_fasta
    from hinge_tpu_torch.io.las import read_las
    from hinge_tpu_torch.overlap.mapper import map_reads_to_targets
    from hinge_tpu_torch.stages.consensus import run_consensus
    from hinge_tpu_torch.stages.draft import run_draft
    from hinge_tpu_torch.stages.gfa import run_gfa
    from hinge_tpu_torch.utils.log import stage_timer

    p = os.path.join(wd, "asm")
    rs = read_fasta(fasta)
    parts = [read_las(las, read_lengths=rs.length)]
    with stage_timer("draft"):
        contigs = run_draft(rs, parts, cfg, _read_max(p + ".max", rs.n_reads),
                            p + ".edges.list", out_fasta=p + ".draft.fasta",
                            device="cuda")
    correct_head(p + ".draft.fasta", p + ".draft.pb.fasta",
                 os.path.join(wd, "draft_map.txt"))
    with stage_timer("map"):
        aln = map_reads_to_targets([str_to_codes(s) for _, s in contigs], rs)
    with stage_timer("consensus"):
        run_consensus(contigs, rs, aln, cfg, out_fasta=p + ".consensus.fasta",
                      device="cuda")
    with stage_timer("gfa"):
        run_gfa(p + "_draft.graphml", os.path.join(wd, "draft_map.txt"),
                p + ".consensus.fasta", out_gfa=p + "_consensus.gfa")
    return rs, parts


def _stage_line(stages):
    return ", ".join(f"{k} {v:.3f}s" for k, v in stages.items())


def phase_yeast(tmp, parent):
    """Phase 10b: the yeast W303-scale workload (tests/torch_golden_repeats.py)
    through assemble() on cuda with the demo ini, held to hinge_tpu's
    manifest: the inputs' sha256, every file written before the draft
    stage under the default switches, then draft -> gfa again under
    HINGE_PARITY_ALIGN=1 (the C DW_banded path, as the manifest was made).
    The largest band-NW block of its draft is held to the twins
    (check_block)."""
    from hinge_tpu_torch.config import Config
    from hinge_tpu_torch.data.simulator import SimParams, simulate
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.ops import classify as CL
    from hinge_tpu_torch.ops import hinge_call as HC
    from hinge_tpu_torch.pipeline import assemble
    from hinge_tpu_torch.utils.log import timings
    from tests import torch_golden_repeats as GR

    with open(GR.MANIFEST) as f:
        man = json.load(f)
    p = GR.yeast_params(SimParams)
    if GR.params_record(p) != man["params"]:
        raise AssertionError("the inputs differ from the manifest's: the "
                             "workload's parameters are not the manifest's")
    base = os.path.join(tmp, "yeast")
    os.makedirs(base)
    t0 = time.perf_counter()
    genome, _, rs, ov = simulate(p)
    sim_wall = time.perf_counter() - t0
    fasta, las = os.path.join(base, "reads.fasta"), os.path.join(base, "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    n_reads, n_records = rs.n_reads, ov.n
    del rs, ov
    bad = GR.manifest_mismatches(base, man["inputs"], man["inputs"])
    if bad:
        raise AssertionError(f"the inputs differ from the manifest's ({bad}): "
                             "the simulator or the writers, not the port's stages")
    log(f"[yeast] host set-up: simulated {n_reads} reads, {n_records} records "
        f"of a {len(genome)} bp genome in {sim_wall:.3f}s "
        f"({os.cpu_count()} processes), wrote them in "
        f"{time.perf_counter() - t0 - sim_wall:.3f}s; FASTA and .las sha256 "
        "equal to the manifest's")
    ini = os.path.join(base, "yeast.ini")
    with open(ini, "w") as f:
        f.write(GR.YEAST_DEMO_INI)

    wd = os.path.join(base, "asm")
    _zero(BN.launches)
    before = timings()
    torch.cuda.reset_peak_memory_stats()
    with _BlockSpy(BN) as spy, _HingeTasks(HC) as tasks, \
            _Timed(CL, "matching_position",
                   count=lambda ov_idx, *a, **kw: ov_idx.numel()) as mpos:
        t0 = time.perf_counter()
        with GR.etree_graphml():
            res = assemble(fasta=fasta, las=las, config=ini, workdir=wd,
                           device="cuda", log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(BN.launches)
    peak = torch.cuda.max_memory_allocated()
    stages = _stage_diff(before)
    G = res["graphs"].get("G3", res["graphs"]["G2"])
    hinged = GR.hinged_edges(G)
    lengths = sorted((len(s) for _, s in res["contigs"]), reverse=True)
    t0 = time.perf_counter()
    cov = GR.coverage_fractions(genome, res["contigs"], p)
    cov_wall = time.perf_counter() - t0
    log(f"[yeast] assemble wall {wall:.3f}s; stages {_stage_line(stages)}")
    log(f"[yeast] peak device memory {peak} bytes; kernel launches {launches}; "
        f"{spy.windows} band-NW windows; {mpos.items} matching-position "
        f"queries in {mpos.calls} calls on {sorted(mpos.devices)}; "
        f"{len(G.edges)} edges in {'G3' if 'G3' in res['graphs'] else 'G2'}, "
        f"{hinged} hinged (hinge_tpu {man['hinged_edges']}); {len(lengths)} "
        f"contigs, longest {lengths[0] if lengths else 0} (hinge_tpu "
        f"{man['contigs']}, {man['longest']} under HINGE_PARITY_ALIGN=1)")
    log("[yeast] probes found per chromosome: "
        + " ".join(f"{c:.3f}" for c in cov) + f" ({cov_wall:.3f}s)")
    if spy.block is None:
        raise AssertionError("yeast: the draft stage sent no block to band_fill")
    q, t, m, n, mrows = spy.block
    spy.block = None
    log(f"[yeast] the draft's largest band-NW block: {q.shape[0]} windows, m "
        f"{int(m.min())}..{mrows}, moves {q.shape[0] * mrows * BN_BW} bytes")
    block_errs, block = check_block("yeast", q, t, m, n, mrows, parent,
                                    twin_reps=1)
    del q, t, m, n

    names = GR.workdir_files(wd)
    want = man["files"]
    pre = [n for n in want if n not in GR.POST_DRAFT]
    bad = GR.manifest_mismatches(wd, want, pre)
    extra = sorted(set(names) - set(man["files"]))
    log(f"[yeast] files written before the draft stage: "
        f"{len(pre) - len(bad)}/{len(pre)} equal to the manifest's"
        + (f"; differ: {bad}" if bad else "") + (f"; not in it: {extra}" if extra else ""))

    # draft -> gfa again with the C DW_banded aligner, as the manifest was made
    before = timings()
    os.environ["HINGE_PARITY_ALIGN"] = "1"
    try:
        t0 = time.perf_counter()
        rs, parts = rerun_tail(wd, fasta, las, Config.from_ini(ini))
        tail_wall = time.perf_counter() - t0
    finally:
        os.environ.pop("HINGE_PARITY_ALIGN", None)
    tail = _stage_diff(before)
    bad_tail = GR.manifest_mismatches(wd, want, GR.POST_DRAFT)
    log(f"[yeast] HINGE_PARITY_ALIGN=1 draft -> gfa again: {tail_wall:.3f}s "
        f"(stages {_stage_line(tail)}); {len(GR.POST_DRAFT) - len(bad_tail)}/"
        f"{len(GR.POST_DRAFT)} files equal to the manifest's"
        + (f"; differ: {bad_tail}" if bad_tail else ""))

    fails = []
    if bad or extra or bad_tail:
        fails.append(f"files differ from hinge_tpu's manifest: {bad + bad_tail}"
                     + (f", not in it: {extra}" if extra else ""))
    if hinged < 1:
        fails.append("the final graph has no hinged edge")
    if not mpos.items or mpos.devices != {"cuda"}:
        fails.append(f"matching_position: {mpos.items} queries on {mpos.devices}")
    if min(cov) < 0.9:
        fails.append(f"a chromosome's probes found below 0.9: {min(cov):.3f}")
    if fails:
        raise AssertionError("yeast: " + "; ".join(fails))
    _check_launches("yeast", launches)
    log(f"[yeast] all {len(want)} files byte-equal to hinge_tpu's manifest "
        "on cuda (graphml by networkx's ElementTree serializer on both sides)")
    return {"wd": wd, "rs": rs, "parts": parts, "cfg": Config.from_ini(ini),
            "stages": stages, "tasks": tasks.args, "launches": launches,
            "windows": spy.windows, "block_errs": block_errs, "block": block}


def phase_yeast_sharded(tmp, yeast):
    """Phase 10c: filter, maximal and layout on 10b's reads and overlaps
    with HINGE_SHARDED=1 over MESH_SHARDS logical shards: every file
    byte-equal to 10b's, the layout's matching-position queries through
    the mesh; and the sharded hinge call on the filter's hinge tasks equal
    to the single-device op."""
    from hinge_tpu_torch.device import to_device
    from hinge_tpu_torch.ops.hinge_call import _hinge_kernel
    from hinge_tpu_torch.parallel.sharding import make_mesh, run_sharded_hinge_call

    wd = os.path.join(tmp, "yeast_sharded")
    walls, queries, peak = run_sharded_stages(
        wd, yeast["rs"], yeast["parts"], yeast["cfg"])
    names = sorted(os.listdir(wd))
    differ = _differing(yeast["wd"], wd, names)
    if differ or "asm.hgraph" not in names:
        raise AssertionError(f"sharded yeast files differ from 10b's: {differ} "
                             f"(of {names})")
    if queries == 0:
        raise AssertionError("no matching-position query reached the mesh")
    log(f"[yeast] HINGE_SHARDED=1: {len(names)} filter/maximal/layout files "
        f"byte-equal to 10b's; {queries} sharded matching-position queries")
    log("[yeast] sharded stage walls (10b's beside): " + ", ".join(
        f"{k} {v:.3f}s ({yeast['stages'].get(k, 0.0):.3f}s)"
        for k, v in walls.items()) + f"; peak device memory {peak} bytes")

    if yeast["tasks"] is None:
        raise AssertionError("the yeast filter called no hinges")
    arrays, kw = yeast["tasks"]
    mesh = make_mesh(MESH_SHARDS, device="cuda")
    got = run_sharded_hinge_call(*arrays, mesh, **kw)
    want = [x.cpu().numpy() for x in _hinge_kernel(
        *(to_device(x, "cuda") for x in arrays), **kw)]
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("sharded hinge call differs from the single-device op")
    log(f"[yeast] run_sharded_hinge_call over {MESH_SHARDS} shards on the "
        f"filter's {len(arrays[0])} hinge tasks ({int(want[0].sum())} "
        "bridged): equal to the single-device op")
    return walls


def phase_repeats(tmp, parent):
    """Phase 10: the repeat path (10a-10c)."""
    t0 = time.perf_counter()
    phase_golden_repeats()
    yeast = phase_yeast(tmp, parent)
    phase_yeast_sharded(tmp, yeast)
    log(f"[repeats] phase 10 wall {time.perf_counter() - t0:.3f}s")
    return yeast


def phase_measurement(tmp, rs, las):
    """Phase 11: the measurement entry points of hinge_tpu_torch.bench on
    the card (11a-11c); each result on a JSON line of its own."""
    from hinge_tpu_torch.bench import bench as B
    from hinge_tpu_torch.bench import bench_draft_ab as AB
    from hinge_tpu_torch.bench import bench_window_dp as W
    from hinge_tpu_torch.device import to_device

    t0 = time.perf_counter()
    a_id, a_start, a_end, _ = B.synth()
    hg = B.synth_hinge()
    got, want = ([x.cpu() for x in B.step(
        *(to_device(x, dev) for x in (a_id, a_start, a_end)),
        {k: to_device(v, dev) for k, v in hg.items()})]
        for dev in ("cuda", "cpu"))
    err = _max_abs_err(got, want)
    if err:
        raise AssertionError(f"bench's chain on cuda differs from the CPU's "
                             f"(max abs err {err})")
    primary, _ = B.headline("cuda")
    if not primary["value"] > 0 or not 0 < primary["sol_frac"] < 1:
        raise AssertionError(f"bench headline out of range: {primary}")
    print(json.dumps({"bench": primary}), flush=True)
    print(json.dumps({"scaling": B._scaling("cuda")}), flush=True)
    t1 = time.perf_counter()
    qs, ts = W.windows(2048)
    print(json.dumps({"window_dp": W.run(qs, ts, device="cuda")}), flush=True)
    t2 = time.perf_counter()
    wd = os.path.join(tmp, "draft_ab")
    AB.prepare(wd, GENOME_LEN, COVERAGE, device="cuda", rs=rs, las=las)
    arms = AB.compare(wd, device="cuda")
    print(json.dumps({"draft_ab": arms}), flush=True)
    log(f"[measure] phase 11 wall {time.perf_counter() - t0:.3f}s: bench "
        f"{t1 - t0:.3f}s, window DP {t2 - t1:.3f}s, draft A/B "
        f"{time.perf_counter() - t2:.3f}s; bench's chain on cuda equal to "
        f"the CPU's (max abs err 0)")


def main():
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        parent = ParentKernels(tmp)
        prev_k3 = PrevK3(tmp)
        errs, p3 = phase_kernels(parent)
        phase_golden()
        (launches, per_launch, block, rs, ov, fasta, p5_stages,
         windows) = phase_real_size(tmp)
        block_errs, main = phase_main_block(block, parent)
        del block
        ops, k4 = phase_device_join(rs, tmp)
        ops += phase_trim(rs, ov)
        del ov
        fasta_launches, vote_ops = phase_fasta_only(tmp, fasta)
        ops += vote_ops
        las = os.path.join(tmp, "reads.las")
        surface_launches = phase_hinge_surface(tmp, rs, las)
        k3 = phase_sharded(tmp, fasta, las, p5_stages, windows, prev_k3)
        del windows
        p10 = phase_repeats(tmp, parent)
        phase_measurement(tmp, rs, las)
        del rs
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": launches[name], "windows_per_launch": per_launch,
         "max_abs_err": max(errs[name], block_errs[name],
                            p10["block_errs"][name]),
         **main[name], "library_ms": None,
         "phase3": {k: p3[name][k] for k in ("ms", "prev_ms", "plain_ms",
                                              "bound_ms", "bound_by", "share")},
         "phase10": {"launches": p10["launches"][name], "windows_per_launch":
                     p10["windows"] / max(p10["launches"][name], 1),
                     "max_abs_err": p10["block_errs"][name],
                     **{k: p10["block"][name][k] for k in (
                         "ms", "prev_ms", "plain_ms", "bound_ms", "bound_by",
                         "share")}}}
        for name in BAND_NW
    ]
    kernels.append({"name": "wave_align", "route": "cuda",
                    "source": KERNELS["wave_align"][0],
                    "replaces": KERNELS["wave_align"][1], **k3,
                    "library_ms": None})
    kernels.append({"name": "thin_rows", "route": "cuda",
                    "source": KERNELS["thin_rows"][0],
                    "replaces": KERNELS["thin_rows"][1],
                    "launches": fasta_launches["thin_rows"], **k4,
                    "library_ms": None})
    log(f"[fasta] kernel launches of the fasta-only path: "
        f"{ {k: fasta_launches[k] for k in (*BAND_NW, 'thin_rows')} }")
    log(f"[surface] kernel launches of the draft verb: "
        f"{ {k: surface_launches[k] for k in BAND_NW} }")
    print(json.dumps({"device_ops": ops}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
