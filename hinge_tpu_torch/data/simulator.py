"""Copied from hinge_tpu/data/simulator.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, but for exact_overlaps' candidate search, which runs in
forked processes (the same records in the same order).

Synthetic read / overlap generator.

The reference's test harness shells out to DAZZ_DB's ``simulator`` binary to
fabricate a read database (`utils/test.sh:14-27`) and runs DALIGNER to get
overlaps.  Neither tool is assumed here: this module samples reads from a
synthetic (optionally repetitive, circular) genome and derives the *exact*
overlap records — match coordinates, strandedness, and DALIGNER-style trace
points — from the known read placements.  That gives fast, deterministic
end-to-end pipelines for tests and benchmarks without an external overlapper.

Trace-point convention replicated from DALIGNER (`align.h:88-125`,
`LOverlap::trim_overlap`, LAInterface.cpp:4577-4596): one (diffs, b-disp)
pair per A-segment between consecutive multiples of ``tspace`` covering
[abpos, aepos); the walk on the B side starts at the B match start (forward
strand for same-strand matches, B match *end* for reverse-complement ones)
and advances by ``±b-disp`` per segment.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from hinge_tpu_torch.data.overlaps import INT, OverlapStore, ReadStore


@dataclasses.dataclass
class SimParams:
    genome_len: int = 100_000
    circular: bool = True
    coverage: float = 30.0
    mean_read_len: int = 8000
    std_read_len: int = 2500
    min_read_len: int = 500
    sub_rate: float = 0.0
    ins_rate: float = 0.0
    del_rate: float = 0.0
    chimera_rate: float = 0.0  # fraction of reads that are chimeric joins
    # repeat structure: list of (src_start, dst_start, length) copies
    repeats: Tuple[Tuple[int, int, int], ...] = ()
    tspace: int = 100
    min_overlap: int = 500  # do not emit overlaps shorter than this
    qv_good: int = 15  # simulated intrinsic QV for good segments (< 40)
    qv_bad: int = 45  # simulated QV for bad segments (>= 40)
    bad_end_len: int = 0  # bases of bad-QV garbage at read ends
    seed: int = 0
    # Multi-chromosome mode (the yeast_W303 workload shape,
    # demo/yeast_W303_demo): >=1 LINEAR chromosomes laid out consecutively in
    # one coordinate space; reads never cross a chromosome boundary.  When
    # set, genome_len/circular are derived (sum of lengths, linear).
    chromosomes: Tuple[int, ...] = ()
    # identical telomeric block at both ends of every chromosome (all 2C
    # blocks are copies of each other, like the genome-wide TG repeat);
    # reads piling up across all ends is exactly what del_telomere=1 flags
    telomere_len: int = 0
    # tandem unit inside the telomeric block: enables intra-read
    # self-alignments at shifts k*unit (filter.cpp:537-561 self.flag)
    telomere_unit: int = 0
    # deterministic extra reads appended after random sampling:
    # (genome_start, length, strand) — e.g. guaranteed telomere-spanning
    # long reads for the yeast workload
    extra_reads: Tuple[Tuple[int, int, int], ...] = ()
    # DALIGNER-statistics noise mode ("daligner"): per-segment diff counts
    # drawn Binomial(segment_len, noise_diff_rate) into the trace's even
    # slots (real .las traces carry them; align.h:88-95), record diffs =
    # their sum, and a chain_split_rate fraction of overlaps emitted as a
    # same-(A,B) CHAIN of two records separated by a one-segment gap on
    # both reads — the local-alignment breaks real DALIGNER output contains
    # (LAInterface.cpp chains same-pair records).  Combine with tspace>125
    # to exercise the uint16 trace encoding end-to-end.
    noise_profile: str = ""
    noise_diff_rate: float = 0.12
    chain_split_rate: float = 0.08
    # cap on CROSS-end telomere match length (0 = uncapped).  Real telomeric
    # repeats are short/diverged relative to aln_threshold, so cross-
    # chromosome matches fragment below the layout length filter — which is
    # exactly what keeps chromosomes from fusing through their telomeres;
    # same-end pileups and intra-read tandem self-matches stay full length.
    telomere_cross_cap: int = 0


@dataclasses.dataclass
class SimRead:
    start: int  # genome start (on forward strand)
    end: int  # genome end (exclusive)
    strand: int  # 0 fwd, 1 rev-comp
    codes: np.ndarray  # uint8 read bases (0..3), read orientation
    gmap: np.ndarray  # int64 [len]: genome pos of each read base (monotone
    #   increasing along the *forward-strand* layout of the read)
    chimeric: bool = False


def chrom_offsets(p: SimParams) -> List[Tuple[int, int]]:
    """Per-chromosome (offset, length) in the concatenated coordinate space."""
    out = []
    off = 0
    for L in p.chromosomes:
        out.append((off, L))
        off += L
    return out


def telomere_regions(p: SimParams) -> List[Tuple[int, int]]:
    """All (start, length) telomeric blocks — two per chromosome."""
    if not p.chromosomes or p.telomere_len <= 0:
        return []
    T = p.telomere_len
    regs = []
    for off, L in chrom_offsets(p):
        regs.append((off, T))
        regs.append((off + L - T, T))
    return regs


def make_genome(p: SimParams, rng: np.random.Generator) -> np.ndarray:
    g = rng.integers(0, 4, size=p.genome_len, dtype=np.uint8)
    regs = telomere_regions(p)
    if regs:
        T = p.telomere_len
        if p.telomere_unit > 0:
            unit = rng.integers(0, 4, size=p.telomere_unit, dtype=np.uint8)
            block = np.tile(unit, T // p.telomere_unit + 1)[:T]
        else:
            block = rng.integers(0, 4, size=T, dtype=np.uint8)
        for start, length in regs:
            g[start : start + length] = block[:length]
    for src, dst, length in p.repeats:
        g[dst : dst + length] = g[src : src + length]
    return g


def _apply_errors(
    seg: np.ndarray, gpos: np.ndarray, p: SimParams, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply sub/ins/del errors to a forward-strand genome segment.

    Returns (read codes, genome-position map), both forward-strand oriented.
    Inserted bases map to the genome position of the next template base.
    """
    if p.sub_rate == 0 and p.ins_rate == 0 and p.del_rate == 0:
        return seg.copy(), gpos.copy()
    n = len(seg)
    u = rng.random(n)
    keep = u >= p.del_rate
    seg = seg[keep]
    gpos = gpos[keep]
    n = len(seg)
    sub_mask = rng.random(n) < p.sub_rate
    if sub_mask.any():
        seg = seg.copy()
        seg[sub_mask] = (seg[sub_mask] + rng.integers(1, 4, size=int(sub_mask.sum()))) % 4
    ins_mask = rng.random(n) < p.ins_rate
    if ins_mask.any():
        out_codes: List[np.ndarray] = []
        out_gpos: List[np.ndarray] = []
        idxs = np.nonzero(ins_mask)[0]
        prev = 0
        for i in idxs:
            out_codes.append(seg[prev : i + 1])
            out_gpos.append(gpos[prev : i + 1])
            out_codes.append(rng.integers(0, 4, size=1, dtype=np.uint8))
            nxt = gpos[i + 1] if i + 1 < n else gpos[i] + 1
            out_gpos.append(np.array([nxt], dtype=gpos.dtype))
            prev = i + 1
        out_codes.append(seg[prev:])
        out_gpos.append(gpos[prev:])
        seg = np.concatenate(out_codes)
        gpos = np.concatenate(out_gpos)
    return seg, gpos


def _sample_linear_span(p: SimParams, rng: np.random.Generator, length: int):
    """(global start, clamped length) for a span inside ONE chromosome
    (multi-chromosome mode) or the single linear genome."""
    if p.chromosomes:
        offs = chrom_offsets(p)
        # chromosome picked proportional to its length
        lens = np.array([L for _, L in offs], dtype=np.float64)
        ci = int(rng.choice(len(offs), p=lens / lens.sum()))
        off, L = offs[ci]
        if length >= L:
            length = L - 1
        return off + int(rng.integers(0, L - length)), length
    if length >= p.genome_len:
        length = p.genome_len - 1
    return int(rng.integers(0, p.genome_len - length)), length


def sample_reads(p: SimParams, rng: np.random.Generator, genome: np.ndarray) -> List[SimRead]:
    n_bases_target = int(p.coverage * p.genome_len)
    reads: List[SimRead] = []
    total = 0
    g2 = np.concatenate([genome, genome]) if p.circular else genome
    while total < n_bases_target:
        length = int(np.clip(rng.normal(p.mean_read_len, p.std_read_len), p.min_read_len, None))
        chim = rng.random() < p.chimera_rate
        if p.circular:
            start = int(rng.integers(0, p.genome_len))
        else:
            start, length = _sample_linear_span(p, rng, length)
        strand = int(rng.integers(0, 2))
        if chim:
            # two unrelated segments joined; gmap still recorded per-half
            l1 = length // 2
            if p.circular:
                s2 = int(rng.integers(0, p.genome_len))
            else:
                s2, _ = _sample_linear_span(p, rng, length - l1)
            seg1 = g2[start : start + l1].astype(np.uint8)
            gp1 = (np.arange(start, start + l1) % p.genome_len).astype(np.int64)
            seg2 = g2[s2 : s2 + (length - l1)].astype(np.uint8)
            gp2 = (np.arange(s2, s2 + (length - l1)) % p.genome_len).astype(np.int64)
            seg = np.concatenate([seg1, seg2])
            gpos = np.concatenate([gp1, gp2])
        else:
            seg = g2[start : start + length].astype(np.uint8)
            gpos = (np.arange(start, start + length) % p.genome_len).astype(np.int64)
        seg, gpos = _apply_errors(seg, gpos, p, rng)
        codes = seg if strand == 0 else (3 - seg[::-1]).astype(np.uint8)
        reads.append(
            SimRead(
                start=start,
                end=start + length,
                strand=strand,
                codes=codes,
                gmap=gpos,  # forward-strand layout
                chimeric=chim,
            )
        )
        total += len(codes)
    for start, length, strand in p.extra_reads:
        seg = g2[start : start + length].astype(np.uint8)
        gpos = (np.arange(start, start + length) % p.genome_len).astype(np.int64)
        seg, gpos = _apply_errors(seg, gpos, p, rng)
        codes = seg if strand == 0 else (3 - seg[::-1]).astype(np.uint8)
        reads.append(
            SimRead(start=start, end=start + length, strand=strand,
                    codes=codes, gmap=gpos)
        )
    return reads


def _segments(r: SimRead) -> List[Tuple[int, int]]:
    """Split the forward-layout gmap into monotone pieces.

    gmap is non-decreasing inside a true genomic segment; it jumps at chimeric
    junctions and circular wrap points.  Returns [(roff0, roff1)] slices."""
    gm = r.gmap
    if len(gm) == 0:
        return []
    dif = np.diff(gm.astype(np.int64))
    # a genuine segment advances by >= 0 per base (insertions repeat the next
    # template position); splits are strictly negative jumps
    cuts = np.nonzero(dif < 0)[0] + 1
    bounds = [0] + cuts.tolist() + [len(gm)]
    return [(bounds[k], bounds[k + 1]) for k in range(len(bounds) - 1)]


def exact_overlaps(
    reads: List[SimRead], p: SimParams, symmetric: bool = True
) -> OverlapStore:
    """Compute exact overlap records (both (i,j) and (j,i) like DALIGNER).

    Matches come from two sources, mirroring what a real overlapper reports:
    true genomic co-location (shift 0), and repeat-copy homology — for every
    repeat (src, dst, L) a match window [src, src+L) with B shifted by
    src-dst (and the symmetric counterpart).  Repeat matches are clamped to
    the copy, like a local aligner would end at the homology boundary.

    The candidate pairs are found and their records made in work units of
    UNIT_SEGMENTS A segments, one forked process a core when there is more
    than one unit (fork, so the read tables are shared, not copied; the
    workers run numpy and Python only); the records, their order and the
    duplicate rule are those of one process.
    """
    genome_len = p.genome_len
    cols = {
        k: []
        for k in (
            "a_id b_id a_len b_len a_start a_end b_start b_end rc diffs tlen".split()
        )
    }
    trace_chunks: List[np.ndarray] = []
    noise_rng = np.random.default_rng((p.seed, 0xDA11))
    seg_lists = [_segments(r) for r in reads]
    big = 1 << 60
    # (shift, window) specs: B genome positions g map to A frame as g+shift,
    # valid only where the A-frame position lies inside window.
    specs: List[Tuple[int, int, int]] = [(0, -big, big)]
    for src, dst, L in p.repeats:
        specs.append((src - dst, src, src + L))
        specs.append((dst - src, dst, dst + L))
    # telomere homology: every block is a copy of every other (all ordered
    # pairs), plus intra-block tandem shifts k*unit for self-alignments
    tregs = telomere_regions(p)
    for s1, T1 in tregs:
        for s2, T2 in tregs:
            if s1 != s2:
                T = min(T1, T2)
                cap = p.telomere_cross_cap
                if cap > 0:
                    # fragment cross-end homology into <=cap windows with
                    # 100bp divergence gaps (diverged repeat copies)
                    w = s1
                    while w < s1 + T:
                        specs.append((s1 - s2, w, min(w + cap, s1 + T)))
                        w += cap + 100
                else:
                    specs.append((s1 - s2, s1, s1 + T))
        if p.telomere_unit > 0:
            u = p.telomere_unit
            k = 1
            while k * u + p.min_overlap <= T1:
                specs.append((k * u, s1 + k * u, s1 + T1))
                specs.append((-k * u, s1, s1 + T1 - k * u))
                k += 1

    n = len(reads)
    # flat segment table: (read, sa0, sa1, g0, g1); candidate pairs found by
    # an interval sweep per spec — O(segments * coverage), not O(n^2)
    seg_table = []
    for i in range(n):
        gm = reads[i].gmap
        for (s0, s1) in seg_lists[i]:
            seg_table.append((i, s0, s1, int(gm[s0]), int(gm[s1 - 1]) + 1))
    seg_g0 = np.array([s[3] for s in seg_table], dtype=np.int64)
    seg_g1 = np.array([s[4] for s in seg_table], dtype=np.int64)
    order = np.argsort(seg_g0, kind="stable")
    sorted_g0 = seg_g0[order]
    max_seg = int((seg_g1 - seg_g0).max()) if len(seg_table) else 0

    # work units: runs of the A segments of each spec whose clamp to the
    # spec's window is at least min_overlap long, in spec order and table
    # order (hinge_tpu's copy tests every segment one by one, in the same
    # order, to the same result)
    units = []
    for si, (sh, w0, w1) in enumerate(specs):
        live = np.nonzero(np.minimum(seg_g1, w1) - np.maximum(seg_g0, w0)
                          >= p.min_overlap)[0]
        for c in range(0, len(live), UNIT_SEGMENTS):
            units.append((si, live[c:c + UNIT_SEGMENTS].tolist()))
    tables = (reads, p, specs, seg_table, seg_g0, seg_g1, order, sorted_g0,
              max_seg, units)
    emitted = set()
    for made in _run_units(tables):
        for key, vals, tr in made:
            if key in emitted:
                continue
            emitted.add(key)
            if vals is None:
                continue
            rec = dict(zip(_COLUMNS, vals))
            tr = np.frombuffer(tr, dtype=np.uint16)
            for rec2, tr2 in _apply_noise(rec, tr, p, noise_rng):
                for k, v in rec2.items():
                    cols[k].append(v)
                trace_chunks.append(tr2)

    trace = (
        np.concatenate(trace_chunks) if trace_chunks else np.zeros(0, dtype=np.uint16)
    )
    store = OverlapStore.from_arrays(
        tspace=p.tspace, trace=trace, **{k: np.asarray(v, dtype=np.int64).astype(INT) if len(v) else np.zeros(0, INT) for k, v in cols.items()}
    )
    return store.sort_by_a()


#: the columns of an overlap record, in the order _make_overlap builds them
_COLUMNS = tuple("a_id b_id a_len b_len a_start a_end b_start b_end rc diffs "
                 "tlen".split())
#: A segments per work unit of exact_overlaps
UNIT_SEGMENTS = 256
#: exact_overlaps' tables in a forked worker, set by _init_worker
_WORKER_TABLES = None


def _unit(tables, u):
    """The candidate pairs that work unit `u` of exact_overlaps meets, in
    the order one process meets them: (key, record values or None, trace
    bytes or None) for each key not met before inside the unit."""
    (reads, p, specs, seg_table, seg_g0, seg_g1, order, sorted_g0, max_seg,
     units) = tables
    si, ais = units[u]
    sh, w0, w1 = specs[si]
    seen = set()
    out = []
    for ai in ais:
        i, sa0, sa1, ga0, ga1 = seg_table[ai]
        a_lo = max(ga0, w0)
        a_hi = min(ga1, w1)
        gm_a = reads[i].gmap
        # B candidates: segments with (gb0+sh) < a_hi and (gb1+sh) > a_lo
        lo_idx = np.searchsorted(sorted_g0, a_lo - sh - max_seg, side="left")
        for oi in range(lo_idx, len(order)):
            bi = int(order[oi])
            gb0 = int(seg_g0[bi])
            if gb0 + sh >= a_hi:
                break
            gb1 = int(seg_g1[bi])
            j, sb0, sb1 = seg_table[bi][0], seg_table[bi][1], seg_table[bi][2]
            if i == j and sh == 0:
                continue
            g0 = max(ga0, gb0 + sh, w0)
            g1 = min(ga1, gb1 + sh, w1)
            if g1 - g0 < p.min_overlap:
                continue
            key = (i, j, g0, g1, sh)
            if key in seen:
                continue
            seen.add(key)
            made = _make_overlap(
                reads, i, j, gm_a, reads[j].gmap, sa0, sa1, sb0, sb1, g0, g1, sh, p
            )
            if made is None:
                out.append((key, None, None))
            else:
                out.append((key, tuple(made[0][c] for c in _COLUMNS),
                            made[1].tobytes()))
    return out


def _init_worker(tables):
    global _WORKER_TABLES
    _WORKER_TABLES = tables


def _worker_unit(u):
    return _unit(_WORKER_TABLES, u)


def _run_units(tables):
    """The outputs of exact_overlaps' work units in order: in this process
    when there is one unit or one core, else in one forked process a core
    (the fork hands `tables` to the workers without copying them)."""
    n_units = len(tables[-1])
    workers = min(os.cpu_count() or 1, n_units)
    if workers < 2:
        yield from (_unit(tables, u) for u in range(n_units))
        return
    import multiprocessing

    pool = multiprocessing.get_context("fork").Pool(
        workers, initializer=_init_worker, initargs=(tables,))
    try:
        yield from pool.imap(_worker_unit, range(n_units), chunksize=4)
        pool.close()
    finally:
        pool.terminate()
        pool.join()


def _seg_bounds(a_start: int, a_end: int, tsp: int) -> np.ndarray:
    """DALIGNER trace boundaries: a_start, interior tspace multiples, a_end."""
    first = (a_start // tsp + 1) * tsp
    return np.concatenate([
        [a_start], np.arange(first, a_end, tsp, dtype=np.int64), [a_end]])


def _apply_noise(rec, tr, p, rng):
    """DALIGNER-statistics noise post-pass (SimParams.noise_profile).

    Fills per-segment diff counts into the trace's even slots (real traces
    are (diffs, disp) pairs; align.h:88-95) with diffs ~ Binomial(seg_len,
    noise_diff_rate), sets the record's summed diffs, and with probability
    chain_split_rate splits the overlap into a same-(A,B) two-record chain
    with a one-trace-segment gap on both reads — the shape of real chained
    DALIGNER output.  Returns a list of (rec, trace) to emit.
    """
    if p.noise_profile != "daligner":
        return [(rec, tr)]
    tsp = p.tspace
    npairs = rec["tlen"] // 2
    bounds = _seg_bounds(rec["a_start"], rec["a_end"], tsp)
    seg_len = np.diff(bounds)
    assert len(seg_len) == npairs, (len(seg_len), npairs)
    disp = tr[1::2].astype(np.int64)

    def finish(r, d_slice, s_lens):
        diffs = rng.binomial(s_lens, p.noise_diff_rate).astype(np.uint16)
        t = np.zeros(2 * len(d_slice), np.uint16)
        t[0::2] = diffs
        t[1::2] = d_slice
        r = dict(r)
        r["diffs"] = int(diffs.sum())
        r["tlen"] = 2 * len(d_slice)
        return r, t

    if npairs >= 3 and rng.random() < p.chain_split_rate:
        m = int(rng.integers(1, npairs - 1))  # segment m becomes the gap
        a1_span = int(bounds[m] - rec["a_start"])
        a2_span = int(rec["a_end"] - bounds[m + 1])
        if a1_span >= 2 * tsp and a2_span >= 2 * tsp:
            cum = np.concatenate([[0], np.cumsum(disp)])
            if rec["rc"] == 0:
                W = rec["b_start"] + cum
            else:
                W = rec["b_end"] - cum
            r1 = dict(rec, a_end=int(bounds[m]),
                      b_start=int(min(W[0], W[m])),
                      b_end=int(max(W[0], W[m])))
            r2 = dict(rec, a_start=int(bounds[m + 1]),
                      b_start=int(min(W[m + 1], W[npairs])),
                      b_end=int(max(W[m + 1], W[npairs])))
            return [finish(r1, disp[:m].astype(np.uint16), seg_len[:m]),
                    finish(r2, disp[m + 1:].astype(np.uint16),
                           seg_len[m + 1:])]
    return [finish(rec, tr[1::2], seg_len)]


def _make_overlap(reads, i, j, gm_a, gm_b, sa0, sa1, sb0, sb1, g0, g1, sh, p):
    ra, rb = reads[i], reads[j]
    # forward-layout spans within each segment
    s_a = sa0 + int(np.searchsorted(gm_a[sa0:sa1], g0, side="left"))
    e_a = sa0 + int(np.searchsorted(gm_a[sa0:sa1], g1, side="left"))
    s_b = sb0 + int(np.searchsorted(gm_b[sb0:sb1], g0 - sh, side="left"))
    e_b = sb0 + int(np.searchsorted(gm_b[sb0:sb1], g1 - sh, side="left"))
    if e_a - s_a < p.min_overlap or e_b - s_b < p.min_overlap:
        return None
    rc = int(ra.strand != rb.strand)
    alen, blen = len(ra.codes), len(rb.codes)
    if ra.strand == 0:
        a_start, a_end = s_a, e_a
    else:
        a_start, a_end = alen - e_a, alen - s_a
    if rb.strand == 0:
        b_start, b_end = s_b, e_b
    else:
        b_start, b_end = blen - e_b, blen - s_b

    # trace points: walk A read-orientation from a_start to a_end in tspace
    # segments; record the B displacement per segment.
    tsp = p.tspace
    bounds = [a_start]
    nb = a_start
    while True:
        nb = (nb // tsp + 1) * tsp
        if nb >= a_end:
            break
        bounds.append(nb)
    bounds.append(a_end)
    bounds_arr = np.array(bounds, dtype=np.int64)
    # map each A boundary to a B read-orientation position
    if ra.strand == 0:
        fwd_idx = bounds_arr
    else:
        fwd_idx = alen - bounds_arr  # forward-layout boundary index
    # boundary genome positions, restricted to the matched A segment: a
    # boundary at the segment's exclusive end maps to last_base+1, NOT to
    # the next (wrapped/chimeric) segment's start
    gm_seg = gm_a[sa0:sa1]
    gm_seg_ext = np.append(gm_seg, gm_seg[-1] + 1)
    g_at = gm_seg_ext[np.clip(fwd_idx - sa0, 0, sa1 - sa0)] - sh
    b_fwd = sb0 + np.searchsorted(gm_b[sb0:sb1], g_at, side="left")
    if rb.strand == 0:
        b_at = b_fwd
    else:
        b_at = blen - b_fwd
    # clamp the walk to the reported B match span so displacements telescope
    # exactly to b_end - b_start
    lo, hi = min(b_start, b_end), max(b_start, b_end)
    b_at = np.clip(b_at, lo, hi)
    disp = np.abs(np.diff(b_at)).astype(np.uint16)
    npairs = len(disp)
    tr = np.zeros(2 * npairs, dtype=np.uint16)
    tr[1::2] = disp
    # diffs per segment: 0 — per-segment diff counts only matter for
    # DALIGNER's own quality filters, which HINGE does not use downstream.
    rec = dict(
        a_id=i, b_id=j, a_len=alen, b_len=blen,
        a_start=a_start, a_end=a_end,
        b_start=min(b_start, b_end), b_end=max(b_start, b_end),
        rc=rc, diffs=0, tlen=2 * npairs,
    )
    return rec, tr


def make_read_store(reads: List[SimRead], p: SimParams, rng: np.random.Generator) -> ReadStore:
    n = len(reads)
    length = np.array([len(r.codes) for r in reads], dtype=INT)
    bases_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(length, out=bases_off[1:])
    bases = np.concatenate([r.codes for r in reads]) if n else np.zeros(0, np.uint8)
    # QV track: one value per tspace segment (DASqv convention)
    qv_off = np.zeros(n + 1, dtype=np.int64)
    qv_chunks = []
    for i, r in enumerate(reads):
        nseg = (len(r.codes) + p.tspace - 1) // p.tspace
        qv = np.full(nseg, p.qv_good, dtype=np.uint8)
        if p.bad_end_len > 0:
            nbad = (p.bad_end_len + p.tspace - 1) // p.tspace
            qv[:nbad] = p.qv_bad
            qv[max(0, nseg - nbad) :] = p.qv_bad
        qv_chunks.append(qv)
        qv_off[i + 1] = qv_off[i] + nseg
    qv_val = np.concatenate(qv_chunks) if qv_chunks else np.zeros(0, np.uint8)
    names = [f"sim/{i+1}/0_{length[i]}" for i in range(n)]
    return ReadStore(
        length=length,
        qv_off=qv_off,
        qv_val=qv_val,
        bases_off=bases_off,
        bases=bases,
        names=names,
    )


def simulate(p: SimParams):
    """Full synthetic dataset: (genome, reads, ReadStore, OverlapStore)."""
    if p.chromosomes:
        p = dataclasses.replace(
            p, genome_len=int(sum(p.chromosomes)), circular=False
        )
    rng = np.random.default_rng(p.seed)
    genome = make_genome(p, rng)
    reads = sample_reads(p, rng, genome)
    rs = make_read_store(reads, p, rng)
    ov = exact_overlaps(reads, p)
    return genome, reads, rs, ov
