"""Stage 1 — reads filtering: chimera masking + hinge detection.

Port of `hinge_tpu/stages/filter.py` (reference `src/filter/filter.cpp`):
the pileup grids are built and kept on the torch device by
`_ResidentProfiles`, hinge calling runs as one batched torch op, and the
host logic (coverage estimate, telomere flags, annotation merging, the
per-part stage-file snapshots) is carried over unchanged.  Writes X.mas
X.cmas X.coverage.txt X.repeat.txt X.hinges.txt X.cov.flag X.self.flag
X.homologous.txt X.filtered.fasta, byte-identical to hinge_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore
from hinge_tpu_torch.device import refuse_unported, to_device
from hinge_tpu_torch.ops import coverage as C


@dataclasses.dataclass
class FilterResult:
    maskvec: np.ndarray  # int32 [n_reads, 2]
    cmask: np.ndarray  # int32 [n_reads, 2] (mask coords in bins)
    repeat_annotation: List[List[Tuple[int, int]]]
    hinges: Dict[int, List[Tuple[int, int]]]
    cov_flag: List[int]
    self_flag: List[int]
    min_cov_final: int
    cov_est: int
    coverages_txt: Optional[List[str]] = None
    # per-part snapshot lines for the stage files (the reference writes
    # them inside its part loop; see hinge_tpu.stages.filter.FilterResult)
    mas_lines: Optional[List[str]] = None
    cmas_lines: Optional[List[str]] = None
    repeat_lines: Optional[List[str]] = None
    hinges_lines: Optional[List[str]] = None


def qv_masks_all(rs: ReadStore, tspace: int, threshold: int = 40) -> np.ndarray:
    """QV mask for every read (filter.cpp:343-369), host numpy; [n,2]."""
    n = rs.n_reads
    out = np.zeros((n, 2), dtype=np.int32)
    if not rs.has_qv():
        return out
    nseg = np.diff(rs.qv_off).astype(np.int64)
    max_seg = int(nseg.max()) if n else 0
    good = np.zeros((n, max_seg), dtype=bool)
    seg_id = np.repeat(np.arange(n), nseg)
    col = np.arange(int(nseg.sum())) - np.repeat(rs.qv_off[:-1], nseg)
    good[seg_id, col] = rs.qv_val < threshold
    ms, me = C.qv_mask_np(good, nseg.astype(np.int32), tspace=tspace)
    out[:, 0] = ms
    out[:, 1] = me
    return out


def _self_match_reads(ov: OverlapStore, rs: ReadStore) -> Set[int]:
    """Reads with heavy self-alignment (filter.cpp:537-561)."""
    sel = ov.a_id == ov.b_id
    if not sel.any():
        return set()
    ids = ov.a_id[sel]
    span = (ov.a_end[sel] - ov.a_start[sel]) + (ov.b_end[sel] - ov.b_start[sel])
    tot = np.zeros(rs.n_reads, dtype=np.int64)
    np.add.at(tot, ids, span)
    covs = tot / np.maximum(rs.length, 1)
    return set(np.nonzero((covs > 4.5) & (rs.length > 10000))[0].tolist())


#: reads per device block — bounds each coverage grid to
#: CHUNK_READS x nb x 4B; larger read sets stream through in chunks
CHUNK_READS = 8192


class _ResidentProfiles:
    """Per-chunk coverage grids held on the device between the profile,
    mask and annotation phases; each grid is downloaded at most once."""

    def __init__(self, chunks, device):
        # chunks: list of (base, hi, cov, cov_cut, ne, ne_cut) device tensors
        self.chunks = chunks
        self.device = device
        self._cov_np = None
        self._cov_cut_np = None

    def masks(self, min_cov, n_chunk, reso):
        """coverage_mask over the resident cut grids (filter.cpp:696-755)."""
        out = np.zeros((4, n_chunk), np.int32)
        for base, hi, _, cov_cut, _, ne_cut in self.chunks:
            r = C.coverage_mask(torch.clamp(cov_cut - min_cov, min=0), ne_cut,
                                reso=reso)
            out[:, base:hi] = torch.stack(r).cpu().numpy()[:, : hi - base]
        return out[0], out[1], out[2], out[3]

    def annotation(self, m0, m1, min_cov, n_chunk, nb, f, reso):
        """repeat_annotation_mask over the resident base grids."""
        ann = np.zeros((n_chunk, nb - 1), np.int8)
        for base, hi, cov, _, ne, _ in self.chunks:
            span = hi - base
            m0p = np.zeros(CHUNK_READS, np.int32)
            m1p = np.zeros(CHUNK_READS, np.int32)
            m0p[:span] = m0[base:hi]
            m1p[:span] = m1[base:hi]
            ann[base:hi] = C.repeat_annotation_mask(
                cov, ne, to_device(m0p, self.device),
                to_device(m1p, self.device), min_cov, reso=reso,
                coverage_fraction=f.coverage_frac_repeat_annotation,
                min_thresh=f.min_repeat_annotation_threshold,
                max_thresh=f.max_repeat_annotation_threshold,
                no_hinge_region=f.no_hinge_region,
            )[:span].cpu().numpy()
        return ann

    def _download(self, slot, n_chunk, nb):
        out = np.zeros((n_chunk, nb), np.int32)
        for ch in self.chunks:
            base, hi = ch[0], ch[1]
            out[base:hi] = ch[slot][: hi - base].cpu().numpy()
        return out

    def cov_np(self, n_chunk, nb):
        """The base coverage grid, downloaded once."""
        if self._cov_np is None:
            self._cov_np = self._download(2, n_chunk, nb)
        return self._cov_np

    def cov_cut_np(self, n_chunk, nb):
        """The cutoff grid, downloaded once (telomere flag sums only)."""
        if self._cov_cut_np is None:
            self._cov_cut_np = self._download(3, n_chunk, nb)
        return self._cov_cut_np


def _device_profiles(ov, sel, r_begin, n_chunk, nb, reso, cut_off, device):
    """Coverage grids for a contiguous read range, chunked over reads.
    Returns (profiles, ne, ne_cut) with the grids resident on `device`."""
    refuse_unported("HINGE_SHARDED")
    a_rel_all = (ov.a_id[sel] - r_begin).astype(np.int32)
    a_s_all = ov.a_start[sel].astype(np.int32)
    a_e_all = ov.a_end[sel].astype(np.int32)

    ne = np.zeros(n_chunk, dtype=np.int32)
    ne_cut = np.zeros(n_chunk, dtype=np.int32)
    chunks = []
    # rows are sorted by a_id: binary-search the chunk boundaries
    for base in range(0, n_chunk, CHUNK_READS):
        hi = min(base + CHUNK_READS, n_chunk)
        lo_row = np.searchsorted(a_rel_all, base, side="left")
        hi_row = np.searchsorted(a_rel_all, hi, side="left")
        a_rel = to_device(a_rel_all[lo_row:hi_row] - base, device)
        a_s = to_device(a_s_all[lo_row:hi_row], device)
        a_e = to_device(a_e_all[lo_row:hi_row], device)
        span = hi - base
        cov = C.profile_coverage(a_rel, a_s, a_e, 0, n_reads=CHUNK_READS,
                                 nb=nb, reso=reso)
        cov_cut = C.profile_coverage(a_rel, a_s, a_e, cut_off,
                                     n_reads=CHUNK_READS, nb=nb, reso=reso)
        me, ms, cnt = C.pileup_stats(a_rel, a_s, a_e, n_reads=CHUNK_READS)
        ne_dev = C.n_entries_from_max_event(me, cnt, reso)
        # clipped profile: start+cutoff events can exceed every end-cutoff
        ne_cut_dev = C.n_entries_from_max_event(
            torch.maximum(me - cut_off, ms + cut_off), cnt, reso)
        ne[base:hi] = ne_dev[:span].cpu().numpy()
        ne_cut[base:hi] = ne_cut_dev[:span].cpu().numpy()
        chunks.append((base, hi, cov, cov_cut, ne_dev, ne_cut_dev))
    return _ResidentProfiles(chunks, device), ne, ne_cut


def run_filter(
    rs: ReadStore,
    parts: Sequence[OverlapStore],
    cfg: Config,
    out_prefix: Optional[str] = None,
    reads_to_keep: Optional[Set[int]] = None,
    has_qv: Optional[bool] = None,
    collect_coverage_txt: bool = False,
    *,
    device,
) -> FilterResult:
    f = cfg.filter
    reso = f.reso
    n_read = rs.n_reads
    if has_qv is None:
        has_qv = rs.has_qv()
    use_qv_mask = f.use_qv and has_qv
    use_coverage_mask = f.coverage
    # filter.cpp:406 reads the SINGULAR "del_telomere" key
    delete_telomere = cfg.layout.del_telomere

    tspace = parts[0].tspace if parts else 100
    QV_mask = qv_masks_all(rs, tspace, f.qv_threshold) if has_qv else np.zeros((n_read, 2), np.int32)

    maskvec = np.zeros((n_read, 2), dtype=np.int32)
    cmask = np.zeros((n_read, 2), dtype=np.int32)
    repeat_annotation: List[List[Tuple[int, int]]] = [[] for _ in range(n_read)]
    hinges: Dict[int, List[Tuple[int, int]]] = {}
    cov_flag: List[int] = []
    self_flag: List[int] = []
    coverage_lines: List[str] = [] if collect_coverage_txt or out_prefix else None

    MIN_COV = f.min_cov
    cov_est = 0
    mas_lines: List[str] = []
    cmas_lines: List[str] = []
    repeat_lines: List[str] = []
    hinges_lines: List[str] = []
    part_idx = -1

    # neighbor expansion for restrictreads (filter.cpp:680-694)
    if reads_to_keep:
        reads_to_keep = set(reads_to_keep)
        initial = set(reads_to_keep)
        for part in parts:
            m = np.isin(part.a_id, list(initial))
            reads_to_keep |= set(part.b_id[m].tolist())

    maxlen = int(rs.length.max()) if n_read else 0
    nb = maxlen // reso + 3

    for part in parts:
        if part.n == 0:
            continue
        part_idx += 1
        r_begin = int(part.a_id[0])
        r_end = int(part.a_id[-1])
        n_chunk = r_end - r_begin + 1

        self_reads = _self_match_reads(part, rs)
        nonself = part.a_id != part.b_id  # self matches excluded from pileups

        prof, ne, ne_cut = _device_profiles(
            part, nonself, r_begin, n_chunk, nb, reso, f.cut_off, device)
        cov = prof.cov_np(n_chunk, nb)  # one download; grids stay resident

        # ---- coverage estimate (filter.cpp:633-673) ----
        lens = rs.length[r_begin : r_end + 1]
        rowsum = cov.sum(axis=1, dtype=np.int64)
        eligible = lens >= 5000
        read_cov = rowsum[eligible]
        read_slot = ne[eligible]
        mean_read_cov = read_cov // np.maximum(1, read_slot)
        if len(mean_read_cov) == 0:
            raise ValueError("no reads >= 5000bp for coverage estimation")
        median_id = len(mean_read_cov) // 2
        if median_id > 0:
            cov_est = int(np.partition(mean_read_cov, median_id)[median_id])
        else:
            cov_est = int(mean_read_cov[0])
        if f.est_cov != 0:
            cov_est = f.est_cov
        if MIN_COV < cov_est // 3:
            MIN_COV = cov_est // 3

        # ---- masks (filter.cpp:696-789) over the resident cut grids ----
        ms, me_, msc, mec = prof.masks(MIN_COV, n_chunk, reso)

        if delete_telomere:
            reduced = np.maximum(
                prof.cov_cut_np(n_chunk, nb) - MIN_COV, 0).astype(np.int32)
            for ri in range(n_chunk):
                i = r_begin + ri
                a, b = int(msc[ri]), int(mec[ri])
                span = b - a + 1
                vals = reduced[ri]
                if span > 20:
                    sc = int(vals[a : a + 10].sum() + 10 * MIN_COV) // 10
                    ec = int(vals[b - 9 : b + 1].sum() + 10 * MIN_COV) // 10
                else:
                    limit = (b - a) // 2
                    if limit == 0:
                        sc = ec = 0
                    else:
                        sc = int(vals[a : a + limit].sum() + limit * MIN_COV) // limit
                        ec = int(vals[b - limit + 1 : b + 1].sum() + limit * MIN_COV) // limit
                if sc >= 10 * ec or ec >= 10 * sc:
                    cov_flag.append(i)
                if i in self_reads:
                    self_flag.append(i)

        for ri in range(n_chunk):
            i = r_begin + ri
            maxstart, maxend = int(ms[ri]), int(me_[ri])
            if reads_to_keep and i not in reads_to_keep:
                maxend = maxstart
                QV_mask[i, 1] = QV_mask[i, 0]
            cmask[i] = (msc[ri], mec[ri])
            if use_qv_mask and use_coverage_mask:
                maskvec[i] = (
                    max(maxstart, QV_mask[i, 0]),
                    min(maxend, QV_mask[i, 1]),
                )
            elif use_coverage_mask:
                maskvec[i] = (maxstart, maxend)
            else:
                maskvec[i] = (QV_mask[i, 0], QV_mask[i, 1])

        # ---- repeat annotation (filter.cpp:796-829), resident grids ----
        ann_grid = prof.annotation(
            maskvec[r_begin : r_end + 1, 0], maskvec[r_begin : r_end + 1, 1],
            MIN_COV, n_chunk, nb, f, reso)
        for ri in range(n_chunk):
            i = r_begin + ri
            nz = np.nonzero(ann_grid[ri])[0]
            anno = [(int(j) * reso, int(ann_grid[ri, j])) for j in nz]
            repeat_annotation[i] = _merge_annotations(anno, f.repeat_annotation_gap_threshold)

        # ---- hinge calling (filter.cpp:838-1070, device op) ----
        _call_hinges_device(
            part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
            repeat_annotation, hinges, f, reso, device,
        )

        # ---- per-part stage-file snapshots (see FilterResult fields) ----
        for i in range(r_begin, r_end + 1):
            cmas_lines.append(f"{i} {cmask[i, 0]} {cmask[i, 1]}")
            mas_lines.append(f"{i} {maskvec[i, 0]} {maskvec[i, 1]}")
        if part_idx == 0:
            for i in range(r_begin, r_end + 1):
                body = "".join(f"{p} {t} " for p, t in repeat_annotation[i])
                repeat_lines.append(f"{i} {body}")
        # reference quirk: the hinges loop is `i < r_end` (skips the last)
        for i in range(r_begin, r_end):
            body = "".join(f"{p} {t} " for p, t in hinges.get(i, []))
            hinges_lines.append(f"{i} {body}")

        # ---- coverage.txt lines (filter.cpp:599-602) ----
        if coverage_lines is not None:
            native = _native_coverage_lines(cov, ne, reso, r_begin)
            if native is not None:
                coverage_lines.extend(native)
            else:
                for ri in range(n_chunk):
                    i = r_begin + ri
                    vals = cov[ri, : ne[ri]]
                    body = "".join(f"{j*reso},{int(v)} " for j, v in enumerate(vals))
                    coverage_lines.append(f"read {i} {body}")

    res = FilterResult(
        maskvec=maskvec,
        cmask=cmask,
        repeat_annotation=repeat_annotation,
        hinges=hinges,
        cov_flag=cov_flag,
        self_flag=self_flag,
        mas_lines=mas_lines,
        cmas_lines=cmas_lines,
        repeat_lines=repeat_lines,
        hinges_lines=hinges_lines,
        min_cov_final=MIN_COV,
        cov_est=cov_est,
        coverages_txt=coverage_lines,
    )
    if out_prefix is not None:
        write_filter_outputs(res, out_prefix)
    return res


def _native_coverage_lines(cov, ne, reso, r_begin):
    """coverage.txt body via native/sweeps.cpp::format_coverage_lines;
    a list of lines, or None without the toolchain."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "format_coverage_lines"):
        return None
    lib.format_coverage_lines.restype = ctypes.c_int64
    c = np.ascontiguousarray(cov, np.int32)
    n = np.ascontiguousarray(ne, np.int32)
    cap = int(c.shape[0]) * 32 + int(np.minimum(n, c.shape[1]).sum()) * 20
    buf = ctypes.create_string_buffer(cap)
    w = lib.format_coverage_lines(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(c.shape[0]), ctypes.c_int64(c.shape[1]),
        ctypes.c_int32(reso), ctypes.c_int64(r_begin),
        buf, ctypes.c_int64(cap),
    )
    if w < 0:
        return None
    return buf.raw[:w].decode().split("\n")[:-1]


def _merge_annotations(anno: List[Tuple[int, int]], gap: int) -> List[Tuple[int, int]]:
    """filter.cpp:817-829: in-place merge of nearby same-sign annotations."""
    a = list(anno)
    i = 0
    while i < len(a):
        if i + 1 < len(a):
            if a[i][1] == 1 and a[i + 1][1] == 1 and a[i + 1][0] - a[i][0] < gap:
                del a[i + 1]
            elif a[i][1] == -1 and a[i + 1][1] == -1 and a[i + 1][0] - a[i][0] < gap:
                del a[i]
            else:
                i += 1
        else:
            i += 1
    return a


def _call_hinges_device(
    part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
    repeat_annotation, hinges, f, reso, device,
):
    """filter.cpp:838-1070: per-read gating on the host, support counting
    and the bridged scans as one batched op (ops/hinge_call.py)."""
    from hinge_tpu_torch.ops.hinge_call import call_hinges_device, introsort_perm

    sel_idx = np.nonzero(nonself)[0]
    a_ids = part.a_id[sel_idx]
    order = np.argsort(a_ids, kind="stable")
    sel_idx = sel_idx[order]
    a_ids = a_ids[order]
    bounds = np.searchsorted(a_ids, np.arange(r_begin, r_end + 2))
    NHR = f.no_hinge_region

    tasks: list = []
    t_pos: list = []
    t_grad: list = []
    t_m0: list = []
    t_m1: list = []
    read_rows: dict = {}
    for i in range(r_begin, r_end + 1):
        hinges[i] = []
        anns = repeat_annotation[i]
        # average coverage near mask ends (filter.cpp:842-865)
        m0, m1 = int(maskvec[i, 0]), int(maskvec[i, 1])
        nloc = int(ne[i - r_begin])
        pos = np.arange(nloc) * reso
        vals = cov[i - r_begin, :nloc]
        s_sel = (pos >= m0) & (pos <= m0 + NHR)
        e_sel = (pos >= m1 - NHR) & (pos <= m1)
        n_s, n_e = int(s_sel.sum()), int(e_sel.sum())
        if n_s > 0 and n_e > 0:
            avg_s = float(vals[s_sel].sum()) / n_s
            avg_e = float(vals[e_sel].sum()) / n_e
            if abs(avg_e - avg_s) < 10:
                continue
        # (num==0 -> NaN in C, comparison false -> proceed)
        if not anns:
            continue
        if i not in read_rows:
            lo, hi = bounds[i - r_begin], bounds[i - r_begin + 1]
            rows = sel_idx[lo:hi]
            # reference pileup order: std::sort(compare_overlap) over the
            # las-order rows, with the introsort tie arrangement
            mlen = ((part.a_end[rows] - part.a_start[rows])
                    + (part.b_end[rows] - part.b_start[rows]))
            rows = rows[introsort_perm(mlen, descending=True)]
            b_ids = part.b_id[rows]
            rcs = part.rc[rows]
            bms = part.b_start[rows]
            bme = part.b_end[rows]
            bm0 = maskvec[b_ids, 0]
            bm1 = maskvec[b_ids, 1]
            right_ovh = np.where(rcs == 0, np.maximum(bm1 - bme, 0),
                                 np.maximum(bms - bm0, 0))
            left_ovh = np.where(rcs == 0, np.maximum(bms - bm0, 0),
                                np.maximum(bm1 - bme, 0))
            read_rows[i] = (
                part.a_start[rows].astype(np.int32),
                part.a_end[rows].astype(np.int32),
                left_ovh.astype(np.int32),
                right_ovh.astype(np.int32),
            )
        for ai, (pos_a, grad) in enumerate(anns):
            tasks.append((i, ai))
            t_pos.append(pos_a)
            t_grad.append(grad)
            t_m0.append(m0)
            t_m1.append(m1)

    if not tasks:
        return
    bridged, support = call_hinges_device(
        tasks, np.asarray(t_pos, np.int32), np.asarray(t_grad, np.int32),
        np.asarray(t_m0, np.int32), np.asarray(t_m1, np.int32), read_rows,
        theta=f.theta, htl=f.hinge_tolerance_length, hbl=f.hinge_bin,
        hrut=f.hinge_unbridged, hbpt=f.hinge_min_pileup, device=device,
    )
    HMS = f.hinge_min_support
    for t, (i, ai) in enumerate(tasks):
        if int(support[t]) < HMS:
            continue
        if (not bool(bridged[t])) and int(support[t]) > HMS:
            pos_a, grad = repeat_annotation[i][ai]
            hinges[i].append((pos_a, grad))


def write_filter_outputs(res: FilterResult, prefix: str):
    """Write the reference's nine filter output files from the per-part
    snapshot lines."""
    with open(prefix + ".mas", "w") as mas:
        mas.write("".join(line + "\n" for line in res.mas_lines))
    with open(prefix + ".cmas", "w") as cmas:
        cmas.write("".join(line + "\n" for line in res.cmas_lines))
    with open(prefix + ".repeat.txt", "w") as rep:
        rep.write("".join(line + "\n" for line in res.repeat_lines))
    with open(prefix + ".hinges.txt", "w") as hg:
        hg.write("".join(line + "\n" for line in res.hinges_lines))
    with open(prefix + ".cov.flag", "w") as fcov:
        for i in res.cov_flag:
            fcov.write(f"{i}\n")
    with open(prefix + ".self.flag", "w") as fself:
        for i in res.self_flag:
            fself.write(f"{i}\n")
    open(prefix + ".homologous.txt", "w").close()
    open(prefix + ".filtered.fasta", "w").close()
    if res.coverages_txt is not None:
        with open(prefix + ".coverage.txt", "w") as fo:
            for line in res.coverages_txt:
                fo.write(line + "\n")
