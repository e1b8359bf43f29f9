"""Copied from hinge_tpu/stages/draft.py: the logic verbatim, the imports
rewritten to hinge_tpu_torch, and the ladder-window aligner replaced by
the port's (`_align_ladder_pairs`: the band-NW CUDA kernels on CUDA), which
the device reaches through `run_draft(..., device=)`.  Its parts are spans
(`draft.index`, `draft.backbone`, `draft.ladders`, `draft.align`,
`draft.vote`, `draft.write`; utils/log.py), and the ladder pairs are
counted (`draft.pairs`, `draft.pairs_identical`).

Stage 5b — draft assembly (`hinge draft`, reference `src/consensus/draft.cpp`).

Per contig from X.edges.list: select the backbone overlap for each edge,
derive full alignment rows (our trace-anchored window re-alignment replaces
recoverAlignment+getAlignmentTags), strand-normalize to the contig
orientation, march tspace waypoints across the backbone to build lanes and
ladders (draft.cpp:398-551), pick the max-min-coverage segment per ladder as
template (:570-587), and vote every ladder segment against it with the
FALCON align-tag MSA (:636-677).  Output: X.draft.fasta (low-coverage bases
lowercase, like the reference consensus sequence strings).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore, revcomp_codes
from hinge_tpu_torch.ops import dalign_trace as DT
from hinge_tpu_torch.ops import falcon_vote as FV
from hinge_tpu_torch.ops import myers as MY
from hinge_tpu_torch.utils.log import count, span

# code 5 = '$': falcon.c's backtrack can emit the literal '$' placeholder
# when the best column's best link index exceeds 4 (falcon.c:456-483)
_L = np.frombuffer(b"acgt-$", dtype=np.uint8)
_U = np.frombuffer(b"ACGT-$", dtype=np.uint8)


def codes_to_text(codes: np.ndarray, low: Optional[np.ndarray] = None) -> str:
    tab = _U[codes]
    if low is not None and len(low) == len(codes):
        tab = np.where(low, _L[codes], tab)
    return tab.tobytes().decode()


def parse_edges_list(path_or_lines) -> List[Tuple[str, List[list], bool, bool, int, int]]:
    """Parse X.edges.list into per-contig records
    (draft.cpp:1071-1157). Returns [(name, edges, one_read, two_read,
    cut_start, cut_end)] with edges = [[a, as, b, bs, w]]."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.read().splitlines()
    else:
        lines = list(path_or_lines)
    contigs = []
    name = None
    edges: List[list] = []
    one_read = two_read = False
    cut_start = cut_end = 0

    def flush():
        if name is not None and edges:
            contigs.append((name, edges, one_read, two_read, cut_start, cut_end))

    for line in lines:
        if not line:
            continue
        if line[0] == ">":
            flush()
            name = line
            edges = []
            one_read = two_read = False
            cut_start = cut_end = 0
            continue
        t = line.split()
        tag = t[0]
        a, ao, b, bo = int(t[1]), int(t[2]), int(t[3]), int(t[4])
        if tag == "O":
            w = 0
            one_read = True
            cut_start, cut_end = int(t[5]), int(t[6])
        elif tag == "D":
            w = int(t[5])
            two_read = True
            cut_start, cut_end = int(t[6]), int(t[7])
        else:
            w = int(t[5])
            if tag == "S":
                cut_start = int(t[6])
            elif tag == "E":
                cut_end = int(t[6])
        edges.append([a, ao, b, bo, w])
    flush()
    return contigs


def _find_overlap_row(ov: OverlapStore, row_lists: Dict[int, np.ndarray], a: int, b: int, w: int) -> Optional[int]:
    """First las-order row with a_id==a, b_id==b, summed raw match len == w
    (draft.cpp:163-177).

    Divergence by necessity: when the pair's alignment is a same-(A,B)
    CHAIN of records (real DALIGNER output contains these), hinging sums
    every record's length into the hinge-graph edge weight, so no single
    record matches and the reference draft binary exit(1)s
    (draft.cpp:263-274 — pinned by tests/test_reference_parity.py on the
    noisy profiles).  hinge_tpu instead falls back to the pair's LONGEST
    record: the chain's backbone piece, which positions read B exactly like
    an unchained overlap would locally."""
    rows = row_lists.get(a)
    if rows is None:
        return None
    best = None
    best_len = -1
    n_pair = 0
    for r in rows:
        if int(ov.b_id[r]) == b:
            ml = int(ov.match_len()[r])
            if ml == w:
                return int(r)
            n_pair += 1
            if ml > best_len:
                best, best_len = int(r), ml
    # fall back ONLY on the chained-pair signature: the pair has MULTIPLE
    # records, none matching the summed edge weight (the weight includes
    # the chain's gap segments, so no linear check can reconstruct it).  A
    # single-record mismatch — e.g. an edges.list from different overlaps —
    # keeps the reference's skip behavior.
    return best if n_pair >= 2 else None


def _row_item_for_edge(ov: OverlapStore, rs: ReadStore, row: int):
    """Bulk-batch item (see batch_align.align_overlap_rows_bulk) for one
    backbone edge's overlap."""
    a_seq = rs.get_bases(int(ov.a_id[row]))
    b_seq = rs.get_bases(int(ov.b_id[row]))
    if int(ov.rc[row]):
        b_frame = revcomp_codes(b_seq)
        bb = int(ov.b_len[row]) - int(ov.b_end[row])
        be = int(ov.b_len[row]) - int(ov.b_start[row])
    else:
        b_frame = b_seq
        bb, be = int(ov.b_start[row]), int(ov.b_end[row])
    return (a_seq, b_frame, int(ov.a_start[row]), int(ov.a_end[row]), bb, be,
            ov.trace_pairs(row), ov.tspace)


def _aln_rows_for_edge(ov: OverlapStore, rs: ReadStore, row: int, band: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full alignment rows for the overlap (A as-is, B complemented when rc),
    covering raw match coords — our recoverAlignment+getAlignmentTags."""
    a_seq = rs.get_bases(int(ov.a_id[row]))
    b_seq = rs.get_bases(int(ov.b_id[row]))
    rc = int(ov.rc[row])
    if rc:
        b_frame = revcomp_codes(b_seq)
        bb_raw = int(ov.b_len[row]) - int(ov.b_end[row])
        be_raw = int(ov.b_len[row]) - int(ov.b_start[row])
        # forward-strand coords flip back to the complemented frame...
        # careful: our store keeps forward-strand [b_start, b_end); in the
        # complemented frame the match is [blen-b_end, blen-b_start)
        bb_raw, be_raw = int(ov.b_len[row]) - int(ov.b_end[row]), int(ov.b_len[row]) - int(ov.b_start[row])
    else:
        b_frame = b_seq
        bb_raw, be_raw = int(ov.b_start[row]), int(ov.b_end[row])
    return BA.align_with_trace_batch(
        a_seq, b_frame,
        int(ov.a_start[row]), int(ov.a_end[row]),
        bb_raw, be_raw,
        ov.trace_pairs(row), tspace=ov.tspace,
    )


def get_mapping(row1: np.ndarray, row2: np.ndarray) -> np.ndarray:
    """draft.cpp:73-90 — for each non-gap position of row1, the count of
    non-gap row2 chars strictly before it."""
    nz2 = (row2 != MY.GAP).astype(np.int64)
    excl = np.concatenate([[0], np.cumsum(nz2)[:-1]])
    return excl[row1 != MY.GAP]


def base_coverage(ov: OverlapStore, read_id: int, rows: np.ndarray, alen: int) -> np.ndarray:
    """LAInterface::getCoverage equivalent: base-level pileup depth."""
    d = np.zeros(alen + 1, dtype=np.int32)
    np.add.at(d, ov.a_start[rows], 1)
    np.add.at(d, ov.a_end[rows], -1)
    return np.cumsum(d[:-1], dtype=np.int32)


def draft_assembly_ctg(
    edges: List[list],
    ov: OverlapStore,
    rs: ReadStore,
    row_lists: Dict[int, np.ndarray],
    pileup_rows: Dict[int, np.ndarray],
    tspace_draft: int,
    edge_safe: int,
    min_cov2: int,
    cut_start: int,
    cut_end: int,
    one_read: bool,
    two_read: bool,
    band: int = 150,
    *,
    device,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """draft.cpp:121-717 — returns (contig codes, lowercase mask) or None."""
    if not edges:
        return None
    a0, a0s = edges[0][0], edges[0][1]

    # case convention (reference): raw read substrings are LOWERCASE
    # (getRead loads with UPPER=1 -> Lower_Read, LAInterface.cpp:257/1250);
    # only FALCON consensus bases with coverage > min_cov are uppercase
    # (falcon.c:460-476).  The `low` masks below encode exactly that.
    if one_read:
        seq = rs.get_bases(a0)
        if a0s == 1:
            seq = revcomp_codes(seq)
        if cut_start <= len(seq) and cut_end <= len(seq):
            out = seq[cut_start:cut_end]
            return out, np.ones(len(out), bool)
        return seq, np.ones(len(seq), bool)

    # select the backbone overlap row per edge
    with span("draft.backbone"):
        selected: List[int] = []
        for (a, ao, b, bo, w) in edges:
            r = _find_overlap_row(ov, row_lists, a, b, w)
            if r is None:
                return None
            selected.append(r)

    if two_read:
        seq = rs.get_bases(a0)
        if a0s == 1:
            seq = revcomp_codes(seq)
        r = selected[0]
        # raw coords in the match frame (B complemented when rc)
        aend = int(ov.a_end[r])
        if int(ov.rc[r]):
            bstart = int(ov.b_len[r]) - int(ov.b_end[r])
        else:
            bstart = int(ov.b_start[r])
        b, bs = edges[0][2], edges[0][3]
        readB = rs.get_bases(b)
        if bs == 1:
            readB = revcomp_codes(readB)
        draft = np.concatenate([seq[:aend], readB[bstart:]])
        if cut_start <= len(draft) and cut_end <= len(draft):
            out = draft[cut_start:cut_end]
            return out, np.ones(len(out), bool)
        return draft, np.ones(len(draft), bool)

    # ---- multi-read contig ----
    n_bb = len(edges)
    breads: List[np.ndarray] = []
    bedges: List[dict] = []
    rowsA: List[np.ndarray] = []
    rowsB: List[np.ndarray] = []
    overhang = np.zeros(0, np.uint8)
    len_overhang = 0

    # all backbone alignment rows in pooled window batches — EXACT
    # recoverAlignment+getAlignmentTags parity (ops/dalign_trace.py)
    with span("draft.backbone"):
        bulk_items = [_row_item_for_edge(ov, rs, selected[idx])
                      for idx in range(n_bb)]
        bulk_rows = DT.align_overlap_rows_exact(bulk_items)

    # lanes, waypoints, ladders, templates and the pooled ladder pairs
    with span("draft.ladders"):
        for idx, (a, ao, b, bo, w) in enumerate(edges):
            r = selected[idx]
            rowA, rowB = bulk_rows[idx]
            if ao == 1:
                # reverse-complement both rows to the contig orientation
                rowA = _rc_row(rowA)
                rowB = _rc_row(rowB)
            rowsA.append(rowA)
            rowsB.append(rowB)

            cur = rs.get_bases(a)
            if ao == 1:
                cur = revcomp_codes(cur)
            nxt = rs.get_bases(b)
            if bo == 1:
                nxt = revcomp_codes(nxt)

            alen, blen = int(ov.a_len[r]), int(ov.b_len[r])
            # contig-oriented coords from the forward-strand stored ones
            # (draft.cpp:304-343)
            if ao == 0:
                abpos, aepos = int(ov.a_start[r]), int(ov.a_end[r])
            else:
                abpos, aepos = alen - int(ov.a_end[r]), alen - int(ov.a_start[r])
            if bo == 0:
                bbpos, bepos = int(ov.b_start[r]), int(ov.b_end[r])
            else:
                bbpos, bepos = blen - int(ov.b_end[r]), blen - int(ov.b_start[r])

            bedges.append(
                dict(a=a, b=b, abpos=abpos, aepos=aepos, bbpos=bbpos, bepos=bepos,
                     alen=alen, blen=blen)
            )
            breads.append(cur)
            overhang = nxt
            len_overhang = blen - bepos - (alen - aepos)

        if 0 < len_overhang < len(overhang):
            overhang = overhang[len(overhang) - len_overhang :]
        else:
            overhang = np.zeros(0, np.uint8)

        mappings = [get_mapping(rowsA[i], rowsB[i]) for i in range(n_bb)]

        # base coverage per backbone read (raw read coords — reference quirk:
        # indexed with contig-oriented positions, draft.cpp:570-587)
        coverages = []
        for (a, ao, b, bo, w) in edges:
            rows = pileup_rows.get(a, np.zeros(0, np.int64))
            coverages.append(base_coverage(ov, a, rows, int(rs.length[a])))

        # ---- waypoints / lanes (draft.cpp:398-487) ----
        lanes: List[List[Tuple[int, int]]] = []
        trace_pts: List[List[int]] = [[] for _ in range(n_bb)]
        cur_start_read = 0
        cur_space = 1
        cur_offset = 0
        rmax = -1
        while cur_start_read < n_bb - 1:
            currentread = cur_start_read
            while (
                bedges[cur_start_read]["abpos"] + cur_space * tspace_draft + cur_offset
                < bedges[cur_start_read]["aepos"] - edge_safe
            ):
                waypoint = bedges[cur_start_read]["abpos"] + tspace_draft * cur_space + cur_offset
                lane: List[Tuple[int, int]] = []
                while (
                    bedges[currentread]["abpos"] < waypoint < bedges[currentread]["aepos"]
                ):
                    trace_pts[currentread].append(waypoint)
                    lane.append((currentread, waypoint))
                    if currentread > rmax:
                        rmax = currentread
                    off = waypoint - bedges[currentread]["abpos"]
                    if off >= len(mappings[currentread]):
                        off = len(mappings[currentread]) - 1
                    waypoint = int(mappings[currentread][off]) + bedges[currentread]["bbpos"]
                    currentread += 1
                    if currentread >= n_bb:
                        break
                if currentread < n_bb and waypoint < bedges[currentread]["alen"]:
                    lane.append((currentread, waypoint))
                    if currentread > rmax:
                        rmax = currentread
                if currentread >= rmax:
                    lanes.append(lane)
                cur_space += 1
                currentread = cur_start_read
            cur_start_read += 1
            cur_space = 1
            if not trace_pts[cur_start_read]:
                cur_offset = 0
            else:
                cur_offset = trace_pts[cur_start_read][-1] - bedges[cur_start_read]["abpos"]

        if not lanes or not lanes[0]:
            return None

        first_start = lanes[0][0][1]
        last_end = lanes[-1][-1][1]
        prefix = rs.get_bases(edges[0][0])[:first_start]
        suffix = rs.get_bases(edges[-1][0])[last_end:]
        cut_end_eff = int(rs.length[edges[-1][2]]) - cut_end

        # ---- ladders (draft.cpp:538-551) ----
        # Pass 1: build every ladder and pool all (segment, template) pairs into
        # one banded batch; Pass 2: FALCON-vote per ladder.
        ladders: List[List[Tuple[int, int, int]]] = []
        for i in range(len(lanes) - 1):
            lane1, lane2 = lanes[i], lanes[i + 1]
            ladder: List[Tuple[int, int, int]] = []
            pos = 0
            for jj in range(len(lane2)):
                while pos < len(lane1) - 1 and lane1[pos][0] != lane2[jj][0]:
                    pos += 1
                if lane1[pos][0] == lane2[jj][0]:
                    ladder.append((lane2[jj][0], lane1[pos][1], lane2[jj][1]))
            ladders.append(ladder)

        # templates: max-min-coverage segment per ladder (draft.cpp:570-587)
        templates: List[Optional[int]] = []
        pair_q: List[np.ndarray] = []
        pair_t: List[np.ndarray] = []
        pair_owner: List[Tuple[int, int]] = []
        for li, ladder in enumerate(ladders):
            if len(ladder) <= 1:
                templates.append(None)
                continue
            mx = 0
            maxcov = 0
            for j, (rd, s, e) in enumerate(ladder):
                seg_cov = coverages[rd][s:e]
                mincov = int(seg_cov.min()) if len(seg_cov) else 10000
                if mincov > maxcov:
                    maxcov = mincov
                    mx = j
            templates.append(mx)
            t_rd, t_s, t_e = ladder[mx]
            template = breads[t_rd][t_s:t_e]
            for j, (rd, s, e) in enumerate(ladder):
                pair_q.append(breads[rd][s:e])
                pair_t.append(template)
                pair_owner.append((li, j))

    with span("draft.align"):
        pair_rows = _align_ladder_pairs(pair_q, pair_t, band, device=device)
        rows_of: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = dict(
            zip(pair_owner, pair_rows)
        )

    with span("draft.vote"):
        # FALCON vote: one batched tag pass over EVERY ladder row (native C,
        # incl. the sentinel column draft.cpp:652-659 prepends), then one
        # batched consensus call (native C core over all windows;
        # falcon.c:270-520).  The per-row Python tag loop was ~25% of the draft
        # stage wall at 4.6Mb (49k calls).
        win_rows: List[Tuple[int, int]] = []  # (ladder, n_rows) per window
        rows_q: List[np.ndarray] = []
        rows_t: List[np.ndarray] = []
        for li, ladder in enumerate(ladders):
            if len(ladder) <= 1:
                continue
            for j in range(len(ladder)):
                qrow, trow = rows_of[(li, j)]
                rows_q.append(qrow)
                rows_t.append(trow)
            win_rows.append((li, len(ladder)))
        all_tags = FV.get_align_tags_batch(rows_q, rows_t, sentinel=True)
        win_tags: List[np.ndarray] = []
        win_tlen: List[int] = []
        win_of: List[int] = []
        pos = 0
        for li, n_rows in win_rows:
            t_rd, t_s, t_e = ladder_span = ladders[li][templates[li]]
            win_tags.append(
                np.concatenate(all_tags[pos : pos + n_rows])
                if n_rows else np.zeros((0, 6), np.int32))
            win_tlen.append((t_e - t_s) + 1)
            win_of.append(li)
            pos += n_rows
        cns_results = FV.get_cns_batch(win_tags, win_tlen, [1] * len(win_tags))
        cns_of = dict(zip(win_of, cns_results))

        draft_chunks: List[np.ndarray] = []
        low_chunks: List[np.ndarray] = []
        for li, ladder in enumerate(ladders):
            if len(ladder) == 0:
                continue
            if len(ladder) == 1:
                rd, s, e = ladder[0]
                draft_chunks.append(breads[rd][s:e])
                low_chunks.append(np.ones(max(e - s, 0), bool))
                continue
            cns, low = cns_of[li]
            draft_chunks.append(cns)
            low_chunks.append(low)

        body = np.concatenate(draft_chunks) if draft_chunks else np.zeros(0, np.uint8)
        low_body = np.concatenate(low_chunks) if low_chunks else np.zeros(0, bool)
        contig = np.concatenate([prefix, body, suffix, overhang])
        low = np.concatenate(
            [np.ones(len(prefix), bool), low_body,
             np.ones(len(suffix) + len(overhang), bool)]
        )
        if cut_start <= len(contig) and cut_end_eff <= len(contig):
            end = len(contig) - cut_end_eff
            contig = contig[cut_start:end] if end >= cut_start else contig[cut_start:cut_start]
            low = low[cut_start : cut_start + len(contig)]
        return contig, low


def _align_ladder_pairs(pair_q, pair_t, band, *, device):
    """Ladder segment alignment rows.

    Identical pairs short-circuit (the rows are the inputs).  The rest go
    to the band-NW aligner (ops/band_nw.py) on CUDA, and to the exact C
    DW_banded path (`MY.align_exact_batch`) on the CPU.
    HINGE_PARITY_ALIGN=1 pins the C path; HINGE_FAST_ALIGN=1 forces the
    band-NW path on any device (on the CPU its plain torch twins).  Mirrors
    hinge_tpu.stages.draft._align_ladder_pairs with CUDA in the TPU's
    place: band-NW rows are optimal-cost but not byte-identical to the
    reference's DW_banded rows."""
    use_band = (os.environ.get("HINGE_FAST_ALIGN", "0") == "1"
                or (os.environ.get("HINGE_PARITY_ALIGN", "0") != "1"
                    and torch.device(device).type == "cuda"))
    rows: List = [None] * len(pair_q)
    todo = []
    for k, (qv, tv) in enumerate(zip(pair_q, pair_t)):
        if len(qv) == len(tv) and np.array_equal(qv, tv):
            rows[k] = (qv, tv)
        else:
            todo.append(k)
    count("draft.pairs", len(pair_q))
    count("draft.pairs_identical", len(pair_q) - len(todo))
    if todo:
        qs = [pair_q[k] for k in todo]
        ts = [pair_t[k] for k in todo]
        if use_band:
            from hinge_tpu_torch.ops.band_nw import band_align_batch

            aligned = band_align_batch(qs, ts, device=device)
        else:
            aligned = MY.align_exact_batch(qs, ts, band)
        for k, r in zip(todo, aligned):
            rows[k] = r
    return rows


def _rc_row(row: np.ndarray) -> np.ndarray:
    """Reverse-complement an alignment row (gap code 4 maps to itself)."""
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    return comp[row[::-1]]


def run_draft(
    rs: ReadStore,
    parts: Sequence[OverlapStore],
    cfg: Config,
    maximal: np.ndarray,
    edges_list_path_or_lines,
    out_fasta: Optional[str] = None,
    *,
    device,
) -> List[Tuple[str, str]]:
    """draft.cpp main on `device`: returns [(contig name, sequence)]."""
    d = cfg.draft
    # the reference's call-site defaults are -1 (draft.cpp:970-974) and it
    # simply misbehaves without an ini; we fall back to nominal.ini values
    tspace = d.tspace if d.tspace > 0 else 900
    edge_safe = d.edge_safe if d.edge_safe > 0 else 100
    min_cov2 = d.min_cov if d.min_cov > 0 else 10
    with span("draft.index"):
        # merge parts, keep only maximal x maximal (draft.cpp:880-913)
        keep_stores = []
        for part in parts:
            keep = maximal[part.a_id] & maximal[part.b_id]
            keep_stores.append(part.take(np.nonzero(keep)[0]))
        if len(keep_stores) == 1:
            ov = keep_stores[0]
        else:
            ov = _concat_stores(keep_stores)

        # per-A-read row lists (las order)
        row_lists: Dict[int, np.ndarray] = {}
        order = np.argsort(ov.a_id, kind="stable")
        bounds = np.searchsorted(ov.a_id[order], np.arange(rs.n_reads + 1))
        for a in range(rs.n_reads):
            if bounds[a + 1] > bounds[a]:
                row_lists[a] = order[bounds[a] : bounds[a + 1]]
        pileup_rows = row_lists

    out: List[Tuple[str, str]] = []
    for (name, edges, one_read, two_read, cs, ce) in parse_edges_list(edges_list_path_or_lines):
        res = draft_assembly_ctg(
            edges, ov, rs, row_lists, pileup_rows,
            tspace, edge_safe, min_cov2, cs, ce, one_read, two_read,
            device=device,
        )
        if res is None:
            continue
        contig, low = res
        with span("draft.write"):
            out.append((name.lstrip(">"), codes_to_text(contig, low)))
    if out_fasta is not None:
        with span("draft.write"), open(out_fasta, "w") as f:
            for name, seq in out:
                f.write(f">{name}\n{seq}\n")
            if not out:
                # draft.cpp:1113-1114 flushes the (empty) trailing
                # name+contig unconditionally: an empty edges.list still
                # yields a 2-byte "\n\n" fasta
                f.write("\n\n")
    return out


def _concat_stores(stores: List[OverlapStore]) -> OverlapStore:
    import numpy as _np

    cols = {}
    for field in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end", "b_start", "b_end", "rc", "diffs", "tlen"):
        cols[field] = _np.concatenate([getattr(s, field) for s in stores])
    traces = _np.concatenate([s.trace for s in stores]) if stores else _np.zeros(0, _np.uint16)
    offs = []
    base = 0
    for s in stores:
        offs.append(s.trace_off + base)
        base += len(s.trace)
    cols["trace_off"] = _np.concatenate(offs)
    return OverlapStore(trace=traces, tspace=stores[0].tspace, **cols)
