"""Stage 3 — hinge-aware greedy layout (reference `src/layout/hinging.cpp`).

Port of `hinge_tpu/stages/layout.py`: the host logic is carried over
unchanged, less the stable weight order hinge_tpu falls back to without
its native library, and the batched GetMatchingPosition queries run as the torch
op `ops.classify.matching_position` on the stage's device.

Pipeline:
  1. GetAlignment (hinging.cpp:347-610): re-stream overlaps, keep
     maximal×maximal pairs, top-2 per pair, trim+classify, bin into
     per-read forward/backward match lists — batched on device via
     hinge_tpu_torch.ops.pairs, with the same tie-pinning as stage 2.
  2. Kill hinges overlapped by clean extension reads (:1262-1321).
  3. Hinge graph (:1365-1640): every (read,hinge)×(match) pair queries
     GetMatchingPosition — batched as one matching_position kernel call —
     then matching hinges within ±MATCHING_HINGE_SLACK join a union-find;
     components smaller than MIN_CONNECTED_COMPONENT_SIZE die (:1666-1675).
     En passant, matches onto previously-killed hinges mark
     new_killed_hinges (poison for the layout loop).
  4. Greedy choice per read (:1905-2148): first non-poisoned FORWARD match
     in weight order, overridden by a FORWARD_INTERNAL match landing on an
     active matching hinge when within 2*HINGE_SLACK of the chosen weight.

Steps 2-3 run in span `layout.hinge_graph`; counters
`layout.hinges_killed` (the filter's hinges that X.hinge.list leaves out)
and `layout.hinged_edges` (X.edges.hinges lines with hinged flag 1;
utils/log.py).

Outputs (formats byte-identical to the reference): X.edges.hinges,
X.edges.hinges2, X.hinge.list, X.killed.hinges, X.hgraph, X.edges.{1,2,
greedy,skipped}, X.deadends.txt, X.garbage.txt.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore
from hinge_tpu_torch.device import to_device, to_host
from hinge_tpu_torch.ops import classify as CL
from hinge_tpu_torch.ops.pairs import (
    ProcessedAlignments, _libstdcxx_orders, process_alignments,
)
from hinge_tpu_torch.parallel.sharding import (
    run_sharded_matching_position, stage_mesh,
)
from hinge_tpu_torch.stages.maximal import _top_k
from hinge_tpu_torch.utils.log import count, span

FORWARD_TYPES = (CL.FORWARD, CL.FORWARD_INTERNAL)
BACKWARD_TYPES = (CL.BACKWARD, CL.BACKWARD_INTERNAL)
#: the match types of a hinged edge (edges.hinges' hinged flag 1)
INTERNAL_TYPES = (CL.FORWARD_INTERNAL, CL.BACKWARD_INTERNAL)


@dataclasses.dataclass
class Matches:
    """Per-part processed candidates + per-read forward/backward bins."""

    store: OverlapStore  # non-self rows of the part
    pa: ProcessedAlignments
    fwd: Dict[int, List[int]]  # read -> candidate indices (into pa arrays)
    bwd: Dict[int, List[int]]


@dataclasses.dataclass
class LayoutResult:
    edges_hinges: List[str]
    edges_hinges2: List[str]
    hinge_list: List[str]
    n_edges_fwd: int
    n_edges_bwd: int
    deadends: List[str]


def load_marked(path: str) -> Dict[int, List[Tuple[int, int]]]:
    """Parse repeat.txt / hinges.txt lines: 'i p1 t1 p2 t2 ...'
    (hinging.cpp:888-941: pairs with any zero component are dropped)."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            i = int(t[0])
            out[i] = []
            vals = [int(x) for x in t[1:]]
            for a in range(0, len(vals) - 1, 2):
                r1, r2 = vals[a], vals[a + 1]
                if r1 != 0 and r2 != 0:
                    out[i].append((r1, r2))
    return out


def get_alignment(
    parts: Sequence[OverlapStore],
    active: np.ndarray,
    eff_start: np.ndarray,
    eff_end: np.ndarray,
    cfg: Config,
    has_db: bool = True,
    *,
    device,
) -> List[Matches]:
    f, lay = cfg.filter, cfg.layout
    per_part = []
    for part in parts:
        if part.n == 0:
            continue
        keep = (
            (part.a_id != part.b_id)
            & active[part.a_id]
            & (active[part.b_id] | (not lay.keep_only_matches_between_maximal_reads))
        )
        sub = part.take(np.nonzero(keep)[0])
        k = 2 if lay.use_two_matches else 1
        cand = _top_k(sub, k, device)
        pa = process_alignments(
            sub, cand, eff_start, eff_end, f.aln_threshold, f.theta, f.theta2,
            trim=has_db,
        )
        fwd: Dict[int, List[int]] = {}
        bwd: Dict[int, List[int]] = {}
        a_ids = sub.a_id[cand]
        for q in range(len(cand)):
            t = int(pa.match_type[q])
            i = int(a_ids[q])
            if t in FORWARD_TYPES:
                fwd.setdefault(i, []).append(q)
            elif t in BACKWARD_TYPES:
                bwd.setdefault(i, []).append(q)
        per_part.append((sub, pa, fwd, bwd))
    if not per_part:
        return []

    # merge the parts into ONE match set: hinging.cpp's GetAlignment part
    # loop (:423) appends every part's candidates into the same global
    # matches_forward/backward vectors and the kill/greedy/layout loops run
    # ONCE over the merged, weight-sorted lists — per-part iteration would
    # double-process boundary reads and re-log deadends per part (caught by
    # the --mlas parity profile 93)
    if len(per_part) == 1:
        sub, pa, fwd, bwd = per_part[0]
    else:
        sub = _concat_stores([pp[0] for pp in per_part])
        row_off = np.cumsum([0] + [pp[0].n for pp in per_part])
        q_off = np.cumsum([0] + [len(pp[1].rows) for pp in per_part])
        import dataclasses as _dc

        cols = {}
        for fld in _dc.fields(ProcessedAlignments):
            vals = [getattr(pp[1], fld.name) for pp in per_part]
            if any(v is None for v in vals):
                cols[fld.name] = None
            elif fld.name == "rows":
                cols[fld.name] = np.concatenate(
                    [v + row_off[pi] for pi, v in enumerate(vals)])
            else:
                cols[fld.name] = np.concatenate(vals)
        pa = ProcessedAlignments(**cols)
        fwd, bwd = {}, {}
        for pi, (_, _, fw, bw) in enumerate(per_part):
            for i, lst in fw.items():
                fwd.setdefault(i, []).extend(q + int(q_off[pi]) for q in lst)
            for i, lst in bw.items():
                bwd.setdefault(i, []).extend(q + int(q_off[pi]) for q in lst)

    # sort by weight desc: hinging.cpp:1068-1069 uses std::sort
    # (compare_overlap_weight), whose unstable tie permutation the
    # hgraph/edge files inherit — replicate it via the libstdc++ oracle
    # (ops/pairs._libstdcxx_orders)
    _, sort_batch = _libstdcxx_orders()
    for d in (fwd, bwd):
        items = sorted(d.items())
        flat = np.array([q for _, lst in items for q in lst],
                        dtype=np.int64)
        if len(flat) == 0:
            continue
        off = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum([len(lst) for _, lst in items], out=off[1:])
        wts = np.ascontiguousarray(pa.weight[flat].astype(np.int64))
        perm = np.zeros(len(flat), dtype=np.int32)
        sort_batch(wts, off, len(items), perm)
        for gi, (i, lst) in enumerate(items):
            s, e = off[gi], off[gi + 1]
            d[i] = [lst[j] for j in perm[s:e]]
    return [Matches(store=sub, pa=pa, fwd=fwd, bwd=bwd)]


def _concat_stores(stores):
    """Order-preserving row concatenation of OverlapStores (no re-sort:
    the merged candidate order must stay part-major)."""
    if len(stores) == 1:
        return stores[0]
    cols = {}
    for fname in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
                  "b_start", "b_end", "rc", "diffs", "tlen"):
        cols[fname] = np.concatenate([getattr(st, fname) for st in stores])
    trace = np.concatenate([st.trace for st in stores])
    offs = []
    base = 0
    for st in stores:
        offs.append(st.trace_off + base)
        base += len(st.trace)
    cols["trace_off"] = np.concatenate(offs)
    return OverlapStore(trace=trace, tspace=stores[0].tspace, **cols)


class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def run_layout(
    rs: ReadStore,
    parts: Sequence[OverlapStore],
    cfg: Config,
    eff_start: np.ndarray,
    eff_end: np.ndarray,
    maximal: np.ndarray,
    marked_repeats: Dict[int, List[Tuple[int, int]]],
    marked_hinges: Dict[int, List[Tuple[int, int]]],
    out_prefix: Optional[str] = None,
    filter_prefix: Optional[str] = None,
    has_db: bool = True,
    *,
    device,
) -> LayoutResult:
    f, lay = cfg.filter, cfg.layout
    n_read = rs.n_reads

    active = maximal.copy()
    garbage: List[int] = []
    telomere_killed = 0
    if lay.del_telomeres:
        for i, anns in marked_repeats.items():
            if len(anns) > lay.num_events_telomere:
                active[i] = False
                telomere_killed += 1
    for i in range(n_read):
        if eff_end[i] - eff_start[i] < f.length_threshold:
            if active[i]:
                garbage.append(i)
            active[i] = False

    matches = get_alignment(parts, active, eff_start, eff_end, cfg, has_db,
                            device=device)

    # hinges_vec: (pos, type, active); killed = repeats not surviving as hinges
    hinges_vec: Dict[int, List[List[int]]] = {}
    killed_vec: Dict[int, List[Tuple[int, int]]] = {}
    for i in range(n_read):
        mh = marked_hinges.get(i, [])
        hinges_vec[i] = [[p, t, 1] for (p, t) in mh]
        surviving = set(mh)
        killed_vec[i] = [
            (p, t) for (p, t) in marked_repeats.get(i, []) if (p, t) not in surviving
        ]

    # ---- hinge graph, steps 2-3: kills, matching hinges, components ----
    with span("layout.hinge_graph", device=device):
        # ---- kill hinges via extension matches (hinging.cpp:1262-1321) ----
        for m in matches:
            b_active = active  # alias
            for i in range(n_read):
                if not active[i]:
                    continue
                for q in m.fwd.get(i, []):
                    if not m.pa.active[q]:
                        continue
                    t = int(m.pa.match_type[q])
                    if t in FORWARD_TYPES and active[int(m.store.b_id[m.pa.rows[q]])]:
                        s = int(m.pa.eff_a_match_start[q])
                        for h in hinges_vec[i]:
                            if h[1] == 1 and (
                                (t == CL.FORWARD_INTERNAL and s < h[0] + lay.kill_hinge_internal)
                                or (t == CL.FORWARD and s < h[0] - lay.kill_hinge_overlap)
                            ):
                                h[2] = 0
                for q in m.bwd.get(i, []):
                    if not m.pa.active[q]:
                        continue
                    t = int(m.pa.match_type[q])
                    if t in BACKWARD_TYPES and active[int(m.store.b_id[m.pa.rows[q]])]:
                        e = int(m.pa.eff_a_match_end[q])
                        for h in hinges_vec[i]:
                            if h[1] == -1 and (
                                (t == CL.BACKWARD_INTERNAL and e > h[0] - lay.kill_hinge_internal)
                                or (t == CL.BACKWARD and e > h[0] + lay.kill_hinge_overlap)
                            ):
                                h[2] = 0

        # ---- hinge graph (hinging.cpp:1365-1640) ----
        node_id: Dict[Tuple[int, int], int] = {}
        for i in range(n_read):
            for k in range(len(hinges_vec[i])):
                node_id[(i, k)] = len(node_id)
        uf = _UF(len(node_id))
        hgraph_lines: List[str] = []
        new_killed: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(n_read)}

        # batch all GetMatchingPosition queries per part
        for m in matches:
            sub, pa = m.store, m.pa
            tw = CL.build_trace_walk(sub)

            queries: List[Tuple[int, int, int, int, int]] = []  # (i,k,q,dir) dir 0 fwd
            for i in range(n_read):
                if not active[i]:
                    continue
                nh = len(hinges_vec[i])
                if nh == 0:
                    continue
                for k in range(nh):
                    for q in m.fwd.get(i, []):
                        if pa.active[q]:
                            t = int(pa.match_type[q])
                            if t in FORWARD_TYPES and active[int(sub.b_id[pa.rows[q]])]:
                                queries.append((i, k, q, 0, 0))
                    for q in m.bwd.get(i, []):
                        if pa.active[q]:
                            t = int(pa.match_type[q])
                            if t in BACKWARD_TYPES and active[int(sub.b_id[pa.rows[q]])]:
                                queries.append((i, k, q, 1, 0))
            if not queries:
                continue
            qa = np.array(queries, dtype=np.int64)
            ov_rows = pa.rows[qa[:, 2]]
            pos_a = np.array([hinges_vec[int(i)][int(k)][0] for i, k in zip(qa[:, 0], qa[:, 1])], dtype=np.int32)
            mesh = stage_mesh(device)
            if mesh is not None:
                # HINGE_SHARDED=1: queries route to the mesh shard owning each
                # overlap row — equal to the single-device op
                pos_b = run_sharded_matching_position(
                    ov_rows.astype(np.int32), pos_a,
                    sub.a_start, sub.a_end, sub.b_start, sub.b_end, sub.rc,
                    tw, mesh, tspace=CL.TRIM_GRID)
            else:
                dv = lambda a: to_device(a, device)  # noqa: E731
                pos_b = to_host(CL.matching_position(
                    dv(ov_rows.astype(np.int32)), dv(pos_a),
                    dv(sub.a_start), dv(sub.a_end), dv(sub.b_start), dv(sub.b_end),
                    dv(sub.rc), dv(tw.npairs), dv(tw.pair_off), dv(tw.cum),
                    tspace=CL.TRIM_GRID,  # reference hardcodes the 100 grid
                ))
            slack = lay.matching_hinge_slack
            for qi in range(len(queries)):
                i, k, q, dr, _ = queries[qi]
                row = pa.rows[q]
                rc = int(sub.rc[row])
                b_id = int(sub.b_id[row])
                pb = int(pos_b[qi])
                htype = hinges_vec[i][k][1]
                req = -htype if rc else htype
                rev_int = 1 if rc else 0
                for l, hb in enumerate(hinges_vec[b_id]):
                    if pb - slack < hb[0] < pb + slack:
                        if req == hb[1]:
                            uf.union(node_id[(i, k)], node_id[(b_id, l)])
                            if (dr == 0 and htype == 1) or (dr == 1 and htype == -1):
                                hgraph_lines.append(
                                    f"{i} {b_id} {hinges_vec[i][k][0]} {hb[0]} 1 {rev_int}"
                                )
                            else:
                                hgraph_lines.append(
                                    f"{b_id} {i} {hb[0]} {hinges_vec[i][k][0]} 1 {rev_int}"
                                )
                mt = int(pa.match_type[q])
                for l, (kp, kt) in enumerate(killed_vec[b_id]):
                    if pb - slack < kp < pb + slack:
                        if dr == 0:
                            if req == kt:
                                if htype == 1:
                                    hgraph_lines.append(
                                        f"{i} {b_id} {hinges_vec[i][k][0]} {kp} 0 {rev_int}"
                                    )
                                else:
                                    hgraph_lines.append(
                                        f"{b_id} {i} {kp} {hinges_vec[i][k][0]} 0 {rev_int}"
                                    )
                                if mt == CL.FORWARD:
                                    new_killed[i].append((hinges_vec[i][k][0], htype))
                        else:
                            if req == kt:
                                if htype == -1:
                                    hgraph_lines.append(
                                        f"{i} {b_id} {hinges_vec[i][k][0]} {kp} 0 {rev_int}"
                                    )
                                else:
                                    hgraph_lines.append(
                                        f"{b_id} {i} {kp} {hinges_vec[i][k][0]} 0 {rev_int}"
                                    )
                            # backward quirk: push regardless of req == kt
                            # (hinging.cpp:1609-1620 is outside the req check)
                            if mt == CL.BACKWARD:
                                new_killed[i].append((hinges_vec[i][k][0], htype))

        # component sizes -> kill small components (hinging.cpp:1644-1675)
        comp_size: Dict[int, int] = {}
        for (i, k), nid in node_id.items():
            comp_size[uf.find(nid)] = comp_size.get(uf.find(nid), 0) + 1
        for (i, k), nid in node_id.items():
            if comp_size[uf.find(nid)] < lay.min_connected_component_size:
                hinges_vec[i][k][2] = 0

    hinge_list_lines = []
    for i in range(n_read):
        for k, h in enumerate(hinges_vec[i]):
            if active[i] and h[2]:
                p, t = marked_hinges[i][k]
                hinge_list_lines.append(f"{i} {p} {t}")
    # the filter's hinges that hinge.list leaves out: killed, or on a read
    # the layout does not use
    count("layout.hinges_killed",
          sum(len(hinges_vec[i]) for i in range(n_read)) - len(hinge_list_lines))

    # ---- layout loop (hinging.cpp:1905-2148) ----
    edges_hinges: List[str] = []
    edges_hinges2: List[str] = []
    skipped_lines: List[str] = []
    deadends: List[str] = []
    greedy_lines: List[str] = []
    g1_lines: List[str] = []
    g2_lines: List[str] = []
    n_fwd = n_bwd = n_hinged = 0

    for m in matches:
        sub, pa = m.store, m.pa

        def _fmt_edge(q, out_list):
            out_list.append(_print_overlap(sub, pa, q))

        # greedy graph (first active FORWARD / BACKWARD per read)
        for i in range(n_read):
            if not active[i]:
                continue
            forward = 0
            for q in m.fwd.get(i, []):
                if pa.active[q] and int(pa.match_type[q]) == CL.FORWARD and active[int(sub.b_id[pa.rows[q]])]:
                    if forward < 1:
                        greedy_lines.append(_print_overlap(sub, pa, q))
                        g1_lines.append(_g1_line(sub, pa, q))
                        g2_lines.append(_g2_line(sub, pa, q))
                    forward += 1
            backward = 0
            for q in m.bwd.get(i, []):
                if pa.active[q] and int(pa.match_type[q]) == CL.BACKWARD and active[int(sub.b_id[pa.rows[q]])]:
                    if backward < 1:
                        greedy_lines.append(_print_overlap(sub, pa, q))
                        g1_lines.append(_g1_line(sub, pa, q))
                        g2_lines.append(_g2_line(sub, pa, q))
                    backward += 1

        for i in range(n_read):
            if not active[i]:
                continue
            chosen = None
            hinge_pos = -1
            forward = forward_internal = 0
            for q in m.fwd.get(i, []):
                if not pa.active[q]:
                    continue
                row = pa.rows[q]
                if not active[int(sub.b_id[row])]:
                    continue
                t = int(pa.match_type[q])
                if t == CL.FORWARD and forward == 0:
                    poisoned = False
                    for (kp, kt) in new_killed[i]:
                        if int(sub.rc[row]) != 1 and kt == -1 and kp > int(pa.eff_b_match_end[q]):
                            skipped_lines.append(_print_overlap(sub, pa, q))
                            poisoned = True
                        elif int(sub.rc[row]) == 1 and kt == 1 and kp < int(pa.eff_b_match_start[q]):
                            skipped_lines.append(_print_overlap(sub, pa, q))
                            poisoned = True
                    if not poisoned:
                        chosen = q
                        hinge_pos = -1
                        forward = 1
                elif t == CL.FORWARD_INTERNAL and forward_internal == 0:
                    b_id = int(sub.b_id[row])
                    if not hinges_vec[b_id]:
                        continue
                    rbs = int(sub.b_start[row]) if int(sub.rc[row]) == 0 else int(sub.b_end[row])
                    want = 1 - 2 * int(sub.rc[row])
                    for h in hinges_vec[b_id]:
                        if (
                            h[0] - lay.hinge_tolerance < rbs < h[0] + lay.hinge_tolerance
                            and h[1] == want
                            and h[2]
                        ):
                            if forward == 0 or int(pa.weight[q]) > int(pa.weight[chosen]) - 2 * lay.hinge_slack:
                                chosen = q
                                forward = 1
                                forward_internal = 1
                                hinge_pos = h[0]
                            break
            if chosen is not None:
                edges_hinges.append(_print_overlap(sub, pa, chosen))
                edges_hinges2.append(_print_overlap2(sub, pa, chosen, hinge_pos))
                n_fwd += 1
                n_hinged += int(pa.match_type[chosen]) in INTERNAL_TYPES
                chosen = None
            else:
                deadends.append(f"{i}\t matches_forward size: {len(m.fwd.get(i, []))}")

            backward = backward_internal = 0
            for q in m.bwd.get(i, []):
                if not pa.active[q]:
                    continue
                row = pa.rows[q]
                if not active[int(sub.b_id[row])]:
                    continue
                t = int(pa.match_type[q])
                if t == CL.BACKWARD and backward == 0:
                    poisoned = False
                    for (kp, kt) in new_killed[i]:
                        if int(sub.rc[row]) != 1 and kt == 1 and kp < int(pa.eff_b_match_start[q]):
                            skipped_lines.append(_print_overlap(sub, pa, q))
                            poisoned = True
                        elif int(sub.rc[row]) == 1 and kt == -1 and kp > int(pa.eff_b_match_end[q]):
                            skipped_lines.append(_print_overlap(sub, pa, q))
                            poisoned = True
                    if not poisoned:
                        chosen = q
                        backward = 1
                        hinge_pos = -1
                elif t == CL.BACKWARD_INTERNAL and backward_internal == 0:
                    b_id = int(sub.b_id[row])
                    if not hinges_vec[b_id]:
                        continue
                    rbe = int(sub.b_end[row]) if int(sub.rc[row]) == 0 else int(sub.b_start[row])
                    want = -1 + 2 * int(sub.rc[row])
                    for h in hinges_vec[b_id]:
                        if (
                            h[0] - lay.hinge_tolerance < rbe < h[0] + lay.hinge_tolerance
                            and h[1] == want
                            and h[2]
                        ):
                            if backward == 0 or int(pa.weight[q]) > int(pa.weight[chosen]) - 2 * lay.hinge_slack:
                                chosen = q
                                backward = 1
                                backward_internal = 1
                                hinge_pos = h[0]
                            break
            if chosen is not None:
                edges_hinges.append(_print_overlap(sub, pa, chosen))
                edges_hinges2.append(_print_overlap2(sub, pa, chosen, hinge_pos))
                n_bwd += 1
                n_hinged += int(pa.match_type[chosen]) in INTERNAL_TYPES
            else:
                deadends.append(f"{i}\t matches_backward size: {len(m.bwd.get(i, []))}")

    count("layout.hinged_edges", n_hinged)

    if out_prefix is not None:
        def _w(name, lines):
            with open(name, "w") as fo:
                for ln in lines:
                    fo.write(ln + "\n")

        _w(out_prefix + ".edges.hinges", edges_hinges)
        _w(out_prefix + ".edges.hinges2", edges_hinges2)
        _w(out_prefix + ".hinge.list", hinge_list_lines)
        _w(out_prefix + ".hgraph", hgraph_lines)
        _w(out_prefix + ".edges.greedy", greedy_lines)
        _w(out_prefix + ".edges.1", g1_lines)
        _w(out_prefix + ".edges.2", g2_lines)
        _w(out_prefix + ".edges.skipped", skipped_lines)
        _w(out_prefix + ".deadends.txt", deadends)
        fp = filter_prefix if filter_prefix is not None else out_prefix
        with open(fp + ".killed.hinges", "w") as fo:
            for i in range(n_read):
                body = "".join(f"{t} {p} " for (p, t) in killed_vec[i])
                fo.write(f"{i} {body}\n")
        with open(fp + ".garbage.txt", "w") as fo:
            for i in garbage:
                fo.write(f"{i}\n")

    return LayoutResult(
        edges_hinges=edges_hinges,
        edges_hinges2=edges_hinges2,
        hinge_list=hinge_list_lines,
        n_edges_fwd=n_fwd,
        n_edges_bwd=n_bwd,
        deadends=deadends,
    )


def _print_overlap(sub, pa, q) -> str:
    """PrintOverlapToFile (hinging.cpp:188-248)."""
    row = pa.rows[q]
    t = int(pa.match_type[q])
    direction = int(sub.rc[row])
    hinged = 1 if t in INTERNAL_TYPES else -1
    a, b = int(sub.a_id[row]), int(sub.b_id[row])
    length = int(pa.length[q])
    eams, eame = int(pa.eff_a_match_start[q]), int(pa.eff_a_match_end[q])
    ebms, ebme = int(pa.eff_b_match_start[q]), int(pa.eff_b_match_end[q])
    # eff read ranges were gathered during ProcessAlignment from the masks
    ears, eare = int(pa._ears[q]), int(pa._eare[q])
    ebrs, ebre = int(pa._ebrs[q]), int(pa._ebre[q])
    rams, rame = int(sub.a_start[row]), int(sub.a_end[row])
    rbms, rbme = int(sub.b_start[row]), int(sub.b_end[row])
    if t in (CL.FORWARD, CL.FORWARD_INTERNAL):
        return (
            f"{a} {b} {length} 0 {direction} {hinged} "
            f"[{eams} {eame}] [{ebms} {ebme}] [{ears} {eare}] [{ebrs} {ebre}] "
            f"[{rams} {rame}] [{rbms} {rbme}]"
        )
    else:
        return (
            f"{b} {a} {length} {direction} 0 {hinged} "
            f"[{ebms} {ebme}] [{eams} {eame}] [{ebrs} {ebre}] [{ears} {eare}] "
            f"[{rams} {rame}] [{rbms} {rbme}]"
        )


def _print_overlap2(sub, pa, q, hinge_pos) -> str:
    """PrintOverlapToFile2 (hinging.cpp:253-344)."""
    row = pa.rows[q]
    t = int(pa.match_type[q])
    direction = int(sub.rc[row])
    a, b = int(sub.a_id[row]), int(sub.b_id[row])
    length = int(pa.length[q])
    eams, eame = int(pa.eff_a_match_start[q]), int(pa.eff_a_match_end[q])
    ebms, ebme = int(pa.eff_b_match_start[q]), int(pa.eff_b_match_end[q])
    ears, eare = int(pa._ears[q]), int(pa._eare[q])
    ebrs, ebre = int(pa._ebrs[q]), int(pa._ebre[q])
    if t == CL.FORWARD:
        return (
            f"{a} {b} {length} 0 {direction} 0 -1 "
            f"[{eams} {eame}] [{ebms} {ebme}] [{ears} {eare}] [{ebrs} {ebre}]"
        )
    if t == CL.BACKWARD:
        return (
            f"{b} {a} {length} {direction} 0 0 -1 "
            f"[{ebms} {ebme}] [{eams} {eame}] [{ebrs} {ebre}] [{ears} {eare}]"
        )
    if t == CL.FORWARD_INTERNAL:
        return (
            f"{a} {b} {length} 0 {direction} 1 {hinge_pos} "
            f"[{eams} {eame}] [{ebms} {ebme}] [{ears} {eare}] [{ebrs} {ebre}]"
        )
    return (
        f"{b} {a} {length} {direction} 0 -1 {hinge_pos} "
        f"[{ebms} {ebme}] [{eams} {eame}] [{ebrs} {ebre}] [{ears} {eare}]"
    )


def _g1_line(sub, pa, q) -> str:
    row = pa.rows[q]
    a, b = int(sub.a_id[row]), int(sub.b_id[row])
    tick = "'" if int(sub.rc[row]) else ""
    return (
        f"{a} {b}{tick} {int(pa.length[q])} "
        f"[{int(pa.eff_a_match_start[q])} {int(pa.eff_a_match_end[q])}] "
        f"[{int(pa.eff_b_match_start[q])} {int(pa.eff_b_match_end[q])}] "
        f"[{int(pa._ears[q])} {int(pa._eare[q])}] [{int(pa._ebrs[q])} {int(pa._ebre[q])}]"
    )


def _g2_line(sub, pa, q) -> str:
    row = pa.rows[q]
    a, b = int(sub.a_id[row]), int(sub.b_id[row])
    if int(sub.rc[row]) == 0:
        head = f"{b}' {a}'"
    else:
        head = f"{b} {a}'"
    return (
        f"{head} {int(pa.length[q])} "
        f"[{int(pa.eff_a_match_start[q])} {int(pa.eff_a_match_end[q])}] "
        f"[{int(pa.eff_b_match_start[q])} {int(pa.eff_b_match_end[q])}] "
        f"[{int(pa._ears[q])} {int(pa._eare[q])}] [{int(pa._ebrs[q])} {int(pa._ebre[q])}]"
    )
