"""Stage 2 — maximal-read selection (contained-read removal).

Port of `hinge_tpu/stages/maximal.py` (reference `src/maximal/maximal.cpp`)
with its imports swapped: the per-pair top-2 selection and the
containment sweep are host code, the sweep and the trim in the native
library (hinge_tpu's Python sweep and device trim for a missing one are
not carried over).  Outputs X.max and X.contained.txt; `read_mas` (copied verbatim) reads X.mas
back for the maximal and layout verbs of the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hinge_tpu_torch.config import Config
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore
from hinge_tpu_torch.ops import classify as CL
from hinge_tpu_torch.ops.pairs import process_alignments, top_k_per_pair
from hinge_tpu_torch.parallel.sharding import sharded_top_k_per_pair, stage_mesh


def _top_k(sub: OverlapStore, k: int, device) -> np.ndarray:
    """Per-(A,B) top-k; HINGE_SHARDED=1 partitions at --mlas (A-id)
    boundaries over the mesh of `device` — identical emission order, so
    stage files byte-match."""
    mesh = stage_mesh(device)
    if mesh is not None:
        return sharded_top_k_per_pair(sub, k, mesh.size)
    return top_k_per_pair(sub, k=k)


def _native_sweep(a_ids, b_ids, is_bcovera, active):
    """Containment sweep via native/sweeps.cpp::containment_sweep; mutates
    `active` in place and returns the (read, containing) pairs."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    a = np.ascontiguousarray(a_ids, np.int32)
    b = np.ascontiguousarray(b_ids, np.int32)
    f = np.ascontiguousarray(is_bcovera, np.uint8)
    act = active.view(np.uint8) if active.dtype == np.bool_ else active
    act = np.ascontiguousarray(act)
    out = np.empty(2 * max(len(a), 1), np.int32)
    n = lib.containment_sweep(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(a)),
        act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    active[:] = act.view(np.bool_) if active.dtype == np.bool_ else act
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


@dataclasses.dataclass
class MaximalResult:
    active: np.ndarray  # bool [n_reads] after containment removal
    contained: List[Tuple[int, int]]  # (read, containing_read)


def read_mas(path: str, n_reads: int) -> Tuple[np.ndarray, np.ndarray]:
    eff = np.zeros((n_reads, 2), dtype=np.int32)
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) >= 3:
                eff[int(t[0])] = (int(t[1]), int(t[2]))
    return eff[:, 0].copy(), eff[:, 1].copy()


def run_maximal(
    rs: ReadStore,
    parts: Sequence[OverlapStore],
    cfg: Config,
    eff_start: np.ndarray,
    eff_end: np.ndarray,
    out_prefix: Optional[str] = None,
    has_db: bool = True,
    *,
    device,
) -> MaximalResult:
    f = cfg.filter
    active = (eff_end - eff_start) >= f.length_threshold  # maximal.cpp:541-548

    contained_pairs: List[Tuple[int, int]] = []
    max_lines: List[int] = []

    for part in parts:
        if part.n == 0:
            continue
        r_begin = int(part.a_id[0])
        r_end = int(part.a_id[-1])
        nonself = part.a_id != part.b_id
        sub = part.take(np.nonzero(nonself)[0])

        k = 2 if cfg.layout.use_two_matches else 1
        cand = _top_k(sub, k, device)
        pa = process_alignments(
            sub, cand, eff_start, eff_end,
            f.aln_threshold, f.theta, f.theta2, trim=has_db,
        )

        a_ids = sub.a_id[cand]
        b_ids = sub.b_id[cand]
        is_bcovera = pa.match_type == CL.BCOVERA

        # sequential containment sweep in ascending read order (earlier
        # contained reads can no longer contain), in one native C pass
        order = np.argsort(a_ids, kind="stable")
        contained_pairs.extend(_native_sweep(
            a_ids[order], b_ids[order], is_bcovera[order], active))

        max_lines.extend(
            (r_begin + np.nonzero(active[r_begin : r_end + 1])[0]).tolist())

    if out_prefix is not None:
        with open(out_prefix + ".max", "w") as fo:
            for i in max_lines:
                fo.write(f"{i}\n")
        with open(out_prefix + ".contained.txt", "w") as fo:
            for i, c in contained_pairs:
                fo.write(f"{i}\t{c}\n")
    return MaximalResult(active=active, contained=contained_pairs)
