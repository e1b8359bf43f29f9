"""Copied from hinge_tpu/io/paf.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

PAF (minimap) overlap reader (reference `src/lib/paf.c` + loadPAF,
LAInterface.cpp:4822-4845).

The reference extracts numeric read ids from PacBio-style names
`x/123/y` via `get_id_from_string` (LAInterface.cpp:4806-4819) and converts
1-based to 0-based. Coordinates are taken verbatim: qs/qe -> A match,
ts/te -> B match (already forward-strand in PAF), `rev` -> rc. No trace
points exist in PAF mode (the reference leaves trace_pts unset and the
pipeline runs with trim=false, maximal.cpp:548).
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from hinge_tpu_torch.data.overlaps import INT, OverlapStore


def _get_id_from_string(name: str) -> int:
    """PacBio name `prefix/<id>/range` -> int id (LAInterface.cpp:4806-4819)."""
    parts = name.split("/")
    return int(parts[1])


def _open(path: str):
    with open(path, "rb") as probe:
        if probe.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt")
    return open(path, "rt")


def read_paf(path: str, name_to_id=None) -> OverlapStore:
    """Parse PAF into an OverlapStore.

    ``name_to_id``: optional dict mapping read names to 0-based ids. Default
    uses the reference's PacBio-name convention (1-based id in 2nd slash
    field).
    """
    cols = {k: [] for k in "a_id b_id a_len b_len a_start a_end b_start b_end rc".split()}
    with _open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 11:
                continue
            qn, ql, qs, qe, strand, tn, tl, ts, te = (
                t[0], int(t[1]), int(t[2]), int(t[3]), t[4], t[5], int(t[6]), int(t[7]), int(t[8]),
            )
            if name_to_id is not None:
                aid, bid = name_to_id[qn], name_to_id[tn]
            else:
                aid = _get_id_from_string(qn) - 1
                bid = _get_id_from_string(tn) - 1
            cols["a_id"].append(aid)
            cols["b_id"].append(bid)
            cols["a_len"].append(ql)
            cols["b_len"].append(tl)
            cols["a_start"].append(qs)
            cols["a_end"].append(qe)
            cols["b_start"].append(ts)
            cols["b_end"].append(te)
            cols["rc"].append(1 if strand == "-" else 0)
    return OverlapStore.from_arrays(**{k: np.asarray(v) for k, v in cols.items()}).sort_by_a()


def write_paf(path: str, ov: OverlapStore, names=None) -> None:
    def nm(i):
        return names[i] if names is not None else f"sim/{i+1}/0_0"

    with open(path, "w") as f:
        for k in range(ov.n):
            f.write(
                "\t".join(
                    str(x)
                    for x in (
                        nm(ov.a_id[k]), ov.a_len[k], ov.a_start[k], ov.a_end[k],
                        "-" if ov.rc[k] else "+",
                        nm(ov.b_id[k]), ov.b_len[k], ov.b_start[k], ov.b_end[k],
                        ov.a_end[k] - ov.a_start[k], ov.a_end[k] - ov.a_start[k], 255,
                    )
                )
                + "\n"
            )
