"""Stage 5b — draft assembly (`hinge draft`, reference `src/consensus/draft.cpp`).

All of the stage is `hinge_tpu.stages.draft`, which imports no jax; only
the ladder-window aligner differs.  `run_draft` runs hinge_tpu's own
`run_draft` and `draft_assembly_ctg` code objects with this module's
`_align_ladder_pairs` bound in their globals, so the stage logic is
shared, not copied, and hinge_tpu's module is left untouched.
"""

from __future__ import annotations

import functools
import os
import types
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu.config import Config
from hinge_tpu.data.overlaps import OverlapStore, ReadStore
from hinge_tpu.ops import myers as MY
from hinge_tpu.stages import draft as _shared


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
    env = dict(vars(_shared))
    env["_align_ladder_pairs"] = functools.partial(_align_ladder_pairs,
                                                   device=device)

    def rebind(fn):
        return types.FunctionType(fn.__code__, env, fn.__name__,
                                  fn.__defaults__)

    env["draft_assembly_ctg"] = rebind(_shared.draft_assembly_ctg)
    return rebind(_shared.run_draft)(rs, parts, cfg, maximal,
                                     edges_list_path_or_lines, out_fasta)
