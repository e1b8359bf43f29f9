"""Build the port's stores and config from plain field values.

Each function takes a dict of numpy arrays and plain values (for instance
`vars(store)` or `dataclasses.asdict(cfg)` of an object made elsewhere)
and returns the port's own object, so that no caller hands the port an
object of another package.  Keys that are not fields of the port's class
are ignored; the arrays are taken as they are, without a copy.
"""

from __future__ import annotations

import dataclasses

from hinge_tpu_torch.config import (Config, ConsensusParams, DraftParams,
                                    FilterParams, LayoutParams, RunningParams)
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore


def _fields(cls, values: dict, skip=()) -> dict:
    names = {f.name for f in dataclasses.fields(cls)} - set(skip)
    return {k: values[k] for k in names if k in values}


def read_store_from_arrays(fields: dict) -> ReadStore:
    """A ReadStore from its field arrays (`length`, `bases_off`, `bases`,
    `qv_off`, `qv_val`, `names`)."""
    kw = _fields(ReadStore, fields)
    if kw.get("names") is not None:
        kw["names"] = list(kw["names"])
    return ReadStore(**kw)


def overlap_store_from_arrays(fields: dict) -> OverlapStore:
    """An OverlapStore from its column arrays and `tspace`; the row-pointer
    cache (`_row_ptr`) is not carried and is rebuilt on first use."""
    return OverlapStore(**_fields(OverlapStore, fields, skip=("_row_ptr",)))


_SECTIONS = {"filter": FilterParams, "running": RunningParams,
             "layout": LayoutParams, "draft": DraftParams,
             "consensus": ConsensusParams}


def config_from_dict(d: dict) -> Config:
    """A Config from a nested dict of its sections' fields."""
    return Config(**{name: cls(**_fields(cls, d[name]))
                     for name, cls in _SECTIONS.items() if name in d})
