"""Frozen copy of the parts of hinge_tpu_torch/data/overlaps.py that the
benchmark's simulator and writers use: the columnar read and overlap
stores, with the logic verbatim.

Coordinate convention (`LAInterface::getOverlap`): all B coordinates are
stored on B's forward strand; for reverse-complement matches the raw
(bbpos, bepos) are flipped to (blen-bepos, blen-bbpos).  Trace points
are a flat uint16 array of (diff, b-displacement) pairs per overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INT = np.int32

_CODE2CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)


def codes_to_str(codes: np.ndarray) -> str:
    return _CODE2CHAR[codes].tobytes().decode()


@dataclasses.dataclass
class ReadStore:
    """Per-read table: lengths, QV track, bases (0..3, one a byte), names."""

    length: np.ndarray  # int32 [n_reads]
    qv_off: Optional[np.ndarray] = None  # int64 [n_reads+1]
    qv_val: Optional[np.ndarray] = None  # uint8 flat
    bases_off: Optional[np.ndarray] = None  # int64 [n_reads+1]
    bases: Optional[np.ndarray] = None  # uint8 flat
    names: Optional[list] = None

    @property
    def n_reads(self) -> int:
        return int(self.length.shape[0])

    def get_bases(self, i: int) -> np.ndarray:
        return self.bases[self.bases_off[i] : self.bases_off[i + 1]]

    def get_seq(self, i: int) -> str:
        return codes_to_str(self.get_bases(i))


@dataclasses.dataclass
class OverlapStore:
    """Struct-of-arrays of overlap records, sorted by (a_id, input order)."""

    a_id: np.ndarray
    b_id: np.ndarray
    a_len: np.ndarray
    b_len: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray  # B's forward strand
    b_end: np.ndarray
    rc: np.ndarray
    diffs: np.ndarray
    tlen: np.ndarray  # trace values a record
    trace_off: np.ndarray  # int64
    trace: np.ndarray  # uint16 flat
    tspace: int = 100

    @property
    def n(self) -> int:
        return int(self.a_id.shape[0])

    @classmethod
    def from_arrays(cls, tspace: int = 100, **cols) -> "OverlapStore":
        n = len(cols["a_id"])
        tlen = cols.get("tlen")
        if tlen is None:
            tlen = np.zeros(n, dtype=INT)
        trace_off = cols.get("trace_off")
        if trace_off is None:
            trace_off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(tlen, out=trace_off[1:])
            trace_off = trace_off[:-1]
        trace = cols.get("trace")
        if trace is None:
            trace = np.zeros(0, dtype=np.uint16)
        return cls(
            a_id=np.asarray(cols["a_id"], dtype=INT),
            b_id=np.asarray(cols["b_id"], dtype=INT),
            a_len=np.asarray(cols["a_len"], dtype=INT),
            b_len=np.asarray(cols["b_len"], dtype=INT),
            a_start=np.asarray(cols["a_start"], dtype=INT),
            a_end=np.asarray(cols["a_end"], dtype=INT),
            b_start=np.asarray(cols["b_start"], dtype=INT),
            b_end=np.asarray(cols["b_end"], dtype=INT),
            rc=np.asarray(cols["rc"], dtype=INT),
            diffs=np.asarray(cols.get("diffs", np.zeros(n)), dtype=INT),
            tlen=np.asarray(tlen, dtype=INT),
            trace_off=np.asarray(trace_off, dtype=np.int64),
            trace=np.asarray(trace, dtype=np.uint16),
            tspace=tspace,
        )

    def sort_by_a(self) -> "OverlapStore":
        """Stable sort by a_id, input order kept inside a pileup."""
        order = np.argsort(self.a_id, kind="stable")
        return self.take(order)

    def take(self, idx: np.ndarray) -> "OverlapStore":
        return OverlapStore(
            a_id=self.a_id[idx], b_id=self.b_id[idx],
            a_len=self.a_len[idx], b_len=self.b_len[idx],
            a_start=self.a_start[idx], a_end=self.a_end[idx],
            b_start=self.b_start[idx], b_end=self.b_end[idx],
            rc=self.rc[idx], diffs=self.diffs[idx], tlen=self.tlen[idx],
            trace_off=self.trace_off[idx], trace=self.trace,
            tspace=self.tspace,
        )
