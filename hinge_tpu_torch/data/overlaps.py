"""Copied from hinge_tpu/data/overlaps.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Columnar overlap / read stores — the core data model.

The reference materializes one heap-allocated ``LOverlap`` object per `.las`
record and builds hash-map pileups (`filter.cpp:522-583`).  Here overlap
records are a struct-of-arrays of int32 columns, sorted by A-read id (the
natural `.las` order), with a CSR ``row_ptr`` over A-ids replacing the
``idx_pileup`` hash maps.  This is the layout every TPU kernel consumes:
dense, static-shaped, shardable by contiguous A-id ranges (the reference's
``--mlas`` partitioning, `filter.cpp:35-63`).

Coordinate convention (matches `LAInterface::getOverlap`,
`LAInterface.cpp:1606-1626`): all B coordinates are stored on B's *forward*
strand; for reverse-complement matches the raw (bbpos, bepos) from the
overlapper are flipped to (blen-bepos, blen-bbpos).

Trace points (DALIGNER pass-through points, `align.h:88-125`): flat uint16
array of (diff, b-displacement) pairs per overlap, with per-overlap offsets.
The b-displacements let coordinate walks (`trim_overlap`,
`GetMatchingPosition`) run without touching sequence data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INT = np.int32


@dataclasses.dataclass
class ReadStore:
    """Per-read table (reference `Read` class, LAInterface.h:14-28)."""

    length: np.ndarray  # int32 [n_reads]
    # QV stream per tspace-segment, ragged (reference qual track, getQV):
    qv_off: Optional[np.ndarray] = None  # int64 [n_reads+1]
    qv_val: Optional[np.ndarray] = None  # uint8 flat
    # 2-bit packed bases, ragged; populated for draft/consensus stages:
    bases_off: Optional[np.ndarray] = None  # int64 [n_reads+1], offsets in bases
    bases: Optional[np.ndarray] = None  # uint8 flat, one base per byte (0..3)
    names: Optional[list] = None

    @property
    def n_reads(self) -> int:
        return int(self.length.shape[0])

    def has_qv(self) -> bool:
        return self.qv_off is not None

    def get_bases(self, i: int) -> np.ndarray:
        return self.bases[self.bases_off[i] : self.bases_off[i + 1]]

    def get_seq(self, i: int) -> str:
        return codes_to_str(self.get_bases(i))


_CODE2CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)
_CHAR2CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CHAR2CODE[_c] = _i
    _CHAR2CODE[_c + 32] = _i  # lowercase


def str_to_codes(s: str) -> np.ndarray:
    a = np.frombuffer(s.encode(), dtype=np.uint8)
    return _CHAR2CODE[a]


def codes_to_str(codes: np.ndarray) -> str:
    return _CODE2CHAR[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


@dataclasses.dataclass
class OverlapStore:
    """Struct-of-arrays of overlap records, sorted by (a_id, input order)."""

    a_id: np.ndarray  # int32 [n]
    b_id: np.ndarray  # int32 [n]
    a_len: np.ndarray  # int32 [n]
    b_len: np.ndarray  # int32 [n]
    a_start: np.ndarray  # int32 [n]  read_A_match_start_
    a_end: np.ndarray  # int32 [n]    read_A_match_end_
    b_start: np.ndarray  # int32 [n]  read_B_match_start_ (fwd strand)
    b_end: np.ndarray  # int32 [n]    read_B_match_end_   (fwd strand)
    rc: np.ndarray  # int32 [n]       reverse_complement_match_
    diffs: np.ndarray  # int32 [n]
    # trace points: uint16 pairs (diffs, b-displacement); tlen = #values
    tlen: np.ndarray  # int32 [n]
    trace_off: np.ndarray  # int64 [n]
    trace: np.ndarray  # uint16 flat
    tspace: int = 100
    # CSR over a_id (built lazily)
    _row_ptr: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.a_id.shape[0])

    def row_ptr(self, n_reads: int) -> np.ndarray:
        """CSR offsets: overlaps of A-read r are rows [row_ptr[r], row_ptr[r+1])."""
        if self._row_ptr is None or self._row_ptr.shape[0] != n_reads + 1:
            counts = np.bincount(self.a_id, minlength=n_reads)
            self._row_ptr = np.zeros(n_reads + 1, dtype=np.int64)
            np.cumsum(counts, out=self._row_ptr[1:])
        return self._row_ptr

    def match_len(self) -> np.ndarray:
        """compare_overlap key: summed match length (LAInterface.cpp:4884-4889)."""
        return (self.a_end - self.a_start) + (self.b_end - self.b_start)

    def trace_pairs(self, i: int) -> np.ndarray:
        """Trace values of overlap i as (tlen/2, 2) array of (diff, b-disp)."""
        t = self.trace[self.trace_off[i] : self.trace_off[i] + self.tlen[i]]
        return t.reshape(-1, 2)

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
        """Stable sort by a_id, preserving input order inside a pileup
        (matches `.las` merge order that the reference streams in)."""
        order = np.argsort(self.a_id, kind="stable")
        return self.take(order)

    def take(self, idx: np.ndarray) -> "OverlapStore":
        return OverlapStore(
            a_id=self.a_id[idx],
            b_id=self.b_id[idx],
            a_len=self.a_len[idx],
            b_len=self.b_len[idx],
            a_start=self.a_start[idx],
            a_end=self.a_end[idx],
            b_start=self.b_start[idx],
            b_end=self.b_end[idx],
            rc=self.rc[idx],
            diffs=self.diffs[idx],
            tlen=self.tlen[idx],
            trace_off=self.trace_off[idx],
            trace=self.trace,
            tspace=self.tspace,
        )

    def compact_traces(self) -> "OverlapStore":
        """Rebuild the flat trace array so offsets are contiguous ascending."""
        new_off = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(self.tlen, out=new_off[1:])
        new_trace = np.zeros(int(new_off[-1]), dtype=np.uint16)
        for i in range(self.n):
            new_trace[new_off[i] : new_off[i + 1]] = self.trace[
                self.trace_off[i] : self.trace_off[i] + self.tlen[i]
            ]
        out = dataclasses.replace(self, trace_off=new_off[:-1], trace=new_trace)
        out._row_ptr = None
        return out
