"""Frozen copies of the port's FASTA and `.las` writers
(hinge_tpu_torch/io/fasta.py::write_fasta, io/las.py::write_las),
rewritten to import nothing of the port; the bytes they write are the
port's.  write_fasta takes a read store and writes one line a read.

`.las` layout (DALIGNER, `align.h`): int64 novl, int32 tspace, then per
record 40 bytes (tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread,
bread, pad) and tlen trace values, uint8 when tspace <= 125, else uint16.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic.stores import OverlapStore, ReadStore

TRACE_XOVR = 125
_REC_BYTES = 40
_HDR = np.dtype([("tlen", "<i4"), ("diffs", "<i4"), ("abpos", "<i4"),
                 ("bbpos", "<i4"), ("aepos", "<i4"), ("bepos", "<i4"),
                 ("flags", "<u4"), ("aread", "<i4"), ("bread", "<i4"),
                 ("pad", "<i4")])
_CODE2CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path: str, rs: ReadStore) -> None:
    """`rs`'s reads, one line each, named as the store names them: the
    bytes of the port's write_fasta over (names[i], get_seq(i))."""
    with open(path, "wb") as f:
        for i in range(rs.n_reads):
            f.write(b">" + rs.names[i].encode() + b"\n")
            f.write(_CODE2CHAR[rs.get_bases(i)].tobytes() + b"\n")


def write_las(path: str, ov: OverlapStore) -> None:
    """`ov` as a `.las` file (the port's write_las, its frames and traces
    gathered into one buffer before the write)."""
    tspace = ov.tspace
    small = tspace <= TRACE_XOVR
    n = ov.n
    recs = np.zeros(n, dtype=_HDR)
    recs["tlen"] = ov.tlen
    recs["diffs"] = ov.diffs
    recs["abpos"] = ov.a_start
    recs["aepos"] = ov.a_end
    # un-flip B coords for rc records
    recs["bbpos"] = np.where(ov.rc == 1, ov.b_len - ov.b_end, ov.b_start)
    recs["bepos"] = np.where(ov.rc == 1, ov.b_len - ov.b_start, ov.b_end)
    recs["flags"] = ov.rc.astype(np.uint32)
    recs["aread"] = ov.a_id
    recs["bread"] = ov.b_id
    tbytes = 1 if small else 2
    tl = ov.tlen.astype(np.int64)
    size = _REC_BYTES + tbytes * tl
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(size, out=start[1:])
    buf = np.zeros(int(start[-1]), dtype=np.uint8)
    frames = recs.view(np.uint8).reshape(n, _REC_BYTES)
    buf[(start[:-1, None] + np.arange(_REC_BYTES)[None, :]).reshape(-1)] = \
        frames.reshape(-1)
    # trace values: the gather of each record's slice, in record order
    idx = np.repeat(ov.trace_off - np.cumsum(np.concatenate([[0], tl[:-1]])),
                    tl) + np.arange(int(tl.sum()))
    tr = ov.trace[idx]
    tpos = np.repeat(start[:-1] + _REC_BYTES, tl) + tbytes * (
        np.arange(int(tl.sum())) - np.repeat(np.cumsum(tl) - tl, tl))
    if small:
        buf[tpos] = tr.astype(np.uint8)
    else:
        le = tr.astype("<u2").view(np.uint8).reshape(-1, 2)
        buf[tpos] = le[:, 0]
        buf[tpos + 1] = le[:, 1]
    with open(path, "wb") as f:
        f.write(np.int64(n).tobytes())
        f.write(np.int32(tspace).tobytes())
        f.write(buf.tobytes())
