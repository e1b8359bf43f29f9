"""Copied from hinge_tpu/io/las.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch, without the numpy reader that hinge_tpu falls back to when
its native library does not build: the port reads with the native parser
only.

DALIGNER `.las` overlap file reader/writer.

Binary layout (reference `src/lib/align.c:3040-3063`, `align.h:126-338`):

    header:  int64 novl, int32 tspace
    record:  the `Overlap` struct minus its leading trace pointer — on LP64:
             tlen, diffs, abpos, bbpos, aepos, bepos (6×int32 from Path),
             flags (uint32), aread, bread (int32), 4 bytes struct padding
             = 40 bytes, followed by the trace: tlen values of uint8 when
             tspace <= TRACE_XOVR (=125, `align.h:58`), else uint16.

B-coordinate flip for reverse-complement records follows
`LAInterface::getOverlap` (LAInterface.cpp:1606-1626): raw (bbpos, bepos)
address the complemented B; we store blen-bepos / blen-bbpos (forward strand).
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Tuple

import numpy as np

from hinge_tpu_torch.data.overlaps import INT, OverlapStore

TRACE_XOVR = 125
_REC_BYTES = 40
_HDR = np.dtype(
    [
        ("tlen", "<i4"),
        ("diffs", "<i4"),
        ("abpos", "<i4"),
        ("bbpos", "<i4"),
        ("aepos", "<i4"),
        ("bepos", "<i4"),
        ("flags", "<u4"),
        ("aread", "<i4"),
        ("bread", "<i4"),
        ("pad", "<i4"),
    ]
)


def read_las(
    path: str,
    read_lengths: Optional[np.ndarray] = None,
) -> OverlapStore:
    """Parse a `.las` file into an OverlapStore with the native C++ parser
    (native/io_native.cpp).

    ``read_lengths`` supplies a_len/b_len (the `.las` itself has no lengths —
    the reference fetches them from the DB, LAInterface.cpp:1591-1592). If
    None, lengths are left as 0 and must be joined later.

    A missing or unreadable file raises its OSError, one shorter than the
    12-byte header, cut inside a record or with bytes after the last record
    a ValueError.
    """
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    novl = ctypes.c_int64()
    tspace = ctypes.c_int32()
    total_trace = ctypes.c_int64()
    rcode = lib.las_scan(
        path.encode(), ctypes.byref(novl), ctypes.byref(tspace), ctypes.byref(total_trace)
    )
    if rcode == -2:
        raise ValueError(f"{path}: truncated las file")
    if rcode == -3:
        raise ValueError(f"{path}: trailing bytes after records")
    if rcode == -1:
        # the file did not open or holds no header: opening it raises the
        # OSError, else the header is short
        with open(path, "rb") as f:
            size = len(f.read(12))
        raise ValueError(
            f"{path}: {size} bytes, shorter than the 12-byte las header"
            if size < 12 else f"{path}: native las_scan could not read it")
    if rcode != 0:
        raise ValueError(f"{path}: native las_scan failed (rcode {rcode})")
    n = int(novl.value)
    cols = {k: np.zeros(n, dtype=INT) for k in (
        "a_id b_id a_len b_len a_start a_end b_start b_end rc diffs tlen".split()
    )}
    trace_off = np.zeros(n, dtype=np.int64)
    trace = np.zeros(int(total_trace.value), dtype=np.uint16)
    if read_lengths is not None:
        rl = np.ascontiguousarray(read_lengths, dtype=np.int32)
        rl_ptr = rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_reads = len(rl)
    else:
        rl_ptr = None
        n_reads = 0

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rcode = lib.las_parse(
        path.encode(), rl_ptr, ctypes.c_int64(n_reads),
        ptr(cols["a_id"], ctypes.c_int32), ptr(cols["b_id"], ctypes.c_int32),
        ptr(cols["a_len"], ctypes.c_int32), ptr(cols["b_len"], ctypes.c_int32),
        ptr(cols["a_start"], ctypes.c_int32), ptr(cols["a_end"], ctypes.c_int32),
        ptr(cols["b_start"], ctypes.c_int32), ptr(cols["b_end"], ctypes.c_int32),
        ptr(cols["rc"], ctypes.c_int32), ptr(cols["diffs"], ctypes.c_int32),
        ptr(cols["tlen"], ctypes.c_int32), ptr(trace_off, ctypes.c_int64),
        ptr(trace, ctypes.c_uint16),
    )
    if rcode != 0:
        # scan succeeded but parse disagreed: that is a native-path bug or a
        # file mutated between the two passes
        raise ValueError(
            f"{path}: native las_parse failed after a successful scan "
            f"(rcode {rcode})"
        )
    return OverlapStore(
        trace_off=trace_off, trace=trace, tspace=int(tspace.value), **cols
    )


def write_las(path: str, ov: OverlapStore, tspace: Optional[int] = None) -> None:
    """Write an OverlapStore as a `.las` file (inverse of read_las)."""
    tspace = tspace if tspace is not None else ov.tspace
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

    with open(path, "wb") as f:
        f.write(np.int64(n).tobytes())
        f.write(np.int32(tspace).tobytes())
        frames = recs.view(np.uint8).reshape(n, _REC_BYTES) if n else np.zeros((0, _REC_BYTES), np.uint8)
        for k in range(n):
            f.write(frames[k].tobytes())
            tl = int(ov.tlen[k])
            tr = ov.trace[ov.trace_off[k] : ov.trace_off[k] + tl]
            if small:
                f.write(tr.astype(np.uint8).tobytes())
            else:
                f.write(tr.astype("<u2").tobytes())


def merge_las(paths, out_path: Optional[str] = None,
              read_lengths: Optional[np.ndarray] = None) -> OverlapStore:
    """LAmerge equivalent (reference `README.md:101`; DALIGNER submodule is
    empty in the checkout, so semantics follow LAsort's documented record
    order): k-way merge of sorted `.las` parts on (aread, bread, comp flag,
    abpos), ties keeping input-file order.  Inputs need not actually be
    sorted — unsorted parts simply get sorted, like running LAsort first.

    Returns the merged store; also writes ``out_path`` when given.
    """
    stores = [read_las(p, read_lengths=read_lengths) for p in paths]
    if not stores:
        raise ValueError("merge_las: no input files")
    tspace = stores[0].tspace
    for p, s in zip(paths[1:], stores[1:]):
        if s.tspace != tspace:
            raise ValueError(
                f"merge_las: {p} has tspace {s.tspace} != {tspace}")
    cols = {}
    for k in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
              "b_start", "b_end", "rc", "diffs", "tlen"):
        cols[k] = np.concatenate([getattr(s, k) for s in stores])
    # trace offsets shift by the cumulative trace length of earlier parts
    tr_base = np.cumsum([0] + [len(s.trace) for s in stores[:-1]])
    cols["trace_off"] = np.concatenate(
        [s.trace_off + b for s, b in zip(stores, tr_base)])
    trace = np.concatenate([s.trace for s in stores]) if stores else np.zeros(0, np.uint16)
    # raw bbpos (pre-flip) is what LAsort compares; our b_start is the
    # forward-strand flip, so recover abpos ordering keys only (aread,
    # bread, comp, abpos) — abpos is stored unflipped in a_start.
    order = np.lexsort((cols["a_start"], cols["rc"], cols["b_id"], cols["a_id"]))
    merged = OverlapStore(trace=trace, tspace=tspace,
                          **{k: v for k, v in cols.items()}).take(order)
    if out_path is not None:
        write_las(out_path, merged)
    return merged


def split_las(ov: OverlapStore, n_reads: int, max_records: int,
              split_pileups: bool = False):
    """Partition a store into A-id-contiguous parts (reference `split_las.py`:
    wraps DAZZ_DB LAsplit to shard by size; here we shard by record count).

    split_pileups=False never cuts inside one A-read's record run.
    split_pileups=True cuts at EXACTLY max_records, so one A-read's
    records can straddle a part boundary — the shape a DBsplit-block-
    aligned LAsplit produces on real data, and the one that exercises the
    reference's per-part mask/MIN_COV carry-over quirks
    (filter.cpp:474-510 reruns the whole pileup logic per part)."""
    if split_pileups:
        return [ov.take(np.arange(s, min(s + max_records, ov.n)))
                for s in range(0, max(ov.n, 1), max_records)]
    rp = ov.row_ptr(n_reads)
    parts = []
    start_row = 0
    start_read = 0
    for r in range(1, n_reads + 1):
        if rp[r] - start_row > max_records and rp[r - 1] > start_row:
            parts.append(ov.take(np.arange(start_row, rp[r - 1])))
            start_row = int(rp[r - 1])
            start_read = r - 1
    parts.append(ov.take(np.arange(start_row, ov.n)))
    return parts
