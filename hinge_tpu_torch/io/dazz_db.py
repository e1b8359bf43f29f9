"""Copied from hinge_tpu/io/dazz_db.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

DAZZ_DB `.db` database reader/writer.

On-disk layout (reference `src/lib/DB.c`, `src/include/DB.h:195-290`):

* stub file `X.db` (text): ``files = N`` + per-file ``lastread prolog fname``
  lines, ``blocks = N`` + block index, and
  ``size = S cutoff = C all = A`` parameters (DB.h:299-311),
* hidden `.X.idx`: a raw little-endian dump of the `HITS_DB` struct (112
  bytes on LP64) followed by `ureads` `HITS_READ` records (40 bytes each:
  origin, rlen, fpulse, pad, boff i64, coff i64, flags, pad),
* hidden `.X.bps`: 2-bit packed bases, 4/byte, first base in the two high
  bits (Compress_Read, DB.c:288-308); read i starts at byte `boff`,
* quality track `.X.qual.anno` (+ `.qual.data`): int32 tracklen, int32
  size(=8), then (n+1) int64 offsets into the uint8 data file
  (Load_Track, DB.c:1137-1250).

Reading applies Trim_DB semantics (DB.c:585-605: keep reads with
``(flags & DB_BEST) >= allflag and rlen >= cutoff``) because `.las` read ids
refer to the trimmed database (LAInterface::openDB calls Open_DB+Trim_DB,
LAInterface.cpp:137-155).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from hinge_tpu_torch.data.overlaps import INT, ReadStore

DB_QV = 0x03FF
DB_CSS = 0x0400
DB_BEST = 0x0800

_HITS_DB = np.dtype(
    [
        ("ureads", "<i4"), ("treads", "<i4"), ("cutoff", "<i4"), ("all", "<i4"),
        ("freq", "<f4", (4,)),
        ("maxlen", "<i4"), ("_pad0", "<i4"),
        ("totlen", "<i8"),
        ("nreads", "<i4"), ("trimmed", "<i4"), ("part", "<i4"),
        ("ufirst", "<i4"), ("tfirst", "<i4"), ("_pad1", "<i4"),
        ("path", "<u8"), ("loaded", "<i4"), ("_pad2", "<i4"),
        ("bases", "<u8"), ("reads", "<u8"), ("tracks", "<u8"),
    ]
)
assert _HITS_DB.itemsize == 112, _HITS_DB.itemsize

_HITS_READ = np.dtype(
    [
        ("origin", "<i4"), ("rlen", "<i4"), ("fpulse", "<i4"), ("_pad0", "<i4"),
        ("boff", "<i8"), ("coff", "<i8"),
        ("flags", "<i4"), ("_pad1", "<i4"),
    ]
)
assert _HITS_READ.itemsize == 40, _HITS_READ.itemsize


def _db_paths(path: str) -> Tuple[str, str, str]:
    if path.endswith(".db"):
        path = path[:-3]
    pwd, root = os.path.split(path)
    pwd = pwd or "."
    return path + ".db", os.path.join(pwd, f".{root}.idx"), os.path.join(pwd, f".{root}.bps")


def _track_paths(path: str, name: str) -> Tuple[str, str]:
    if path.endswith(".db"):
        path = path[:-3]
    pwd, root = os.path.split(path)
    pwd = pwd or "."
    return (
        os.path.join(pwd, f".{root}.{name}.anno"),
        os.path.join(pwd, f".{root}.{name}.data"),
    )


def read_db(path: str, load_bases: bool = True, load_qual: bool = True) -> ReadStore:
    """Open + trim a DAZZ_DB database into a ReadStore."""
    stub_path, idx_path, bps_path = _db_paths(path)
    cutoff, allv = -1, 1
    names = None
    with open(stub_path) as f:
        stub = f.read()
    for line in stub.splitlines():
        t = line.split()
        if t[:1] == ["size"] or (len(t) >= 6 and t[0] == "size"):
            # "size = S cutoff = C all = A"
            try:
                cutoff = int(t[t.index("cutoff") + 2])
                allv = int(t[t.index("all") + 2])
            except (ValueError, IndexError):
                pass

    with open(idx_path, "rb") as f:
        hdr = np.frombuffer(f.read(_HITS_DB.itemsize), dtype=_HITS_DB)[0]
        ureads = int(hdr["ureads"])
        recs = np.frombuffer(f.read(ureads * _HITS_READ.itemsize), dtype=_HITS_READ)
    if len(recs) != ureads:
        raise ValueError(f"{idx_path}: truncated index ({len(recs)}/{ureads} reads)")

    # Trim_DB keep mask
    if int(hdr["cutoff"]) > 0 or cutoff > 0:
        cutoff = max(cutoff, int(hdr["cutoff"]))
    allflag = 0 if allv else DB_BEST
    keep = ((recs["flags"] & DB_BEST) >= allflag) & (recs["rlen"] >= max(cutoff, 0))
    kept = recs[keep]

    length = kept["rlen"].astype(INT)
    n = len(kept)
    bases_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(length, out=bases_off[1:])
    bases = None
    if load_bases:
        with open(bps_path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        bases = np.empty(int(bases_off[-1]), dtype=np.uint8)
        for i in range(n):
            rlen = int(kept["rlen"][i])
            nby = (rlen + 3) // 4
            chunk = raw[int(kept["boff"][i]) : int(kept["boff"][i]) + nby]
            # unpack: first base in bits 7-6 (Compress_Read)
            ex = np.empty(nby * 4, dtype=np.uint8)
            ex[0::4] = (chunk >> 6) & 3
            ex[1::4] = (chunk >> 4) & 3
            ex[2::4] = (chunk >> 2) & 3
            ex[3::4] = chunk & 3
            bases[bases_off[i] : bases_off[i + 1]] = ex[:rlen]

    qv_off = qv_val = None
    if load_qual:
        anno_path, data_path = _track_paths(path, "qual")
        if os.path.exists(anno_path) and os.path.exists(data_path):
            with open(anno_path, "rb") as f:
                tracklen, size = np.frombuffer(f.read(8), dtype="<i4")
                anno = np.frombuffer(f.read(), dtype="<i8" if size == 8 else "<i4")
            with open(data_path, "rb") as f:
                data = np.frombuffer(f.read(), dtype=np.uint8)
            if tracklen == ureads:
                # untrimmed track: trim alongside (DB.c:612-647)
                starts = anno[:-1][keep]
                ends = anno[1:][keep]
                lens = (ends - starts).astype(np.int64)
                qv_off = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(lens, out=qv_off[1:])
                qv_val = np.concatenate(
                    [data[s:e] for s, e in zip(starts, ends)]
                ) if n else np.zeros(0, np.uint8)
            else:
                qv_off = anno.astype(np.int64)
                qv_val = data

    return ReadStore(
        length=length, qv_off=qv_off, qv_val=qv_val,
        bases_off=bases_off, bases=bases, names=names,
    )


def write_db(
    path: str,
    rs: ReadStore,
    cutoff: int = 0,
    all_reads: int = 1,
    prolog: str = "m000_000",
    n_blocks: int = 1,
) -> None:
    """Write a ReadStore as a DAZZ_DB database (stub + .idx + .bps [+ qual]).

    n_blocks > 1 writes a real DBsplit-style block index (DB.h:299-311:
    "blocks = N" then N+1 " %9d %9d" ufirst/tfirst lines at even read
    boundaries) — the multi-block shape every demo pipeline produces via
    DBsplit (demo/*/run.sh) and the reference's Open_DB parses at
    DB.c:461-490."""
    stub_path, idx_path, bps_path = _db_paths(path)
    n = rs.n_reads
    n_blocks = max(1, min(n_blocks, max(n, 1)))
    with open(stub_path, "w") as f:
        f.write(f"files = {1:9d}\n")
        f.write(f"  {n:9d} {prolog} {os.path.basename(stub_path)[:-3]}\n")
        f.write(f"blocks = {n_blocks:9d}\n")
        f.write(f"size = {200000000:10d} cutoff = {cutoff:9d} all = {all_reads:1d}\n")
        for b in range(n_blocks + 1):
            edge = n * b // n_blocks
            f.write(f" {edge:9d} {edge:9d}\n")

    recs = np.zeros(n, dtype=_HITS_READ)
    recs["origin"] = np.arange(1, n + 1)
    recs["rlen"] = rs.length
    recs["fpulse"] = 0
    recs["flags"] = DB_BEST
    boff = 0
    packed_chunks = []
    for i in range(n):
        recs["boff"][i] = boff
        codes = rs.get_bases(i)
        rlen = len(codes)
        nby = (rlen + 3) // 4
        padded = np.zeros(nby * 4, dtype=np.uint8)
        padded[:rlen] = codes
        b = (
            (padded[0::4] << 6) | (padded[1::4] << 4) | (padded[2::4] << 2) | padded[3::4]
        ).astype(np.uint8)
        packed_chunks.append(b)
        boff += nby

    hdr = np.zeros(1, dtype=_HITS_DB)
    hdr["ureads"] = n
    hdr["treads"] = n
    hdr["cutoff"] = cutoff
    hdr["all"] = all_reads
    hdr["maxlen"] = int(rs.length.max()) if n else 0
    hdr["totlen"] = int(rs.length.sum())
    hdr["nreads"] = n
    with open(idx_path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(recs.tobytes())
    with open(bps_path, "wb") as f:
        for b in packed_chunks:
            f.write(b.tobytes())

    if rs.has_qv():
        anno_path, data_path = _track_paths(path, "qual")
        with open(anno_path, "wb") as f:
            f.write(np.array([n, 8], dtype="<i4").tobytes())
            f.write(rs.qv_off.astype("<i8").tobytes())
        with open(data_path, "wb") as f:
            f.write(rs.qv_val.astype(np.uint8).tobytes())
