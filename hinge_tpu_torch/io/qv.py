"""Copied from hinge_tpu/io/qv.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

PacBio `.qvs` quality-stream decoder (DAZZ_DB QV codec, read path).

Re-implements the reference's Huffman(+run-length) decompressor for the five
PacBio quality streams — deletion QV, deletion tag, insertion QV, merge QV,
substitution QV — exactly as vendored in the reference:

* coding header + scheme tables: `Read_QVcoding` / `Read_Scheme`
  (src/lib/QV.c:1177-1269, :359-413)
* per-entry stream decode: `Uncompress_Next_QVentry` (QV.c:1353-1406) with
  `Decode` (:547-637, lazy 32-bit refills), `Decode_Run` (:641-760,
  run-char streams with 16-bit escape), 2-bit tag decompression
  `Uncompress_Read`/`Lower_Read` (src/lib/DB.c:311-342) and the packed-tag
  expansion `Unpack_Tag` (QV.c:868-878).
* DB integration: one coding scheme per imported .quiva file, entries at
  each read's `coff` (DB.c `Open_QVs`:821-1035).

This is a capability/compatibility path (the assembly pipeline itself
consumes only the DASqv-style `qual` *track*, which `ops/intrinsic_qv.py`
can also synthesize from `.las` diffs); it is deliberately host Python —
the per-symbol bit loop is cold and tiny next to the overlap stream.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Dict, List, Optional

import numpy as np

_M64 = (1 << 64) - 1
_LETTER = b"acgt"


@dataclasses.dataclass
class HScheme:
    """One Huffman table: code lengths + 16-bit prefix lookup (QV.c:66-77)."""

    type: int
    lens: np.ndarray  # int32 [256]
    lookup: np.ndarray  # int32 [65536]


@dataclasses.dataclass
class QVCoding:
    """Parsed coding block (QV.h:66-77 QVcoding)."""

    flip: bool
    del_char: int  # -1 when the deletion stream is not run-coded
    sub_char: int
    prefix: str
    del_scheme: HScheme
    drun_scheme: Optional[HScheme]
    ins_scheme: HScheme
    mrg_scheme: HScheme
    sub_scheme: HScheme
    srun_scheme: Optional[HScheme]


def _read_scheme(f: BinaryIO, flip: bool) -> HScheme:
    """QV.c Read_Scheme (:359-413): type byte, 256 x (len byte [+ uint32])."""
    t = f.read(1)
    if len(t) != 1:
        raise ValueError("qvs: truncated scheme type byte")
    lens = np.zeros(256, dtype=np.int32)
    bits = np.zeros(256, dtype=np.uint32)
    wfmt = ">I" if flip else "<I"
    for i in range(256):
        x = f.read(1)
        if len(x) != 1:
            raise ValueError(f"qvs: truncated code length {i}")
        lens[i] = x[0]
        if x[0] > 0:
            w = f.read(4)
            if len(w) != 4:
                raise ValueError(f"qvs: truncated code bits {i}")
            bits[i] = struct.unpack(wfmt, w)[0]
    look = np.zeros(65536, dtype=np.int32)
    for i in range(256):
        if lens[i] > 0:
            base = int(bits[i]) << (16 - int(lens[i]))
            powr = 1 << (16 - int(lens[i]))
            look[base : base + powr] = i
    return HScheme(type=t[0], lens=lens, lookup=look)


def read_qvcoding(f: BinaryIO) -> QVCoding:
    """QV.c Read_QVcoding (:1177-1269)."""
    key = struct.unpack("<H", f.read(2))[0]
    flip = key != 0x33CC
    hfmt = ">H" if flip else "<H"
    ifmt = ">i" if flip else "<i"
    del_char = struct.unpack(hfmt, f.read(2))[0]
    if del_char >= 256:
        del_char = -1
    sub_char = struct.unpack(hfmt, f.read(2))[0]
    if sub_char >= 256:
        sub_char = -1
    plen = struct.unpack(ifmt, f.read(4))[0]
    prefix = f.read(plen).decode("latin-1") if plen > 0 else ""
    del_scheme = _read_scheme(f, flip)
    drun = _read_scheme(f, flip) if del_char >= 0 else None
    ins_scheme = _read_scheme(f, flip)
    mrg_scheme = _read_scheme(f, flip)
    sub_scheme = _read_scheme(f, flip)
    srun = _read_scheme(f, flip) if sub_char >= 0 else None
    return QVCoding(
        flip=flip, del_char=del_char, sub_char=sub_char, prefix=prefix,
        del_scheme=del_scheme, drun_scheme=drun, ins_scheme=ins_scheme,
        mrg_scheme=mrg_scheme, sub_scheme=sub_scheme, srun_scheme=srun,
    )


class _BitReader:
    """The Decode loop's 64-bit window with lazy uint32 refills (QV.c GET,
    :575-604).  Each Decode/Decode_Run call gets a FRESH reader — streams
    consume whole uint32 words and trailing bits are discarded."""

    __slots__ = ("f", "flip", "icode", "ilen")

    def __init__(self, f: BinaryIO, flip: bool):
        self.f = f
        self.flip = flip
        self.icode = 0
        self.ilen = 0

    def get(self, n: int) -> None:
        if n > self.ilen:
            w = self.f.read(4)
            if len(w) != 4:
                raise ValueError("qvs: truncated stream (Decode refill)")
            word = struct.unpack(">I" if self.flip else "<I", w)[0]
            # fread(ipart): the new word REPLACES the low 32 bits
            ic = ((self.icode << self.ilen) & _M64) & ~0xFFFFFFFF | word
            k = n - self.ilen
            self.icode = (ic << k) & _M64
            self.ilen = 32 - k
        else:
            self.icode = (self.icode << n) & _M64
            self.ilen -= n

    @property
    def xpart(self) -> int:  # next 16 bits
        return (self.icode >> 32) & 0xFFFF

    @property
    def cpart(self) -> int:  # next 8 bits
        return (self.icode >> 40) & 0xFF


def _decode(scheme: HScheme, f: BinaryIO, rlen: int, flip: bool) -> bytearray:
    """QV.c Decode (:547-637)."""
    signal = 255 if scheme.type == 2 else 256
    lens = scheme.lens
    look = scheme.lookup
    br = _BitReader(f, flip)
    out = bytearray(rlen)
    n = 16
    for j in range(rlen):
        br.get(n)
        c = int(look[br.xpart])
        n = int(lens[c])
        if c == signal:
            br.get(n)
            c = br.cpart
            n = 8
        out[j] = c
    return out


def _decode_run(
    neme: HScheme, reme: HScheme, f: BinaryIO, rlen: int, rchar: int, flip: bool
) -> bytearray:
    """QV.c Decode_Run (:641-760): (run-length, literal) alternation."""
    nsignal = 255 if neme.type == 2 else 256
    br = _BitReader(f, flip)
    out = bytearray(rlen)
    n = 16
    j = 0
    while j < rlen:
        br.get(n)
        c = int(reme.lookup[br.xpart])
        n = int(reme.lens[c])
        if c == 255:
            br.get(n)
            c = br.xpart
            n = 16
        for _ in range(c):
            out[j] = rchar
            j += 1
        if j < rlen:
            br.get(n)
            c = int(neme.lookup[br.xpart])
            n = int(neme.lens[c])
            if c == nsignal:
                br.get(n)
                c = br.cpart
                n = 8
            out[j] = c
        j += 1  # the for-loop increment
    return out


def _unpack_2bit(data: bytes, clen: int) -> bytearray:
    """DB.c Uncompress_Read + Lower_Read (:311-342): 2-bit codes → 'acgt'."""
    out = bytearray(clen)
    for k in range(clen):
        b = data[k >> 2]
        out[k] = _LETTER[(b >> (6 - 2 * (k & 3))) & 3]
    return out


def uncompress_entry(f: BinaryIO, coding: QVCoding, rlen: int) -> Dict[str, bytes]:
    """QV.c Uncompress_Next_QVentry (:1353-1406): the 5 streams of one read."""
    flip = coding.flip
    if coding.del_char < 0:
        del_qv = _decode(coding.del_scheme, f, rlen, flip)
        clen = rlen
    else:
        del_qv = _decode_run(
            coding.del_scheme, coding.drun_scheme, f, rlen, coding.del_char, flip
        )
        clen = sum(1 for q in del_qv if q != coding.del_char)
    tlen = (clen + 3) >> 2
    packed = f.read(tlen) if tlen > 0 else b""
    if len(packed) != tlen:
        raise ValueError("qvs: truncated deletion tag")
    tag = _unpack_2bit(packed, clen)
    if coding.del_char >= 0:
        # Unpack_Tag (QV.c:868-878): expand to rlen, 'n' at del_char slots
        full = bytearray(rlen)
        j = clen - 1
        for k in range(rlen - 1, -1, -1):
            if del_qv[k] == coding.del_char:
                full[k] = ord("n")
            else:
                full[k] = tag[j]
                j -= 1
        tag = full
    ins_qv = _decode(coding.ins_scheme, f, rlen, flip)
    mrg_qv = _decode(coding.mrg_scheme, f, rlen, flip)
    if coding.sub_char < 0:
        sub_qv = _decode(coding.sub_scheme, f, rlen, flip)
    else:
        sub_qv = _decode_run(
            coding.sub_scheme, coding.srun_scheme, f, rlen, coding.sub_char, flip
        )
    return {
        "del_qv": bytes(del_qv),
        "del_tag": bytes(tag),
        "ins_qv": bytes(ins_qv),
        "mrg_qv": bytes(mrg_qv),
        "sub_qv": bytes(sub_qv),
    }


def read_quiva_qvs(path: str, rlens) -> List[Dict[str, bytes]]:
    """Decode a single-file `.qvs` stream: coding block, then one entry per
    read length in `rlens` (the layout our qv harness and a 1-file DB use)."""
    out = []
    with open(path, "rb") as f:
        coding = read_qvcoding(f)
        for rlen in rlens:
            out.append(uncompress_entry(f, coding, int(rlen)))
    return out


def read_db_qvs(db_path: str) -> List[Dict[str, bytes]]:
    """Decode every read's QV streams from a DB's `.qvs` (DB.c Open_QVs
    :821-1035: per imported file, a coding block followed by its reads'
    entries; the first read of each file carries the block offset in coff)."""
    from hinge_tpu_torch.io.dazz_db import _HITS_DB, _HITS_READ, _db_paths

    stub, idx_path, _ = _db_paths(db_path)
    # stub: "files = N" + per-file "lastread prolog fname"
    lastreads = []
    with open(stub) as f:
        nfiles = int(f.readline().split("=")[1])
        for _ in range(nfiles):
            lastreads.append(int(f.readline().split()[0]))
    with open(idx_path, "rb") as f:
        hdr = np.frombuffer(f.read(_HITS_DB.itemsize), dtype=_HITS_DB)[0]
        nreads = int(hdr["ureads"])
        reads = np.frombuffer(f.read(_HITS_READ.itemsize * nreads), dtype=_HITS_READ)
    out = []
    # hidden file alongside .idx/.bps: DB.c opens Catenate(db->path, ".qvs")
    with open(idx_path[: -len(".idx")] + ".qvs", "rb") as f:
        first = 0
        for last in lastreads:
            if last <= first:
                continue
            f.seek(int(reads["coff"][first]))
            coding = read_qvcoding(f)
            for i in range(first, last):
                out.append(uncompress_entry(f, coding, int(reads["rlen"][i])))
            first = last
    return out


# ---------------------------------------------------------------------------
# Write path (QV.c compress side, re-derived)
# ---------------------------------------------------------------------------
#
# QVcoding_Scan (QV.c:896-986) + Create_QVcoding (:992-1133) +
# Write_QVcoding (:1136-1174) + Encode/Encode_Run (:423-545) +
# Pack_Tag (:841-851).  Deliberate deviation from the reference: the scan
# here histograms runs over the WHOLE input after choosing del/sub run
# chars (the reference picks subChar mid-scan at the 100k-char mark and
# only histograms runs from that point, QV.c:973-982) — this changes table
# quality on the margin, never decodability.

_HUFF_CUTOFF = 16  # QV.c:63 — lookup-table decode limits codes to 16 bits


def _huffman(hist: np.ndarray, escape_lens: Optional[np.ndarray]):
    """Huffman code (lens, bits, type) over the non-zero symbols of hist.

    Mirrors QV.c Huffman (:184-261): when escape_lens is given (the first
    pass's lengths), symbols with first-pass length > 16 plus symbol 255
    are united into one escape class whose code signals an explicit
    8/16-bit literal; the result is a type-2 scheme.  Ties in the merge are
    broken by insertion order (our heap uses a sequence number) — any
    consistent Huffman code round-trips, only table quality varies.
    """
    import heapq

    lens = np.zeros(256, dtype=np.int32)
    bits = np.zeros(256, dtype=np.uint32)
    heap = []
    seq = 0
    esc_members: List[int] = []
    if escape_lens is not None:
        esc_count = 0
        for i in range(256):
            if hist[i] > 0 and (escape_lens[i] > _HUFF_CUTOFF or i == 255):
                esc_count += int(hist[i])
                esc_members.append(i)
        heap.append((esc_count, seq, ("esc", None)))
        seq += 1
    for i in range(256):
        if hist[i] > 0 and (escape_lens is None
                            or (escape_lens[i] <= _HUFF_CUTOFF and i != 255)):
            heap.append((int(hist[i]), seq, ("sym", i)))
            seq += 1
    heapq.heapify(heap)
    if len(heap) == 1:
        # degenerate single-symbol alphabet: 1-bit code
        _, _, leaf = heap[0]
        heap = [(0, 0, ("node", (leaf, leaf)))]
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, seq, ("node", (n1, n2))))
        seq += 1

    def walk(node, code, ln):
        kind, payload = node
        if kind == "node":
            walk(payload[0], code << 1, ln + 1)
            walk(payload[1], (code << 1) | 1, ln + 1)
        elif kind == "sym":
            lens[payload] = ln
            bits[payload] = code
        else:  # escape class -> stored as symbol 255's code
            lens[255] = ln
            bits[255] = code

    walk(heap[0][2], 0, 0)
    if escape_lens is not None:
        for i in esc_members:
            lens[i] = lens[255]
            bits[i] = bits[255]
        if int(lens[lens > 0].max(initial=0)) > _HUFF_CUTOFF:
            raise ValueError("qvs: escape-pass Huffman code exceeds 16 bits")
        return lens, bits, 2
    return lens, bits, 0


def _make_scheme(hist: np.ndarray):
    """SCHEME_MACRO (QV.c:1033-1042): plain build, escape rebuild if any
    code exceeds 16 bits."""
    lens, bits, _ = _huffman(hist, None)
    if int(lens.max(initial=0)) > _HUFF_CUTOFF:
        lens, bits, t = _huffman(hist, lens)
        return lens, bits, 2
    return lens, bits, 0


class _BitWriter:
    """Encode's uint32 output window incl. its end padding (QV.c:423-483:
    the decoder's 16-bit lookahead must never read past the last word)."""

    __slots__ = ("out", "ocode", "olen", "llen")

    def __init__(self, out: BinaryIO):
        self.out = out
        self.ocode = 0
        self.olen = 0
        self.llen = 0

    def emit(self, n: int, code: int) -> None:
        self.llen = self.olen
        total = self.olen + n
        if total >= 32:
            self.olen = total - 32
            self.ocode |= code >> self.olen
            self.out.write(struct.pack("<I", self.ocode & 0xFFFFFFFF))
            self.ocode = (code << (32 - self.olen)) & 0xFFFFFFFF if self.olen else 0
        else:
            self.olen = total
            self.ocode |= (code << (32 - self.olen)) & 0xFFFFFFFF

    def finish(self) -> None:
        if self.olen > 0:
            self.out.write(struct.pack("<I", self.ocode & 0xFFFFFFFF))
            if self.llen > 16 and self.olen > self.llen:
                self.out.write(struct.pack("<I", self.ocode & 0xFFFFFFFF))
        elif self.llen > 16:
            self.out.write(struct.pack("<I", self.ocode & 0xFFFFFFFF))


def _encode(scheme, out: BinaryIO, data: bytes) -> None:
    """QV.c Encode (:423-483)."""
    lens, bits, typ = scheme
    esc_bits = int(bits[255]) if typ == 2 else -1
    esc_len = int(lens[255]) if typ == 2 else -1
    bw = _BitWriter(out)
    for x in data:
        n, c = int(lens[x]), int(bits[x])
        bw.emit(n, c)
        if c == esc_bits and n == esc_len:
            bw.emit(8, x)
    bw.finish()


def _encode_run(neme, reme, out: BinaryIO, data: bytes, rchar: int) -> None:
    """QV.c Encode_Run (:485-545): alternating (run-length, literal)."""
    nlens, nbits, ntyp = neme
    rlens, rbits, _ = reme
    nesc_b = int(nbits[255]) if ntyp == 2 else -1
    nesc_l = int(nlens[255]) if ntyp == 2 else -1
    resc_b, resc_l = int(rbits[255]), int(rlens[255])
    bw = _BitWriter(out)
    k = 0
    rlen = len(data)
    while k < rlen:
        h = k
        while k < rlen and data[k] == rchar:
            k += 1
        x = 255 if k - h >= 255 else k - h
        n, c = int(rlens[x]), int(rbits[x])
        bw.emit(n, c)
        if c == resc_b and n == resc_l:
            bw.emit(16, k - h)
        if k < rlen:
            x = data[k]
            n, c = int(nlens[x]), int(nbits[x])
            bw.emit(n, c)
            if c == nesc_b and n == nesc_l:
                bw.emit(8, x)
            k += 1
    bw.finish()


def _write_scheme(scheme, out: BinaryIO) -> None:
    """QV.c Write_Scheme (:337-355)."""
    lens, bits, typ = scheme
    out.write(bytes([typ]))
    for i in range(256):
        out.write(bytes([int(lens[i])]))
        if lens[i] > 0:
            out.write(struct.pack("<I", int(bits[i])))


def _pack_2bit(tag: bytes) -> bytes:
    """DB.c Number_Read + Compress_Read: 'acgt'->0..3, 4 codes per byte."""
    codes = np.frombuffer(tag, dtype=np.uint8)
    num = np.zeros(len(codes), dtype=np.uint8)
    for v, ch in enumerate(b"acgt"):
        num[codes == ch] = v
        num[codes == (ch & ~0x20)] = v  # accept upper case
    clen = len(num)
    pad = (-clen) % 4
    num = np.concatenate([num, np.zeros(pad, np.uint8)])
    q = num.reshape(-1, 4)
    packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return packed.astype(np.uint8).tobytes()


class QVEncoder:
    """Huffman coding built from a training set of entries; encodes entries
    in the exact `.qvs` layout `read_quiva_qvs`/`qv_harness` consume."""

    def __init__(self, entries: List[Dict[str, bytes]], prefix: str = "@fake",
                 lossy: bool = False):
        del_h = np.zeros(256, np.int64)
        ins_h = np.zeros(256, np.int64)
        mrg_h = np.zeros(256, np.int64)
        sub_h = np.zeros(256, np.int64)
        del_r = np.ones(256, np.int64)   # QV.c:909-911: run hists start at 1
        sub_r = np.ones(256, np.int64)
        tot = 0
        del_char = -1
        for e in entries:
            dq = np.frombuffer(e["del_qv"], dtype=np.uint8)
            del_h += np.bincount(dq, minlength=256)
            ins_h += np.bincount(np.frombuffer(e["ins_qv"], np.uint8), minlength=256)
            mrg_h += np.bincount(np.frombuffer(e["mrg_qv"], np.uint8), minlength=256)
            sub_h += np.bincount(np.frombuffer(e["sub_qv"], np.uint8), minlength=256)
            tot += len(dq)
            if del_char < 0:
                tag = np.frombuffer(e["del_tag"], dtype=np.uint8)
                hit = np.nonzero((tag == ord("n")) | (tag == ord("N")))[0]
                if len(hit):
                    del_char = int(dq[hit[0]])
        sub_char = -1
        if tot >= 200000:
            cand = int(np.argmax(sub_h))
            if sub_h[cand] >= 0.5 * tot:  # Create_QVcoding (:1012)
                sub_char = cand
        if lossy:  # QV.c:1016-1031: drop low ins/mrg bits
            ins_h = ins_h.reshape(128, 2).sum(1).repeat(2)
            ins_h[1::2] = 0
            mrg_h = mrg_h.reshape(64, 4).sum(1).repeat(4)
            mrg_h[np.arange(256) % 4 != 0] = 0
        for e in entries:
            if del_char >= 0:
                _hist_runs(del_r, np.frombuffer(e["del_qv"], np.uint8), del_char)
            if sub_char >= 0:
                _hist_runs(sub_r, np.frombuffer(e["sub_qv"], np.uint8), sub_char)
        if del_char >= 0:
            del_h[del_char] = 0  # Create_QVcoding (:1060)
        if sub_char >= 0:
            sub_h[sub_char] = 0
        self.lossy = lossy
        self.prefix = prefix
        self.del_char = del_char
        self.sub_char = sub_char
        self.del_scheme = _make_scheme(del_h)
        self.drun_scheme = _make_scheme(del_r) if del_char >= 0 else None
        self.ins_scheme = _make_scheme(ins_h)
        self.mrg_scheme = _make_scheme(mrg_h)
        self.sub_scheme = _make_scheme(sub_h)
        self.srun_scheme = _make_scheme(sub_r) if sub_char >= 0 else None

    def write_coding(self, out: BinaryIO) -> None:
        """QV.c Write_QVcoding (:1136-1174)."""
        out.write(struct.pack("<H", 0x33CC))
        out.write(struct.pack("<H", 256 if self.del_char < 0 else self.del_char))
        out.write(struct.pack("<H", 256 if self.sub_char < 0 else self.sub_char))
        pfx = self.prefix.encode("latin-1")
        out.write(struct.pack("<i", len(pfx)))
        out.write(pfx)
        _write_scheme(self.del_scheme, out)
        if self.del_char >= 0:
            _write_scheme(self.drun_scheme, out)
        _write_scheme(self.ins_scheme, out)
        _write_scheme(self.mrg_scheme, out)
        _write_scheme(self.sub_scheme, out)
        if self.sub_char >= 0:
            _write_scheme(self.srun_scheme, out)

    def write_entry(self, out: BinaryIO, e: Dict[str, bytes]) -> None:
        """QV.c Compress_Next_QVentry (:1306-1351)."""
        dq = e["del_qv"]
        ins, mrg = e["ins_qv"], e["mrg_qv"]
        if self.lossy:
            ins = bytes((b >> 1) << 1 for b in ins)
            mrg = bytes((b >> 2) << 2 for b in mrg)
        if self.del_char < 0:
            _encode(self.del_scheme, out, dq)
            tag = e["del_tag"]
        else:
            _encode_run(self.del_scheme, self.drun_scheme, out, dq, self.del_char)
            keep = np.frombuffer(dq, np.uint8) != self.del_char
            tag = np.frombuffer(e["del_tag"], np.uint8)[keep].tobytes()
        out.write(_pack_2bit(tag))
        _encode(self.ins_scheme, out, ins)
        _encode(self.mrg_scheme, out, mrg)
        if self.sub_char < 0:
            _encode(self.sub_scheme, out, e["sub_qv"])
        else:
            _encode_run(self.sub_scheme, self.srun_scheme, out, e["sub_qv"],
                        self.sub_char)


def _hist_runs(run: np.ndarray, stream: np.ndarray, rchar: int) -> None:
    """QV.c Histogram_Runs (:746-762), vectorized: run lengths of rchar
    before each non-rchar symbol (and the trailing run), capped at 255."""
    is_r = stream == rchar
    n = len(stream)
    lit = np.nonzero(~is_r)[0]
    prev = np.concatenate([[-1], lit[:-1]])
    runs = lit - prev - 1
    np.add.at(run, np.minimum(runs, 255), 1)
    if len(lit) == 0:
        np.add.at(run, min(n, 255), 1)
    elif lit[-1] != n - 1:
        np.add.at(run, min(n - 1 - lit[-1], 255), 1)


def write_quiva_qvs(path: str, entries: List[Dict[str, bytes]],
                    prefix: str = "@fake", lossy: bool = False) -> QVEncoder:
    """Encode entries as a single-file `.qvs` (coding block + one entry per
    read — the inverse of read_quiva_qvs)."""
    enc = QVEncoder(entries, prefix=prefix, lossy=lossy)
    with open(path, "wb") as f:
        enc.write_coding(f)
        for e in entries:
            enc.write_entry(f, e)
    return enc
