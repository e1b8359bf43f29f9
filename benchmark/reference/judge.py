"""The plain reference: what an assembly's outputs say, judged against
the truth the benchmark made (traffic.generate.Truth).  NumPy only; it
imports nothing of the program and takes nothing the program made but
the outputs it judges.

Each number below is compared with a limit of its own (the cell's
`limits`, workloads/<cell>.json); a call is correct when every number
is at or under its limit.

- `ovl_false` (where the built-in overlapper ran): the share of its
  records that do not place their two reads on one stretch of the
  genome, on the strands the reads came from.  A record's two matched
  spans are mapped through the reads' true genome positions; it is
  false when its rc flag is not the reads' strands differing, or when
  the two spans' genome start or end points lie more than OVL_TOL
  bases apart (a record's span ends are exact seed matches in both
  reads, so a sound record's ends agree within a few bases at any
  read error rate).
- `ovl_missed` (where the built-in overlapper ran): the share of read
  pairs whose true genome arcs overlap by OVL_MIN bases or more that no
  record joins.
- `edges_false`: layout edges (`<prefix>.edges.hinges`) whose two reads
  no overlap record the layout was given joins (the `.las` input or the
  overlapper's records).  Exact: limit 0.
- `draft_err`, `cons_err`: errors a base of the draft / consensus
  contigs, estimated from the share m of their K-mers (canonical, over
  contigs of at least MIN_CONTIG bases) that occur nowhere in the
  genome: 1 - (1 - m)^(1/K).
- `genome_missed`: the share of the genome's K-mers that occur in no
  consensus contig: what is missing or wrong of the genome.
- `misjoins`: where the consensus contigs join stretches that do not
  follow each other in the genome.  Each contig's K-mers that occur
  once in the genome are placed there; runs of placements on one strand
  and one diagonal are blocks, blocks of fewer than MIN_BLOCK
  placements are dropped (chance matches of erroneous K-mers), and
  consecutive blocks of a contig that change strand or jump off the
  diagonal by more than the contig bases between them allow (JOIN_TOL
  plus JOIN_DRIFT of them) are a misjoin: a repeat collapsed, copies
  glued, chromosomes chained.  Repeated K-mers are never placed, so a
  contig that runs through a repeat into the right flank is no misjoin.
  A join counts only where both its sides lie END_SEG bases or more
  inside the contig: within one long read of its ends the layout's path
  starts or stops on a read that hangs over, folds back onto the other
  strand or repeats itself (the port does all three at CLR noise).
- `lga50`: the number of aligned segments (the blocks above, joined
  where no misjoin parts them), longest first, whose genome spans
  together cover half of the genome: 1 for one whole circular
  chromosome, the count of the longest chromosomes that make half of a
  linear genome, more as the assembly breaks up.
- `links_false`: the GFA's L lines (segment u's end -> segment v's
  start) whose two ends do not follow each other anywhere in the
  genome: the last LINK_PIECE bases of u and the first of v are each
  placed at every genome position their K-mers occur at (repeated ones
  too, so a repeat's segment lies at each copy), in runs of MIN_BLOCK
  placements on one strand and diagonal, and the link is true where a
  place of u's end and one of v's start lie on one strand with v's
  start within LINK_TOL bases of where u's end puts it.  This is where
  HINGE's repeat graph shows: each copy's flanks linked through the
  repeat's segment.  A segment's end placed over one long read holds
  its strand through a read that folds back there.
- `gfa_diff`: the GFA's S lines whose sequence is not one of the
  consensus contigs, and 1 when it has none.  Exact: limit 0.
- `calls_diff`: the calls whose outputs (draft, consensus, GFA, layout
  edges, overlap records) differ from the first call's, byte for byte.
  Exact: limit 0.
"""

from __future__ import annotations

import hashlib

import numpy as np

K = 21
MIN_CONTIG = 1000
OVL_MIN = 2000
#: bases by which a true record's two span ends may map apart
OVL_TOL = 50
#: placements a block needs to count (see `misjoins`)
MIN_BLOCK = 10
#: a diagonal jump that is no misjoin: JOIN_TOL bases plus JOIN_DRIFT of
#: the contig bases between the two placements (the consensus's indels)
JOIN_TOL, JOIN_DRIFT = 100, 0.05
#: a join this close to a contig's end is the path's first or last read
#: hanging over, not a misjoin (see `misjoins`)
END_SEG = 10_000
#: bases of a segment's end that place it, and how far a link's two
#: places may lie from following each other (see `links_false`): one long
#: read, as for a misjoin near a contig's end
LINK_PIECE = LINK_TOL = END_SEG
_MASK = (1 << (2 * K)) - 1
_REVCOMP = str.maketrans("ACGTacgt", "TGCAtgca")
_ASCII2CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ASCII2CODE[_c] = _i
    _ASCII2CODE[_c + 32] = _i


def _kmer_table(codes: np.ndarray, circular: bool = False) -> tuple:
    """(canonical K-mers (uint64), whether each is its forward-strand
    K-mer, its start) at each position of `codes` (0..3; any other value
    makes the K-mers over it absent), wrapped when `circular`."""
    codes = np.asarray(codes, dtype=np.uint8)
    if circular:
        codes = np.concatenate([codes, codes[:K - 1]])
    n = codes.shape[0] - K + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool),
                np.zeros(0, dtype=np.int64))
    bad = codes > 3
    c = np.where(bad, 0, codes).astype(np.uint64)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for j in range(K):
        fwd = (fwd << np.uint64(2)) | c[j:j + n]
        rev |= (np.uint64(3) - c[j:j + n]) << np.uint64(2 * j)
    ok = np.convolve(bad, np.ones(K, dtype=np.int64), "valid") == 0
    fwd, rev = fwd[ok], rev[ok]
    return np.minimum(fwd, rev), fwd <= rev, np.nonzero(ok)[0]


def _member(x: np.ndarray, table: np.ndarray) -> np.ndarray:
    """For each element of x, in sorted order, whether the sorted array
    `table` holds it (x sorted first: the search then walks the table in
    order, ten times faster than in x's own order)."""
    if table.shape[0] == 0:
        return np.zeros(x.shape[0], dtype=bool)
    x = np.sort(x)
    i = np.minimum(np.searchsorted(table, x), table.shape[0] - 1)
    return table[i] == x


class Reference:
    """The judge of one cell's assemblies: the truth's K-mer table and
    read arcs are built once, then each call's outputs are judged."""

    def __init__(self, truth):
        self.truth = truth
        canon, is_fwd, pos = _kmer_table(truth.genome, truth.circular)
        self.genome_kmers = canon
        o = np.argsort(canon, kind="stable")
        sc = canon[o]
        new = np.ones(sc.shape[0], dtype=bool)
        new[1:] = sc[1:] != sc[:-1]
        self.table = sc[new]
        # the K-mers that occur once in the genome: where each lies and on
        # which strand (placements for `structure`)
        once = new.copy()
        once[:-1] &= new[1:]
        self.all_key, self.all_pos, self.all_fwd = sc, pos[o], is_fwd[o]
        self.place_key = sc[once]
        self.place_pos = self.all_pos[once]
        self.place_fwd = self.all_fwd[once]
        del canon, is_fwd, pos, o, new, once
        self.G = int(truth.genome.shape[0])
        t = truth
        lens = np.diff(t.gmap_off)
        self.read_len = lens
        first = t.gmap[t.gmap_off[:-1]].astype(np.int64)
        last = t.gmap[t.gmap_off[1:] - 1].astype(np.int64)
        self.arc0, self.arc_len = first, self._fwd(first, last) + 1
        self.input_pairs = None
        if t.records is not None:
            self.input_pairs = self._pair_keys(t.records[0], t.records[1])
        self._true_pairs = None
        self._seq_kmers = {}

    def _pair_keys(self, a, b):
        """Sorted unique keys of the unordered read pairs (a[i], b[i])."""
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        return np.unique(np.minimum(a, b) * self.truth.n_reads + np.maximum(a, b))

    def true_pairs(self):
        """Keys of the read pairs whose genome arcs overlap by OVL_MIN
        bases or more (an interval sweep; arcs repeated one genome later
        on a circle)."""
        if self._true_pairs is not None:
            return self._true_pairs
        n = self.truth.n_reads
        s, e, ids = self.arc0, self.arc0 + self.arc_len, np.arange(n)
        if self.truth.circular:
            s, e, ids = (np.concatenate([s, s + self.G]),
                         np.concatenate([e, e + self.G]),
                         np.concatenate([ids, ids]))
        o = np.argsort(s, kind="stable")
        s, e, ids = s[o], e[o], ids[o]
        # partners of arc i: the arcs after it that start OVL_MIN or more
        # before its end
        cnt = np.maximum(np.searchsorted(s, e - OVL_MIN, side="right")
                         - np.arange(s.shape[0]) - 1, 0)
        i = np.repeat(np.arange(s.shape[0]), cnt)
        j = i + 1 + np.arange(i.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        keep = ((np.minimum(e[i], e[j]) - np.maximum(s[i], s[j]) >= OVL_MIN)
                & (ids[i] != ids[j]))
        self._true_pairs = self._pair_keys(ids[i][keep], ids[j][keep])
        return self._true_pairs

    def _fwd(self, g0, g1):
        """Bases from g0 forward to g1 (around the circle when circular)."""
        d = g1 - g0
        return np.mod(d, self.G) if self.truth.circular else d

    def _apart(self, g0, g1):
        """Bases between genome positions g0 and g1 (the shorter way round
        on a circle)."""
        d = np.abs(g0 - g1)
        return np.minimum(d, self.G - d) if self.truth.circular else d

    def _wrap(self, d):
        """Diagonal differences d, taken the shorter way round a circle."""
        if not self.truth.circular:
            return d
        return np.mod(d + self.G // 2, self.G) - self.G // 2

    def seq_kmers(self, seq: str) -> tuple:
        """`_kmer_table` of a contig's bases, kept for the judge call in
        progress (base_err, genome_missed and segments all read it)."""
        if seq not in self._seq_kmers:
            self._seq_kmers[seq] = _kmer_table(
                _ASCII2CODE[np.frombuffer(seq.encode(), np.uint8)])
        return self._seq_kmers[seq]

    def segments(self, seq: str) -> list:
        """The aligned segments of contig `seq` (see `misjoins` above), in
        contig order: (genome start, genome bases, first contig base, last
        contig base) each."""
        canon, is_fwd, c = self.seq_kmers(seq)
        if canon.shape[0] == 0 or self.place_key.shape[0] == 0:
            return []
        o = np.argsort(canon)
        i = np.empty(canon.shape[0], dtype=np.int64)
        # sorted queries walk the table in order (see _member)
        i[o] = np.minimum(np.searchsorted(self.place_key, canon[o]),
                          self.place_key.shape[0] - 1)
        hit = self.place_key[i] == canon
        c, i = c[hit], i[hit]
        if c.shape[0] == 0:
            return []
        g = self.place_pos[i]
        s = np.where(is_fwd[hit] == self.place_fwd[i], 1, -1)
        d = g - s * c

        def parted(x, y):
            """Do placements x and y (x before y) lie on other strands or
            diagonals?"""
            return ((s[x] != s[y]) | (np.abs(self._wrap(d[y] - d[x]))
                                      > JOIN_TOL + JOIN_DRIFT * (c[y] - c[x])))

        n = c.shape[0]
        starts = np.concatenate([[0], np.nonzero(parted(np.arange(n - 1),
                                                         np.arange(1, n)))[0] + 1])
        ends = np.concatenate([starts[1:], [n]]) - 1
        keep = ends - starts + 1 >= MIN_BLOCK
        first, last = starts[keep], ends[keep]
        if first.shape[0] == 0:
            return []
        cut = np.concatenate([[0], np.nonzero(parted(last[:-1], first[1:]))[0] + 1])
        segs = []
        for f, l in zip(first[cut], last[np.concatenate([cut[1:], [len(first)]]) - 1]):
            span = min(int(c[l] - c[f]) + K, self.G)
            segs.append((int(g[f] if s[f] > 0 else g[l]), span, int(c[f]),
                         int(c[l]) + K))
        return segs

    def places(self, seq: str) -> list:
        """Where `seq` lies in the genome: (strand, diagonal) of each run of
        MIN_BLOCK or more placements of its K-mers, repeated ones at each
        of their positions; a base c of `seq` lies at diagonal + strand * c."""
        canon, is_fwd, c = _kmer_table(
            _ASCII2CODE[np.frombuffer(seq.encode(), np.uint8)])
        lo = np.searchsorted(self.all_key, canon, side="left")
        hi = np.searchsorted(self.all_key, canon, side="right")
        n = hi - lo
        if n.sum() == 0:
            return []
        rep = np.repeat(np.arange(canon.shape[0]), n)
        j = lo[rep] + np.arange(rep.shape[0]) - np.repeat(np.cumsum(n) - n, n)
        s = np.where(is_fwd[rep] == self.all_fwd[j], 1, -1)
        d = self.all_pos[j] - s * c[rep]
        if self.truth.circular:
            d = np.mod(d, self.G)
        o = np.lexsort((d, s))
        s, d = s[o], d[o]
        tol = JOIN_TOL + JOIN_DRIFT * len(seq)
        cut = np.concatenate([[0], np.nonzero((s[1:] != s[:-1])
                                              | (d[1:] - d[:-1] > tol))[0] + 1,
                              [s.shape[0]]])
        return [(int(s[a]), int(d[(a + b) // 2])) for a, b in zip(cut[:-1], cut[1:])
                if b - a >= MIN_BLOCK]

    def links_false(self, gfa) -> int:
        """L lines of the GFA lines `gfa` whose ends do not follow each
        other in the genome (see `links_false` above)."""
        seg = {}
        links = []
        for ln in gfa:
            t = ln.split("\t")
            if t[0] == "S":
                seg[t[1]] = t[2]
            elif t[0] == "L":
                links.append(t[1:5])
        bad = 0
        for u, su, v, sv in links:
            x = seg.get(u, "")
            y = seg.get(v, "")
            x = revcomp(x) if su == "-" else x
            y = revcomp(y) if sv == "-" else y
            px = x[-LINK_PIECE:]
            # each place as the diagonal of u + v joined (v's base c at len(x) + c)
            ends = [(st, d - st * (len(x) - len(px))) for st, d in self.places(px)]
            starts = [(st, d - st * len(x)) for st, d in self.places(y[:LINK_PIECE])]
            bad += not any(a == b and abs(int(self._wrap(np.int64(e - f)))) <= LINK_TOL
                           for a, e in ends for b, f in starts)
        return bad

    def structure(self, seqs) -> tuple:
        """(misjoins, lga50) of the contigs `seqs` of MIN_CONTIG bases or
        more."""
        misjoins = 0
        flat = []
        for x in seqs:
            if len(x) < MIN_CONTIG:
                continue
            sg = self.segments(x)
            flat += sg
            misjoins += sum(a[3] >= END_SEG and len(x) - b[2] >= END_SEG
                            for a, b in zip(sg, sg[1:]))
        cover = np.zeros(self.G, dtype=bool)
        done = 0
        flat.sort(key=lambda sg: -sg[1])
        for n, (g0, span, _, _) in enumerate(flat, 1):
            if self.truth.circular:
                parts = [(g0, min(g0 + span, self.G)),
                         (0, max(g0 + span - self.G, 0))]
            else:
                parts = [(g0, min(g0 + span, self.G))]
            for lo, hi in parts:
                done += int(hi - lo - cover[lo:hi].sum())
                cover[lo:hi] = True
            if 2 * done >= self.G:
                return misjoins, n
        return misjoins, len(flat) + 1

    def _span_arc(self, rid, lo, hi):
        """The genome arc of read-orientation span [lo, hi) of reads `rid`."""
        t = self.truth
        n = self.read_len[rid]
        rev = t.strand[rid] == 1
        f0 = np.where(rev, n - hi, lo)
        f1 = np.where(rev, n - 1 - lo, hi - 1)
        g0 = t.gmap[t.gmap_off[rid] + f0].astype(np.int64)
        g1 = t.gmap[t.gmap_off[rid] + f1].astype(np.int64)
        return g0, self._fwd(g0, g1) + 1

    def ovl_false(self, rec) -> float:
        """The share of the records `rec` (columns a_id, b_id, rc,
        a_start, a_end, b_start, b_end; B on its forward strand) that
        are false; 1.0 when there is none."""
        a = np.asarray(rec["a_id"], np.int64)
        b = np.asarray(rec["b_id"], np.int64)
        if a.shape[0] == 0:
            return 1.0
        ga, la = self._span_arc(a, np.asarray(rec["a_start"], np.int64),
                                np.asarray(rec["a_end"], np.int64))
        gb, lb = self._span_arc(b, np.asarray(rec["b_start"], np.int64),
                                np.asarray(rec["b_end"], np.int64))
        strands = (self.truth.strand[a] != self.truth.strand[b]).astype(np.int64)
        off = np.maximum(self._apart(ga, gb), self._apart(ga + la, gb + lb))
        bad = (off > OVL_TOL) | (np.asarray(rec["rc"], np.int64) != strands)
        return float(bad.mean())

    def ovl_missed(self, rec) -> float:
        """The share of the true pairs (true_pairs) that no record of
        `rec` joins."""
        want = self.true_pairs()
        got = self._pair_keys(rec["a_id"], rec["b_id"])
        return float(1.0 - _member(want, got).mean()) if want.shape[0] else 0.0

    def edges_false(self, edges: np.ndarray, pairs: np.ndarray) -> int:
        """Edges (rows of read ids) whose reads no record of the sorted
        pair keys `pairs` joins."""
        if edges.shape[0] == 0:
            return 0
        keys = self._pair_keys(edges[:, 0], edges[:, 1])
        return int((~_member(keys, pairs)).sum())

    def base_err(self, seqs) -> float:
        """Errors a base of the contigs `seqs` of MIN_CONTIG bases or more,
        from their K-mers absent from the genome; 1.0 when there is none."""
        km = [self.seq_kmers(s)[0] for s in seqs if len(s) >= MIN_CONTIG]
        km = np.concatenate(km) if km else np.zeros(0, np.uint64)
        if km.shape[0] == 0:
            return 1.0
        miss = 1.0 - _member(km, self.table).mean()
        return float(1.0 - (1.0 - miss) ** (1.0 / K))

    def genome_missed(self, seqs) -> float:
        """Share of the genome's K-mers found in no contig of `seqs`."""
        km = [self.seq_kmers(s)[0] for s in seqs]
        km = np.unique(np.concatenate(km)) if km else np.zeros(0, np.uint64)
        return float(1.0 - _member(self.genome_kmers, km).mean())

    def judge(self, out: dict, only=None) -> dict:
        """The numbers of one call's outputs (those named in `only`, when
        given): `out` holds `draft`, `consensus` (lists of sequences),
        `gfa` (lines), `edges` (an [n, 2] array of read ids) and, where
        the overlapper ran, `records`."""
        want = lambda *names: only is None or any(n in only for n in names)  # noqa: E731
        self._seq_kmers = {}
        cons = list(out["consensus"])
        got = {}
        rec = out.get("records")
        if rec is not None:
            if want("ovl_false"):
                got["ovl_false"] = self.ovl_false(rec)
            if want("ovl_missed"):
                got["ovl_missed"] = self.ovl_missed(rec)
            pairs = self._pair_keys(rec["a_id"], rec["b_id"])
        else:
            pairs = self.input_pairs
        if want("edges_false"):
            got["edges_false"] = self.edges_false(out["edges"], pairs)
        if want("draft_err"):
            got["draft_err"] = self.base_err(out["draft"])
        if want("cons_err"):
            got["cons_err"] = self.base_err(cons)
        if want("genome_missed"):
            got["genome_missed"] = self.genome_missed(cons)
        if want("misjoins", "lga50"):
            got["misjoins"], got["lga50"] = self.structure(cons)
        if want("links_false"):
            got["links_false"] = self.links_false(out["gfa"])
        if want("gfa_diff"):
            s_lines = [ln.split("\t")[2] for ln in out["gfa"]
                       if ln.startswith("S\t")]
            have = set(cons)
            got["gfa_diff"] = (sum(x not in have for x in s_lines)
                               + int(not s_lines))
        self._seq_kmers = {}
        return got


def revcomp(seq: str) -> str:
    return seq[::-1].translate(_REVCOMP)


def digest(out: dict) -> str:
    """sha256 of one call's outputs: draft, consensus, GFA, layout edges
    and, where the overlapper ran, its records."""
    h = hashlib.sha256()
    for key in ("draft", "consensus", "gfa"):
        for s in out[key]:
            h.update(s.encode())
            h.update(b"\n")
        h.update(b"\0")
    h.update(np.ascontiguousarray(out["edges"]).tobytes())
    for col in sorted(out.get("records") or {}):
        h.update(np.ascontiguousarray(out["records"][col]).tobytes())
    return h.hexdigest()


def verdict(readings: list, limits: dict) -> tuple:
    """The run's numbers from each call's readings (the worst over the
    calls) and `calls_diff` from their digests; ([(name, number, limit)],
    correct) over the numbers that `limits` names (a cell compares those
    its faults can fail).  A limit without a number is an error."""
    worst = {}
    for r in readings:
        for k, v in r["numbers"].items():
            worst[k] = max(worst.get(k, v), v)
    digests = [r["digest"] for r in readings]
    worst["calls_diff"] = sum(d != digests[0] for d in digests[1:])
    missing = set(limits) - set(worst)
    if missing:
        raise KeyError(f"limits for numbers the reference does not make: "
                       f"{sorted(missing)}")
    rows = [(k, worst[k], lim) for k, lim in limits.items()]
    return rows, all(v <= lim for _, v, lim in rows)
