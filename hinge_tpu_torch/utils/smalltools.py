"""Copied from hinge_tpu/utils/smalltools.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Small pipeline utilities mirroring the reference's scripts/ directory.

- `clip_ends`: drop graph edges touching reads mapped near chromosome ends
  (scripts/clip_ends.py — ground-truth file rows `read chr left right`,
  kill reads within CHR_THR of either chromosome end).
- `create_bandage_file`: edges file -> Bandage LastGraph-style NODE/ARC file
  (scripts/create_bandage_file.py).
"""

from __future__ import annotations

from typing import Set

CHR_THR = 20000


def clip_ends(ground_truth_path: str, edges_path: str, out_path: str | None = None,
              chr_thr: int = CHR_THR) -> int:
    """Filter an edges file, removing every line whose first two columns
    name a read mapping within `chr_thr` of a chromosome end
    (clip_ends.py:9-36). Returns the number of surviving lines."""
    out_path = out_path or edges_path + ".clipped"
    chr_lengths: dict = {}
    rows = []
    with open(ground_truth_path) as f:
        for line in f:
            m = list(map(int, line.strip().split()))
            rows.append(m)
            chr_lengths[m[1]] = max(chr_lengths.get(m[1], 0), max(m[2], m[3]))
    reads_to_kill: Set[int] = set()
    for m in rows:
        read_left, read_right = min(m[2], m[3]), max(m[2], m[3])
        if read_left < chr_thr:
            reads_to_kill.add(m[0])
        if read_right > chr_lengths[m[1]] - chr_thr:
            reads_to_kill.add(m[0])
    kept = 0
    with open(edges_path) as f, open(out_path, "w") as g:
        for line in f:
            cols = line.split()
            if int(cols[0]) in reads_to_kill or int(cols[1]) in reads_to_kill:
                continue
            g.write(line)
            kept += 1
    return kept


def create_bandage_file(edges_path: str, out_path: str) -> int:
    """Emit a Bandage-loadable LastGraph skeleton (NODE/ARC records with
    dummy sequence) from a two-column edges file
    (create_bandage_file.py:8-50). Returns the node count."""
    nodes: dict = {}
    arcs: dict = {}
    with open(edges_path) as f:
        for line in f:
            cols = line.split()
            if len(cols) < 2:
                continue
            node0, node1 = int(cols[0]), int(cols[1])
            nodes[node0] = 1
            nodes[node1] = 1
            arcs[(node0, node1) if node0 < node1 else (node1, node0)] = 1
    with open(out_path, "w") as fout:
        for node in nodes:
            fout.write("NODE " + str(node) + " 0 0 0 0 0\n")
            fout.write("AAA\n")
            fout.write("AAA\n")
        for arc in arcs:
            fout.write("ARC " + str(arc[0]) + " " + str(arc[1]) + " 0\n")
    return len(nodes)


def _window_hashes(codes, k: int):
    """uint64 polynomial rolling hash of every length-k window (wraparound
    arithmetic; callers verify bytes before declaring a repeat)."""
    import numpy as np

    s = codes.astype(np.uint64)
    n = len(s)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    B = np.uint64(1099511628211)
    # prefix hash: H[i] = s[0]*B^(i-1) + ... + s[i-1]
    powers = np.empty(n, dtype=np.uint64)
    powers[0] = 1
    np.multiply.accumulate(np.full(n - 1, B, dtype=np.uint64), out=powers[1:])
    pref = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(s * powers, out=pref[1:])
    # window hash normalized to a common power so equal windows hash equal:
    # (pref[i+k]-pref[i]) / B^i  ->  multiply by B^(n-i) instead of dividing
    inv_pow = powers[::-1]  # B^(n-1-i)
    return (pref[k:] - pref[:-k]) * inv_pow[k - 1 :]


def find_exact_repeats(chrom: dict, min_len: int = 1000):
    """Exact repeats of length >= min_len within/between chromosomes, both
    strands — the internal replacement for the `mummer -maxmatch -b -l 1000`
    subprocess of scripts/repeat_annotate_reads.py:39-41 (zero-egress image:
    no external mummer binary).

    chrom: {chr_index: sequence string}.  A position is repeated when its
    length-min_len window occurs a second time anywhere (other position,
    other chromosome, or on the reverse strand); runs of repeated positions
    merge into (start, end) intervals exactly covering every maximal repeat
    of length >= min_len.  Returns {chr_index: [(start, end), ...]}.
    """
    import numpy as np

    comp = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")
    k = min_len
    keys = sorted(chrom)
    owners = []  # (chr, pos, is_rc) per window, aligned with all_h
    hashes = []
    seqs = {}
    for c in keys:
        seq = chrom[c].upper().encode()
        seqs[c] = seq
        codes = np.frombuffer(seq, dtype=np.uint8)
        rc = np.frombuffer(seq.translate(comp)[::-1], dtype=np.uint8)
        for is_rc, arr in ((0, codes), (1, rc)):
            h = _window_hashes(arr, k)
            if len(h):
                hashes.append(h)
                owners.append((c, is_rc, len(arr)))
    if not hashes:
        return {c: [] for c in keys}
    all_h = np.concatenate(hashes)
    own_c = np.concatenate(
        [np.full(len(h), i, dtype=np.int32) for i, h in enumerate(hashes)]
    )
    own_p = np.concatenate([np.arange(len(h), dtype=np.int64) for h in hashes])
    order = np.argsort(all_h, kind="stable")
    hs = all_h[order]

    def fwd_window(ci, p):
        c, is_rc, n = owners[ci]
        if is_rc:
            p = n - k - p
        return c, p

    def win_bytes(ci, p):
        c, is_rc, n = owners[ci]
        if is_rc:
            q = n - k - p
            return seqs[c][q : q + k].translate(comp)[::-1]
        return seqs[c][p : p + k]

    repeated = {c: np.zeros(max(len(seqs[c]) - k + 1, 0), dtype=bool) for c in keys}
    # verify equal-hash groups byte-for-byte; a window is a repeat when its
    # content occurs at >= 2 distinct forward-strand locations (a window and
    # the rc view of the SAME location dedup to one key and don't count)
    starts = np.flatnonzero(np.concatenate(([True], hs[1:] != hs[:-1])))
    bounds = np.concatenate((starts, [len(hs)]))
    for gi in range(len(starts)):
        grp = order[bounds[gi] : bounds[gi + 1]]
        if len(grp) < 2:
            continue
        rep = win_bytes(own_c[grp[0]], int(own_p[grp[0]]))
        fw = set()
        for j in grp:
            if win_bytes(own_c[j], int(own_p[j])) == rep:
                fw.add(fwd_window(own_c[j], int(own_p[j])))
        if len(fw) >= 2:
            for c, p in fw:
                repeated[c][p] = True
    out = {}
    for c in keys:
        mask = repeated[c]
        ivs = []
        p = 0
        while p < len(mask):
            if mask[p]:
                q = p
                while q + 1 < len(mask) and mask[q + 1]:
                    q += 1
                ivs.append((p, q + k))
                p = q + 1
            p += 1
        out[c] = ivs
    return out


def repeat_annotate_reads(
    multifasta_path: str,
    gt_file_path: str,
    out_path: str,
    min_len: int = 1000,
    repeats_out: str | None = None,
) -> int:
    """Annotate ground-truth read rows with a repeat flag.

    Mirrors scripts/repeat_annotate_reads.py:12-92: chromosomes come from a
    multifasta whose headers are 1-based chromosome numbers (`>1 ...`);
    repeats >= min_len are discovered internally (find_exact_repeats replaces
    the mummer subprocess); each GT row `read chr start end ...` gains a
    tab-separated 0/1 column = whether the read's start or end falls inside
    any repeat interval of its chromosome (endpoint-inclusive, :80-92).
    Returns the number of rows written; optional `repeats_out` records the
    discovered intervals as `chr start end` rows.
    """
    from hinge_tpu_torch.io.fasta import iter_fastx

    chrom = {}
    for i, (name, seq, _q) in enumerate(iter_fastx(multifasta_path)):
        try:
            ci = int(name.split()[0]) - 1
        except ValueError:
            ci = i
        chrom[ci] = seq
    chr_repeats = find_exact_repeats(chrom, min_len=min_len)
    if repeats_out:
        with open(repeats_out, "w") as f:
            for c in sorted(chr_repeats):
                for s, e in chr_repeats[c]:
                    f.write(f"{c} {s} {e}\n")
    n = 0
    with open(gt_file_path) as f, open(out_path, "w") as g:
        for line in f:
            cols = line.split()
            if len(cols) < 4:
                continue
            cr = int(cols[1])
            rd_st = int(cols[2])
            rd_end = int(cols[3])
            is_repeat = 0
            for s, e in chr_repeats.get(cr, []):
                if s <= rd_st <= e or s <= rd_end <= e:
                    is_repeat = 1
            g.write(line.strip() + "\t" + str(is_repeat) + "\n")
            n += 1
    return n
