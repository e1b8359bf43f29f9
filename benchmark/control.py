"""The control of the comparison that decides `correct`, and the faults
planted in the program whose readings set the upper ends of the limits.
An arm (ARMS) is a context manager that patches the program where the
fault arises and undoes the patch on leaving; a fault of the outputs
(ON_OUTPUTS) alters what a stage wrote last, and is judged on the
program's own outputs of the same call (the stages after it only copy
them).  `calibrate.py` reads both on the chip at a cell's own size,
`tests/test_harness_control.py` on the CPU.  The benchmark's own runs
never enter one.

- `votes_skipped`, the control: one guarantee both configurations
  state broken, "every base of a draft and of a consensus contig is the
  vote of the reads over it".  Each ladder row of the draft is the
  ladder's template segment (so the draft's vote returns one read's
  bases) and the consensus stage returns the draft contigs unchanged.
- `hinges_none`: the filter's hinge calling calls no hinge, so the
  repeat path (hinged reads and edges) never starts.
- `join_spans_shifted`: the join's p3 (`device_join.thin_rows`, K4 on
  the card) returns every fourth row's query positions, its kept
  anchors' and its span's, moved by up to SHIFT bases: records whose
  two spans map apart (ovl_false).
- `join_rows_dropped`: p3 rejects every second row: records missing
  (ovl_missed).

Faults of the outputs:

- `contigs_shuffled`: each consensus contig (and its GFA segment) cut
  into SHUFFLE_PIECES pieces, joined again in another order with every
  second piece reverse-complemented (misjoins, lga50).
- `links_rotated`: each GFA link's target segment replaced by the next
  link's (links_false).
- `edges_rewired`: every tenth layout edge's second read replaced by the
  read half the read set away (edges_false).
- `segment_altered`: the first GFA segment's sequence with a base
  changed (gfa_diff).
"""

from __future__ import annotations

import contextlib
import importlib

from benchmark.reference.judge import revcomp

#: pieces `contigs_shuffled` cuts each contig into
SHUFFLE_PIECES = 8
#: bases `join_spans_shifted` moves a row's query positions by, at most
SHIFT = 200


@contextlib.contextmanager
def patched(*patches):
    """Set each (module name, attribute, make) to make(original), and put
    the originals back on leaving."""
    undo = []
    try:
        for mod_name, attr, make in patches:
            mod = importlib.import_module(mod_name)
            undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def _write_fasta(results, out_fasta):
    if out_fasta is not None:
        with open(out_fasta, "w") as f:
            for name, seq in results:
                f.write(f">{name}\n{seq}\n")


def consensus_changed(change):
    """The consensus stage with `change` applied to the contigs it makes
    (before it writes them)."""
    def make(orig):
        def run(contigs, rs, aln, cfg, out_fasta=None, band=300, *, device):
            res = change(orig(contigs, rs, aln, cfg, None, band, device=device))
            _write_fasta(res, out_fasta)
            return res
        return run
    return patched(("hinge_tpu_torch.stages.consensus", "run_consensus", make))


def votes_skipped():
    def template_rows(orig):
        return lambda pair_q, pair_t, band, *, device: [(t, t) for t in pair_t]

    def draft_as_consensus(orig):
        def run(contigs, rs, aln, cfg, out_fasta=None, band=300, *, device):
            res = [(f"Consensus{ci}", seq) for ci, (_, seq) in enumerate(contigs)]
            _write_fasta(res, out_fasta)
            return res
        return run

    return patched(
        ("hinge_tpu_torch.stages.draft", "_align_ladder_pairs", template_rows),
        ("hinge_tpu_torch.stages.consensus", "run_consensus", draft_as_consensus))


def shuffle_contig(seq: str, pieces: int = SHUFFLE_PIECES) -> str:
    """`seq` cut into `pieces` pieces, joined in the order of their
    indices times 3 (mod `pieces`; a fixed permutation when `pieces` is
    prime to 3), every second one reverse-complemented."""
    n = len(seq)
    cut = [seq[i * n // pieces:(i + 1) * n // pieces] for i in range(pieces)]
    order = [(3 * i) % pieces for i in range(pieces)]
    return "".join(revcomp(cut[j]) if k % 2 else cut[j]
                   for k, j in enumerate(order))


def hinges_none():
    def make(orig):
        def run(part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
                repeat_annotation, hinges, f, reso, device):
            orig(part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
                 repeat_annotation, hinges, f, reso, device)
            for i in range(r_begin, r_end + 1):
                hinges[i] = []
        return run
    return patched(("hinge_tpu_torch.stages.filter", "_call_hinges_device", make))


def _p3_changed(change):
    """p3 with `change` applied to its outputs (a list, changed in place)."""
    def make(orig):
        def run(a_row, a_q, a_t, n_rows, *rest):
            out = list(orig(a_row, a_q, a_t, n_rows, *rest))
            change(out)
            return tuple(out)
        return run
    return patched(("hinge_tpu_torch.overlap.device_join", "thin_rows", make))


def join_spans_shifted():
    import torch

    def change(out):
        f_q, f_row, Q0 = out[0], out[2], out[5]
        rows = torch.arange(Q0.shape[0], device=Q0.device)
        d = torch.where(rows % 4 == 0, torch.clamp(Q0, max=SHIFT),
                        torch.zeros_like(Q0))
        out[0], out[5], out[6] = f_q - d[f_row], Q0 - d, out[6] - d
    return _p3_changed(change)


def join_rows_dropped():
    import torch

    def change(out):
        okr, nb = out[9], out[10]
        keep = torch.arange(okr.shape[0], device=okr.device) % 2 == 1
        out[9], out[10] = okr & keep, torch.where(keep, nb, torch.zeros_like(nb))
    return _p3_changed(change)


def contigs_shuffled(out: dict) -> dict:
    new = {seq: shuffle_contig(seq) for seq in out["consensus"]}
    gfa = []
    for ln in out["gfa"]:
        t = ln.split("\t")
        if t[0] == "S" and t[2] in new:
            t[2] = new[t[2]]
        gfa.append("\t".join(t))
    return dict(out, consensus=[new[x] for x in out["consensus"]], gfa=gfa)


def links_rotated(out: dict) -> dict:
    links = [i for i, ln in enumerate(out["gfa"]) if ln.startswith("L\t")]
    gfa = list(out["gfa"])
    for i, j in zip(links, links[1:] + links[:1]):
        t, u = out["gfa"][i].split("\t"), out["gfa"][j].split("\t")
        t[3:5] = u[3:5]
        gfa[i] = "\t".join(t)
    return dict(out, gfa=gfa)


def edges_rewired(out: dict) -> dict:
    import numpy as np

    e = np.array(out["edges"], dtype=np.int64, copy=True)
    if e.shape[0]:
        n = int(e.max()) + 1
        e[::10, 1] = (e[::10, 1] + n // 2) % n
    return dict(out, edges=e)


def segment_altered(out: dict) -> dict:
    gfa = list(out["gfa"])
    for i, ln in enumerate(gfa):
        t = ln.split("\t")
        if t[0] == "S" and t[2]:
            t[2] = ("C" if t[2][0] != "C" else "G") + t[2][1:]
            gfa[i] = "\t".join(t)
            break
    return dict(out, gfa=gfa)


#: every arm by name
ARMS = {
    "votes_skipped": votes_skipped,
    "hinges_none": hinges_none,
    "join_spans_shifted": join_spans_shifted,
    "join_rows_dropped": join_rows_dropped,
}
#: every fault of the outputs by name: (the fault, the numbers it is for)
ON_OUTPUTS = {
    "contigs_shuffled": (contigs_shuffled, ("misjoins", "lga50")),
    "links_rotated": (links_rotated, ("links_false",)),
    "edges_rewired": (edges_rewired, ("edges_false",)),
    "segment_altered": (segment_altered, ("gfa_diff",)),
}
