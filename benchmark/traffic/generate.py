"""The benchmark's one traffic generator: a configuration (a genome
recipe and its reads' profile: coverage, read lengths, error rates;
`configs/<name>.json`) and a mix (`traffic/mixes/<name>.json`: the input
form, the records' trace spacing and shortest overlap, and any key of
the reads' profile it changes) give, from a seed, the files one cell
assembles and the truth the reference judges by.

The genome and reads are the frozen simulator's (`simulate`'s genome,
reads and read store for the same SimParams); for a mix whose input is
"las" the overlap records are its `exact_overlaps`, which stand in for
DALIGNER's.  The reads are written as FASTA named `sim/<i+1>/0_<len>`,
the records as `.las`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from benchmark.traffic import simulator as S
from benchmark.traffic.writers import write_fasta, write_las

#: the keys of a configuration or a mix that are SimParams fields
MIX_PARAMS = ("coverage", "mean_read_len", "std_read_len", "min_read_len",
              "sub_rate", "ins_rate", "del_rate", "tspace", "min_overlap")
INPUTS = ("fasta", "las")


@dataclasses.dataclass
class Truth:
    """What the simulator knows of a cell's inputs: the genome (codes
    0..3 in the concatenated coordinates), whether it is one circular
    chromosome, the chromosomes' (offset, length), and for each read its
    strand and the genome position of each of its bases in forward-strand
    layout (`gmap[gmap_off[i]:gmap_off[i+1]]`, int32); `records` the
    `.las` cell's input overlaps (a_id, b_id) pairs, else None."""

    genome: np.ndarray
    circular: bool
    chroms: list
    strand: np.ndarray
    gmap_off: np.ndarray
    gmap: np.ndarray
    records: object = None

    @property
    def n_reads(self) -> int:
        return int(self.strand.shape[0])


def sim_params(config: dict, mix: dict, seed: int) -> S.SimParams:
    """The SimParams of `config`'s genome and reads under `mix` (whose
    keys win) for `seed`: one
    circular chromosome, or linear chromosomes with copies between them,
    telomeric blocks and reads over every telomere (the yeast recipe of
    the port's tests, tests/torch_golden_repeats.py::yeast_params)."""
    g = config
    names = [c[0] for c in g["chromosomes"]]
    lens = [int(c[1]) for c in g["chromosomes"]]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    at = {n: s for n, s in zip(names, starts)}
    kw = {k: src[k] for src in (config, mix) for k in MIX_PARAMS if k in src}
    repeats = tuple((at[r["src"][0]] + int(r["src"][1]),
                     at[r["dst"][0]] + int(r["dst"][1]), int(r["len"]))
                    for r in g.get("repeats", ()))
    if g["circular"]:
        if len(lens) != 1:
            raise ValueError("a circular genome has one chromosome")
        return S.SimParams(genome_len=lens[0], circular=True,
                           repeats=repeats, seed=seed, **kw)
    tread = int(g.get("telomere_read", 0))
    extra = ()
    if tread:
        extra = tuple([(o, tread, 0) for o in starts]
                      + [(o + L - tread, tread, 1)
                         for o, L in zip(starts, lens)])
    return S.SimParams(
        chromosomes=tuple(lens), telomere_len=int(g.get("telomere_len", 0)),
        telomere_unit=int(g.get("telomere_unit", 0)),
        telomere_cross_cap=int(g.get("telomere_cross_cap", 0)),
        extra_reads=extra, repeats=repeats, seed=seed, **kw)


def simulate_reads(p: S.SimParams):
    """`simulate(p)`'s params (made linear where it has chromosomes),
    genome, reads and read store, without its overlap records."""
    if p.chromosomes:
        p = dataclasses.replace(p, genome_len=int(sum(p.chromosomes)),
                                circular=False)
    rng = np.random.default_rng(p.seed)
    genome = S.make_genome(p, rng)
    reads = S.sample_reads(p, rng, genome)
    rs = S.make_read_store(reads, p, rng)
    return p, genome, reads, rs


def make_inputs(config: dict, mix: dict, seed: int, outdir: str,
                log=lambda msg: None) -> tuple:
    """Write the cell's reads (`reads.fasta`) and, for a "las" mix, its
    overlap records (`reads.las`) into `outdir`; returns ({"fasta": path,
    "las": path or ""}, Truth)."""
    if mix["input"] not in INPUTS:
        raise ValueError(f"mix input {mix['input']!r}, want one of {INPUTS}")
    t0 = time.perf_counter()
    p, genome, reads, rs = simulate_reads(sim_params(config, mix, seed))
    log(f"[traffic] {rs.n_reads} reads, {int(rs.length.sum())} bases "
        f"({time.perf_counter() - t0:.1f}s)")
    os.makedirs(outdir, exist_ok=True)
    paths = {"fasta": os.path.join(outdir, "reads.fasta"), "las": ""}
    write_fasta(paths["fasta"], rs)
    records = None
    if mix["input"] == "las":
        t1 = time.perf_counter()
        ov = S.exact_overlaps(reads, p)
        paths["las"] = os.path.join(outdir, "reads.las")
        write_las(paths["las"], ov)
        records = np.stack([ov.a_id, ov.b_id]).astype(np.int64)
        log(f"[traffic] {ov.n} overlap records "
            f"({time.perf_counter() - t1:.1f}s)")
        del ov
    lens = np.array([len(r.gmap) for r in reads], dtype=np.int64)
    gmap_off = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(lens, out=gmap_off[1:])
    truth = Truth(
        genome=genome, circular=bool(p.circular),
        chroms=S.chrom_offsets(p) if p.chromosomes else [(0, p.genome_len)],
        strand=np.array([r.strand for r in reads], dtype=np.int8),
        gmap_off=gmap_off,
        gmap=np.concatenate([r.gmap for r in reads]).astype(np.int32),
        records=records)
    return paths, truth
