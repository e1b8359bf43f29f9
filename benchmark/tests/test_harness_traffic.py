"""The frozen traffic copy makes the port's reads, records and files.

At a small size and the same seeds, benchmark/traffic's simulator gives
the reads (codes and genome maps), read store and exact overlap records
of hinge_tpu_torch.data.simulator, and its writers the bytes of the
port's write_fasta and write_las; the generator's recipes give the
port's tests' yeast parameters."""

import dataclasses
import os

import numpy as np
import pytest

from benchmark import spec
from benchmark.traffic import generate
from benchmark.traffic import simulator as B
from benchmark.traffic import writers
from hinge_tpu_torch.data import simulator as P

SEEDS = (0, 7, 2 ** 40 + 3)
CASES = (
    dict(genome_len=60_000, sub_rate=0.01, ins_rate=0.005, del_rate=0.005,
         coverage=12.0),
    dict(genome_len=40_000, ins_rate=0.05, coverage=8.0,
         repeats=((5_000, 20_000, 3_000),)),
    dict(chromosomes=(20_000, 30_000), telomere_len=1_500, telomere_unit=300,
         telomere_cross_cap=400, extra_reads=((0, 4_000, 0), (46_000, 4_000, 1)),
         coverage=10.0, sub_rate=0.01, ins_rate=0.005, del_rate=0.005),
)


def _both(seed, kw):
    pb, pp = B.SimParams(seed=seed, **kw), P.SimParams(seed=seed, **kw)
    return B.simulate(pb), P.simulate(pp)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_simulate_equals_port(seed, case):
    (gb, rb, sb, ob), (gp, rp, sp, op) = _both(seed, CASES[case])
    assert np.array_equal(gb, gp)
    assert len(rb) == len(rp)
    for a, b in zip(rb, rp):
        assert (a.start, a.end, a.strand) == (b.start, b.end, b.strand)
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.gmap, b.gmap) and a.gmap.dtype == b.gmap.dtype
    for f in ("length", "qv_off", "qv_val", "bases_off", "bases"):
        assert np.array_equal(getattr(sb, f), getattr(sp, f)), f
    assert sb.names == sp.names
    for f in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
              "b_start", "b_end", "rc", "diffs", "tlen", "trace_off", "trace"):
        assert np.array_equal(getattr(ob, f), getattr(op, f)), f
    assert ob.n > 0


@pytest.mark.parametrize("tspace", (100, 150))
def test_writers_write_the_ports_bytes(tmp_path, tspace):
    from hinge_tpu_torch.io.fasta import write_fasta
    from hinge_tpu_torch.io.las import write_las

    kw = dict(CASES[0], tspace=tspace)
    (_, _, sb, ob), (_, _, sp, op) = _both(5, kw)
    writers.write_fasta(str(tmp_path / "b.fasta"), sb)
    write_fasta(str(tmp_path / "p.fasta"),
                ((sp.names[i], sp.get_seq(i)) for i in range(sp.n_reads)))
    writers.write_las(str(tmp_path / "b.las"), ob)
    write_las(str(tmp_path / "p.las"), op)
    for a, b in (("b.fasta", "p.fasta"), ("b.las", "p.las")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_yeast_recipe_is_the_tests_recipe_cut():
    """The yeast configuration's SimParams are tests/torch_golden_repeats'
    yeast_params on the kept chromosomes, with the copies that land in
    them, under the configuration's raw CLR read errors."""
    from tests import torch_golden_repeats as G

    bench = spec.benchmark()
    cell = spec.Cell("yeast7_las", bench)
    got = generate.sim_params(cell.config, cell.mix, 0)
    full = G.yeast_params(B.SimParams)
    keep = ("I", "III", "IV", "V", "VII", "IX", "XI")
    roman = ("I II III IV V VI VII VIII IX X XI XII XIII XIV XV XVI").split()
    lens = tuple(L for n, L in zip(roman, G.YEAST_CHROMOSOMES) if n in keep)
    assert got.chromosomes == lens and sum(lens) == 4_853_289
    for f in ("telomere_len", "telomere_unit", "telomere_cross_cap",
              "coverage", "mean_read_len", "std_read_len", "min_read_len",
              "tspace", "min_overlap"):
        assert getattr(got, f) == getattr(full, f), f
    assert (got.sub_rate, got.ins_rate, got.del_rate) == (0.013, 0.078, 0.039)
    starts = [sum(lens[:i]) for i in range(len(lens))]
    at = dict(zip(keep, starts))
    want = [(at["IV"] + 400_000, at["VII"] + 300_000, 25_000)]
    want += [(at["IV"] + 900_000, at[c] + 150_000, 6_000)
             for c in ("I", "III", "V", "IX", "XI")]
    assert list(got.repeats) == want
    assert len(got.extra_reads) == 2 * len(keep)


def test_make_inputs_writes_the_cells_files(tmp_path):
    cfg = dict(spec.Cell("ecoli_fasta", spec.benchmark()).config,
               chromosomes=[["x", 50_000]])
    mix = spec.load_json(os.path.join(spec.BENCH_DIR, "traffic", "mixes",
                                      "pacbio_las.json"))
    paths, truth = generate.make_inputs(cfg, mix, 3, str(tmp_path))
    from hinge_tpu_torch.io.fasta import read_fasta
    from hinge_tpu_torch.io.las import read_las

    rs = read_fasta(paths["fasta"])
    ov = read_las(paths["las"], read_lengths=rs.length)
    p = generate.sim_params(cfg, mix, 3)
    _, reads, sp, op = P.simulate(P.SimParams(**dataclasses.asdict(p)))
    assert rs.n_reads == sp.n_reads == truth.n_reads
    assert np.array_equal(rs.bases, sp.bases)
    assert np.array_equal(ov.a_id, op.a_id) and np.array_equal(ov.b_start, op.b_start)
    for i in (0, rs.n_reads - 1):
        got = truth.gmap[truth.gmap_off[i]:truth.gmap_off[i + 1]]
        assert np.array_equal(got, reads[i].gmap)
