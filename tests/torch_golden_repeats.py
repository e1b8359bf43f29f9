"""The repeat path's workloads, golden files and manifest, port side.

Two workloads take HINGE's repeat path (hinged reads, matching hinges,
hinged edges in the clip graphs):

- case (a), tests/test_repeat_resolution.py's: a 300 kb circular genome
  at 50x with one 25 kb exact repeat, longer than every read.  Its filter
  -> draft-path files are kept in tests/golden_repeats/ (GOLDEN_FILES);
- "yeast W303 scale": the 16 nuclear chromosomes of S. cerevisiae S288C
  (SGD R64) at their real lengths, the telomeric blocks and telomere
  reads of tests/test_multichrom.py, four unbridged 25 kb repeats and a
  6 kb Ty1-like element copied to five chromosomes, 30x, with read
  errors.  tests/golden_repeats/yeast_w303.json is hinge_tpu's manifest
  of it: the sha256 of the inputs and of every file assemble() writes
  with the demo's ini under HINGE_PARITY_ALIGN=1 (graphml by networkx's
  ElementTree serializer, etree_graphml).

tests/make_golden_repeats.py writes both with hinge_tpu.  This module
imports neither jax nor hinge_tpu, so chip_smoke.py can use it on the
card; the functions that make the parameters take the SimParams class,
so one definition serves both packages' simulators.
"""

import contextlib
import hashlib
import os

import numpy as np

from tests import torch_golden

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden_repeats")
MANIFEST = os.path.join(GOLDEN_DIR, "yeast_w303.json")
PREFIX = "R"
#: the golden files of case (a): tests/torch_golden.FILES, the filter's
#: flags and homologous reads, and the hinging files of
#: hinge_tpu/utils/sweep.py's parity lists
GOLDEN_FILES = tuple(PREFIX + s for s in (
    ".mas", ".cmas", ".repeat.txt", ".hinges.txt", ".max", ".contained.txt",
    ".edges.hinges", ".edges.hinges2", ".hinge.list", ".killed.hinges",
    ".edges.list", ".cov.flag", ".self.flag", ".homologous.txt", ".edges.1",
    ".edges.2", ".edges.greedy", ".edges.skipped", ".deadends.txt", ".hgraph",
))

#: tests/test_repeat_resolution.py's workload
CASE_A = dict(genome_len=300_000, coverage=50.0, mean_read_len=9000,
              std_read_len=4000, min_read_len=2000,
              repeats=((40_000, 180_000, 25_000),), seed=9)

#: S. cerevisiae S288C nuclear chromosomes I-XVI (SGD R64), in bp
YEAST_CHROMOSOMES = (
    230_218, 813_184, 316_620, 1_531_933, 576_874, 270_161, 1_090_940,
    562_643, 439_888, 745_751, 666_816, 1_078_177, 924_431, 784_333,
    1_091_291, 948_066,
)
#: unbridged 25 kb copies, (chromosome, offset) -> (chromosome, offset),
#: chromosomes numbered from 1 (I) and offsets within each chromosome
YEAST_UNBRIDGED = (((4, 400_000), (7, 300_000)), ((12, 200_000), (15, 500_000)),
                   ((2, 300_000), (13, 400_000)), ((10, 250_000), (16, 350_000)))
UNBRIDGED_LEN = 25_000
#: a Ty1-like element: its source and the chromosomes it is copied to,
#: at offset TY1_DST of each
TY1_SRC, TY1_LEN, TY1_DST = (4, 900_000), 6_000, 150_000
TY1_COPIES = (1, 3, 5, 9, 11)
TELOMERE_READ = 14_000
#: sub 1%, ins 0.5%, del 0.5%: without errors the draft short-circuits
#: every ladder window and the band-NW kernels never run
READ_ERRORS = dict(sub_rate=0.01, ins_rate=0.005, del_rate=0.005)

#: the reference's yeast demo ini (demo/yeast_W303_demo/nominal.ini), the
#: text of tests/test_multichrom.py::YEAST_DEMO_INI
YEAST_DEMO_INI = """\
[filter]
length_threshold = 1000;
quality_threshold = 0.23;
n_iter = 3; // filter iteration
aln_threshold = 1000;
min_cov = 5;
cut_off = 300;
theta = 300;
use_qv = true;

[running]
n_proc = 12;

[draft]
min_cov = 10;
trim = 200;
edge_safe = 100;
tspace = 900;
step = 50;

[consensus]
min_length = 4000;
trim_end = 200;
best_n = 1;
quality_threshold = 0.23;

[layout]
hinge_slack = 1000
min_connected_component_size = 8
del_telomere = 1
aggressive_pruning = 1
"""

#: the files assemble() writes from the draft stage on; every other file
#: of the manifest is written before it
POST_DRAFT = ("asm.draft.fasta", "asm.draft.pb.fasta", "draft_map.txt",
              "asm.consensus.fasta", "asm_consensus.gfa")
#: probes of the coverage check: PROBE bp every PROBE_STEP bp
PROBE, PROBE_STEP = 500, 20_000


def case_a_params(SimParams):
    return SimParams(**CASE_A)


def chrom_starts(lengths=YEAST_CHROMOSOMES):
    return [sum(lengths[:i]) for i in range(len(lengths))]


def yeast_repeats():
    """The (src, dst, length) copies in the concatenated coordinates."""
    s = chrom_starts()
    at = lambda c, off: s[c - 1] + off  # noqa: E731
    out = [(at(*a), at(*b), UNBRIDGED_LEN) for a, b in YEAST_UNBRIDGED]
    out += [(at(*TY1_SRC), at(c, TY1_DST), TY1_LEN) for c in TY1_COPIES]
    return tuple(out)


def yeast_params(SimParams):
    """The yeast W303-scale workload as `SimParams` (either package's)."""
    starts = chrom_starts()
    extra = tuple([(o, TELOMERE_READ, 0) for o in starts]
                  + [(o + L - TELOMERE_READ, TELOMERE_READ, 1)
                     for o, L in zip(starts, YEAST_CHROMOSOMES)])
    return SimParams(
        chromosomes=YEAST_CHROMOSOMES, telomere_len=6_000, telomere_unit=400,
        telomere_cross_cap=900, extra_reads=extra, repeats=yeast_repeats(),
        coverage=30.0, mean_read_len=8_000, std_read_len=1_600,
        min_read_len=500, seed=0, **READ_ERRORS)


def params_record(p) -> dict:
    """A SimParams as JSON values (tuples as lists)."""
    import dataclasses
    import json

    return json.loads(json.dumps(dataclasses.asdict(p)))


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def file_record(path) -> dict:
    return {"sha256": sha256(path), "bytes": os.path.getsize(path)}


def workdir_files(workdir):
    """Every file assemble() wrote in `workdir` but its log."""
    return sorted(f for f in os.listdir(workdir)
                  if f != "log" and os.path.isfile(os.path.join(workdir, f)))


@contextlib.contextmanager
def etree_graphml():
    """networkx's write_graphml pinned to its ElementTree serializer, the
    one it takes where lxml does not import.  Where lxml imports it writes
    the same graph in other bytes, so the manifest is written, and the
    card held to it, under this pin."""
    from unittest import mock

    import networkx as nx
    from networkx.readwrite import graphml

    with mock.patch.object(nx, "write_graphml", graphml.write_graphml_xml):
        yield


def manifest_mismatches(workdir, want: dict, names):
    """The names among `names` whose file in `workdir` is missing or
    differs from the manifest's record `want[name]`."""
    bad = []
    for name in names:
        path = os.path.join(workdir, name)
        if not os.path.isfile(path) or file_record(path) != want[name]:
            bad.append(name)
    return bad


def hinged_edges(G) -> int:
    return sum(1 for _, _, d in G.edges(data=True) if d.get("hinge_edge") == 1)


def coverage_fractions(genome, contigs, p):
    """For each chromosome, the share of PROBE-bp probes every PROBE_STEP bp
    of its non-telomeric interior found in the contigs, on either strand
    (tests/test_multichrom.py's check at the probe spacing of a genome
    this size)."""
    comp = str.maketrans("ACGT", "TGCA")
    seqs = [s.upper() for _, s in contigs]
    blob = "\n".join(seqs + [s.translate(comp)[::-1] for s in seqs])
    code2b = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for off, L in zip(chrom_starts(p.chromosomes), p.chromosomes):
        lo, hi = off + p.telomere_len + 1000, off + L - p.telomere_len - 1000
        probes = range(lo, hi - PROBE, PROBE_STEP)
        found = sum(code2b[genome[s:s + PROBE]].tobytes().decode() in blob
                    for s in probes)
        out.append(found / max(1, len(probes)))
    return out


def build(tmpdir: str, device) -> str:
    """filter -> maximal -> layout -> clip -> draft-path through
    hinge_tpu_torch on `device`, on case (a)'s reads and overlaps, with the
    nominal config (tests/torch_golden.py's build); returns the prefix."""
    return torch_golden.build(tmpdir, device, params=CASE_A, prefix=PREFIX)


def mismatches(tmpdir: str):
    """Golden files whose bytes differ from the ones in `tmpdir`."""
    return torch_golden.mismatches(tmpdir, GOLDEN_FILES, GOLDEN_DIR)
