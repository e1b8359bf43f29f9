"""hinge_tpu_torch.overlap.device_join against the native C join and
hinge_tpu's device join, on the CPU, tolerance 0 (every column, the trace
offsets and the trace bytes).  Each side gets its own ReadStore: the
port's is carried over from hinge_tpu's simulator output by
hinge_tpu_torch.data.carry.

The workloads are tests/test_device_join.py's: 120 kb at 14x in one block
and in blocks of a fifth of the bases, and a repeat-heavy 60 kb genome."""

import numpy as np
import pytest
import torch

from hinge_tpu.data.overlaps import ReadStore
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.overlap import device_join as JDJ
from hinge_tpu.overlap import mapper as M
from hinge_tpu_torch.data import carry
from hinge_tpu_torch.overlap import device_join as DJ
from hinge_tpu_torch.overlap import mapper as TM
from tests.test_device_join import _assert_stores_equal, _c_base_records


def _port(rs):
    return carry.read_store_from_arrays(vars(rs))


@pytest.fixture(scope="module")
def sim_mid():
    return simulate(SimParams(genome_len=120_000, coverage=14, seed=11))[2]


@pytest.fixture(scope="module")
def sim_repeat():
    return simulate(SimParams(genome_len=60_000, coverage=10, seed=5,
                              repeats=((5_000, 40_000, 6_000),)))[2]


def test_kmer_hash_matches_mapper():
    """The int64 splitmix equals mapper._kmer_hash's uint64 bits, top bit
    set included."""
    codes = np.random.default_rng(0).integers(0, 4, 4000).astype(np.uint8)
    want = M._kmer_hash(codes, 15).view(np.int64)
    got = DJ.kmer_hash(torch.from_numpy(codes), 15).numpy()[: want.size]
    assert (want < 0).sum() > 1000
    np.testing.assert_array_equal(got, want)
    # every bit of the finalizer, at inputs with high bits set
    v = np.array([0, 1, 2**62 - 1, 2**63 - 1, 2**63, 2**64 - 1,
                  0xDEADBEEFCAFEF00D], np.uint64)
    h = (v ^ (v >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    np.testing.assert_array_equal(
        DJ.splitmix(torch.from_numpy(v.view(np.int64))).numpy(), h.view(np.int64))


@pytest.mark.parametrize("workload", ["one_block", "five_blocks", "repeats"])
def test_device_join_matches_c_join(workload, sim_mid, sim_repeat):
    rs = sim_repeat if workload == "repeats" else sim_mid
    kw = {}
    if workload == "five_blocks":
        kw["block_bases"] = max(2 * int(rs.length.sum()) // 5, 1 << 16)
    ref = _c_base_records(rs)
    assert ref.n > 50
    stats = {}
    got = DJ.overlap_base_records(_port(rs), device="cpu", stats=stats, **kw)
    assert stats["blocks"] >= (5 if workload == "five_blocks" else 1)
    _assert_stores_equal(got, ref)


def test_device_join_matches_hinge_tpu():
    rs = simulate(SimParams(genome_len=40_000, coverage=10, seed=3))[2]
    want = JDJ.overlap_base_records(rs)
    assert want is not None and want.n > 20
    _assert_stores_equal(DJ.overlap_base_records(_port(rs), device="cpu"),
                         want)


def _short_reads():
    return ReadStore(length=np.array([10, 12], np.int32),
                     bases_off=np.array([0, 10, 22], np.int64),
                     bases=np.zeros(22, np.uint8))


def test_gate_returns_none():
    """A gate refuses w > k in both packages (None).  Reads shorter than
    k + w, which hinge_tpu's gate refuses, pass the port's and give the C
    join's records (none for reads shorter than k)."""
    rs = _short_reads()
    assert JDJ.overlap_base_records(rs) is None
    assert DJ.join_gate(_port(rs), 15, 12, 500) is None
    _assert_stores_equal(DJ.overlap_base_records(_port(rs), device="cpu"),
                         _c_base_records(rs))
    assert JDJ.overlap_base_records(rs, w=16) is None
    assert DJ.overlap_base_records(_port(rs), w=16, device="cpu") is None
    assert "w = 16 > k = 15" in DJ.join_gate(_port(rs), 15, 16, 500)


def test_switch_raises_on_gated_input(monkeypatch):
    """With HINGE_DEVICE_JOIN=1 a gated input raises, naming the gate and
    the switch that runs the C join; it never takes the C join."""
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    with pytest.raises(ValueError, match="w = 16 > k = 15.*HINGE_DEVICE_JOIN=0"):
        TM.overlap_reads(_port(_short_reads()), w=16, device="cpu")


def test_overlap_reads_device_matches_c(sim_mid, monkeypatch):
    """overlap_reads (dedup + mirrors) through the device join equals
    hinge_tpu's overlap_reads on the C join."""
    monkeypatch.delenv("HINGE_DEVICE_JOIN", raising=False)
    ref = M.overlap_reads(sim_mid)
    port_rs = _port(sim_mid)
    _assert_stores_equal(TM.overlap_reads(port_rs, device="cpu"), ref)
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    _assert_stores_equal(TM.overlap_reads(port_rs, device="cpu"), ref)
