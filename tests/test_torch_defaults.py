"""The port's CUDA defaults for the overlap join and the consensus vote,
on the CPU, tolerance 0.

- `mapper.use_device_join` and `consensus.vote_route` for a CPU and a
  CUDA device under each value of HINGE_DEVICE_JOIN / HINGE_DEVICE_VOTE
  (a CUDA `torch.device` allocates nothing, so no card is needed).
- Reads shorter than k + w run through the device join: its records equal
  the port's C join's and hinge_tpu's C join's on a read set holding reads
  of fewer than k, of k..k+w-1 and of more bases, with one bucket per
  short read family overflowing max_bucket.
- A capacity gate under the default raises, naming the gate and
  HINGE_DEVICE_JOIN=0, and never runs the C join.
- assemble() from FASTA with HINGE_DEVICE_JOIN=1 on the short-read set is
  byte-equal to hinge_tpu's run on the C join, and the pipeline and the
  overlap verb hand their device to the routing rules.
"""

import os

import numpy as np
import pytest
import torch

from hinge_tpu.data.overlaps import ReadStore
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.overlap import device_join as JDJ
from hinge_tpu_torch.data import carry
from hinge_tpu_torch.overlap import device_join as DJ
from hinge_tpu_torch.overlap import mapper as TM
from hinge_tpu_torch.stages import consensus as TC
from tests.test_device_join import _assert_stores_equal, _c_base_records

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
K, W = 15, 12
#: lengths of the cut reads: none, one and w-1 k-mers, a whole window
SHORT_LENS = (5, 14, 15, 16, 20, 25, 26, 27, 30)
#: reads whose first 24 bases (10 k-mers, one minimizer each) are added
#: 70 times over: more than max_bucket = 64 index entries for one hash
PREFIX_READS = (0, 5, 9)


@pytest.mark.parametrize("device", [CPU, CUDA], ids=["cpu", "cuda"])
@pytest.mark.parametrize("mode", [None, "0", "1"], ids=["unset", "0", "1"])
def test_join_route(device, mode, monkeypatch):
    if mode is None:
        monkeypatch.delenv("HINGE_DEVICE_JOIN", raising=False)
    else:
        monkeypatch.setenv("HINGE_DEVICE_JOIN", mode)
    want = {None: device.type == "cuda", "0": False, "1": True}[mode]
    assert TM.use_device_join(device) is want
    assert TM.use_device_join(device.type) is want


@pytest.mark.parametrize("device", [CPU, CUDA], ids=["cpu", "cuda"])
@pytest.mark.parametrize("mode", [None, "0", "1", "np"],
                         ids=["unset", "0", "1", "np"])
def test_vote_route(device, mode, monkeypatch):
    if mode is None:
        monkeypatch.delenv("HINGE_DEVICE_VOTE", raising=False)
    else:
        monkeypatch.setenv("HINGE_DEVICE_VOTE", mode)
    want = {None: "device" if device.type == "cuda" else "native",
            "0": "native", "1": "device", "np": "np"}[mode]
    assert TC.vote_route(device) == want
    assert TC.vote_route(str(device)) == want


def test_unknown_switch_values_raise(monkeypatch):
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "yes")
    with pytest.raises(ValueError, match="HINGE_DEVICE_JOIN"):
        TM.use_device_join(CUDA)
    monkeypatch.setenv("HINGE_DEVICE_VOTE", "on")
    with pytest.raises(ValueError, match="HINGE_DEVICE_VOTE"):
        TC.vote_route(CUDA)


def _with_short_reads(rs, seed=1):
    """hinge_tpu's ReadStore of `rs`'s reads with cut reads interleaved:
    three of each SHORT_LENS length from random places, and 70 copies of
    the 24-base prefix of each PREFIX_READS read."""
    rng = np.random.default_rng(seed)
    reads = [rs.get_bases(i) for i in range(rs.n_reads)]
    cut = []
    for n in SHORT_LENS:
        for _ in range(3):
            r = reads[int(rng.integers(len(reads)))]
            s = int(rng.integers(0, len(r) - n))
            cut.append(r[s : s + n])
    cut += [reads[i][:24] for i in PREFIX_READS for _ in range(70)]
    out = []
    for i, r in enumerate(reads):
        out.append(r)
        if i < len(cut):
            out.append(cut[i])
    out += cut[len(reads):]
    lens = np.array([len(r) for r in out], np.int32)
    off = np.zeros(len(out) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return ReadStore(length=lens, bases_off=off,
                     bases=np.concatenate(out).astype(np.uint8),
                     names=[f"r/{i + 1}/0_{n}" for i, n in enumerate(lens)])


@pytest.fixture(scope="module")
def short_set():
    rs = simulate(SimParams(genome_len=60_000, coverage=12, seed=7,
                            sub_rate=0.01, ins_rate=0.005,
                            del_rate=0.005))[2]
    return _with_short_reads(rs)


def test_short_reads_join_matches_c_joins(short_set):
    """The device join on reads of < k, k..k+w-1 and >= k+w bases equals
    the port's C join and hinge_tpu's C join on every column and trace
    byte; hinge_tpu's device join refuses the set."""
    lens = short_set.length
    assert (lens < K).any() and ((lens >= K) & (lens < K + W)).any()
    assert DJ.join_gate(carry.read_store_from_arrays(vars(short_set)),
                        K, W, 500) is None
    # the prefix copies overflow their buckets: the C index drops hashes
    # that it keeps without them
    long_only = [short_set.get_bases(i) for i in range(short_set.n_reads)
                 if lens[i] > 100]
    every = [short_set.get_bases(i) for i in range(short_set.n_reads)]
    dropped = np.setdiff1d(TM.build_index(long_only, K, W).hashes,
                           TM.build_index(every, K, W).hashes)
    assert len(dropped) >= len(PREFIX_READS)

    want = _c_base_records(short_set)
    assert want.n > 100
    assert JDJ.overlap_base_records(short_set) is None
    port_rs = carry.read_store_from_arrays(vars(short_set))
    targets = [port_rs.get_bases(i) for i in range(port_rs.n_reads)]
    os.environ["HINGE_DEVICE_JOIN"] = "0"
    try:
        port_c = TM.map_reads_to_targets(targets, port_rs, half_pairs=True)
    finally:
        os.environ.pop("HINGE_DEVICE_JOIN", None)
    _assert_stores_equal(port_c, want)
    got = DJ.overlap_base_records(port_rs, device="cpu",
                                  block_bases=1 << 16)
    _assert_stores_equal(got, want)


@pytest.mark.parametrize("via", ["overlap_reads", "blocks"])
def test_device_join_leaves_the_c_joins_minimizer_cache(via, short_set,
                                                         monkeypatch):
    """overlap_reads on the device join (and the device join in blocks of
    2^16 bases) leaves on the ReadStore the query minimizers that the C
    join caches there for the map stage: `_minimizers_batch`'s positions,
    hashes and counts, array-equal."""
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    port_rs = carry.read_store_from_arrays(vars(short_set))
    if via == "blocks":
        stats = {}
        DJ.overlap_base_records(port_rs, device="cpu", block_bases=1 << 16,
                                stats=stats)
        assert stats["blocks"] > 5
    else:
        TM.overlap_reads(port_rs, device="cpu")
    got = TM.minimizer_cache(port_rs)[(K, W)]
    want = TM._minimizers_batch(port_rs.bases, port_rs.bases_off, K, W,
                                both_strands=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() == len(got[0]) and (got[2] == 0).any()


def test_short_stream_minimizers_match_mapper():
    """One read a length from 0 to k + w + 2: the device minimizers of
    both strands equal mapper.minimizers' positions and hashes."""
    rng = np.random.default_rng(4)
    lens = np.arange(0, K + W + 3)
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    packed = torch.from_numpy(DJ._pack_codes(carry.read_store_from_arrays(
        dict(length=lens.astype(np.int32), bases_off=off, bases=codes))))
    (mh, mpos, msid), _ = DJ.minimizers(
        packed, torch.from_numpy(off), torch.from_numpy(lens), 0, len(lens),
        2 * int(lens.sum()), K, W)
    for r, n in enumerate(lens):
        fwd = codes[off[r] : off[r + 1]]
        for strand, seq in ((0, fwd), (1, (3 - fwd[::-1]).astype(np.uint8))):
            pos, h = TM.minimizers(seq, K, W)
            sel = (msid == 2 * r + strand).numpy()
            np.testing.assert_array_equal(mpos.numpy()[sel], pos)
            np.testing.assert_array_equal(
                mh.numpy()[sel] ^ np.int64(DJ._SIGN), h.view(np.int64))
            if n < K + W:
                assert len(pos) == (n >= K)


@pytest.mark.parametrize("gate", ["reads", "length", "band", "memory",
                                  "stub"])
def test_capacity_gate_raises_under_default(gate, monkeypatch):
    """On CUDA with HINGE_DEVICE_JOIN unset, a read set past a capacity
    gate raises ValueError naming the gate and HINGE_DEVICE_JOIN=0; the
    C join never runs.  The gates are checked before any device work, so
    a CUDA torch.device needs no card (the card's free memory is stubbed
    to 1 MiB for the memory gate)."""
    monkeypatch.delenv("HINGE_DEVICE_JOIN", raising=False)
    lens = {"reads": [30] * DJ.MAX_TID, "length": [30, 1 << 24],
            "band": [30, 1_100_000], "memory": [30, 40],
            "stub": [30, 40]}[gate]
    lens = np.array(lens, np.int32)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    rs = carry.read_store_from_arrays(dict(
        length=lens, bases_off=off, bases=np.zeros(int(off[-1]), np.uint8)))
    names = {"reads": "MAX_TID", "length": "2\\^24", "band": "band_rel",
             "memory": "bytes of device memory, 1048576 free",
             "stub": "stubbed gate"}
    if gate == "stub":
        monkeypatch.setattr(DJ, "join_gate", lambda *a, **kw: "stubbed gate")
    monkeypatch.setattr(DJ, "_free_bytes", lambda dev: 1 << 20)

    def no_c_join(*a, **kw):
        raise AssertionError("the C join ran")

    monkeypatch.setattr(TM, "map_reads_to_targets", no_c_join)
    with pytest.raises(ValueError, match=names[gate]) as e:
        TM.overlap_reads(rs, device=CUDA)
    assert "HINGE_DEVICE_JOIN=0" in str(e.value)
    assert DJ.overlap_base_records(rs, device=CUDA) is None
    if gate == "memory":  # the host has no device memory to run out of
        assert DJ.join_gate(rs, K, W, 500, device=CPU) is None


def test_fasta_only_short_reads_match_hinge_tpu_c_join(tmp_path,
                                                       monkeypatch):
    """assemble() from FASTA on a read set with short reads: the port
    with HINGE_DEVICE_JOIN=1 (device="cpu") writes the draft, consensus
    and GFA of hinge_tpu's C-join run byte for byte.  The pipeline hands
    its device to both routing rules."""
    from hinge_tpu.pipeline import assemble as assemble_jax
    from hinge_tpu_torch.pipeline import assemble as assemble_torch

    monkeypatch.setenv("HINGE_PARITY_ALIGN", "1")
    rs = _with_short_reads(simulate(SimParams(
        genome_len=50_000, coverage=18.0, mean_read_len=5000,
        std_read_len=1000, seed=21))[2])
    assert (rs.length < K + W).sum() > 200
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i))
                        for i in range(rs.n_reads)))
    quiet = lambda *a: None  # noqa: E731
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "0")
    assemble_jax(fasta=fasta, workdir=str(tmp_path / "jax"), log=quiet)

    seen = []
    for mod, name in ((TM, "use_device_join"), (TC, "vote_route")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda dev, _r=real, _n=name: (
            seen.append((_n, str(dev))), _r(dev))[1])
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    assemble_torch(fasta=fasta, workdir=str(tmp_path / "torch"), log=quiet,
                   device="cpu")
    assert ("use_device_join", "cpu") in seen
    assert ("vote_route", "cpu") in seen
    for name in ("asm.draft.fasta", "asm.consensus.fasta",
                 "asm_consensus.gfa"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = f.read()
        assert len(want) > 1000, name
        with open(tmp_path / "torch" / name, "rb") as f:
            assert f.read() == want, name


def test_overlap_verb_hands_its_device_to_the_rule(tmp_path, monkeypatch):
    """`cli overlap --device cpu` asks use_device_join with its device;
    with the switch unset that is the C join, whose records it writes."""
    from hinge_tpu_torch.cli import main
    from hinge_tpu_torch.io.las import read_las

    rs = simulate(SimParams(genome_len=20_000, coverage=8, seed=2))[2]
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i))
                        for i in range(rs.n_reads)))
    monkeypatch.delenv("HINGE_DEVICE_JOIN", raising=False)
    seen = []
    real = TM.use_device_join
    monkeypatch.setattr(TM, "use_device_join",
                        lambda dev: (seen.append(str(dev)), real(dev))[1])
    out = str(tmp_path / "ov.las")
    assert main(["overlap", "--fasta", fasta, "--out", out,
                 "--device", "cpu"]) == 0
    assert seen == ["cpu"]
    want = TM.overlap_reads(carry.read_store_from_arrays(vars(rs)),
                            device="cpu")
    got = read_las(out, read_lengths=rs.length)
    assert got.n == want.n > 0
    for f in ("a_id", "b_id", "a_start", "a_end", "b_start", "b_end", "rc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_defaults_ab_alternates_arms_with_equal_outputs(monkeypatch):
    """bench_defaults_ab on a 150 kb noisy genome on the CPU, its device
    arm pinned to the device join and vote (on the CPU the unset switches
    take the C paths): equal outputs, the join's per-phase stats in the
    device run only, and the join check's records equal."""
    from hinge_tpu_torch.bench import bench_defaults_ab as AB

    monkeypatch.setitem(AB.ARMS, "device", {"HINGE_DEVICE_JOIN": "1",
                                            "HINGE_DEVICE_VOTE": "1"})
    monkeypatch.setenv("HINGE_DEVICE_VOTE", "np")
    monkeypatch.setattr(AB, "ORDER", ("c", "device"))
    e = AB.run(150_000, 15.0, device="cpu", errors=True)
    assert os.environ["HINGE_DEVICE_VOTE"] == "np"
    c, dev = e["runs"]
    assert e["outputs_equal"] and c["consensus_sha256"] == dev["consensus_sha256"]
    assert c["device_join"] is None
    assert dev["device_join"]["blocks"] >= 1 and dev["device_join"]["hits"] > 0
    assert {"overlap", "consensus"} <= set(dev["stages"])
    assert e["join"]["equal"] and e["join"]["records"] > 100
    assert e["workload"]["sub_rate"] == 0.01
