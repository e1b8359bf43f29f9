"""hinge_tpu_torch.data.carry and the port's own native library.

carry builds the port's stores and config from another package's field
values: every carried field must equal its source.  The port's copy of
the native C++ library builds into the port's own directory and must
give what hinge_tpu's library gives on the same inputs (the banded Myers
batch aligner and the .las reader), with both libraries loaded in one
process."""

import dataclasses
import os

import numpy as np
import pytest

from hinge_tpu import native as J_native
from hinge_tpu.config import nominal_config as j_nominal_config
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.las import read_las as j_read_las
from hinge_tpu.io.las import write_las
from hinge_tpu.ops import myers as JMY
from hinge_tpu_torch import native as T_native
from hinge_tpu_torch.config import Config, nominal_config
from hinge_tpu_torch.data import carry
from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore
from hinge_tpu_torch.io.las import read_las as t_read_las
from hinge_tpu_torch.ops import myers as TMY

OV_FIELDS = ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end", "b_start",
             "b_end", "rc", "diffs", "tlen", "trace_off", "trace")


@pytest.fixture(scope="module")
def sim():
    return simulate(SimParams(genome_len=20_000, coverage=10.0,
                              mean_read_len=3000, std_read_len=600,
                              sub_rate=0.01, ins_rate=0.005, del_rate=0.005,
                              seed=4))


def test_read_store_fields_equal_source(sim):
    rs = sim[2]
    got = carry.read_store_from_arrays(vars(rs))
    assert type(got) is ReadStore
    for f in ("length", "bases_off", "bases", "qv_off", "qv_val"):
        assert getattr(rs, f) is not None, f
        np.testing.assert_array_equal(getattr(got, f), getattr(rs, f), f)
    assert got.names == rs.names
    assert got.get_seq(3) == rs.get_seq(3)


def test_overlap_store_fields_equal_source(sim):
    ov = sim[3]
    ov.row_ptr(sim[2].n_reads)  # fill the source's cache
    got = carry.overlap_store_from_arrays(vars(ov))
    assert type(got) is OverlapStore
    assert got._row_ptr is None and got.tspace == ov.tspace
    for f in OV_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ov, f), f)
    np.testing.assert_array_equal(got.row_ptr(sim[2].n_reads),
                                  ov.row_ptr(sim[2].n_reads))


def test_config_from_dict_equals_source():
    src = j_nominal_config()
    src.filter.theta = 1234
    got = carry.config_from_dict(dataclasses.asdict(src))
    assert type(got) is Config
    assert dataclasses.asdict(got) == dataclasses.asdict(src)
    assert dataclasses.asdict(carry.config_from_dict(
        dataclasses.asdict(nominal_config()))) == dataclasses.asdict(
            nominal_config())


def test_native_library_builds_into_the_port(sim):
    lib_t, lib_j = T_native.get_lib(), J_native.get_lib()
    if lib_j is None:
        pytest.skip("hinge_tpu's native toolchain unavailable")
    port_build = os.path.join(os.path.dirname(T_native.__file__), os.pardir,
                              "build", "native")
    assert os.path.dirname(T_native._LIB_PATH) == os.path.normpath(port_build)
    assert T_native._LIB_PATH != J_native._LIB_PATH
    assert lib_t is not lib_j


@pytest.mark.parametrize("pad_full", [0, 1])
def test_native_myers_batch_matches_hinge_tpu(pad_full):
    if J_native.get_lib() is None:
        pytest.skip("hinge_tpu's native toolchain unavailable")
    rng = np.random.default_rng(pad_full)
    qs, ts = [], []
    for _ in range(40):
        t = rng.integers(0, 4, int(rng.integers(50, 600))).astype(np.uint8)
        q = t.copy()
        q[rng.random(len(q)) < 0.05] = rng.integers(0, 4)
        q = np.delete(q, np.nonzero(rng.random(len(q)) < 0.03)[0])
        qs.append(q)
        ts.append(t)
    fn = "align_full_batch" if pad_full else "align_exact_batch"
    got = getattr(TMY, fn)(qs, ts)
    want = getattr(JMY, fn)(qs, ts)
    assert len(got) == len(want) == len(qs)
    for (gq, gt), (wq, wt) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gt, wt)


def test_native_las_reader_matches_hinge_tpu(sim, tmp_path):
    if J_native.get_lib() is None:
        pytest.skip("hinge_tpu's native toolchain unavailable")
    path = str(tmp_path / "s.las")
    write_las(path, sim[3])
    got, want = t_read_las(path), j_read_las(path)
    assert got.n == want.n > 100 and got.tspace == want.tspace
    for f in OV_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
