"""The port's native library is required: `native.get_lib()` raises when it
does not build, and `read_las`, which has no numpy reader to hand a bad
file to, raises what hinge_tpu's numpy reader raises on the same bytes."""

import numpy as np
import pytest

from hinge_tpu.io.las import read_las as j_read_las
from hinge_tpu_torch import native
from hinge_tpu_torch.data.overlaps import OverlapStore
from hinge_tpu_torch.io.las import read_las, write_las


@pytest.fixture
def las_file(tmp_path):
    """Three records with four trace values each, tspace 100 (uint8
    traces): a 12-byte header and 3 x 44 bytes."""
    n = 3
    ov = OverlapStore.from_arrays(
        tspace=100, a_id=np.arange(n), b_id=np.arange(n) + 1,
        a_len=np.full(n, 5000), b_len=np.full(n, 5000),
        a_start=np.full(n, 100), a_end=np.full(n, 300),
        b_start=np.full(n, 50), b_end=np.full(n, 250),
        rc=np.array([0, 1, 0]), tlen=np.full(n, 4),
        trace=np.tile(np.array([3, 100, 2, 100], np.uint16), n))
    path = tmp_path / "good.las"
    write_las(str(path), ov)
    return path


BAD_FILES = {
    "missing": None,
    "empty": lambda b: b"",
    "eleven_bytes": lambda b: b[:11],
    "last_record_cut": lambda b: b[:-3],
    "trailing_bytes": lambda b: b + b"\0\0",
}


@pytest.mark.parametrize("case", sorted(BAD_FILES))
def test_read_las_raises_like_the_numpy_reader(case, las_file, tmp_path):
    good = las_file.read_bytes()
    assert len(good) == 12 + 3 * 44
    bad = tmp_path / f"{case}.las"
    if BAD_FILES[case] is not None:
        bad.write_bytes(BAD_FILES[case](good))
    with pytest.raises(Exception) as want:
        j_read_las(str(bad), use_native=False)
    with pytest.raises(want.type) as got:
        read_las(str(bad))
    assert type(got.value) is want.type
    assert want.type in (FileNotFoundError, ValueError)


def test_get_lib_raises_when_the_compiler_is_missing(monkeypatch, tmp_path):
    missing = str(tmp_path / "no-such-compiler")
    monkeypatch.setattr(native, "_CXX", [missing, "-O3"])
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB_PATH",
                        str(tmp_path / "build" / "libhinge_io.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    errors = []
    for _ in range(2):
        with pytest.raises(native.NativeLibraryError) as e:
            native.get_lib()
        assert missing in str(e.value)
        errors.append(e.value)
    assert errors[0] is errors[1]
    assert not (tmp_path / "build" / "libhinge_io.so").exists()
