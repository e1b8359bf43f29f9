"""Copied from hinge_tpu/native/__init__.py: the C++ sources and the
bindings verbatim; the library builds into hinge_tpu_torch/build/native/.

Native (C++) IO core with lazy build + ctypes binding.

The shared library is compiled on first use (g++ -O3) into the port's
build/native/ directory.  The port's host stages have no other
implementation: there is no fallback, and a library that does not build
or load raises NativeLibraryError.  The compiler writes a file private to
the process, which is then renamed into place, so that parallel test
workers never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shlex
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "io_native.cpp")
_SRC2 = os.path.join(_HERE, "dalign_np.cpp")
_SRC3 = os.path.join(_HERE, "stdcxx_order.cpp")
_SRC4 = os.path.join(_HERE, "sweeps.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libhinge_io.so")
#: the compiler command, before its sources and its output
_CXX = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"]


class NativeLibraryError(RuntimeError):
    """The port's native library did not build or did not load."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[NativeLibraryError] = None


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = _CXX + [_SRC, _SRC2, _SRC3, _SRC4, "-o", tmp]
    try:
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeLibraryError(
                f"`{shlex.join(cmd)}` did not run: {e}") from None
        if r.returncode != 0:
            tail = r.stderr.decode(errors="replace").splitlines()[-20:]
            raise NativeLibraryError(
                f"`{shlex.join(cmd)}` exited {r.returncode}:\n"
                + "\n".join(tail))
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    if not os.path.exists(_LIB_PATH) or (
        os.path.getmtime(_LIB_PATH)
        < max(os.path.getmtime(_SRC), os.path.getmtime(_SRC2),
              os.path.getmtime(_SRC3), os.path.getmtime(_SRC4))
    ):
        _build()
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        raise NativeLibraryError(f"loading {_LIB_PATH}: {e}") from None
    c = ctypes
    lib.las_scan.restype = c.c_int
    lib.las_scan.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64),
    ]
    lib.las_parse.restype = c.c_int
    for fn in ("fasta_scan", "minimizers", "map_block_hits",
               "minimizers_batch", "index_sort_filter", "emit_records",
               "myers_align_batch", "falcon_cns_batch", "mirror_traces",
               "scatter_copy_u16", "dalign_compact_rows", "build_contexts",
               "containment_sweep", "consensus_vote_batch",
               "falcon_tags_batch", "format_coverage_lines"):
        getattr(lib, fn).restype = c.c_int64
    for fn in ("dalign_rows_batch", "dalign_rows_batch_mt",
               "dalign_diffs_batch", "umap_iter_order", "stdsort_desc_perm",
               "umap_iter_order_batch", "stdsort_desc_perm_batch"):
        getattr(lib, fn).restype = c.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, building it on first call.  Raises
    NativeLibraryError if it does not build or load, and the same error at
    once on every later call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            _lib = _load()
        except NativeLibraryError as e:
            _error = e
            raise
        return _lib
