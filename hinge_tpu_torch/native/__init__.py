"""Copied from hinge_tpu/native/__init__.py: the C++ sources and the
bindings verbatim; the library builds into hinge_tpu_torch/build/native/.

Native (C++) IO core with lazy build + ctypes binding.

The shared library is compiled on first use (g++ -O3) into the port's
build/native/ directory; all users fall back to the pure-numpy
implementations when a toolchain is unavailable.  The compiler writes a
file private to the process, which is then renamed into place, so that
parallel test workers never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
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
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
        _SRC, _SRC2, _SRC3, _SRC4, "-o", tmp,
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None if
    unavailable (callers must fall back to the Python implementations)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH)
            < max(os.path.getmtime(_SRC), os.path.getmtime(_SRC2),
                  os.path.getmtime(_SRC3), os.path.getmtime(_SRC4))
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        c = ctypes
        lib.las_scan.restype = c.c_int
        lib.las_scan.argtypes = [
            c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
            c.POINTER(c.c_int64),
        ]
        lib.las_parse.restype = c.c_int
        lib.fasta_scan.restype = c.c_int64
        if hasattr(lib, "minimizers"):
            lib.minimizers.restype = c.c_int64
        if hasattr(lib, "map_block_hits"):
            lib.map_block_hits.restype = c.c_int64
        for fn in ("minimizers_batch", "index_sort_filter", "emit_records",
                   "myers_align_batch", "falcon_cns_batch", "mirror_traces",
                   "scatter_copy_u16", "dalign_compact_rows",
                   "build_contexts"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = c.c_int64
        for fn in ("dalign_rows_batch", "dalign_rows_batch_mt",
                   "dalign_diffs_batch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = c.c_int
        for fn in ("containment_sweep", "consensus_vote_batch",
                   "falcon_tags_batch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = c.c_int64
        for fn in ("umap_iter_order", "stdsort_desc_perm",
                   "umap_iter_order_batch", "stdsort_desc_perm_batch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = c.c_int
        _lib = lib
        return _lib
