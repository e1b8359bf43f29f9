"""Build and bind the hand-written CUDA kernels of `hinge_tpu_torch/csrc`.

At first use, `nvcc` compiles every `csrc/*.cu` for sm_90a into one shared
library with a plain C interface under `hinge_tpu_torch/build/` (listed in
.gitignore), and `ctypes` binds it.  Nothing is built at import time, and
a failed build raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libhinge_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build in this process did: seconds, command, ptxas report
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("hinge_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def _compile() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"hinge_tpu_torch: nvcc failed ({r.returncode}):\n"
            f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, LIB_PATH)
    build_info.update(seconds=time.perf_counter() - t0, cmd=" ".join(cmd),
                      ptxas=r.stderr)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, compiled on first call when missing or older
    than its sources."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _compile()
        lib = ctypes.CDLL(LIB_PATH)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hinge_band_fill.argtypes = [vp, ll, vp, ll, vp, vp, vp, i, i, vp]
        lib.hinge_band_fill.restype = i
        lib.hinge_row_traceback.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp]
        lib.hinge_row_traceback.restype = i
        _lib = lib
        return _lib
