"""Build and bind the hand-written CUDA kernels of `hinge_tpu_torch/csrc`.

At first use, `nvcc` compiles each `csrc/*.cu` for sm_90a into a shared
library of its own with a plain C interface under `hinge_tpu_torch/build/`
(listed in .gitignore), one compiler process per source, all started
together; `ctypes` binds them.  Nothing is built at import time, and a
failed build raises DeviceError: there is no fallback to another
implementation.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
import types

from hinge_tpu_torch.device import DeviceError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: argument types of each exported entry point
SIGNATURES = {
    "hinge_band_fill": [_VP, _LL, _VP, _LL, _VP, _VP, _VP, _I, _I, _VP],
    "hinge_row_traceback": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "hinge_emit_rows": [*[_VP] * 6, _LL, _VP, _LL, _VP, _VP, _VP,
                        *[_I] * 4, _VP],
    "hinge_wave_align": [_VP, _VP, _LL, _VP, _VP, *[_I] * 7, _LL, _I,
                         *[_VP] * 8],
    "hinge_wave_align_resident": [_I, _I, _LL, _I],
    "hinge_thin_rows_bounds": [_VP, _LL, _LL, _VP, _VP, _VP],
    "hinge_thin_rows_walk": [_VP, _VP, _VP, *[_LL] * 6, *[_VP] * 11],
    "hinge_thin_rows_sync": [_VP, _LL, _VP, _VP, _VP],
    "hinge_thin_rows_copy": [*[_VP] * 5, _LL, *[_VP] * 5],
}

_lock = threading.Lock()
_kernels = None
#: what the last build in this process did: seconds, commands, ptxas report
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceError("hinge_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def compile_sources(sources, build_dir: str) -> dict:
    """Compile each source into `build_dir/lib<stem>.so`, skipping the
    ones newer than their source, all nvcc processes at once.  Returns
    {stem: library path}; records times and the ptxas report in
    `build_info`."""
    os.makedirs(build_dir, exist_ok=True)
    libs, procs = {}, {}
    t0 = time.perf_counter()
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = os.path.join(build_dir, f"lib{stem}.so")
        libs[stem] = lib
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[stem] = (cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    report, failed = [], []
    for stem, (cmd, tmp, lib, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, lib)
        report.append(err)
    if failed:
        raise DeviceError("hinge_tpu_torch: nvcc failed:\n" + "\n".join(failed))
    if procs:
        build_info.update(seconds=time.perf_counter() - t0,
                          cmds=[" ".join(c) for c, *_ in procs.values()],
                          ptxas="\n".join(report))
    return libs


def bind(libs: dict) -> types.SimpleNamespace:
    """The entry points of SIGNATURES from the libraries of
    `compile_sources`, with their ctypes argument types set."""
    fns = {}
    for path in libs.values():
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = _I
                fns[name] = fn
    missing = set(SIGNATURES) - set(fns)
    if missing:
        raise DeviceError(f"hinge_tpu_torch: kernels missing: {sorted(missing)}")
    return types.SimpleNamespace(**fns)


def load_kernels() -> types.SimpleNamespace:
    """The kernel entry points, compiled on first call when missing or
    older than their sources."""
    global _kernels
    with _lock:
        if _kernels is None:
            _kernels = bind(compile_sources(
                sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))), BUILD_DIR))
        return _kernels
