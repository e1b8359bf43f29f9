"""Copied from hinge_tpu/utils/log.py (logger and stage timing verbatim),
with the torch profiler in place of its `jax_trace`.

The reference registers an spdlog logger with stdout + daily-file sinks in
every binary (`filter.cpp:201-205`, mkdir("log") at :170) and logs stage
counters (#reads, #alignments, #hinges, coverage estimates — SURVEY.md §5).
This module provides the equivalent: a process-wide logger writing to
stdout and `<logdir>/log.txt`, a `stage_timer` context manager that
records wall time per stage, and an optional torch profiler trace hook.
The logger is named "hinge_tpu_torch", so that it never shares handlers
with another package's logger in the same process.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Dict, Optional

import torch

_LOGGER: Optional[logging.Logger] = None
_TIMINGS: Dict[str, float] = {}


def get_logger(logdir: str = "log",
               name: str = "hinge_tpu_torch") -> logging.Logger:
    """stdout + file dual-sink logger (reference: spdlog 'log' logger)."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    try:
        os.makedirs(logdir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logdir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:
        pass
    _LOGGER = logger
    return logger


@contextlib.contextmanager
def stage_timer(name: str, logger: Optional[logging.Logger] = None):
    """Times a pipeline stage; accumulates into the process timing table."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TIMINGS[name] = _TIMINGS.get(name, 0.0) + dt
        if logger is not None:
            logger.info("%s: %.2fs", name, dt)


def timings() -> Dict[str, float]:
    return dict(_TIMINGS)


@contextlib.contextmanager
def torch_trace(out_dir: Optional[str]):
    """Chrome/Perfetto trace of the enclosed block (CPU and CUDA
    activities) written to <out_dir>/trace.json when out_dir is set."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
