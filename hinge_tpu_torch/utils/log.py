"""Logging, stage timing and the profiler trace hook.

The logger and the per-stage timing table are hinge_tpu's
(`hinge_tpu.utils.log`, which imports no jax); this module adds the torch
profiler in place of `jax_trace`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from hinge_tpu.utils.log import get_logger, stage_timer, timings  # noqa: F401


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
