"""Device selection and host->device copies.

There is no fallback: a caller that asks for "cuda" on a machine without
a card gets an error, never a silent CPU run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: opt-in switches of hinge_tpu whose device code is not ported yet, with
#: the ROADMAP queue item that ports it
_UNPORTED_SWITCHES = {
    "HINGE_SHARDED": "ROADMAP queue item 6 (sharding/distributed with NCCL)",
}


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hinge_tpu_torch: device='cuda' but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain torch versions")


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu", or a
    torch.device); raises for CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"hinge_tpu_torch: unsupported device {device!r}")
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Copy a numpy array onto `device` with its dtype unchanged."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def refuse_unported(name: str) -> None:
    """Raise NotImplementedError when the opt-in switch `name` is on."""
    if os.environ.get(name, "0") == "1":
        raise NotImplementedError(
            f"{name}=1 reaches device code that hinge_tpu_torch has not "
            f"ported yet: {_UNPORTED_SWITCHES[name]}")
