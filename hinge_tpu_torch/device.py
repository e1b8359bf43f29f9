"""Device selection and the copies between host and device.

There is no fallback: a caller that asks for "cuda" on a machine without
a card gets an error, never a silent CPU run.
"""

from __future__ import annotations

import numpy as np
import torch

from hinge_tpu_torch.utils.log import count


class DeviceError(RuntimeError):
    """The device cannot run the port's work: no CUDA card, or a kernel
    that fails to build or launch.  Callers that record a failed piece of
    work and go on (the accuracy sweep) let this propagate instead."""


def is_device_error(e: BaseException) -> bool:
    """True for a DeviceError or an error that torch raised from the card
    (a CUDA runtime error or an out-of-memory)."""
    return isinstance(e, (DeviceError, torch.cuda.OutOfMemoryError,
                          getattr(torch, "AcceleratorError", DeviceError)))


def require_cuda() -> None:
    """Raise DeviceError unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise DeviceError(
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
    """Copy a numpy array onto `device` with its dtype unchanged; counted
    in the open call's `copy.h2d_bytes` (0 for a CPU device)."""
    a = np.ascontiguousarray(a)
    cuda = torch.device(device).type == "cuda"
    count("copy.h2d_bytes", a.nbytes if cuda else 0)
    return torch.from_numpy(a).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as a numpy array on the host; a CUDA tensor's copy is counted in
    the open call's `copy.d2h_bytes` and `copy.d2h_calls` (0 for a CPU
    tensor)."""
    cuda = t.is_cuda
    count("copy.d2h_bytes", t.numel() * t.element_size() if cuda else 0)
    count("copy.d2h_calls", int(cuda))
    return t.cpu().numpy()
