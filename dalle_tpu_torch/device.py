"""Where the port's entry points run."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. Without a
    card and without an explicit device this raises: nothing falls back to
    the CPU unless the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run it on the CPU")
    return torch.device("cuda")


def to_device(array, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``. To a card it goes
    through pinned memory without blocking the host, so an upload in the
    middle of a dispatch does not wait for the kernels queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
