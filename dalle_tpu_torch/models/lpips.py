"""LPIPS perceptual distance: conv features, unit-normalized differences,
learned 1×1 heads, spatial mean.

Port of ``dalle_tpu/models/lpips.py``. Inputs are NHWC in [-1, 1], as in
the JAX package; the trunk runs NCHW. Module names follow the flax tree
(``vgg.slice{s}_conv{i}``, ``lin{i}``); a head keeps the flax shape
(1, 1, 1, C).

* ``load_tiny_perceptual`` loads the port's copy of the JAX package's
  shipped weights (``models/data/tiny_perceptual.npz``), already in the
  port's layout: state_dict keys, convolution kernels OIHW. It is the
  default perceptual net of VQGAN training.
* The torchvision VGG16 trunk (``slices=None``) keeps its random init: its
  weights are a download. The JAX package's ``load_torch_weights`` for a
  local copy is not ported (no caller; ``ROADMAP.md`` Queue 1 item 10).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# torchvision VGG16 conv layout: channels per conv, a maxpool before each
# slice but the first
VGG_SLICES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
# the JAX package's in-repo trunk (same structure, ~0.6M parameters)
TINY_SLICES = ((32, 32), (64, 64), (128, 128), (256,))
TINY_WEIGHTS = os.path.join(os.path.dirname(__file__), "data", "tiny_perceptual.npz")

# ImageNet scaling constants (taming's ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The conv trunk; ``forward`` returns each slice's relu output (NCHW)."""

    def __init__(self, slices: Optional[Tuple[Tuple[int, ...], ...]] = None):
        super().__init__()
        self.slices = tuple(slices or VGG_SLICES)
        ch = 3
        for s, chans in enumerate(self.slices):
            for i, out in enumerate(chans):
                self.add_module(f"slice{s}_conv{i}", nn.Conv2d(ch, out, 3, padding=1))
                ch = out

    def forward(self, x) -> Sequence[torch.Tensor]:
        outs = []
        for s, chans in enumerate(self.slices):
            if s > 0:
                x = F.max_pool2d(x, 2, 2)
            for i in range(len(chans)):
                x = torch.relu(getattr(self, f"slice{s}_conv{i}")(x))
            outs.append(x)
        return outs


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """d(x, y) for NHWC images in [-1, 1] → (b,)."""

    def __init__(self, slices: Optional[Tuple[Tuple[int, ...], ...]] = None):
        super().__init__()
        self.vgg = VGG16Features(slices)
        for i, chans in enumerate(self.vgg.slices):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(1, 1, 1, chans[-1])))

    def forward(self, x, y):
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        fx = self.vgg(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self.vgg(((y - shift) / scale).permute(0, 3, 1, 2))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = getattr(self, f"lin{i}").reshape(1, -1, 1, 1).abs()
            total = total + torch.mean(torch.sum(diff * w, dim=1), dim=(1, 2))
        return total


def init_lpips(*, seed: int = 0, slices=None, device=None) -> LPIPS:
    """An LPIPS with a random trunk (normal, std 1/sqrt(fan-in); biases 0)
    and heads of ones, from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = LPIPS(slices)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                w.normal_(0.0, (w.shape[1] * w.shape[2] * w.shape[3]) ** -0.5, generator=gen)
                m.bias.zero_()
    return model.eval().requires_grad_(False)


def load_tiny_perceptual(path: str = TINY_WEIGHTS, device=None) -> LPIPS:
    """The shipped perceptual net, frozen. Raises FileNotFoundError when the
    file is missing."""
    dev = resolve_device(device)
    data = np.load(path)
    with torch.device(dev):
        model = LPIPS(TINY_SLICES)
    model.load_state_dict({k: torch.from_numpy(np.array(data[k])) for k in data.files})
    return model.eval().requires_grad_(False)

