"""The VQGAN's adversary: the PatchGAN discriminator and the GAN losses.

Port of ``dalle_tpu/models/gan.py`` (taming's ``NLayerDiscriminator``,
``ActNorm`` and ``VQLPIPSWithDiscriminator``'s terms). Images are NHWC, as
in the JAX package; the convolutions run NCHW. Module names follow the flax
tree (``conv_{i}``, ``norm_{i}``, ``conv_out``).

* ``BatchNorm`` is flax's, not ``torch.nn.BatchNorm2d``: in a training pass
  it normalizes with the batch's mean and its biased variance
  E[x²] - E[x]² (clipped at 0, in f32) at ε 1e-5, and moves the running
  statistics by flax's momentum 0.9 (torch's 0.1) towards that biased
  variance, where torch would take the unbiased one. ``update_stats=False``
  normalizes with the batch's statistics and leaves the running ones, as
  the JAX package's generator step discards its discriminator pass's
  ``batch_stats``.
* ``ActNorm`` initializes its per-channel affine from the first batch it
  sees (loc = -mean, scale = 1 / (std + 1e-6)), which flax does in its
  init pass.
* ``adaptive_disc_weight`` is taming's ‖∂nll/∂w‖ / (‖∂g/∂w‖ + 1e-4) at the
  decoder's last weight, clipped to [0, 1e4] and detached: two
  ``torch.autograd.grad`` calls at that weight on the step's own graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConfigBase


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    channels; see the module's docstring."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.to(x.dtype)[None, :, None, None]) * mul.to(x.dtype)[None, :, None, None]
        return y + self.bias.to(x.dtype)[None, :, None, None]


class ActNorm(nn.Module):
    """Per-channel affine scale·(x + loc), initialized from the first batch
    it sees; ``loc`` and ``scale`` keep flax's (1, 1, C) shape."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, 1, channels))
        self.scale = nn.Parameter(torch.ones(1, 1, channels))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.uint8))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if not bool(self.initialized):
            with torch.no_grad():
                xf = x.float()
                self.loc.copy_(-xf.mean(dim=(0, 2, 3)).reshape(1, 1, -1))
                std = xf.std(dim=(0, 2, 3), unbiased=False)
                self.scale.copy_((1.0 / (std + 1e-6)).reshape(1, 1, -1))
                self.initialized.fill_(1)
        loc = self.loc.reshape(1, -1, 1, 1).to(x.dtype)
        return self.scale.reshape(1, -1, 1, 1).to(x.dtype) * (x + loc)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4×4 convolutions, stride 2 then 1, with LeakyReLU(0.2),
    filters doubling up to 8× ``ndf``, a norm on all but the first, and a
    1-channel logit map. NHWC in and out."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, use_actnorm: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        norm = ActNorm if use_actnorm else BatchNorm
        self.conv_0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        ch = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            self.add_module(f"conv_{n}", nn.Conv2d(ch, out, 4, stride=2, padding=1,
                                                   bias=use_actnorm))
            self.add_module(f"norm_{n}", norm(out))
            ch = out
        out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv_{n_layers}", nn.Conv2d(ch, out, 4, stride=1, padding=1,
                                                      bias=use_actnorm))
        self.add_module(f"norm_{n_layers}", norm(out))
        self.conv_out = nn.Conv2d(out, 1, 4, stride=1, padding=1)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Conv kernels N(0, 0.02) (taming's ``weights_init``), biases 0,
        norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        return self

    def forward(self, x, train: bool = True, update_stats: bool = True):
        min_res = 3 * 2 ** self.n_layers
        if x.shape[1] < min_res or x.shape[2] < min_res:
            raise ValueError(
                f"NLayerDiscriminator(n_layers={self.n_layers}) needs inputs >= "
                f"{min_res}x{min_res}; got {x.shape[1]}x{x.shape[2]}: reduce "
                "disc_num_layers for small images")
        h = F.leaky_relu(self.conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"norm_{n}")(getattr(self, f"conv_{n}")(h), train, update_stats)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    """0.5 · (mean relu(1 - real) + mean relu(1 + fake))."""
    return 0.5 * (torch.mean(torch.relu(1.0 - logits_real))
                  + torch.mean(torch.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    """0.5 · (mean softplus(-real) + mean softplus(fake))."""
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``value`` before ``threshold`` (taming's ``disc_start``), else
    ``weight``."""
    return value if global_step < threshold else weight


@dataclass(frozen=True)
class GANLossConfig(ConfigBase):
    """taming's ``VQLPIPSWithDiscriminator`` settings, with the JAX
    package's defaults; ``perceptual_net`` "tiny" is the shipped weights
    (``models/lpips.load_tiny_perceptual``), "vgg" the torchvision-shaped
    trunk at its random init."""
    disc_start: int = 0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_ndf: int = 64
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    use_actnorm: bool = False
    disc_loss: str = "hinge"   # hinge | vanilla
    perceptual_net: str = "tiny"


def adaptive_disc_weight(nll: torch.Tensor, g_loss: torch.Tensor, last_layer: torch.Tensor,
                         disc_weight: float) -> torch.Tensor:
    """‖∂nll/∂w‖ / (‖∂g/∂w‖ + 1e-4), clipped to [0, 1e4], detached, ×
    ``disc_weight``; ``w`` is ``last_layer``, the tensor the step's graph
    used as the decoder's ``conv_out`` weight. Both graphs are kept for the
    step's backward."""
    nll_grad, = torch.autograd.grad(nll, last_layer, retain_graph=True)
    g_grad, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    d_weight = torch.linalg.vector_norm(nll_grad.float()) / (
        torch.linalg.vector_norm(g_grad.float()) + 1e-4)
    return torch.clamp(d_weight, 0.0, 1e4).detach() * disc_weight


def bce_loss(logits, targets):
    """Sigmoid BCE, the mean over every element."""
    return torch.mean(F.softplus(logits) - logits * targets)


def bce_with_quant_loss(logits, targets, codebook_loss, codebook_weight: float = 1.0):
    """taming's ``BCELossWithQuant``: BCE + the weighted codebook term →
    (total, parts)."""
    bce = bce_loss(logits, targets)
    total = bce + codebook_weight * torch.mean(codebook_loss)
    return total, {"bce_loss": bce, "quant_loss": torch.mean(codebook_loss)}
