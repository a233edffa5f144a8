"""Discrete VAE, decode side: codebook → decoder → pixels.

Port of the decode path of ``dalle_tpu/models/dvae.py``. The public layout
stays NHWC, (b, H, W, C), as in the JAX package; inside, the convolutions
run NCHW. The encoder (pixels → tokens) is not ported yet.

The JAX decoder upsamples with flax ``ConvTranspose(4x4, stride 2,
padding="SAME")``, which does not flip its kernel and pads the dilated input
by 2 on each side. ``nn.ConvTranspose2d(4, stride=2, padding=1)`` pads the
dilated input by k-1-p = 2 as well and flips its kernel, so the same
function follows from flipping the flax kernel spatially (``convert.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import DVAEConfig
from ..device import resolve_device


class ResBlock(nn.Module):
    """conv3x3 → relu → conv3x3 → relu → conv1x1, residual."""

    def __init__(self, chan: int):
        super().__init__()
        self.conv1 = nn.Conv2d(chan, chan, 3, padding=1)
        self.conv2 = nn.Conv2d(chan, chan, 3, padding=1)
        self.conv3 = nn.Conv2d(chan, chan, 1)

    def forward(self, x):
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        return self.conv3(h) + x


class Decoder(nn.Module):
    """1×1 from codebook_dim (when resblocks exist), ResBlocks, then
    num_layers × (convT4x4/s2 + relu), final 1×1 to channels. NCHW."""

    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        c = cfg
        self.num_resnet_blocks = c.num_resnet_blocks
        self.num_layers = c.num_layers
        chan = c.codebook_dim
        if c.num_resnet_blocks > 0:
            self.proj_in = nn.Conv2d(chan, c.hidden_dim, 1)
            chan = c.hidden_dim
            for i in range(c.num_resnet_blocks):
                self.add_module(f"res_{i}", ResBlock(c.hidden_dim))
        for i in range(c.num_layers):
            self.add_module(f"up_{i}", nn.ConvTranspose2d(chan, c.hidden_dim, 4,
                                                          stride=2, padding=1))
            chan = c.hidden_dim
        self.to_pixels = nn.Conv2d(chan, c.channels, 1)

    def forward(self, z):
        if self.num_resnet_blocks > 0:
            z = self.proj_in(z)
            for i in range(self.num_resnet_blocks):
                z = getattr(self, f"res_{i}")(z)
        for i in range(self.num_layers):
            z = torch.relu(getattr(self, f"up_{i}")(z))
        return self.to_pixels(z)


class DiscreteVAE(nn.Module):
    """The dVAE's decode side. ``decode`` maps (b, n) token ids to NHWC
    images."""

    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        if cfg.image_size & (cfg.image_size - 1):
            raise ValueError("image size must be a power of 2")
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``: convolution kernels normal with
        std 1/sqrt(fan-in), biases 0, codebook std 1/sqrt(codebook_dim)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                # Conv2d weight (out, in, kh, kw); ConvTranspose2d (in, out, kh, kw)
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * w.shape[2] * w.shape[3]
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                m.bias.zero_()
        self.codebook.weight.normal_(0.0, self.cfg.codebook_dim ** -0.5,
                                     generator=generator)
        return self

    def decode(self, img_seq):
        """(b, n) token ids → (b, H, W, C) image."""
        emb = self.codebook(img_seq.to(self.codebook.weight.device))
        b, n, d = emb.shape
        hw = int(n ** 0.5)
        z = emb.reshape(b, hw, hw, d).permute(0, 3, 1, 2)
        return self.decoder(z).permute(0, 2, 3, 1).contiguous()


def init_dvae(cfg: DVAEConfig, *, seed: int = 0, device=None) -> DiscreteVAE:
    """A DiscreteVAE with random weights from a seeded ``torch.Generator``,
    built directly on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = DiscreteVAE(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
