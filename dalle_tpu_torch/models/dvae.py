"""Discrete VAE: pixels → token ids (encode), token ids → pixels (decode),
and the training forward (``forward``: the gumbel quantizer and the loss).

Port of ``dalle_tpu/models/dvae.py``. The public layout stays NHWC,
(b, H, W, C), as in the JAX package; inside, the convolutions run NCHW.
The encoder's flax ``Conv(4x4, stride 2, padding=1)`` pads one pixel on
each side, as ``nn.Conv2d(4, stride=2, padding=1)`` does.

The JAX decoder upsamples with flax ``ConvTranspose(4x4, stride 2,
padding="SAME")``, which does not flip its kernel and pads the dilated input
by 2 on each side. ``nn.ConvTranspose2d(4, stride=2, padding=1)`` pads the
dilated input by k-1-p = 2 as well and flips its kernel, so the same
function follows from flipping the flax kernel spatially (``convert.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DVAEConfig
from ..device import resolve_device
from ..ops.quantize import gumbel_softmax, kl_to_uniform


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


class Encoder(nn.Module):
    """num_layers × (conv4x4/s2 + relu), then ResBlocks, then 1×1 to
    num_tokens logits. NCHW."""

    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        c = cfg
        self.num_resnet_blocks = c.num_resnet_blocks
        self.num_layers = c.num_layers
        chan = c.channels
        for i in range(c.num_layers):
            self.add_module(f"down_{i}", nn.Conv2d(chan, c.hidden_dim, 4, stride=2,
                                                   padding=1))
            chan = c.hidden_dim
        for i in range(c.num_resnet_blocks):
            self.add_module(f"res_{i}", ResBlock(c.hidden_dim))
        self.to_logits = nn.Conv2d(chan, c.num_tokens, 1)

    def forward(self, x):
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"down_{i}")(x))
        for i in range(self.num_resnet_blocks):
            x = getattr(self, f"res_{i}")(x)
        return self.to_logits(x)


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
    """The dVAE. Images are NHWC floats in [0, 1]: ``get_codebook_indices``
    maps them to (b, n) token ids in raster order, ``decode`` maps (b, n)
    token ids back to images, and ``forward`` is the training path."""

    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        if cfg.image_size & (cfg.image_size - 1):
            raise ValueError("image size must be a power of 2")
        if cfg.num_layers < 1:
            raise ValueError("the dVAE needs num_layers >= 1")
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim)
        # registered last, so reset_parameters draws the decoder and the
        # codebook from a seed as it did before the encoder was ported
        self.encoder = Encoder(cfg)

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

    def norm(self, images):
        """Per-channel (x - mean) / std with the config's normalization. The
        constants are uploaded once per dtype and device: an upload from a
        Python list is a synchronising copy, and the encode runs every step."""
        if self.cfg.normalization is None:
            return images
        key = (images.dtype, images.device)
        cache = self.__dict__.setdefault("_norm_consts", {})
        if key not in cache:
            cache[key] = tuple(torch.tensor(v, dtype=images.dtype, device=images.device)
                               for v in self.cfg.normalization)
        means, stds = cache[key]
        return (images - means) / stds

    def _normed(self, img):
        """(b, H, W, C) images on the model's device, checked and normalized."""
        img = img.to(self.codebook.weight.device)
        size = self.cfg.image_size
        if img.shape[1] != size or img.shape[2] != size:
            raise ValueError(f"input must be {size}px, got {tuple(img.shape)}")
        return self.norm(img)

    def _logits(self, img_n):
        return self.encoder(img_n.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def encode_logits(self, img):
        """(b, H, W, C) images → (b, h, w, num_tokens) logits."""
        return self._logits(self._normed(img))

    @torch.no_grad()
    def get_codebook_indices(self, img):
        """argmax over the token logits (the first of equal maxima, as
        ``jnp.argmax``), flattened in raster order → (b, n) int64."""
        logits = self.encode_logits(img)
        return torch.argmax(logits, dim=-1).reshape(logits.shape[0], -1)

    def decode(self, img_seq):
        """(b, n) token ids → (b, H, W, C) image."""
        emb = self.codebook(img_seq.to(self.codebook.weight.device))
        b, n, d = emb.shape
        hw = int(n ** 0.5)
        z = emb.reshape(b, hw, hw, d).permute(0, 3, 1, 2)
        return self.decoder(z).permute(0, 2, 3, 1).contiguous()

    def forward(self, img, temp: Optional[float] = None, return_loss: bool = False,
                return_recons: bool = False, hard_recons: bool = False, *,
                return_health: bool = False, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The training and reconstruction path. (b, H, W, C) images → the
        reconstruction (b, H, W, C); with ``return_loss`` the loss instead,
        with ``return_recons`` too (loss, recons).

        The encoder's logits go through the gumbel-softmax at temperature
        ``temp`` (default ``cfg.temperature``; straight-through when
        ``cfg.straight_through``), its draw ``noise`` or else from
        ``generator``; ``hard_recons`` takes the argmax's one-hot instead and
        draws nothing. The codebook mix is the product of that (b, h, w, n)
        sample with the codebook. The loss, in f32, is the reconstruction
        error against the *normalized* image (MSE, or smooth-L1 at β = 1)
        plus ``kl_div_loss_weight`` × the batchmean KL to uniform.

        ``return_health`` appends the health taps (``obs/health.py``) as the
        last element of every return: the codebook vitals of the encoder's
        argmax, and ``gumbel_health`` of the logits, the sample the decoder
        took and the temperature; device scalars from tensors the forward
        holds."""
        c = self.cfg
        img_n = self._normed(img)
        logits = self._logits(img_n)
        temp = c.temperature if temp is None else temp
        if hard_recons:
            one_hot = F.one_hot(torch.argmax(logits, dim=-1), c.num_tokens).to(logits.dtype)
        else:
            one_hot = gumbel_softmax(logits, temp, hard=c.straight_through, noise=noise,
                                     generator=generator)
        sampled = torch.einsum("bhwn,nd->bhwd", one_hot, self.codebook.weight)
        out = self.decoder(sampled.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        health = None
        if return_health:
            from ..obs.health import codebook_health, gumbel_health
            with torch.no_grad():
                health = codebook_health(torch.argmax(logits, dim=-1), c.num_tokens)
                health.update(gumbel_health(logits, one_hot, temp))
        if not return_loss:
            return (out, health) if return_health else out
        diff = img_n.float() - out.float()
        if c.smooth_l1_loss:
            a = diff.abs()
            recon = torch.mean(torch.where(a < 1.0, 0.5 * diff ** 2, a - 0.5))
        else:
            recon = torch.mean(diff ** 2)
        b, h, w, n = logits.shape
        kl = kl_to_uniform(logits.reshape(b, h * w, n).float())
        loss = recon + kl * c.kl_div_loss_weight
        if not return_recons:
            return (loss, health) if return_health else loss
        return (loss, out, health) if return_health else (loss, out)


def init_dvae(cfg: DVAEConfig, *, seed: int = 0, device=None) -> DiscreteVAE:
    """A DiscreteVAE with random weights from a seeded ``torch.Generator``,
    built directly on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = DiscreteVAE(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
