"""The VQGAN autoencoder: images → codebook indices → images.

Port of ``dalle_tpu/models/vqgan.py`` (taming's ``VQModel`` and
``GumbelVQ`` over the DDPM-style conv stacks). The public layout stays
NHWC, (b, H, W, C) with images in [-1, 1], as in the JAX package; inside,
the convolutions run NCHW. Module names follow the flax tree
(``encoder.down_{level}_block_{i}``, ``encoder.mid_attn_1``,
``decoder.up_{level}_upsample.conv``, ``codebook``, ``quant_conv``, …), so
``convert.py`` maps a JAX ``VQModel`` onto this one by path;
``models/pretrained.py`` maps taming's checkpoint names onto them.

* ``Downsample`` pads (0, 1) on the bottom and right, then runs an unpadded
  stride-2 3×3 convolution, as taming does.
* ``Upsample`` repeats each pixel 2×2 (nearest), then a 3×3 convolution.
* ``GroupNorm`` has 32 groups (the largest divisor of the channel count up
  to 32 for test-sized widths) at ε 1e-6.
* ``AttnBlock`` is single-head attention over the flattened h·w positions:
  two ``torch.matmul`` calls, as the JAX package's two einsums.
* Dropout (``cfg.dropout``) acts only in a training pass
  (``deterministic=False``), its keep mask drawn from the caller's
  generator.
* ``health_taps`` gives the codebook vitals of an encode (``obs/health.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VQGANConfig
from ..device import resolve_device
from ..ops.quantize import VQOutput, gumbel_quantize, remap_indices, unmap_indices, vector_quantize
from .transformer import drawn_dropout


def swish(x):
    return x * torch.sigmoid(x)


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm(32, ε 1e-6); below 32 channels or off a multiple of 32,
    gcd(32, channels) groups, as the JAX package does for small widths."""
    groups = 32 if channels % 32 == 0 else math.gcd(32, channels)
    return nn.GroupNorm(groups, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    """norm → swish → conv3×3, norm → swish → dropout → conv3×3, with a 1×1
    ``nin_shortcut`` when the channel count changes."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.conv1(swish(self.norm1(x)))
        h = swish(self.norm2(h))
        h = self.conv2(h if deterministic else drawn_dropout(h, self.dropout, generator))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h×w grid, residual."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = group_norm(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k) * (c ** -0.5), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """(0, 1) pad on the bottom and right, then a stride-2 3×3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class VQGANEncoder(nn.Module):
    """conv_in → per ch_mult level num_res_blocks × ResnetBlock (+ AttnBlock
    at attn_resolutions) and a Downsample (not after the last) → mid (Res,
    Attn, Res) → norm, swish, conv_out to z_channels (2× with double_z)."""

    def __init__(self, c: VQGANConfig):
        super().__init__()
        self.cfg = c
        self.conv_in = nn.Conv2d(c.in_channels, c.ch, 3, padding=1)
        self.blocks = []
        ch, res = c.ch, c.resolution
        for lvl, mult in enumerate(c.ch_mult):
            for i in range(c.num_res_blocks):
                self.add_module(f"down_{lvl}_block_{i}", ResnetBlock(ch, c.ch * mult, c.dropout))
                ch = c.ch * mult
                self.blocks.append(f"down_{lvl}_block_{i}")
                if res in c.attn_resolutions:
                    self.add_module(f"down_{lvl}_attn_{i}", AttnBlock(ch))
                    self.blocks.append(f"down_{lvl}_attn_{i}")
            if lvl != len(c.ch_mult) - 1:
                self.add_module(f"down_{lvl}_downsample", Downsample(ch))
                self.blocks.append(f"down_{lvl}_downsample")
                res //= 2
        self.mid_block_1 = ResnetBlock(ch, ch, c.dropout)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch, c.dropout)
        self.norm_out = group_norm(ch)
        self.conv_out = nn.Conv2d(ch, 2 * c.z_channels if c.double_z else c.z_channels, 3,
                                  padding=1)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.conv_in(x)
        for name in self.blocks + ["mid_block_1", "mid_attn_1", "mid_block_2"]:
            h = _apply(getattr(self, name), h, deterministic, generator)
        return self.conv_out(swish(self.norm_out(h)))


class VQGANDecoder(nn.Module):
    """conv_in → mid (Res, Attn, Res) → per reversed ch_mult level
    (num_res_blocks + 1) × ResnetBlock (+ AttnBlock) and an Upsample (not
    after level 0) → norm, swish, conv_out to out_ch."""

    def __init__(self, c: VQGANConfig):
        super().__init__()
        self.cfg = c
        levels = len(c.ch_mult)
        ch = c.ch * c.ch_mult[-1]
        res = c.resolution // 2 ** (levels - 1)
        self.conv_in = nn.Conv2d(c.z_channels, ch, 3, padding=1)
        self.mid_block_1 = ResnetBlock(ch, ch, c.dropout)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch, c.dropout)
        self.blocks = []
        for lvl in reversed(range(levels)):
            for i in range(c.num_res_blocks + 1):
                self.add_module(f"up_{lvl}_block_{i}",
                                ResnetBlock(ch, c.ch * c.ch_mult[lvl], c.dropout))
                ch = c.ch * c.ch_mult[lvl]
                self.blocks.append(f"up_{lvl}_block_{i}")
                if res in c.attn_resolutions:
                    self.add_module(f"up_{lvl}_attn_{i}", AttnBlock(ch))
                    self.blocks.append(f"up_{lvl}_attn_{i}")
            if lvl != 0:
                self.add_module(f"up_{lvl}_upsample", Upsample(ch))
                self.blocks.append(f"up_{lvl}_upsample")
                res *= 2
        self.norm_out = group_norm(ch)
        self.conv_out = nn.Conv2d(ch, c.out_ch, 3, padding=1)

    def forward(self, z, deterministic: bool = True, generator=None):
        h = self.conv_in(z)
        for name in ["mid_block_1", "mid_attn_1", "mid_block_2"] + self.blocks:
            h = _apply(getattr(self, name), h, deterministic, generator)
        return self.conv_out(swish(self.norm_out(h)))


def _apply(mod, h, deterministic, generator):
    if isinstance(mod, ResnetBlock):
        return mod(h, deterministic, generator)
    return mod(h)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class VQModel(nn.Module):
    """encoder → quant_conv 1×1 → quantizer → post_quant_conv 1×1 →
    decoder. Images are NHWC floats in [-1, 1].

    * ``forward(img)`` → (recon, vq loss, indices).
    * ``encode(img)`` → ``VQOutput`` (NHWC latents, (b, h, w) indices, loss).
    * ``decode(quant)``, ``get_codebook_indices(img)`` → (b, n) raster-order
      ids, ``decode_code(ids)`` → images.

    The gumbel quantizer's draw is ``noise`` ((b, h, w, n_embed)) when
    given, else from ``generator``; in a deterministic pass without either,
    from a generator seeded 0, as the JAX package uses a fixed key there."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        c = self.cfg = cfg
        self.encoder = VQGANEncoder(c)
        self.decoder = VQGANDecoder(c)
        self.codebook = nn.Embedding(c.n_embed, c.embed_dim)
        self.quant_conv = nn.Conv2d(2 * c.z_channels if c.double_z else c.z_channels,
                                    c.embed_dim, 1)
        if c.quantizer == "gumbel":
            self.quant_proj = nn.Conv2d(c.embed_dim, c.n_embed, 1)
        self.post_quant_conv = nn.Conv2d(c.embed_dim, c.z_channels, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``: conv kernels normal with std
        1/sqrt(fan-in), biases 0, GroupNorm 1 and 0, codebook std
        1/sqrt(embed_dim)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                m.weight.normal_(0.0, (w.shape[1] * w.shape[2] * w.shape[3]) ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.codebook.weight.normal_(0.0, self.cfg.embed_dim ** -0.5, generator=generator)
        return self

    @property
    def fmap_size(self) -> int:
        return self.cfg.resolution // 2 ** (len(self.cfg.ch_mult) - 1)

    def quantize(self, h, temp: Optional[float] = None, deterministic: bool = True, *,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> VQOutput:
        """(b, C, h, w) encoder output → ``VQOutput`` with NHWC latents."""
        c = self.cfg
        z = self.quant_conv(h)
        if c.quantizer == "gumbel":
            logits = _nhwc(self.quant_proj(z))
            hard = c.straight_through if not deterministic else True
            if noise is None and generator is None and deterministic:
                generator = torch.Generator(device=logits.device).manual_seed(0)
            return gumbel_quantize(logits, self.codebook.weight, 1.0 if temp is None else temp,
                                   hard, c.gumbel_kl_weight, noise=noise, generator=generator)
        return vector_quantize(_nhwc(z), self.codebook.weight, beta=c.beta)

    def encode(self, img, temp: Optional[float] = None, deterministic: bool = True, *,
               noise=None, generator=None) -> VQOutput:
        h = self.encoder(_nchw(img), deterministic, generator)
        return self.quantize(h, temp, deterministic, noise=noise, generator=generator)

    def decode(self, quant, deterministic: bool = True, generator=None):
        """NHWC latents → NHWC image."""
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(quant)), deterministic,
                                  generator))

    @torch.no_grad()
    def get_codebook_indices(self, img, generator: Optional[torch.Generator] = None):
        """(b, H, W, C) images → (b, n) int64 ids; with ``remap_used`` in the
        used subset's id space (unknown codes per ``remap_unknown``, random
        ones from ``generator``, else from a generator seeded 0)."""
        ids = self.encode(img, deterministic=True).indices
        if self.cfg.remap_used is not None:
            ids = remap_indices(ids, self.cfg.remap_used, self.cfg.remap_unknown, generator)
        return ids.reshape(ids.shape[0], -1)

    def decode_code(self, ids):
        """(b, n) ids → (b, H, W, C) images; ids past the codebook are
        clamped into it (a second stage's vocabulary may be larger)."""
        b, n = ids.shape
        hw = int(n ** 0.5)
        ids = ids.to(self.codebook.weight.device)
        if self.cfg.remap_used is not None:
            ids = unmap_indices(ids, self.cfg.remap_used)
        ids = ids.clamp(0, self.cfg.n_embed - 1)
        return self.decode(self.codebook(ids).reshape(b, hw, hw, self.cfg.embed_dim))

    def health_taps(self, q: VQOutput, temp: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """The health taps of one encode's ``VQOutput`` (``obs/health.py``):
        codebook usage perplexity, dead fraction and entropy from its
        indices and, on the gumbel path (``q.probs``), the temperature and
        the encoder's mean argmax confidence; f32 device scalars."""
        from ..obs.health import HEALTH_PREFIX, codebook_health
        with torch.no_grad():
            out = codebook_health(q.indices, self.cfg.n_embed)
            if q.probs is not None:
                out[f"{HEALTH_PREFIX}gumbel_temp"] = q.probs.new_full(
                    (), 1.0 if temp is None else float(temp), dtype=torch.float32)
                out[f"{HEALTH_PREFIX}encoder_confidence"] = torch.mean(
                    torch.amax(q.probs.float(), dim=-1))
        return out

    def forward(self, img, temp: Optional[float] = None, deterministic: bool = True, *,
                noise=None, generator=None):
        q = self.encode(img, temp, deterministic, noise=noise, generator=generator)
        recon = self.decode(q.quantized, deterministic, generator=generator)
        return recon, q.loss, q.indices


def init_vqgan(cfg: VQGANConfig, *, seed: int = 0, device=None) -> VQModel:
    """A VQModel with random weights from a seeded ``torch.Generator``,
    built directly on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = VQModel(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
