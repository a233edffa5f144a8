"""CLIP: the contrastive text/image model that reranks generations.

Port of ``dalle_tpu/models/clip.py``. Token and position embeddings into a
non-causal text transformer, pooled by the mean over the non-pad tokens;
images cut into patches (from NHWC, in the JAX package's order), projected,
into a non-causal visual transformer, pooled by the mean; both latents
divided by their norm; a learned temperature; the symmetric cross-entropy
over the similarity matrix. Module names follow the flax tree
(``convert.clip_state_dict`` maps it one to one).

The two towers run the dense attention: their ``TransformerConfig`` is not
causal and leaves ``use_pallas`` at "auto", which gives a non-causal layer
and a layer with a key mask the dense core, never K1 (causal only); below
2,048 tokens nothing else is taken (``Transformer.attention_mode``).

CLIP's own projections are plain ``nn.Linear``s, which cannot apply int8
scales: ``embed_text`` and ``embed_image`` refuse int8 parameters
(``assert_float_params``), as the JAX package's CLIP does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ClipConfig, TransformerConfig
from ..device import resolve_device
from ..ops.quantize_weights import assert_float_params
from ..ops.sampling import masked_mean
from .transformer import Transformer


def _tower(seq_len: int, dim: int, depth: int, heads: int) -> TransformerConfig:
    return TransformerConfig(seq_len=seq_len, causal=False, dim=dim, depth=depth,
                             heads=heads, dim_head=dim // heads, attn_types=("full",),
                             image_fmap_size=0, rotary_emb=False)


def _unit(lat: torch.Tensor) -> torch.Tensor:
    """``lat`` divided by its norm (no epsilon, as the JAX package)."""
    return lat / torch.linalg.vector_norm(lat, dim=-1, keepdim=True)


class CLIP(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        c = self.cfg = cfg
        self.text_emb = nn.Embedding(c.num_text_tokens, c.dim_text)
        self.text_pos_emb = nn.Embedding(c.text_seq_len, c.dim_text)
        self.text_transformer = Transformer(_tower(c.text_seq_len, c.dim_text,
                                                   c.text_enc_depth, c.text_heads))
        self.to_text_latent = nn.Linear(c.dim_text, c.dim_latent, bias=False)
        num_patches = (c.visual_image_size // c.visual_patch_size) ** 2
        patch_dim = c.channels * c.visual_patch_size ** 2
        self.to_visual_embedding = nn.Linear(patch_dim, c.dim_image)
        self.visual_pos_emb = nn.Embedding(num_patches, c.dim_image)
        self.visual_transformer = Transformer(_tower(num_patches, c.dim_image,
                                                     c.visual_enc_depth, c.visual_heads))
        self.to_visual_latent = nn.Linear(c.dim_image, c.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.ones(()))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``: Linear and Embedding weights
        normal with std 1/sqrt(fan-in) (embeddings: 1/sqrt(dim)), biases 0,
        LayerNorm 1/0, the temperature 1."""
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        self.temperature.fill_(1.0)
        return self

    def _device(self):
        return self.text_emb.weight.device

    def embed_text(self, text) -> torch.Tensor:
        """(b, n ≤ text_seq_len) ids, 0 the pad → (b, dim_latent) of norm 1."""
        assert_float_params(self)
        text = torch.as_tensor(text).to(self._device(), torch.long)
        mask = text != 0
        pos = torch.arange(text.shape[1], device=text.device)
        x = self.text_emb(text) + self.text_pos_emb(pos)
        x = self.text_transformer(x, key_mask=mask)
        return _unit(self.to_text_latent(masked_mean(x, mask)))

    def embed_image(self, image) -> torch.Tensor:
        """(b, H, W, C) NHWC floats → (b, dim_latent) of norm 1."""
        assert_float_params(self)
        c = self.cfg
        image = torch.as_tensor(image).to(self._device())
        p = c.visual_patch_size
        b, h, w, ch = image.shape
        if h != c.visual_image_size or w != c.visual_image_size:
            raise ValueError(f"image must be {c.visual_image_size}px, got {h}x{w}")
        # (b, h/p, p, w/p, p, c) → (b, n_patches, p·p·c)
        x = image.reshape(b, h // p, p, w // p, p, ch)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), -1)
        x = self.to_visual_embedding(x)
        x = x + self.visual_pos_emb(torch.arange(x.shape[1], device=x.device))
        x = self.visual_transformer(x)
        return _unit(self.to_visual_latent(x.mean(dim=1)))

    def score_images(self, text, images) -> torch.Tensor:
        """One prompt against n candidates: (1, n_text) ids and (n, H, W, C)
        images → (n,) scores, the text tower run once."""
        t = self.embed_text(text)[0]
        v = self.embed_image(images)
        return (v @ t) * torch.exp(self.temperature)

    def forward(self, text, image, return_loss: bool = False):
        """Per-pair scores (b,) (the rerank), or with ``return_loss`` the
        mean of the text→image and image→text cross-entropies over the
        (b, b) similarity matrix."""
        t = self.embed_text(text)
        v = self.embed_image(image)
        temp = torch.exp(self.temperature)
        if not return_loss:
            return (t * v).sum(dim=-1) * temp
        sim = (t @ v.t()) * temp
        labels = torch.arange(sim.shape[0], device=sim.device)
        return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels)) / 2


def init_clip(cfg: ClipConfig, *, seed: int = 0, device=None) -> CLIP:
    """A CLIP with random weights from a seeded ``torch.Generator``, built
    directly on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIP(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
