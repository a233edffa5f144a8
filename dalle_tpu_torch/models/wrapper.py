"""The DALLE ↔ VAE composition: text ids → image tokens → pixels.

Port of ``DiscreteVAEAdapter`` and ``DalleWithVae.generate_images`` from
``dalle_tpu/models/wrapper.py`` for the precision modes float32, bfloat16
(bf16 weights and KV cache) and bf16_int8kv (bf16 weights, int8 KV cache).
Image priming from pixels, CLIP reranking, int8 weights and speculative
decoding are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .dalle import DALLE
from .dvae import DiscreteVAE

_CACHE_DTYPE = {"float32": torch.float32, "f32": torch.float32,
                "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "bf16_int8kv": torch.int8}


class DiscreteVAEAdapter:
    """The VAE contract the wrapper consumes: image_size, num_layers,
    num_tokens, decode(ids) -> NHWC images."""

    def __init__(self, model: DiscreteVAE):
        self.model = model
        cfg = model.cfg
        self.image_size = cfg.image_size
        self.num_layers = cfg.num_layers
        self.num_tokens = cfg.num_tokens

    @torch.no_grad()
    def decode(self, ids):
        return self.model.decode(ids)


class DalleWithVae:
    """Raw-pixel interface around DALLE: decodes generated tokens to pixels
    through the frozen VAE."""

    def __init__(self, model: DALLE, vae: DiscreteVAEAdapter):
        self.model = model
        self.vae = vae
        self._fast = None   # (source model, bf16 copy)

    def _resolve_precision(self, precision: str):
        """(model, cache_dtype) for a decode precision mode. The bf16 copy of
        the weights is made once and kept, keyed on the source module (a
        new ``self.model`` is cast anew; weights changed in place on the
        same module are not seen)."""
        if precision == "int8w":
            raise NotImplementedError("int8 weights (int8w) are not ported yet")
        if precision not in _CACHE_DTYPE:
            raise ValueError(f"unknown precision {precision!r}; expected "
                             "float32 | bfloat16 | bf16_int8kv")
        cache_dtype = _CACHE_DTYPE[precision]
        if cache_dtype == torch.float32:
            return self.model, cache_dtype
        if self._fast is None or self._fast[0] is not self.model:
            self._fast = (self.model, copy.deepcopy(self.model).to(torch.bfloat16))
        return self._fast[1], cache_dtype

    def generate_images(self, text, *, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        filter_thres: float = 0.5, temperature: float = 1.0,
                        cond_scale: float = 1.0, img=None,
                        num_init_img_tokens: Optional[int] = None, clip=None,
                        precision: str = "float32", speculative: int = 0):
        """text (b, text_seq_len) ids → images (b, H, W, C). Sampling draws
        from ``generator`` (or takes ``noise``, see
        ``DALLE.generate_images_tokens``); logits are sampled in f32 in every
        precision mode."""
        if img is not None or num_init_img_tokens is not None:
            raise NotImplementedError("priming from pixels needs the dVAE "
                                      "encoder, not ported yet")
        if clip is not None:
            raise NotImplementedError("CLIP reranking is not ported yet")
        if speculative > 0:
            raise NotImplementedError("speculative decoding is not ported yet")
        model, cache_dtype = self._resolve_precision(precision)
        ids = model.generate_images_tokens(
            text, generator=generator, noise=noise, filter_thres=filter_thres,
            temperature=temperature, cond_scale=cond_scale,
            cache_dtype=cache_dtype)
        return self.vae.decode(ids)
