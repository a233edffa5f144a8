"""The DALLE ↔ VAE composition: text ids → image tokens → pixels.

Port of ``DiscreteVAEAdapter`` and ``DalleWithVae.generate_images`` from
``dalle_tpu/models/wrapper.py`` for the precision modes float32, bfloat16
(bf16 weights and KV cache) and bf16_int8kv (bf16 weights, int8 KV cache),
and ``DalleWithVae.serve_engine``, the continuous-batching engine over the
same derived weights, and ``dalle_config_for_vae``. ``generate_images``
primes from pixels through the dVAE's encoder (``img=``) and scores its
images with a CLIP (``clip=``, the rerank); ``attach_rerank`` keeps a CLIP
with the wrapper. int8 weights and speculative decoding are not ported yet
and raise ``NotImplementedError``; ``image_pipeline`` (the serving rerank
stage) waits for ``ROADMAP.md`` Queue 1 item 6.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..config import DalleConfig
from .clip import CLIP
from .dalle import DALLE
from .dvae import DiscreteVAE

_CACHE_DTYPE = {"float32": torch.float32, "f32": torch.float32,
                "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "bf16_int8kv": torch.int8}


class DiscreteVAEAdapter:
    """The VAE contract the wrapper consumes: image_size, num_layers,
    num_tokens, get_codebook_indices(NHWC images in [0, 1]) -> (b, n) ids,
    decode(ids) -> NHWC images."""

    def __init__(self, model: DiscreteVAE):
        self.model = model
        cfg = model.cfg
        self.image_size = cfg.image_size
        self.num_layers = cfg.num_layers
        self.num_tokens = cfg.num_tokens

    @property
    def image_fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @torch.no_grad()
    def get_codebook_indices(self, images):
        """Images (a tensor, or a host array uploaded as f32) → token ids on
        the dVAE's device."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        return self.model.get_codebook_indices(images)

    @torch.no_grad()
    def decode(self, ids):
        return self.model.decode(ids)


@torch.no_grad()
def rerank_scores(clip: CLIP, text, images) -> torch.Tensor:
    """CLIP's per-pair scores of (b, n) DALL·E text ids and (b, H, W, C)
    images: ids at or above CLIP's vocabulary become 0, the text is cropped
    or 0-padded to CLIP's ``text_seq_len``."""
    c = clip.cfg
    text = torch.as_tensor(text).to(images.device, torch.long)
    text = torch.where(text >= c.num_text_tokens, torch.zeros_like(text), text)
    n = c.text_seq_len
    text = text[:, :n] if text.shape[1] >= n else torch.nn.functional.pad(
        text, (0, n - text.shape[1]))
    return clip(text, images)


def dalle_config_for_vae(vae: DiscreteVAEAdapter, **dalle_kwargs) -> DalleConfig:
    """The image-side fields of a ``DalleConfig`` taken from the vae, the
    rest from ``dalle_kwargs``."""
    return DalleConfig(image_size=vae.image_size, image_vocab_size=vae.num_tokens,
                       image_fmap_size=vae.image_fmap_size, **dalle_kwargs)


class DalleWithVae:
    """Raw-pixel interface around DALLE: decodes generated tokens to pixels
    through the frozen VAE. ``clip`` is an optional frozen CLIP reranker,
    kept for callers to pass as ``generate_images(clip=…)``."""

    def __init__(self, model: DALLE, vae: DiscreteVAEAdapter, clip: Optional[CLIP] = None):
        self.model = model
        self.vae = vae
        self.clip = clip
        self._fast = None   # (source model, bf16 copy)

    def attach_rerank(self, clip: CLIP) -> "DalleWithVae":
        """Keep ``clip`` (e.g. from ``train.checkpoints.load_clip``) as the
        reranker. Returns self."""
        self.clip = clip
        return self

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
        precision mode. ``img`` (b, H, W, C) primes the first
        ``num_init_img_tokens`` image tokens (default 43.75 % of them, 14 of
        32 rows) with its dVAE tokens.

        With a ``clip`` (a ``models.clip.CLIP``) → (images, scores): each
        image's similarity to its own text × exp(temperature). Text ids at or
        above CLIP's vocabulary become 0 (the pad), and the text is cropped
        or 0-padded to CLIP's ``text_seq_len``."""
        prime = None
        if img is not None:
            n_prime = num_init_img_tokens
            if n_prime is None:
                n_prime = int(0.4375 * self.model.cfg.image_seq_len)
            if not 0 <= n_prime < self.model.cfg.image_seq_len:
                raise ValueError(f"num_init_img_tokens {n_prime} must be in "
                                 f"[0, {self.model.cfg.image_seq_len})")
            prime = self.vae.get_codebook_indices(img)[:, :n_prime]
        if clip is not None and not isinstance(clip, CLIP):
            raise TypeError(f"clip must be a models.clip.CLIP, got {type(clip).__name__}")
        if speculative > 0:
            raise NotImplementedError("speculative decoding is not ported yet")
        model, cache_dtype = self._resolve_precision(precision)
        ids = model.generate_images_tokens(
            text, generator=generator, noise=noise, filter_thres=filter_thres,
            temperature=temperature, cond_scale=cond_scale, image_prime=prime,
            cache_dtype=cache_dtype)
        images = self.vae.decode(ids)
        if clip is None:
            return images
        return images, rerank_scores(clip, text, images)

    def serve_engine(self, *, slots: int, precision: str = "bf16_int8kv",
                     filter_thres: float = 0.5, temperature: float = 1.0,
                     topk_approx: bool = False, steps_per_sync: int = 1,
                     decode_health: bool = False, prefill_chunk: int = 0,
                     kv_block_tokens: int = 0, kv_pool_blocks=None,
                     radix_cache: bool = True, noise_fn=None):
        """Continuous-batching decode engine (``serve/engine.py``) over this
        wrapper's model, in a precision mode of ``generate_images``: bf16
        modes reuse the one cached bf16 copy of the weights. The default is
        bf16 weights with an int8 KV cache (the JAX package defaults to
        int8 weights, ``int8w``, which is not ported yet). The engine runs
        where the model is, and emits image token ids per request."""
        from ..serve.engine import DecodeEngine
        model, cache_dtype = self._resolve_precision(precision)
        return DecodeEngine(model, slots=slots, cache_dtype=cache_dtype,
                            filter_thres=filter_thres, temperature=temperature,
                            topk_approx=topk_approx, steps_per_sync=steps_per_sync,
                            decode_health=decode_health, prefill_chunk=prefill_chunk,
                            kv_block_tokens=kv_block_tokens,
                            kv_pool_blocks=kv_pool_blocks, radix_cache=radix_cache,
                            noise_fn=noise_fn,
                            device=next(model.parameters()).device)
