"""The DALLE ↔ VAE composition: text ids → image tokens → pixels.

Port of ``DiscreteVAEAdapter`` and ``DalleWithVae.generate_images`` from
``dalle_tpu/models/wrapper.py`` for the precision modes float32, bfloat16
(bf16 weights and KV cache), bf16_int8kv (bf16 weights, int8 KV cache) and
int8w (int8 weights through the W8 kernel, int8 KV cache), with the
speculative sampler (``speculative=γ``); ``generate_texts``;
``DalleWithVae.serve_engine``, the continuous-batching engine over the same
derived weights, int8w by default as in the JAX package;
``DalleWithVae.loss``, the training loss from pixels; and
``dalle_config_for_vae``. ``generate_images`` primes from pixels through
the dVAE's encoder (``img=``) and scores its images with a CLIP (``clip=``,
the rerank); ``attach_rerank`` keeps a CLIP with the wrapper.
``image_pipeline`` builds the post-decode product pipeline
(``serve/pipeline.py``: pixels, CLIP rerank, top k) from the wrapper's vae
and CLIP.

With tracing on (``obs.configure()``), ``generate_images`` records the
JAX package's spans (``decode/vae_encode_prime``,
``decode/generate_tokens`` with its ``tokens``, ``batch`` and ``precision``,
``decode/vae_decode``, ``decode/clip_rerank``), the gauge
``obs.decode_per_token_ms`` and the counter ``obs.decode_tokens_total``.
``decode/generate_tokens`` then ends in a synchronisation of the card, so
it times the tokens and not their launches; with tracing off nothing
waits.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..config import DalleConfig
from ..obs import counter_add, gauge_set, span
from ..obs import enabled as _obs_enabled
from ..ops.quantize_weights import quantize_params_int8
from .clip import CLIP
from .dalle import DALLE
from .dvae import DiscreteVAE

_CACHE_DTYPE = {"float32": torch.float32, "f32": torch.float32,
                "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "bf16_int8kv": torch.int8, "int8w": torch.int8}


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
        self._derived = None   # (source model, {mode: derived model})

    def attach_rerank(self, clip: CLIP) -> "DalleWithVae":
        """Keep ``clip`` (e.g. from ``train.checkpoints.load_clip``) as the
        reranker. Returns self."""
        self.clip = clip
        return self

    def image_pipeline(self, *, top_k: Optional[int] = None, **kw):
        """The post-decode product pipeline (``serve/pipeline.py``): batched
        dVAE pixel decode, batched CLIP rerank and top-k ordering over
        finished candidate groups, built from this wrapper's vae and
        attached CLIP. ``kw`` goes to ``ImagePipeline``."""
        from ..serve.pipeline import ImagePipeline
        return ImagePipeline(vae=self.vae, clip=self.clip, top_k=top_k, **kw)

    def loss(self, text, images, generator: Optional[torch.Generator] = None,
             null_cond_prob: float = 0.0, null_mask: Optional[torch.Tensor] = None,
             dropout: bool = False):
        """The training loss from raw pixels: ``images`` ((b, H, W, C) in
        [0, 1]) through the VAE's ``get_codebook_indices``, then the model's
        loss with ``text`` → (loss, {"loss_text", "loss_img"}). The
        classifier-free-guidance nulls are ``null_mask`` or drawn with
        ``null_cond_prob`` from ``generator``; ``dropout`` trains with the
        model's dropout, its masks from ``generator``."""
        ids = self.vae.get_codebook_indices(images)
        text = torch.as_tensor(text).to(ids.device, torch.long)
        return self.model(text, ids, True, null_cond_prob=null_cond_prob,
                          null_mask=null_mask, generator=generator, dropout=dropout)

    def _resolve_precision(self, precision: str):
        """(model, cache_dtype) for a decode precision mode. The derived
        models (a bf16 copy for bfloat16 and bf16_int8kv; an int8-weight,
        bf16-elsewhere copy for int8w, ``quantize_params_int8``) are made
        once and kept side by side, keyed on the source module: a new
        ``self.model`` drops them all (weights changed in place on the same
        module are not seen)."""
        if precision not in _CACHE_DTYPE:
            raise ValueError(f"unknown precision {precision!r}; expected "
                             "float32 | bfloat16 | bf16_int8kv | int8w")
        cache_dtype = _CACHE_DTYPE[precision]
        if cache_dtype == torch.float32:
            return self.model, cache_dtype
        if self._derived is None or self._derived[0] is not self.model:
            self._derived = (self.model, {})
        mode = "int8w" if precision == "int8w" else "bf16"
        models = self._derived[1]
        if mode not in models:
            models[mode] = (quantize_params_int8(self.model) if mode == "int8w"
                            else copy.deepcopy(self.model).to(torch.bfloat16))
        return models[mode], cache_dtype

    def generate_images(self, text, *, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        filter_thres: float = 0.5, temperature: float = 1.0,
                        cond_scale: float = 1.0, img=None,
                        num_init_img_tokens: Optional[int] = None, clip=None,
                        precision: str = "float32", speculative: int = 0,
                        draft: str = "row"):
        """text (b, text_seq_len) ids → images (b, H, W, C). Sampling draws
        from ``generator`` (or takes ``noise``, see
        ``DALLE.generate_images_tokens``); logits are sampled in f32 in every
        precision mode. ``img`` (b, H, W, C) primes the first
        ``num_init_img_tokens`` image tokens (default 43.75 % of them, 14 of
        32 rows) with its dVAE tokens.

        With a ``clip`` (a ``models.clip.CLIP``) → (images, scores): each
        image's similarity to its own text × exp(temperature). Text ids at or
        above CLIP's vocabulary become 0 (the pad), and the text is cropped
        or 0-padded to CLIP's ``text_seq_len``.

        ``speculative=γ > 0`` decodes through the draft-and-verify sampler
        (``DALLE.generate_images_tokens_speculative``, ``draft`` "row" or
        "repeat"): exact sampling for any draft quality, under a
        per-(step, row) draw table (``noise`` (n_steps, b, V) or drawn from
        ``generator``), so the same distribution as the sequential loop and
        other bits. It takes neither CFG nor priming (``ValueError``)."""
        prime = None
        if img is not None:
            n_prime = num_init_img_tokens
            if n_prime is None:
                n_prime = int(0.4375 * self.model.cfg.image_seq_len)
            if not 0 <= n_prime < self.model.cfg.image_seq_len:
                raise ValueError(f"num_init_img_tokens {n_prime} must be in "
                                 f"[0, {self.model.cfg.image_seq_len})")
            with span("decode/vae_encode_prime"):
                prime = self.vae.get_codebook_indices(img)[:, :n_prime]
        if clip is not None and not isinstance(clip, CLIP):
            raise TypeError(f"clip must be a models.clip.CLIP, got {type(clip).__name__}")
        if speculative > 0 and (cond_scale != 1.0 or prime is not None):
            # not an assert: -O must not silently drop the user's CFG
            raise ValueError(
                "speculative decode supports cond_scale=1.0 and no "
                "image priming (CFG would need a second verified "
                "window per round)")
        model, cache_dtype = self._resolve_precision(precision)
        n_new = model.cfg.image_seq_len - (prime.shape[1] if prime is not None else 0)
        with span("decode/generate_tokens", tokens=int(n_new), batch=int(text.shape[0]),
                  precision=precision) as dec_span:
            if speculative > 0:
                ids = model.generate_images_tokens_speculative(
                    text, gamma=speculative, draft=draft, generator=generator, noise=noise,
                    filter_thres=filter_thres, temperature=temperature,
                    cache_dtype=cache_dtype)
            else:
                ids = model.generate_images_tokens(
                    text, generator=generator, noise=noise, filter_thres=filter_thres,
                    temperature=temperature, cond_scale=cond_scale, image_prime=prime,
                    cache_dtype=cache_dtype)
            if _obs_enabled() and ids.is_cuda:
                # the launches return before the card is done: without the
                # wait the span would time the launches, not the tokens
                torch.cuda.synchronize(ids.device)
        if dec_span.duration is not None and n_new > 0:
            gauge_set("obs.decode_per_token_ms", dec_span.duration * 1e3 / n_new)
            counter_add("obs.decode_tokens_total", float(n_new * text.shape[0]))
        with span("decode/vae_decode"):
            images = self.vae.decode(ids)
        if clip is None:
            return images
        with span("decode/clip_rerank"):
            scores = rerank_scores(clip, text, images)
        return images, scores

    def generate_texts(self, text=None, *, batch: int = 1,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       filter_thres: float = 0.5, temperature: float = 1.0):
        """Complete text prefixes to text_seq_len tokens with the source
        (full-width) model: ``DALLE.generate_texts_tokens``."""
        return self.model.generate_texts_tokens(
            text, batch=batch, generator=generator, noise=noise,
            filter_thres=filter_thres, temperature=temperature)

    def serve_engine(self, *, slots: int, precision: str = "int8w",
                     filter_thres: float = 0.5, temperature: float = 1.0,
                     topk_approx: bool = False, steps_per_sync: int = 1,
                     use_kernel=None, decode_health: bool = False,
                     prefill_chunk: int = 0, kv_block_tokens: int = 0,
                     kv_pool_blocks=None, radix_cache: bool = True, noise_fn=None):
        """Continuous-batching decode engine (``serve/engine.py``) over this
        wrapper's model, in a precision mode of ``generate_images``, reusing
        the wrapper's cached derived weights. The default is ``int8w``, as in
        the JAX package: int8 weights (per-channel scales, the W8 kernel)
        beside the int8 KV cache, the least weight and cache bytes a decode
        step reads.

        Its tokens against the same model's sequential
        ``generate_images_tokens`` under the request's generator keep the
        reference's contract (``dalle_tpu/models/dalle.py:290-296``):
        * with ``use_kernel=False`` here and on the sequential call, bit for
          bit in every precision: both paths then attend through the JAX
          package's dense formula, and the W8 product gives a row the same
          bits at any row count;
        * under ``use_kernel`` None (auto) or True, the engine attends
          through the windowed kernels K3/K5 and the sequential decode
          steps through K2, distinct implementations that round at other
          points; at f32 compute and cache they differ in summation order
          only (on the CPU bit for bit), in the bf16 modes (the default
          included) they may part at a near-tie, as the JAX package's do on
          its TPU.
        Pass ``precision="float32"`` for the full-width engine. The engine
        runs where the model is, and emits image token ids per request."""
        from ..serve.engine import DecodeEngine
        model, cache_dtype = self._resolve_precision(precision)
        return DecodeEngine(model, slots=slots, cache_dtype=cache_dtype,
                            filter_thres=filter_thres, temperature=temperature,
                            topk_approx=topk_approx, steps_per_sync=steps_per_sync,
                            decode_health=decode_health, prefill_chunk=prefill_chunk,
                            kv_block_tokens=kv_block_tokens,
                            kv_pool_blocks=kv_pool_blocks, radix_cache=radix_cache,
                            use_kernel=use_kernel, noise_fn=noise_fn,
                            device=next(model.parameters()).device)
