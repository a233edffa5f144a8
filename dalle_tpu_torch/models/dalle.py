"""DALL·E: the autoregressive text→image transformer.

Port of ``dalle_tpu/models/dalle.py``: per-position pad tokens and <bos>,
tied or untied embeddings, axial positional embeddings when rotary is off,
the static logits allow-mask, the stable-training tricks, and cached
generation with top-k + gumbel sampling, classifier-free guidance (two
caches: conditioned and null-text) and image priming. The VAE is not a
submodule; ``models/wrapper.py`` composes the two. The training loss is not
ported yet: ``forward`` returns logits.

Generation runs eagerly: a Python loop over decode steps, each step one
``Transformer.decode_step`` whose attention is the decode kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import DalleConfig
from ..device import resolve_device
from ..ops.sampling import gumbel_sample, top_k_filter
from .transformer import LN_EPS, DivideMax, Transformer

MASK_VALUE = -1e9  # fill for the logits mask


class AxialPositionalEmbedding(nn.Module):
    """Learned factored 2D position embedding: row + col tables broadcast over
    the grid and summed."""

    def __init__(self, dim: int, shape: Tuple[int, int]):
        super().__init__()
        h, w = shape
        self.row = nn.Parameter(torch.empty(h, 1, dim))
        self.col = nn.Parameter(torch.empty(1, w, dim))

    def forward(self, n: Optional[int] = None):
        emb = (self.row + self.col).reshape(-1, self.row.shape[-1])
        return emb if n is None else emb[:n]


class DALLE(nn.Module):
    def __init__(self, cfg: DalleConfig):
        super().__init__()
        c = self.cfg = cfg
        self.num_text_tokens = c.num_text_tokens + c.text_seq_len  # + per-pos pads
        self.total_tokens = self.num_text_tokens + c.image_vocab_size
        self.transformer = Transformer(c.transformer())
        if c.share_input_output_emb:
            # one (total_tokens, dim) table serves both embeddings and the
            # output projection
            self.shared_emb = nn.Parameter(torch.empty(self.total_tokens, c.dim))
            self.logits_bias = nn.Parameter(torch.zeros(self.total_tokens))
        else:
            self.text_emb = nn.Embedding(self.num_text_tokens, c.dim)
            self.image_emb = nn.Embedding(c.image_vocab_size, c.dim)
            self.to_logits = nn.Linear(c.dim, self.total_tokens)
        if not c.rotary_emb:
            self.text_pos_emb = nn.Embedding(c.text_seq_len + 1, c.dim)
            self.image_pos_emb = AxialPositionalEmbedding(
                c.dim, (c.image_fmap_size, c.image_fmap_size))
        self.final_norm = nn.LayerNorm(c.dim, eps=LN_EPS)
        self.norm_by_max = DivideMax(dim=-1)
        # static (seq, total_tokens) allow-mask: text positions predict text
        # tokens, image positions image tokens (True = allowed)
        seq = torch.arange(c.total_seq_len)[:, None]
        tok = torch.arange(self.total_tokens)[None, :]
        self.register_buffer(
            "logits_allow", (seq >= c.text_seq_len) == (tok >= self.num_text_tokens),
            persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights drawn from ``generator`` (on the parameters'
        device), in the JAX package's initializers' scales: Dense/Embed
        normal with std 1/sqrt(fan-in) (embeddings: 1/sqrt(dim)), biases 0,
        the tied table N(0, 0.02), axial tables N(0, 1), LayerNorm 1/0."""
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                # Linear weight (out, in), Embedding (num, dim): the last
                # axis is the fan-in / dim in both
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, AxialPositionalEmbedding):
                m.row.normal_(0.0, 1.0, generator=generator)
                m.col.normal_(0.0, 1.0, generator=generator)
        if self.cfg.share_input_output_emb:
            self.shared_emb.normal_(0.0, 0.02, generator=generator)
            self.logits_bias.zero_()
        return self

    # -- embedding helpers -------------------------------------------------
    def _embed_text_ids(self, ids):
        if self.cfg.share_input_output_emb:
            return self.shared_emb[ids]
        return self.text_emb(ids)

    def _embed_image_ids(self, ids):
        if self.cfg.share_input_output_emb:
            return self.shared_emb[ids + self.num_text_tokens]
        return self.image_emb(ids)

    def _logits(self, x):
        x = self.final_norm(x)
        if self.cfg.share_input_output_emb:
            return x @ self.shared_emb.t() + self.logits_bias
        return self.to_logits(x)

    def remap_and_bos(self, text):
        """0-pads → unique per-position pad ids; prepend <bos>=0. Longer text
        is cropped to text_seq_len, shorter 0-padded."""
        c = self.cfg
        n = text.shape[1]
        if n > c.text_seq_len:
            text = text[:, :c.text_seq_len]
        elif n < c.text_seq_len:
            text = nn.functional.pad(text, (0, c.text_seq_len - n))
        pad_ids = torch.arange(c.text_seq_len, device=text.device) + c.num_text_tokens
        text = torch.where(text == 0, pad_ids[None, :], text)
        return nn.functional.pad(text, (1, 0))  # <bos> id 0

    def embed_text(self, text_with_bos):
        tok = self._embed_text_ids(text_with_bos)
        if not self.cfg.rotary_emb:
            n = text_with_bos.shape[1]
            tok = tok + self.text_pos_emb.weight[:n]
        return tok

    def embed_image(self, image_ids, first_pos: int = 0):
        tok = self._embed_image_ids(image_ids)
        if not self.cfg.rotary_emb:
            n = image_ids.shape[1]
            tok = tok + self.image_pos_emb()[first_pos:first_pos + n]
        return tok

    def _stabilize(self, tokens):
        if self.cfg.stable:  # α-blend trick
            alpha = 0.1
            tokens = tokens * alpha + tokens.detach() * (1 - alpha)
        return tokens

    def _finish(self, x, start: int, n: int):
        """transformer output → logits masked by rows start..start+n of the
        allow-mask."""
        if self.cfg.stable:
            x = self.norm_by_max(x)
        logits = self._logits(x)
        allow = self.logits_allow[start:start + n]
        return torch.where(allow[None], logits, MASK_VALUE)

    def _device(self):
        return self.final_norm.weight.device

    # -- forward -----------------------------------------------------------
    def forward(self, text, image_ids):
        """``text``: (b, text_seq_len) int (0 = pad); ``image_ids``:
        (b, image_seq_len) codebook indices → (b, n, total_tokens) logits."""
        c = self.cfg
        if text.shape[1] != c.text_seq_len:
            raise ValueError(f"text must be {c.text_seq_len} tokens, got {text.shape[1]}")
        text_b = self.remap_and_bos(text)
        tokens = torch.cat([self.embed_text(text_b), self.embed_image(image_ids)], dim=1)
        tokens = self._stabilize(tokens[:, :c.total_seq_len])
        out = self.transformer(tokens)
        return self._finish(out, 0, tokens.shape[1])

    # -- generation --------------------------------------------------------
    def _prefill(self, text, image_prime, batch: int, dtype=torch.float32):
        c = self.cfg
        cache = self.transformer.init_cache(batch, c.total_seq_len, dtype)
        tokens = self.embed_text(self.remap_and_bos(text))
        if image_prime is not None and image_prime.shape[1] > 0:
            tokens = torch.cat([tokens, self.embed_image(image_prime)], dim=1)
        tokens = self._stabilize(tokens)
        y, cache = self.transformer.prefill(tokens, cache)
        logits = self._finish(y[:, -1:], tokens.shape[1] - 1, 1)[:, 0]
        return logits, cache, tokens.shape[1]

    def _decode_one(self, token_id, img_pos: int, offset: int, cache):
        """Embed the image token sampled at image position ``img_pos`` and
        advance the cache at ``offset``."""
        tok = self._embed_image_ids(token_id[:, None])
        if not self.cfg.rotary_emb:
            tok = tok + self.image_pos_emb()[img_pos:img_pos + 1][None]
        tok = self._stabilize(tok)
        y, cache = self.transformer.decode_step(tok, cache, offset)
        return self._finish(y, offset, 1)[:, 0], cache

    @torch.no_grad()
    def generate_images_tokens(self, text, *, generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None,
                               filter_thres: float = 0.5, temperature: float = 1.0,
                               cond_scale: float = 1.0,
                               image_prime: Optional[torch.Tensor] = None,
                               cache_dtype=torch.float32):
        """AR-sample the image token sequence → (b, image_seq_len) int64.

        Gumbel draws come from ``generator``, or from ``noise`` of shape
        (n_steps, b, image_vocab_size): row i is the draw for the i-th
        sampled token, the last row the final token's (sampled from the last
        logits, with no decode after it). ``cond_scale != 1`` runs
        classifier-free guidance with a second, null-text cache.
        ``image_prime`` (b, n_prime) token ids fix the first image tokens.
        ``cache_dtype`` float32, bfloat16 or int8 (quantized KV)."""
        c = self.cfg
        dev = self._device()
        text = text.to(dev)
        b = text.shape[0]
        if image_prime is not None:
            image_prime = image_prime.to(dev)
        n_prime = 0 if image_prime is None else image_prime.shape[1]
        n_steps = c.image_seq_len - n_prime
        if noise is not None and tuple(noise.shape) != (n_steps, b, c.image_vocab_size):
            raise ValueError(f"noise must be {(n_steps, b, c.image_vocab_size)}, "
                             f"got {tuple(noise.shape)}")
        use_cfg = cond_scale != 1.0

        logits, cache, prefix_len = self._prefill(text, image_prime, b, cache_dtype)
        if use_cfg:
            null_logits, null_cache, _ = self._prefill(torch.zeros_like(text),
                                                       image_prime, b, cache_dtype)
            logits = null_logits + (logits - null_logits) * cond_scale

        def sample(logits, i):
            band = top_k_filter(logits[:, self.num_text_tokens:], thres=filter_thres)
            return gumbel_sample(band, temperature=temperature, generator=generator,
                                 noise=None if noise is None else noise[i])

        toks = []
        for i in range(n_steps - 1):
            tok = sample(logits, i)
            toks.append(tok)
            offset = prefix_len + i
            logits, cache = self._decode_one(tok, n_prime + i, offset, cache)
            if use_cfg:
                nl, null_cache = self._decode_one(tok, n_prime + i, offset, null_cache)
                logits = nl + (logits - nl) * cond_scale
        toks.append(sample(logits, n_steps - 1))
        out = torch.stack(toks, dim=1)
        if n_prime > 0:
            out = torch.cat([image_prime.to(out.dtype), out], dim=1)
        return out


def init_dalle(cfg: DalleConfig, *, seed: int = 0, device=None) -> DALLE:
    """A DALLE with random weights from a seeded ``torch.Generator``, built
    directly on ``device`` (default: the CUDA card; pass "cpu" explicitly)."""
    dev = resolve_device(device)
    with torch.device(dev):
        # the buffers made from numpy tables (rotary, static masks) ignore
        # the default device; .to moves them, the parameters are there already
        model = DALLE(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
