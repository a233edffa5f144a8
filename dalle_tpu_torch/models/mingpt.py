"""minGPT: the decoder-only transformer of taming's second stage.

Port of ``dalle_tpu/models/mingpt.py``: token and learned position
embeddings, pre-LN blocks (LayerNorm ε 1e-6, as flax) with a 4× GELU (tanh
form, ``jax.nn.gelu``'s default) MLP and an unbiased head; the first
``n_unmasked`` key positions visible to every query (a static mask, dense
attention as in the JAX package). Module names follow the flax tree
(``tok_emb``, ``pos_emb``, ``block_{i}.qkv``, ``ln_f``, ``head``).

Cached sampling runs over a preallocated ``KVCache`` per layer
(``ops/attention.py``): ``prefill`` writes the prompt, ``decode_one``
appends one token and attends through ``cached_attend``, which on the card
is the decode kernel K2 (``ops/decode_attention.py``). ``make_sampler`` is
the JAX package's scanned sampler as a loop: ``vocab_limit``, top-k,
temperature, and gumbel noise from a generator or injected as a
(steps, b, vocab) table. Dropout (``resid_pdrop``, ``embd_pdrop``) acts
only in a training pass, its masks drawn from the caller's generator;
``attn_pdrop`` is unused, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConfigBase
from ..device import resolve_device
from ..ops.attention import KVCache, attend, cached_attend
from ..ops.sampling import gumbel_sample, quiet_spans
from .transformer import drawn_dropout


@dataclass(frozen=True)
class GPTConfig(ConfigBase):
    """taming's ``GPTConfig`` as a typed config, with the JAX package's
    defaults."""
    vocab_size: int = 512
    block_size: int = 512
    n_layer: int = 12
    n_head: int = 8
    n_embd: int = 256
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    n_unmasked: int = 0


def prefix_causal_mask(n: int, n_unmasked: int) -> np.ndarray:
    """Lower-triangular (n, n) mask with the first ``n_unmasked`` key columns
    visible to every row."""
    mask = np.tril(np.ones((n, n), bool))
    if n_unmasked > 0:
        mask[:, :n_unmasked] = True
    return mask


class GPTBlock(nn.Module):
    """x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        c = self.cfg = cfg
        self.ln1 = nn.LayerNorm(c.n_embd, eps=1e-6)
        self.ln2 = nn.LayerNorm(c.n_embd, eps=1e-6)
        self.qkv = nn.Linear(c.n_embd, 3 * c.n_embd)
        self.attn_out = nn.Linear(c.n_embd, c.n_embd)
        self.mlp_in = nn.Linear(c.n_embd, 4 * c.n_embd)
        self.mlp_out = nn.Linear(4 * c.n_embd, c.n_embd)

    def split_heads(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.cfg.n_head, -1).transpose(1, 2)

    def qkv_heads(self, x):
        """(b, n, d) → q, k, v as (b, h, n, d/h) after ``ln1``."""
        return map(self.split_heads, self.qkv(self.ln1(x)).chunk(3, dim=-1))

    @staticmethod
    def merge_heads(out):
        b, h, n, hd = out.shape
        return out.transpose(1, 2).reshape(b, n, h * hd)

    def mlp(self, x):
        return self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))

    def forward(self, x, mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator=None):
        q, k, v = self.qkv_heads(x)
        out = self.merge_heads(attend(q, k, v, causal=mask is None, static_mask=mask))
        drop = 0.0 if deterministic else self.cfg.resid_pdrop
        x = x + drawn_dropout(self.attn_out(out), drop, generator)
        return x + drawn_dropout(self.mlp(x), drop, generator)

    def decode_step(self, x, cache: KVCache, length: int) -> Tuple[torch.Tensor, KVCache]:
        """One token x (b, 1, d) at position ``length`` - 1."""
        q, k, v = self.qkv_heads(x)
        cache = cache.append(k, v, length - 1)
        x = x + self.attn_out(self.merge_heads(cached_attend(q, cache, length)))
        return x + self.mlp(x), cache


class GPT(nn.Module):
    """Token + learned position embeddings → blocks → LayerNorm → unbiased
    vocabulary head. ``embeddings`` (b, m, d) are prepended to the token
    embeddings."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        c = self.cfg = cfg
        self.tok_emb = nn.Embedding(c.vocab_size, c.n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, c.block_size, c.n_embd))
        for i in range(c.n_layer):
            self.add_module(f"block_{i}", GPTBlock(c))
        self.ln_f = nn.LayerNorm(c.n_embd, eps=1e-6)
        self.head = nn.Linear(c.n_embd, c.vocab_size, bias=False)
        self.register_buffer("mask", torch.as_tensor(
            prefix_causal_mask(c.block_size, c.n_unmasked), device=self.pos_emb.device),
            persistent=False)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layer)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``: Linear weights normal with std
        1/sqrt(fan-in), biases 0, LayerNorms 1 and 0, the token table std
        1/sqrt(n_embd), the position table std 0.02."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.tok_emb.weight.normal_(0.0, self.cfg.n_embd ** -0.5, generator=generator)
        self.pos_emb.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, idx, embeddings: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        x = self.tok_emb(idx)
        if embeddings is not None:
            x = torch.cat([embeddings, x], dim=1)
        n = x.shape[1]
        if n > self.cfg.block_size:
            raise ValueError(f"sequence of {n} longer than block_size {self.cfg.block_size}")
        x = drawn_dropout(x + self.pos_emb[:, :n], 0.0 if deterministic else self.cfg.embd_pdrop,
                          generator)
        mask = self.mask[:n, :n]
        for blk in self.blocks:
            x = blk(x, mask=mask, deterministic=deterministic, generator=generator)
        return self.head(self.ln_f(x))

    # -- cached decode -------------------------------------------------------
    def init_cache(self, batch: int, dtype=torch.float32) -> Tuple[KVCache, ...]:
        c = self.cfg
        return tuple(KVCache.init(batch, c.n_head, c.block_size, c.n_embd // c.n_head, dtype,
                                  device=self.pos_emb.device) for _ in range(c.n_layer))

    def decode_one(self, token, pos: int, cache):
        """token (b, 1) at position ``pos`` → (logits (b, vocab), cache)."""
        x = self.tok_emb(token) + self.pos_emb[:, pos:pos + 1]
        new = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.decode_step(x, c, pos + 1)
            new.append(c)
        return self.head(self.ln_f(x))[:, 0], tuple(new)

    def prefill(self, idx, cache):
        """The prompt (b, n) through every layer at once, writing the caches
        → (logits of the last position, cache, n)."""
        x = self.tok_emb(idx)
        n = x.shape[1]
        x = x + self.pos_emb[:, :n]
        mask = self.mask[:n, :n]
        new = []
        for blk, c in zip(self.blocks, cache):
            q, k, v = blk.qkv_heads(x)
            c = c.append(k, v, 0)
            x = x + blk.attn_out(blk.merge_heads(attend(q, k, v, causal=False,
                                                        static_mask=mask)))
            x = x + blk.mlp(x)
            new.append(c)
        return self.head(self.ln_f(x))[:, -1], tuple(new), n


def init_gpt(cfg: GPTConfig, *, seed: int = 0, device=None) -> GPT:
    """A GPT with random weights from a seeded ``torch.Generator``, built
    directly on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = GPT(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()


def make_sampler(model: GPT, steps: int, *, top_k: Optional[int] = None,
                 temperature: float = 1.0, vocab_limit: Optional[int] = None):
    """→ ``sample(prompt (b, n), *, generator=None, noise=None)`` → (b, n +
    steps) ids: prefill, then ``steps`` tokens, each the gumbel-argmax of
    the last logits with ids ≥ ``vocab_limit`` and all but the ``top_k``
    largest masked; ``noise`` (steps, b, vocab) replaces the generator's
    draws. The last token is not decoded further."""

    @torch.no_grad()
    def sample(prompt, *, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        batch, n_prompt = prompt.shape
        if n_prompt + steps > model.cfg.block_size:
            raise ValueError(f"prompt {n_prompt} + steps {steps} exceeds block_size "
                             f"{model.cfg.block_size}")
        logits, cache, n0 = model.prefill(prompt, model.init_cache(batch))
        vocab = logits.shape[-1]
        toks = []
        with quiet_spans():            # one jitted scan in the JAX package
            for i in range(steps):
                lg = logits.float()
                if vocab_limit is not None:
                    lg = lg.masked_fill(torch.arange(vocab, device=lg.device) >= vocab_limit,
                                        float("-inf"))
                if top_k is not None:
                    kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
                    lg = lg.masked_fill(lg < kth, float("-inf"))
                tok = gumbel_sample(lg, temperature=temperature, generator=generator,
                                    noise=None if noise is None else noise[i])
                toks.append(tok)
                if i + 1 < steps:
                    logits, cache = model.decode_one(tok[:, None], n0 + i, cache)
        return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)], dim=1)

    return sample
