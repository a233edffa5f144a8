"""Sampling primitives: top-k filtering and the gumbel-max draw.

Port of ``dalle_tpu/ops/sampling.py`` (``top_k_filter``, ``top_p_filter``,
``gumbel_sample``, ``gumbel_sample_rows``, and CLIP's pooling
``masked_mean``). Draws come from an explicit ``torch.Generator``;
``gumbel_sample`` also takes injected noise, so a test can feed it the JAX
package's own draws. ``row_noise`` gives each row of a batch its own draw
source, which is how the serve engine keeps every request's tokens those of
a sequential run under the request's own generator. The speculative
sampler (``DALLE.generate_images_tokens_speculative``) takes a whole
(step, row) table of ``gumbel_noise`` so that a token's draw does not depend
on the round in which its row reaches it.
"""

from __future__ import annotations

from typing import Optional

import torch


def top_k_filter(logits: torch.Tensor, thres: float = 0.5) -> torch.Tensor:
    """Keep the top max(int((1-thres)·vocab), 1) logits (everything >= the
    k-th largest), set the rest to -inf."""
    k = max(int((1.0 - thres) * logits.shape[-1]), 1)
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, top_p: float = 0.9) -> torch.Tensor:
    """Nucleus filtering: keep the largest logits while the softmax mass
    before each (in descending order) is below ``top_p`` (the first always
    kept), set the rest to -inf. Ties at the cut are kept, as the JAX
    package's threshold comparison keeps them."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < top_p], dim=-1)
    kth = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, float("-inf"))


def gumbel_noise(shape, *, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U uniform on (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_sample(logits: torch.Tensor, *, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax(logits/T + g) over the last axis, in f32. ``g`` is ``noise``
    (the logits' shape) when given, else a fresh draw from ``generator``."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device)
    elif noise.shape != logits.shape:
        raise ValueError(f"noise {tuple(noise.shape)} must match logits "
                         f"{tuple(logits.shape)}")
    scaled = logits.float() / max(temperature, 1e-10)
    return torch.argmax(scaled + noise.to(scaled.device, torch.float32), dim=-1)


def row_noise(sources, vocab: int, device) -> torch.Tensor:
    """(len(sources), vocab) f32 gumbel draws, one row per source: a
    ``torch.Generator`` draws ``(1, vocab)`` exactly as a sequential batch-1
    sampler does, a tensor or array is taken as the row's draw, None (a
    parked row) draws nothing and gives zeros."""
    rows = []
    for src in sources:
        if src is None:
            rows.append(torch.zeros((1, vocab), dtype=torch.float32, device=device))
        elif isinstance(src, torch.Generator):
            rows.append(gumbel_noise((1, vocab), generator=src, device=device))
        else:
            rows.append(torch.as_tensor(src, dtype=torch.float32).reshape(1, vocab).to(device))
    return torch.cat(rows, dim=0)


def gumbel_sample_rows(logits: torch.Tensor, noise: torch.Tensor, *,
                       thres: float = 0.5, temperature: float = 1.0) -> torch.Tensor:
    """Per-row filtered gumbel-argmax over (b, V) logits with a (b, V) draw
    (``row_noise``): ``top_k_filter`` + ``gumbel_sample`` row by row, so a
    row sampled here equals that row sampled alone under the same draw."""
    return gumbel_sample(top_k_filter(logits, thres=thres),
                         temperature=temperature, noise=noise)


def masked_mean(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (b, n, d) ``t`` over axis 1, counting only the positions where
    the (b, n) ``mask`` is True (at least one in the divisor)."""
    t = torch.where(mask[..., None], t, torch.zeros((), dtype=t.dtype, device=t.device))
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    return t.sum(dim=1) / denom
