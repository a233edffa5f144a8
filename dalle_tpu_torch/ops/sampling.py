"""Sampling primitives: top-k filtering and the gumbel-max draw.

Port of ``dalle_tpu/ops/sampling.py`` (``top_k_filter``, ``gumbel_sample``).
Draws come from an explicit ``torch.Generator``; ``gumbel_sample`` also takes
injected noise, so a test can feed it the JAX package's own draws.
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
