"""The dVAE's quantizer: the gumbel-softmax relaxation and its KL term.

Port of ``gumbel_softmax`` and ``kl_to_uniform`` from
``dalle_tpu/ops/quantize.py``. Draws come from an explicit
``torch.Generator``, or are injected (``noise``), so a test can feed
``gumbel_softmax`` the JAX package's own ``jax.random.gumbel`` draw.
``vector_quantize``, ``gumbel_quantize`` and the index remaps wait for the
VQGAN (``ROADMAP.md`` Queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .sampling import gumbel_noise


def gumbel_softmax(logits: torch.Tensor, tau: float, hard: bool = False, dim: int = -1,
                   *, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """softmax((logits + g) / tau) over ``dim``, g standard Gumbel: ``noise``
    (the logits' shape) when given, else a draw from ``generator``. ``tau``
    is cast to the logits' dtype before the division, so a bf16 path stays
    bf16. ``hard`` returns the one-hot of the argmax in the forward and the
    soft sample's gradient in the backward (straight-through)."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator, device=logits.device)
    elif noise.shape != logits.shape:
        raise ValueError(f"noise {tuple(noise.shape)} must match logits "
                         f"{tuple(logits.shape)}")
    g = noise.to(logits.device, logits.dtype)
    tau = torch.tensor(tau, dtype=logits.dtype, device=logits.device)
    y_soft = torch.softmax((logits + g) / tau, dim=dim)
    if not hard:
        return y_soft
    idx = torch.argmax(y_soft, dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, idx, 1.0)
    return y_soft + (y_hard - y_soft).detach()


def kl_to_uniform(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """KL(softmax(logits) ‖ uniform), summed over positions and vocab and
    divided by the batch (the leading dim): ``F.kl_div``'s "batchmean"."""
    n = logits.shape[dim]
    logp = torch.log_softmax(logits, dim=dim)
    kl = torch.sum(logp.exp() * (logp + math.log(n)), dim=dim)
    return kl.sum() / logits.shape[0]
