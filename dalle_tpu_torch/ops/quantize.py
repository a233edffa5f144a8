"""The quantizers: the dVAE's gumbel-softmax relaxation and its KL term,
and the VQGAN's nearest-code quantizer, its gumbel variant and the index
remaps onto a used subset of the codebook.

Port of ``dalle_tpu/ops/quantize.py``. Draws come from an explicit
``torch.Generator``, or are injected (``noise``), so a test can feed
``gumbel_softmax`` and ``gumbel_quantize`` the JAX package's own
``jax.random.gumbel`` draw. The straight-through estimator is
``z + (z_q - z).detach()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

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


class VQOutput(NamedTuple):
    quantized: torch.Tensor          # the input's shape
    indices: torch.Tensor            # int64 codebook indices, the input's shape without d
    loss: torch.Tensor               # codebook + commitment loss (scalar)
    # gumbel path only: the softmax over the codebook logits
    probs: Optional[torch.Tensor] = None


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25) -> VQOutput:
    """Nearest-code quantization of (..., d) latents against an (n, d)
    codebook: the code at the least ||z||² - 2 z·e + ||e||² (the first of
    equal minima), loss mean((sg[z_q] - z)²) + beta · mean((z_q - sg[z])²),
    and the straight-through z + sg[z_q - z]."""
    d = z.shape[-1]
    flat = z.reshape(-1, d)
    z_sq = torch.sum(flat ** 2, dim=-1, keepdim=True)
    e_sq = torch.sum(codebook ** 2, dim=-1)
    dist = z_sq - 2.0 * flat @ codebook.t() + e_sq[None, :]
    idx = torch.argmin(dist, dim=-1)
    zq = codebook[idx].reshape(z.shape)
    commit = torch.mean((zq - z.detach()) ** 2)
    codebook_loss = torch.mean((zq.detach() - z) ** 2)
    loss = codebook_loss + beta * commit
    zq = z + (zq - z).detach()
    return VQOutput(zq, idx.reshape(z.shape[:-1]), loss)


def gumbel_quantize(logits: torch.Tensor, codebook: torch.Tensor, tau: float, hard: bool,
                    kl_weight: float, *, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> VQOutput:
    """taming's ``GumbelQuantize``: a gumbel-softmax over (..., n) codebook
    logits (draw ``noise``, else from ``generator``) mixes the codebook
    rows; the loss is ``kl_weight`` × the mean KL of softmax(logits) to the
    uniform prior; the indices are the logits' argmax."""
    n = codebook.shape[0]
    one_hot = gumbel_softmax(logits, tau, hard=hard, noise=noise, generator=generator)
    zq = one_hot @ codebook
    probs = torch.softmax(logits, dim=-1)
    kl = kl_weight * torch.mean(torch.sum(probs * torch.log(probs * n + 1e-10), dim=-1))
    return VQOutput(zq, torch.argmax(logits, dim=-1), kl, probs)


def remap_indices(idx: torch.Tensor, used: Sequence[int], unknown: Union[str, int] = "random",
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full-codebook indices onto their position in ``used``. An index not
    in ``used`` becomes a random used position (``unknown='random'``, drawn
    from ``generator``, else from a generator seeded 0 so that evaluation
    tokenization is deterministic), the extra position ``len(used)``
    (``'extra'``), or the int ``unknown``."""
    used_t = torch.as_tensor(list(used), device=idx.device)
    match = idx[..., None] == used_t
    found = match.any(dim=-1)
    new = torch.argmax(match.to(torch.uint8), dim=-1)
    if unknown == "random":
        if generator is None:
            generator = torch.Generator(device=idx.device).manual_seed(0)
        fill = torch.randint(0, used_t.shape[0], idx.shape, generator=generator,
                             device=idx.device)
    elif unknown == "extra":
        fill = torch.full_like(idx, used_t.shape[0])
    else:
        fill = torch.full_like(idx, int(unknown))
    return torch.where(found, new, fill)


def unmap_indices(idx: torch.Tensor, used: Sequence[int]) -> torch.Tensor:
    """The inverse of ``remap_indices``: out-of-range positions (the 'extra'
    token) collapse to ``used[0]``, then back to full-codebook ids."""
    used_t = torch.as_tensor(list(used), device=idx.device)
    idx = torch.where(idx >= used_t.shape[0], torch.zeros_like(idx), idx)
    return used_t[idx]
