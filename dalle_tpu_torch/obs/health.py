"""Decode-quality taps: the serve engine's per-row view of the
distribution it samples from.

Port of ``decode_quality`` (``dalle_tpu/obs/health.py``) and the key
helpers of ``dalle_tpu/obs/anomaly.py`` (``HEALTH_PREFIX``,
``split_health_key``). The taps run on the logits already on the card and
return tensors there, so the engine reads them with its tokens, in the same
host read; they draw nothing from a generator, so sampling is untouched.
The training taps (``tree_health``, ``codebook_health``, ``gumbel_health``)
and the anomaly detectors are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

HEALTH_PREFIX = "health/"


def split_health_key(key: str) -> Optional[tuple]:
    """``health/grad_norm/gen/encoder`` → ("grad_norm", "gen/encoder");
    ``health/codebook_perplexity`` → ("codebook_perplexity", ""); None for
    other keys."""
    if not key.startswith(HEALTH_PREFIX):
        return None
    rest = key[len(HEALTH_PREFIX):]
    metric, _, group = rest.partition("/")
    return metric, group


def decode_quality(logits: torch.Tensor, topk: int = 32) -> Dict[str, torch.Tensor]:
    """Per-row stats of (B, V) next-token logits, (B,) f32 each:

      * ``entropy``: nats of the next-token distribution;
      * ``topk_mass``: the probability mass of the ``topk`` most likely
        tokens (all of them when ``topk`` ≥ V).

    In f32 whatever the logits' dtype (bf16 and int8w engines emit bf16)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(lp)
    ent = -torch.sum(p * lp, dim=-1)
    k = min(int(topk), logits.shape[-1])
    top = torch.topk(p, k, dim=-1).values
    return {"entropy": ent, "topk_mass": torch.sum(top, dim=-1)}
