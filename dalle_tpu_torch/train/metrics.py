"""Parameter and FLOP counts for throughput reports.

Port of ``count_params`` and ``transformer_train_flops`` from
``dalle_tpu/train/metrics.py``. The JAX package's meter, peak table and
profiler hooks come with the observability slice.
"""

from __future__ import annotations

import torch


def count_params(model: torch.nn.Module) -> int:
    """Elements over every parameter; a layer shared between depths counts
    once, as in the flax tree."""
    return sum(p.numel() for p in model.parameters())


def transformer_train_flops(n_params: int, tokens_per_batch: int) -> float:
    """6·N·D analytic training FLOPs per step (forward + backward)."""
    return 6.0 * n_params * tokens_per_batch
