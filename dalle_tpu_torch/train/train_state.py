"""Learning-rate schedules, the optimizer, and mixed precision.

Port of ``dalle_tpu/train/train_state.py``. The JAX package builds an optax
chain, ``clip_by_global_norm`` then ``adam``/``adamw``/``sgd`` under a
schedule; the port clips as optax defines it and steps the matching
``torch.optim`` optimizer, whose update is optax's: Adam's eps outside the
square root with both bias corrections, AdamW's decay decoupled and scaled
by the learning rate. Update ``k`` (counted from 0) uses the schedule's
value at ``k``, as optax's ``scale_by_schedule`` does.

Not ported yet, and raising ``NotImplementedError``: ``adafactor``,
``lr_scheduler="plateau"``, ``grad_accum_steps > 1`` (``optax.MultiSteps``)
and the runtime ``lr_scale`` leaf.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..config import OptimConfig


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step → learning rate: constant, cosine decay to 0 over
    ``total_steps - warmup_steps``, or exponential decay
    (``lr · rate^(step / transition_steps)``, not staircased), after an
    optional linear warm-up from 0 over ``warmup_steps``."""
    lr = cfg.learning_rate
    if cfg.lr_scheduler == "constant":
        def sched(step):
            return lr
    elif cfg.lr_scheduler == "cosine":
        decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

        def sched(step):
            t = min(step, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    elif cfg.lr_scheduler == "exponential":
        def sched(step):
            return lr * cfg.lr_decay_rate ** (step / cfg.lr_transition_steps)
    elif cfg.lr_scheduler == "plateau":
        raise NotImplementedError("lr_scheduler='plateau' is not ported yet")
    else:
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")
    if cfg.warmup_steps <= 0:
        return sched
    warm = cfg.warmup_steps

    def warmed(step):
        if step < warm:
            return lr * step / warm
        return sched(step - warm)
    return warmed


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    as an f32 scalar tensor on the tensors' device."""
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t
                                 for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / ‖g‖)``, as optax's
    ``clip_by_global_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
    the norm and is another function). Returns the norm before clipping."""
    norm = global_norm(grads)
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class Optimizer:
    """The optax chain of ``make_optimizer``: optional global-norm clipping,
    then ``core`` (a ``torch.optim`` optimizer) at the scheduled learning
    rate. ``count`` is optax's step count: the number of updates applied."""

    def __init__(self, cfg: OptimConfig, params: Sequence[torch.nn.Parameter]):
        if cfg.grad_accum_steps > 1:
            raise NotImplementedError("grad_accum_steps > 1 is not ported yet")
        self.cfg = cfg
        self.params = list(params)
        self.schedule = make_lr_schedule(cfg)
        lr = cfg.learning_rate
        if cfg.optimizer == "adam":
            self.core = torch.optim.Adam(self.params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                         eps=cfg.eps)
        elif cfg.optimizer == "adamw":
            self.core = torch.optim.AdamW(self.params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                          eps=cfg.eps, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "sgd":
            self.core = torch.optim.SGD(self.params, lr=lr)
        elif cfg.optimizer == "adafactor":
            raise NotImplementedError("optimizer='adafactor' is not ported yet")
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.count = 0

    def zero_grad(self):
        self.core.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip the parameters' gradients, apply one update, and return the
        global gradient norm before clipping (a device scalar)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.cfg.grad_clip_norm and self.cfg.grad_clip_norm > 0:
            norm = clip_by_global_norm_(grads, self.cfg.grad_clip_norm)
        else:
            norm = global_norm(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.core.param_groups:
            group["lr"] = lr
        self.core.step()
        self.count += 1
        return norm


def make_optimizer(cfg: OptimConfig, params: Sequence[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(cfg, params)


def compute_dtype(precision) -> Optional[torch.dtype]:
    """``PrecisionConfig.compute`` → torch dtype (None when float32)."""
    name = getattr(precision, "compute", "float32")
    if name in ("float32", "f32", None):
        return None
    return getattr(torch, name)


def cast_floating(params: Dict[str, torch.Tensor],
                  dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """Floating parameters cast to ``dtype``. The casts are differentiable,
    so a forward on the copies (``torch.func.functional_call``) sends its
    gradients, cast back to f32, into the f32 masters. Every op of the
    forward then runs in ``dtype`` — embeddings and LayerNorm included,
    which ``torch.autocast`` would keep in f32."""
    if dtype is None:
        return params
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
