"""Learning-rate schedules, the optimizer, and mixed precision.

Port of ``dalle_tpu/train/train_state.py``. The JAX package builds one optax
chain (``_build_optimizer``) and ``TrainState.apply_gradients`` applies it;
``Optimizer.step`` computes the same chain on the parameters' ``.grad``, in
this order:

1. ``optax.MultiSteps`` when ``grad_accum_steps`` = k > 1: every call folds
   the gradients into a running mean, ``acc + (g - acc) / (n + 1)``; only
   every k-th call runs the rest of the chain, on that mean, and the other
   calls change no parameter.
2. ``clip_by_global_norm`` as optax defines it.
3. The core at the scheduled learning rate: Adam (eps outside the square
   root, both bias corrections), AdamW (the decay decoupled and scaled by
   the learning rate), SGD, or Adafactor (``_Adafactor``). Update ``k``
   (counted from 0) reads the schedule at ``k``.
4. With ``lr_scheduler="plateau"``, the scale of
   ``optax.contrib.reduce_on_plateau`` (``_Plateau``), which sees every
   call's loss, accumulation steps included.
5. With ``lr_scale`` armed (``TrainConfig.runtime_lr_scale``), the runtime
   scale ``set_lr_scale`` writes, as ``TrainState.lr_scale``.

With ``health`` (``ObsConfig.health``), each call also leaves ``taps``
(``StepTaps``): per parameter, Σg² and the non-finite elements of the
gradient it was given (before any clipping or averaging, as the JAX step's
taps read ``grads``), Σp² after the call, and Σu² of the update it applied
(optax's ``updates``, after every scale; 0 on an accumulation step, where
``MultiSteps`` emits zeros). Each core takes ‖u‖ where it forms u, as one
more reduction beside its arithmetic: the parameters' bits are the same with
and without, and no parameter is copied (Adam's ‖u‖ takes one temporary the
size of a foreach group).

With ``shards`` (a ``ShardLayout``: fully sharded data parallelism) each
parameter and its state are this rank's slice along one dimension (or
whole), and every reduction that crosses that dimension is summed over the
layout's group, so the update equals the one-process optimizer's: the
global norm of the clip (a replicated leaf counted once), Adafactor's
factored means of g² and of ``v_row``, its per-tensor rms(u) and rms(p)
and its factoring (read off the full shapes), and the taps. Elementwise
arithmetic (Adam, SGD) needs nothing.

Nothing in a step is read back to the host: the scales are device scalars,
the counts host integers that the host advances itself. Adam, AdamW and
SGD use ``torch.optim``'s foreach arithmetic; each core works through the
parameters in groups of at most ``GROUP_ELEMENTS`` elements, which bounds
its temporaries.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import OptimConfig
from ..parallel.comm import all_reduce_

GROUP_ELEMENTS = 1 << 27            # a core's foreach group (512 MB of f32)
# optax.adafactor's defaults, which the JAX package keeps
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_CLIP = 1.0                # clip_by_block_rms threshold
ADAFACTOR_MIN_PARAM_RMS = 1e-3      # scale_by_param_block_rms floor
# optax.contrib.reduce_on_plateau's defaults, which the JAX package keeps
PLATEAU_RTOL = 1e-4
PLATEAU_ATOL = 0.0
PLATEAU_ACCUMULATION = 1


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step → learning rate: constant, cosine decay to 0 over
    ``total_steps - warmup_steps``, or exponential decay
    (``lr · rate^(step / transition_steps)``, not staircased), after an
    optional linear warm-up from 0 over ``warmup_steps``. "plateau" is the
    constant rate here; its scale is ``_Plateau``'s."""
    lr = cfg.learning_rate
    if cfg.lr_scheduler in ("constant", "plateau"):
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


def tensor_norms(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's L2 norm, accumulated in f32 (0-d f32 tensors)."""
    return torch._foreach_norm([t.float() if t.dtype != torch.float32 else t
                                for t in tensors])


def global_norm(tensors: Sequence[torch.Tensor],
                norms: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    as an f32 scalar tensor on the tensors' device; ``norms`` are the
    tensors' own (``tensor_norms``) when the caller has them."""
    if norms is None:
        norms = tensor_norms(tensors)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / ‖g‖)``, as optax's
    ``clip_by_global_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
    the norm and is another function). ``norm`` is ‖g‖ when the caller has
    it. Returns the norm before clipping."""
    if norm is None:
        norm = global_norm(grads)
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


def _groups(tensors: Sequence[torch.Tensor], cap: int = GROUP_ELEMENTS) -> List[List[int]]:
    """Indices of ``tensors`` in order, cut into runs of at most ``cap``
    elements (a larger tensor is a run of its own)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and size + t.numel() > cap:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    if cur:
        out.append(cur)
    return out


def factored_dims(shape) -> Optional[tuple]:
    """optax's ``_factored_dims`` with ``min_dim_size_to_factor`` 128: (the
    second-largest axis, the largest axis) by ``np.argsort``, or None for a
    tensor of rank < 2 or whose second-largest size is under 128. The port
    applies it to its own layout (a ``Linear.weight`` is the flax kernel's
    transpose): where the two sizes differ it picks the same physical axes
    as JAX; where they tie, argsort's order may pick the other ones (a
    square ``Linear``), which ``convert.adafactor_state_from_optax`` swaps."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class StepTaps(NamedTuple):
    """One ``Optimizer.step``'s per-parameter reductions (``health``), each
    (P,) f32 in the parameters' order."""
    grad_sq: torch.Tensor     # Σ g², before clipping or averaging
    nonfinite: torch.Tensor   # the count of inf/nan elements of g
    param_sq: torch.Tensor    # Σ p², after the call
    update_sq: torch.Tensor   # Σ u², u the update applied (0 where none)


def _put_norms(unorm, idx, norms):
    for i, n in zip(idx, norms):
        unorm[i] = n


class ShardLayout(NamedTuple):
    """Fully sharded parameters: ``dims[i]`` is the dimension of parameter
    i that this rank holds one of ``parts`` equal slices of (None: whole on
    every rank); ``group`` holds the other slices."""
    dims: List[Optional[int]]
    group: object
    parts: int

    def full_shape(self, i: int, shape) -> tuple:
        d = self.dims[i]
        return tuple(n * self.parts if j == d else n for j, n in enumerate(shape))

    def globalize(self, idx: Sequence[int], *norm_lists: List[torch.Tensor]):
        """Per-tensor L2 norms of the parameters ``idx`` (one list per
        quantity) with each sharded tensor's norm made the whole tensor's:
        sqrt of the group's sum of squares, in one exchange."""
        sel = [j for j, i in enumerate(idx) if self.dims[i] is not None]
        if not sel:
            return norm_lists
        sq = torch.stack([torch.stack([ns[j] for j in sel]) for ns in norm_lists]).square()
        full = all_reduce_(sq, self.group).sqrt()
        out = []
        for row, ns in zip(full, norm_lists):
            ns = list(ns)
            for k, j in enumerate(sel):
                ns[j] = row[k]
            out.append(ns)
        return out


class _Core:
    """One optimizer's per-parameter state, named by ``STATE`` (lists in
    the parameters' order, None where a parameter holds none), and its
    update: ``apply(params, grads, lr, count, scale, unorm)`` moves the
    parameters by ``scale`` (a device scalar, or None for 1) times the
    update at learning rate ``lr``, ``count`` updates after the first. When
    ``unorm`` (a list, one slot a parameter) is given, it puts ‖u‖ of each
    parameter's update there, reading what the update reads and writing no
    parameter."""
    STATE: tuple = ()
    shard: Optional[ShardLayout] = None

    def state_dim(self, key: str, i: int) -> Optional[int]:
        """The sharded dimension of state ``key`` of parameter i."""
        return None if self.shard is None else self.shard.dims[i]

    def state_dict(self) -> Dict[str, list]:
        return {k: getattr(self, k) for k in self.STATE}

    def load_state_dict(self, sd: Dict[str, list]):
        for k in self.STATE:
            mine, theirs = getattr(self, k), sd[k]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state {k!r}: {len(theirs)} tensors for "
                                 f"{len(mine)} parameters")
            for i, (dst, src) in enumerate(zip(mine, theirs)):
                if (dst is None) != (src is None) or (
                        dst is not None and dst.shape != src.shape):
                    raise ValueError(f"optimizer state {k!r}[{i}] does not fit its "
                                     "parameter")
                if dst is not None:
                    dst.copy_(src)


class _Sgd(_Core):
    def __init__(self, cfg: OptimConfig, params, shard: Optional[ShardLayout] = None):
        self.shard = shard
        self.groups = _groups(params)

    def apply(self, params, grads, lr, count, scale, unorm=None):
        for idx in self.groups:
            ps, gs = [params[i] for i in idx], [grads[i] for i in idx]
            if scale is not None:
                gs = torch._foreach_mul(gs, scale)
            if unorm is not None:
                norms = torch._foreach_norm(gs)
                torch._foreach_mul_(norms, lr)
                _put_norms(unorm, idx, norms)
            torch._foreach_add_(ps, gs, alpha=-lr)


class _Adam(_Core):
    """``optax.adam`` / ``optax.adamw`` in ``torch.optim.Adam``'s foreach
    arithmetic: mu ← lerp(mu, g, 1-β1), nu ← β2·nu + (1-β2)·g², p ← p −
    lr/(1-β1^t) · mu / (sqrt(nu)/sqrt(1-β2^t) + eps); AdamW first scales p
    by 1 − lr·wd."""
    STATE = ("mu", "nu")

    def __init__(self, cfg: OptimConfig, params, shard: Optional[ShardLayout] = None):
        self.shard = shard
        self.b1, self.b2, self.eps = cfg.beta1, cfg.beta2, cfg.eps
        self.wd = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.groups = _groups(params)

    def apply(self, params, grads, lr, count, scale, unorm=None):
        t = count + 1
        bc1 = 1.0 - self.b1 ** t
        bc2_sqrt = math.sqrt(1.0 - self.b2 ** t)
        for idx in self.groups:
            ps, gs = [params[i] for i in idx], [grads[i] for i in idx]
            mus, nus = [self.mu[i] for i in idx], [self.nu[i] for i in idx]
            torch._foreach_lerp_(mus, gs, 1.0 - self.b1)
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
            denom = torch._foreach_sqrt(nus)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, self.eps)
            if scale is not None:
                torch._foreach_reciprocal_(denom)
                torch._foreach_mul_(denom, scale)      # scale / denom
            if unorm is not None:
                # -u = lr/bc1 · mu/denom (+ lr·wd · p), scaled; p before the update
                u = (torch._foreach_div(mus, denom) if scale is None
                     else torch._foreach_mul(mus, denom))
                if self.wd:
                    torch._foreach_mul_(u, lr / bc1)
                    torch._foreach_add_(u, ps if scale is None
                                        else torch._foreach_mul(ps, scale),
                                        alpha=lr * self.wd)
                    norms = torch._foreach_norm(u)
                else:
                    norms = torch._foreach_norm(u)
                    torch._foreach_mul_(norms, lr / bc1)
                _put_norms(unorm, idx, norms)
                del u
            if self.wd:
                torch._foreach_mul_(ps, 1.0 - lr * self.wd if scale is None
                                    else 1.0 - scale * (lr * self.wd))
            if scale is None:
                torch._foreach_addcdiv_(ps, mus, denom, value=-lr / bc1)
            else:
                torch._foreach_addcmul_(ps, mus, denom, value=-lr / bc1)


class _Adafactor(_Core):
    """``optax.adafactor(lr, momentum=None, weight_decay_rate=wd or None)``
    (optax 0.2.6, ``factorized.scale_by_factored_rms`` then ``alias.py``'s
    chain), per tensor:

    * β_t = 1 − (t+1)^−0.8 at the update's count t (from 0; β_0 = 0);
    * g² + 1e-30, averaged over the largest axis into ``v_row`` and over
      the second-largest into ``v_col`` (``factored_dims``), each a moving
      average at β_t, and u = g · (v_row / mean(v_row))^−½ · v_col^−½; an
      unfactored tensor keeps a full ``v`` and u = g · v^−½;
    * u / max(1, rms(u)), then × lr, then × max(rms(p), 1e-3): one factor
      a tensor here;
    * + wd · p when ``weight_decay`` > 0 (after the learning rate), and the
      parameter moves by −u.

    Factored tensors are updated one at a time (their temporaries are one
    tensor's); the unfactored ones in foreach groups."""
    STATE = ("v_row", "v_col", "v")

    def __init__(self, cfg: OptimConfig, params, shard: Optional[ShardLayout] = None):
        self.wd = cfg.weight_decay
        self.shard = shard
        self.full = [tuple(p.shape) if shard is None else shard.full_shape(i, p.shape)
                     for i, p in enumerate(params)]
        self.dims = [factored_dims(shape) for shape in self.full]
        self.v_row, self.v_col, self.v = [], [], []
        for p, dims in zip(params, self.dims):
            if dims is None:
                self.v_row.append(None)
                self.v_col.append(None)
                self.v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                self.v_row.append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
                self.v_col.append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
                self.v.append(None)
        self.factored = [i for i, d in enumerate(self.dims) if d is not None]
        unfactored = [i for i, d in enumerate(self.dims) if d is None]
        self.unfactored = [[unfactored[j] for j in run]
                           for run in _groups([params[i] for i in unfactored])]

    def state_dim(self, key: str, i: int) -> Optional[int]:
        s = super().state_dim(key, i)
        if s is None or key not in ("v_row", "v_col") or self.dims[i] is None:
            return s
        gone = self.dims[i][1 if key == "v_row" else 0]   # v_row drops d0, v_col d1
        return None if s == gone else s - (s > gone)

    def _mean(self, x, dim: int, sdim: Optional[int], n: int, keepdim: bool = False):
        """x.mean(dim); when ``dim`` is the sharded one (``sdim``), the
        group's sum over its ``n`` elements."""
        if sdim != dim:
            return x.mean(dim, keepdim=keepdim)
        return all_reduce_(x.sum(dim, keepdim=keepdim), self.shard.group) / n

    @staticmethod
    def decay(count: int) -> float:
        """β_t as optax computes it, in f32."""
        t = np.float32(count + 1)
        return float(np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY))

    def _factored_update(self, i, g, beta):
        d1, d0 = self.dims[i]
        full = self.full[i]
        s = super().state_dim("v", i)
        g2 = torch.addcmul(g.new_full((), ADAFACTOR_EPS), g, g)
        v_row, v_col = self.v_row[i], self.v_col[i]
        v_row.mul_(beta).add_(self._mean(g2, d0, s, full[d0]), alpha=1.0 - beta)
        v_col.mul_(beta).add_(self._mean(g2, d1, s, full[d1]), alpha=1.0 - beta)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row = (v_row / self._mean(v_row, reduced_d1, self.state_dim("v_row", i), full[d1],
                                  keepdim=True)).rsqrt_()
        u = torch.mul(g, row.unsqueeze(d0), out=g2)
        return u.mul_(v_col.rsqrt().unsqueeze(d1))

    def _finish(self, us, ps, lr, scale, idx, unorm):
        """Block-rms clip, learning rate, parameter scale, decay, apply."""
        roots = [math.sqrt(math.prod(self.full[i])) for i in idx]
        norms = torch._foreach_norm(us)
        p_norms = torch._foreach_norm(ps)
        u_glob, p_glob = (norms, p_norms) if self.shard is None else \
            self.shard.globalize(idx, norms, p_norms)
        u_rms = torch._foreach_div(u_glob, roots)
        p_rms = torch._foreach_div(p_glob, roots)
        torch._foreach_clamp_min_(u_rms, ADAFACTOR_CLIP)
        torch._foreach_clamp_min_(p_rms, ADAFACTOR_MIN_PARAM_RMS)
        factors = torch._foreach_div(p_rms, u_rms)
        torch._foreach_mul_(factors, lr / ADAFACTOR_CLIP)
        if not self.wd:
            # one pass: p − (factor · scale) · u
            if scale is not None:
                torch._foreach_mul_(factors, scale)
            if unorm is not None:
                _put_norms(unorm, idx, torch._foreach_mul(norms, factors))
            for p, u, f in zip(ps, us, factors):
                p.addcmul_(u, f, value=-1.0)
            return
        for u, f in zip(us, factors):
            u.mul_(f)
        torch._foreach_add_(us, ps, alpha=self.wd)
        if scale is not None:
            torch._foreach_mul_(us, scale)
        if unorm is not None:
            _put_norms(unorm, idx, torch._foreach_norm(us))
        torch._foreach_sub_(ps, us)

    def apply(self, params, grads, lr, count, scale, unorm=None):
        beta = self.decay(count)
        for i in self.factored:
            self._finish([self._factored_update(i, grads[i], beta)], [params[i]], lr, scale,
                         [i], unorm)
        for idx in self.unfactored:
            gs, vs = [grads[i] for i in idx], [self.v[i] for i in idx]
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_add_(g2, ADAFACTOR_EPS)
            torch._foreach_mul_(vs, beta)
            torch._foreach_add_(vs, g2, alpha=1.0 - beta)
            del g2
            us = torch._foreach_rsqrt(vs)
            torch._foreach_mul_(us, gs)
            self._finish(us, [params[i] for i in idx], lr, scale, idx, unorm)


_CORES = {"adam": _Adam, "adamw": _Adam, "sgd": _Sgd, "adafactor": _Adafactor}


class _Plateau:
    """``optax.contrib.reduce_on_plateau(factor, patience, cooldown=,
    min_scale=)`` with optax's rtol 1e-4, atol 0 and accumulation size 1,
    as device tensors updated with ``torch.where``: a step reads nothing
    back. ``update(loss)`` feeds one value; ``scale`` multiplies the
    update."""
    FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count",
              "avg_value")

    def __init__(self, cfg: OptimConfig, device):
        self.factor, self.patience = cfg.plateau_factor, cfg.plateau_patience
        self.cooldown, self.min_scale = cfg.plateau_cooldown, cfg.plateau_min_scale
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.scale = torch.ones((), **f32)
        self.best_value = torch.full((), math.inf, **f32)
        self.plateau_count = torch.zeros((), **i32)
        self.cooldown_count = torch.zeros((), **i32)
        self.count = torch.zeros((), **i32)
        self.avg_value = torch.zeros((), **f32)

    def update(self, value: torch.Tensor):
        count = self.count + 1
        avg = (self.count * self.avg_value + value.detach().float()) / count
        improved = avg < (1.0 - PLATEAU_RTOL) * self.best_value - PLATEAU_ATOL
        best = torch.where(improved, avg, self.best_value)
        plateau = torch.where(improved, 0, self.plateau_count + 1)
        cooling = self.cooldown_count > 0
        hit = plateau == self.patience
        zero = torch.zeros_like(plateau)
        new_plateau = torch.where(cooling | hit, zero, plateau)
        new_scale = torch.where(
            cooling, self.scale,
            torch.clamp_min(torch.where(hit, self.scale * self.factor, self.scale),
                            self.min_scale))
        new_cooldown = torch.where(cooling, self.cooldown_count - 1,
                                   torch.where(hit, zero + self.cooldown, zero))
        done = count == PLATEAU_ACCUMULATION
        self.scale = torch.where(done, new_scale, self.scale)
        self.best_value = torch.where(done, best, self.best_value)
        self.plateau_count = torch.where(done, new_plateau, self.plateau_count)
        self.cooldown_count = torch.where(done, new_cooldown, self.cooldown_count)
        self.count = torch.where(done, zero, count)
        self.avg_value = torch.where(done, torch.zeros_like(avg), avg)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS}

    def load_state_dict(self, sd: Dict[str, torch.Tensor]):
        for k in self.FIELDS:
            getattr(self, k).copy_(sd[k])


class Optimizer:
    """The JAX package's optax chain (see the module's docstring) over
    ``params``. ``count`` is the number of updates the core has applied
    (the schedule reads it); with accumulation, ``mini_step`` counts the
    calls since the last update. ``lr_scale`` arms the runtime scale at
    1.0; ``health`` makes every call leave its ``taps`` (the module's
    docstring); ``shards`` (a ``ShardLayout``) makes ``params`` slices of
    fully sharded tensors (the module's docstring)."""

    def __init__(self, cfg: OptimConfig, params: Sequence[torch.nn.Parameter],
                 lr_scale: bool = False, health: bool = False,
                 shards: Optional[ShardLayout] = None):
        if cfg.optimizer not in _CORES:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.params = list(params)
        self.schedule = make_lr_schedule(cfg)
        self.shards = shards
        self.core = _CORES[cfg.optimizer](cfg, self.params, shards)
        device = self.params[0].device
        self.count = 0
        self.accum = max(cfg.grad_accum_steps, 1)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum > 1 else None
        self._acc_groups = _groups(self.params) if self.acc is not None else []
        self.plateau = _Plateau(cfg, device) if cfg.lr_scheduler == "plateau" else None
        self.lr_scale = (torch.ones((), dtype=torch.float32, device=device)
                         if lr_scale else None)
        self.health = health
        self.taps: Optional[StepTaps] = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def set_lr_scale(self, value: float):
        """Set the runtime learning-rate scale (``runtime_lr_scale``); it
        multiplies every later update and travels with the state."""
        if self.lr_scale is None:
            raise ValueError("the runtime lr scale is not armed (TrainConfig."
                             "runtime_lr_scale=False)")
        self.lr_scale.fill_(value)

    def _scale(self) -> Optional[torch.Tensor]:
        scales = [s for s in (None if self.plateau is None else self.plateau.scale,
                              self.lr_scale) if s is not None]
        if not scales:
            return None
        return scales[0] if len(scales) == 1 else scales[0] * scales[1]

    def _accumulate(self, grads):
        n = self.mini_step
        for idx in self._acc_groups:
            acc = [self.acc[i] for i in idx]
            delta = torch._foreach_sub([grads[i] for i in idx], acc)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(acc, delta)

    def step(self, loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One call of the chain on the parameters' gradients (a missing one
        is zero); ``loss`` (a device scalar) feeds the plateau schedule.
        Returns the global norm of these gradients, before any clipping or
        averaging (a device scalar)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norms = self._norms(grads)
        norm = global_norm(grads, norms)
        unorm = None
        if self.health:
            # non-finite elements a tensor, counted in f32 as the JAX tap sums
            # them: g - g is 0 where g is finite and NaN where it is not, and
            # its ord-0 norm counts the NaNs (two passes; isfinite(g).sum()
            # makes five and an int64 copy of g)
            bad = torch.stack([torch.linalg.vector_norm(torch.sub(g, g), ord=0)
                               for g in grads])
            grad_taps = (torch.stack(norms).square(), bad)
            unorm = [None] * len(self.params)
        if self.plateau is not None:
            if loss is None:
                raise ValueError("lr_scheduler='plateau' needs the step's loss")
            self.plateau.update(loss)
        inner_norm = norm
        if self.acc is not None:
            self._accumulate(grads)
            self.mini_step = (self.mini_step + 1) % self.accum
            if self.mini_step:
                if self.health:
                    self._tap(grad_taps, None)
                return norm
            grads = self.acc
            inner_norm = None if self.shards is None else global_norm(grads,
                                                                      self._norms(grads))
        with torch.no_grad():
            if self.cfg.grad_clip_norm and self.cfg.grad_clip_norm > 0:
                clip_by_global_norm_(grads, self.cfg.grad_clip_norm, inner_norm)
            self.core.apply(self.params, grads, self.schedule(self.count), self.count,
                            self._scale(), unorm)
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        if self.health:
            self._tap(grad_taps, unorm)
        return norm

    def _norms(self, tensors) -> List[torch.Tensor]:
        """Each parameter-shaped tensor's whole L2 norm (``tensor_norms``,
        sharded ones summed over the group)."""
        norms = tensor_norms(tensors)
        if self.shards is None:
            return norms
        (norms,) = self.shards.globalize(range(len(norms)), norms)
        return norms

    def _tap(self, grad_taps, unorm):
        """This call's ``taps``: the gradient's, then the parameters' and the
        update's (None: no update, zeros); sharded parameters' sums and
        counts summed over the group."""
        grad_sq, nonfinite = grad_taps
        with torch.no_grad():
            param_sq = torch.stack(tensor_norms(self.params)).square()
            update_sq = (torch.zeros_like(param_sq) if unorm is None
                         else torch.stack(unorm).square())
            if self.shards is not None:
                sel = [i for i, d in enumerate(self.shards.dims) if d is not None]
                if sel:
                    rows = torch.stack([nonfinite, param_sq, update_sq])
                    rows[:, sel] = all_reduce_(rows[:, sel].contiguous(), self.shards.group)
                    nonfinite, param_sq, update_sq = rows
        self.taps = StepTaps(grad_sq, nonfinite, param_sq, update_sq)

    def state_dims(self) -> Dict[str, list]:
        """The sharded dimension of every state tensor (``state_dict``'s
        ``core`` lists and ``acc``), None where whole: what a checkpoint
        gathers and a restore cuts."""
        n = len(self.params)
        dims = {"core": {k: [self.core.state_dim(k, i) for i in range(n)]
                         for k in self.core.STATE}}
        dims["acc"] = [self.core.state_dim("acc", i) for i in range(n)]
        return dims

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The core's moments, the counts, the accumulator, the plateau's
        state and the runtime scale: references to the live tensors, as
        ``torch.optim``'s ``state_dict``."""
        return {"optimizer": self.cfg.optimizer, "count": self.count,
                "core": self.core.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc,
                "plateau": None if self.plateau is None else self.plateau.state_dict(),
                "lr_scale": self.lr_scale}

    def load_state_dict(self, sd: Dict, count: Optional[int] = None):
        """Copy ``sd`` (a ``state_dict``) into the live state. A
        ``torch.optim.Adam``/``AdamW``/``SGD`` state dict (the checkpoints
        written before this optimizer) loads its moments, with ``count``
        from beside it."""
        if "param_groups" in sd:
            sd = self._from_torch_optim(sd, count)
        if sd["optimizer"] != self.cfg.optimizer:
            raise ValueError(f"a {sd['optimizer']} state for a {self.cfg.optimizer} "
                             "optimizer")
        self.core.load_state_dict(sd["core"])
        self.count = int(sd["count"])
        self.mini_step = int(sd.get("mini_step", 0))
        for name in ("acc", "plateau", "lr_scale"):
            if (sd.get(name) is None) != (getattr(self, name) is None):
                raise ValueError(f"the state's {name!r} does not match this optimizer's "
                                 "config")
        if self.acc is not None:
            for dst, src in zip(self.acc, sd["acc"]):
                dst.copy_(src)
        if self.plateau is not None:
            self.plateau.load_state_dict(sd["plateau"])
        if self.lr_scale is not None:
            self.lr_scale.copy_(sd["lr_scale"])

    def _from_torch_optim(self, sd: Dict, count: Optional[int]) -> Dict:
        if count is None:
            raise ValueError("a torch.optim state dict needs its count")
        kind = self.cfg.optimizer
        if kind in ("adam", "adamw"):
            state = sd["state"]
            core = {"mu": [state[i]["exp_avg"] for i in range(len(self.params))],
                    "nu": [state[i]["exp_avg_sq"] for i in range(len(self.params))]}
        elif kind == "sgd":
            core = {}
        else:
            raise ValueError(f"a torch.optim state dict for a {kind} optimizer")
        return {"optimizer": kind, "count": count, "core": core, "mini_step": 0,
                "acc": self.acc, "plateau": None if self.plateau is None
                else self.plateau.state_dict(), "lr_scale": self.lr_scale}


def make_optimizer(cfg: OptimConfig, params: Sequence[torch.nn.Parameter],
                   lr_scale: bool = False, health: bool = False,
                   shards: Optional[ShardLayout] = None) -> Optimizer:
    return Optimizer(cfg, params, lr_scale, health, shards)


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
