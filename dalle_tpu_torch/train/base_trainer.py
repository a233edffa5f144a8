"""The trainers' shared shell: the optimizer step, the metrics cadence,
checkpoints, the fit loop with scanned groups and device prefetch, and NaN
rollback.

Port of ``dalle_tpu/train/base_trainer.py`` for the port's four trainers
(``DalleTrainer``, ``VAETrainer``, ``CLIPTrainer``, ``VQGANTrainer``). A subclass builds
``self.model`` (its parameters are the f32 masters), calls
``_setup_training`` with its loss, and defines ``_put_batch(batch,
stacked)`` (a batch as ``train_step`` takes it, on the device),
``train_step(*batch)`` (one optimizer step) and ``train_steps(*stacked)``
(k steps from (k, b, …) batches, each draw as k ``train_step`` calls make
it, so the two give the same bits). Each places its batch once
(``_place``: this rank's rows, then ``_put_batch``) and hands it to
``_step_placed`` / ``_steps_placed``, which end in ``_finish_step``.

* **Two counters.** ``step`` counts the steps taken, NaN steps included:
  it bounds ``fit`` and names checkpoints. ``optimizer.count`` counts the
  updates the optimizer's state holds, and the learning-rate schedule
  reads it. A rollback rewinds the count with that state and leaves the
  step, as the JAX package rewinds ``opt_state`` and not
  ``TrainState.step``. A checkpoint carries both.
* **The metrics cadence** (``metrics_every`` = N, ``defer_metrics``): a
  step's metrics stay on the device; the host reads them (one
  synchronisation) when the step is a multiple of N, else the step returns
  ``{}``. With ``defer_metrics`` the read at a boundary returns the
  previous boundary's metrics, tagged ``metrics_step``, and parks this
  one's: that step has long finished, so the read does not wait.
* **Scanned groups** (``scan_steps`` = k): ``fit`` stacks k consecutive
  batches and calls ``train_steps``; a short or ragged group drains through
  ``train_step`` (``stack_batches``). Its events (metrics, NaN check, log,
  checkpoint, sample) then come a group at a time, each at the first group
  that crosses its boundary.
* **Device prefetch** (``device_prefetch`` = depth > 0): ``fit`` keeps
  ``depth`` batches already placed on the card (``data/device_prefetch.py``,
  through ``_place``) and steps them with ``_step_placed``.
* **NaN rollback** (``train_cfg.nan_rollback``, on by default as in the JAX
  package): ``fit`` snapshots the masters and the optimizer state, its
  count included, at its start and after every save, and puts the snapshot
  back after a read of a loss that is not finite: a group's or a late
  (``metrics_every`` > 1) NaN rewinds every step since the snapshot. Those
  metrics are not logged, and no checkpoint is written for them: a save
  boundary, and ``fit``'s end, first read the latest step's metrics. The
  snapshot is a copy on the card when ``rollback_snapshot`` is "device", or
  "auto" and ``torch.cuda.mem_get_info`` shows free memory for 1.15× its
  bytes; it is in host memory otherwise, and always on the CPU.
* **Checkpoints** (``train/checkpoints.py``, with ``checkpoint_dir``):
  ``fit`` saves before its first step (``preflight_checkpoint``), whenever
  the step crosses a multiple of ``save_every_steps``, and at its end;
  with ``async_checkpointing`` (the default) a save blocks only for the
  host snapshot and the write runs on a thread, which ``fit`` drains
  (``ckpt/drain``) whenever it returns or raises;
  ``restore`` brings back the masters, the optimizer's state (moments,
  counts, accumulator, plateau state, runtime lr scale), the step and the
  trainer's generator. The metadata carries the model's identity
  (``_meta``) and ``extra_meta``. A checkpoint written before the port's
  own optimizer (a ``torch.optim`` state dict beside ``count``) restores.
* **Chaos** (``chaos.step_hook``): ``fit`` calls it with the step before
  each dispatch, where the JAX package's fit does, so an installed
  ``FaultPlan`` kills, hangs, slows or corrupts there.
* **Telemetry** (``train_cfg.obs``, the JAX package's names): every
  iteration of ``fit`` is a ``fit/step`` span nesting ``fit/batch_wait``
  (blocked on the batch stream), ``fit/dispatch`` (the step's host work and
  launches) and ``fit/sync`` (the metrics read); saves are
  ``fit/checkpoint``, snapshots ``ckpt/snapshot_good`` and
  ``ckpt/preemptive_snapshot``, rollbacks ``ckpt/rollback``. The same
  splits land in each record read inside ``fit`` as ``t_batch_wait_s``,
  ``t_dispatch_s``, ``t_sync_s``, ``t_h2d_s`` (the prefetcher's host time
  for the batch), ``t_ckpt_s`` (the previous save, one record late) and
  ``data_starvation`` (the share of the wall since the last record spent
  waiting on data), with the device gauges every ``device_poll_every``
  steps and a Prometheus textfile mirror (``prometheus_path``). A
  ``ThroughputMeter`` adds samples/s, tokens/s and MFU every ``log_every``
  steps. ``obs.trace`` exports ``trace.json`` and ``spans.jsonl`` to
  ``trace_dir`` (or ``<checkpoint_dir>/obs``) when ``fit`` ends;
  ``obs.watchdog_deadline_s`` runs the stall watchdog, fed a beat a step;
  ``profile_step`` = N profiles the real step that contains step N with
  ``torch.profiler`` into ``<checkpoint_dir>/profile_stepN``.
* **Health** (``obs.health``): the optimizer leaves its per-parameter
  reductions (``train_state.StepTaps``) and ``GroupTaps`` sums them into
  the JAX package's ``health/*`` columns, added to the step's device
  metrics, so they ride its one read. ``fit`` builds a ``HealthSentry``
  (``obs/anomaly.py``) that sees every record read once;
  ``train/actions.BreachActions`` acts on its breaches, through
  ``take_preemptive_snapshot`` (a one-shot rung that ``_rollback``
  prefers over the save's snapshot), ``_rollback`` and ``set_lr_scale``.
  ``grad_hook(trainer)``, when set, runs between the backward and the
  optimizer: tests write into a gradient there.
* **Across processes** (``backend=`` a ``parallel.TorchBackend`` or
  ``mesh=`` a ``parallel.ProcessMesh``; by default the mesh of
  ``train_cfg.mesh`` over the initialized process group): each rank is fed
  the global batch and keeps its rows (``mesh.shard_batch``). Under dp the
  loss and backward run on those rows and the masters' gradients are
  summed over the ranks in flat buckets of one dtype and scaled by
  1/(dp·fsdp) before the optimizer, so its clip sees the global gradient
  (the JAX step's in-graph psum). Under fsdp each rank holds its slice of
  every master and optimizer moment along the dimension
  ``parallel/partition.py`` gives to fsdp (leaves that do not divide stay
  whole); a step all-gathers the compute-dtype copies, runs the loss and
  backward on them, reduces the gradients and keeps its slice, and the
  optimizer sums what crosses a slice (``train_state.ShardLayout``). The
  reported loss and auxiliary scalars are the global ones. A checkpoint
  holds the gathered state (rank 0 writes it; every rank reads it and cuts
  its slice), so it restores at any world size. Only rank 0 logs and hands
  records to the metrics writer; the signal latches are agreed over the
  ranks at every step boundary, so all of them save and leave together.
  tp > 1 raises (ROADMAP.md Queue 1 item 11c).
* **Signals** (``install_signal_checkpoint``, ``install_preemption_handler``):
  the handlers only latch flags. SIGUSR1 saves at the next step boundary
  and drains that save, so the latch means "durable now". SIGTERM does the
  same and then leaves ``fit`` with ``preempted`` set; a second SIGTERM
  changes nothing. A boundary whose loss is not finite rolls back and
  skips the save, and the latch waits for the next finite boundary.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..chaos.faults import step_hook as chaos_step_hook
from ..data.device_prefetch import DevicePrefetcher
from ..device import resolve_device, to_device
from ..obs import (DeviceTelemetry, GroupTaps, StallWatchdog, device_memory_headroom,
                   export_chrome_trace, export_spans_jsonl, metrics_snapshot, span,
                   write_textfile)
from ..obs import configure as obs_configure
from ..parallel.comm import (agree, all_gather_dim, all_reduce_, all_reduce_many_,
                             reduce_scatter_many, shard_of, world_group)
from ..parallel.mesh import (AXES, build_mesh, shard_batch, shard_stacked_batch,
                             single_device_mesh)
from .checkpoints import CheckpointManager
from .metrics import ThroughputMeter, count_params, profiled
from .train_state import ShardLayout, cast_floating, compute_dtype, make_optimizer

SNAPSHOT_HEADROOM = 1.15    # "auto" keeps the snapshot on the card below this share of free
_NUMPY = {torch.int64: np.int64, torch.float32: np.float32, torch.bool: np.bool_}


def _copy_tree(tree, device=None):
    """A copy of nested dicts, lists and tuples with every tensor cloned, on
    ``device`` when given, else where it is."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if device is None else t.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v, device) for v in tree)
    return tree


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _crossed(prev: int, cur: int, every: int) -> bool:
    return every > 0 and prev // every != cur // every


def _line(m: Dict[str, Any]) -> str:
    """A metrics record as fit logs it, under the step it belongs to:
    numbers as %.5g, the breach columns (detector and group names) as they
    are."""
    return f"[step {_record_step(m)}] " + " ".join(
        f"{k}={v:.5g}" if isinstance(v, (int, float)) and not isinstance(v, bool)
        else f"{k}={v}" for k, v in m.items() if k not in ("step", "metrics_step"))


def _record_step(m: Dict[str, Any]) -> int:
    return m.get("metrics_step", m["step"])


def _record(m: Dict[str, Any]) -> Dict[str, Any]:
    """A metrics record as a writer takes it: without its step keys."""
    return {k: v for k, v in m.items() if k not in ("step", "metrics_step")}


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _stack(xs):
    """A group's leaves stacked on a new leading axis: tensors with
    ``torch.stack`` (on their device), host arrays with ``np.stack``."""
    if any(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack([torch.as_tensor(x) for x in xs])
    return np.stack(xs)


def stack_batches(batches: Iterable, k: int):
    """The JAX trainers' ``_stack_batches``: (stacked, batch) pairs, full
    groups of ``k`` batches stacked leaf by leaf for ``train_steps``, a
    final short group as single batches for ``train_step``. A group whose
    batches differ in shape also drains as single batches (warned once)."""
    it = iter(batches)
    warned = False
    while True:
        group = list(itertools.islice(it, k))
        if not group:
            return
        homogeneous = all(len(b) == len(group[0]) and all(
            _shape(x) == _shape(group[0][j]) for j, x in enumerate(b)) for b in group)
        if len(group) < k or not homogeneous:
            if not homogeneous and not warned:
                warnings.warn("scan_steps: batch group has mismatched shapes; draining it "
                              "as single steps (a loader with varying batch shapes "
                              "disables the scanned path)")
                warned = True
            for b in group:
                yield False, b
            if len(group) < k:
                return
            continue
        yield True, tuple(_stack(xs) for xs in zip(*group))


class _LossBackward(torch.nn.Module):
    """A loss and its backward in one call. ``functional_call`` swaps the
    cast copies in for the parameters only for the duration of a call; the
    backward recomputes remat'd blocks and loss chunks from the module, so
    it has to run inside the same call to see the same copies.
    ``loss_fn(model, *args, **kw)`` → (loss, dict of auxiliary scalars)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args, **kw):
        loss, aux = self.loss_fn(self.model, *args, **kw)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}


class BaseTrainer:
    """What the trainers share; see the module's docstring. ``extra_meta``
    is merged into every checkpoint's metadata (the DALL·E CLI puts the
    VAE's identity there). ``last_snapshot`` holds the newest rollback
    snapshot's ``mode``, ``bytes`` and ``ms``."""

    model_class = "Model"
    generator: Optional[torch.Generator] = None   # the step's draws, checkpointed
    # the signal latches (see the module's "Signals")
    _signal_save = False
    _preempt = False
    preempted = False
    tokens_per_sample = 0                          # for the logged tokens/s
    flops_per_step = 0.0                           # for the logged MFU
    grad_hook: Optional[Callable[["BaseTrainer"], None]] = None
    # why a trainer cannot train across processes (None: it can)
    single_process_only: Optional[str] = None
    span_name = "train"                            # its spans' prefix ("dalle", ...)

    def __init__(self, train_cfg, device=None, *, backend=None, mesh=None):
        if train_cfg.log_artifacts:
            raise NotImplementedError("log_artifacts uploads to wandb, which is not ported "
                                      "(ROADMAP.md Queue 1 item 12)")
        self.train_cfg = train_cfg
        if mesh is None and backend is not None:
            mesh = backend.mesh
        mc = train_cfg.mesh
        if mc.tp > 1 or (mesh is not None and mesh.shape["tp"] > 1):
            raise NotImplementedError(
                "tp > 1 (Megatron-style heads and feed-forward hidden, with "
                "GEGLUFeedForward's w1 split into matching halves of x and gate) is not "
                "ported: ROADMAP.md Queue 1 item 11c")
        if mesh is None and world_group() is not None:
            mesh = build_mesh(mc)
        elif mesh is None:
            if max(mc.dp, mc.fsdp) > 1:
                raise NotImplementedError(
                    f"dp={mc.dp}, fsdp={mc.fsdp} train across processes: start one "
                    "process a rank (parallel.TorchBackend, or torch's launcher env); "
                    "one process runs only sp (its ranks in this process)")
            mesh = single_device_mesh()
        if mesh.size > 1 and self.single_process_only:
            raise NotImplementedError(self.single_process_only)
        self.backend, self.mesh = backend, mesh
        self.is_root = mesh.rank == 0
        # every rank when it has peers (tp is 1, so (dp, fsdp, sp) is the
        # world), on the wire the step's tensors take
        self._world = mesh.group(*AXES) if mesh.size > 1 else None
        self._shard_dims = None     # fsdp: each parameter's sliced dimension
        if backend is not None:
            backend.check_batch_size(train_cfg.batch_size)
        if device is None:
            device = getattr(backend, "device", None)
        self.device = resolve_device(device)
        self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir,
                                       keep_n=train_cfg.keep_n_checkpoints,
                                       async_save=train_cfg.async_checkpointing)
                     if train_cfg.checkpoint_dir else None)
        self.extra_meta: Dict[str, Any] = {}
        self.step = 0
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self.last_preemptive: Optional[Dict[str, Any]] = None
        self._good = None   # (mode, step, copies of the model and optimizer state)
        self._preemptive = None   # the one-shot rung, as _good
        # (step, device metrics, host metrics, partial breakdown): the latest
        # step's, until read or NaN-checked, and under defer_metrics the
        # parked boundary's
        self._pending = None
        self._deferred = None
        # the step breakdown's state (set by fit; a dispatch start of None
        # is a bare train_step, which gets no breakdown)
        self._obs_dispatch_t0 = None
        self._obs_last_wait = 0.0
        self._obs_last_h2d = 0.0
        self._obs_last_ckpt = 0.0
        self._obs_wait_accum = 0.0
        self._obs_window_t0 = None
        self._obs_poll_bucket = -1
        self._telemetry = None
        self.meter: Optional[ThroughputMeter] = None
        self.last_watchdog: Optional[StallWatchdog] = None
        self.last_profile: Optional[str] = None
        self.health_sentry = None     # built by fit (or BreachActions) under obs.health
        self._health_last_step = -1
        self._taps: Optional[GroupTaps] = None
        self._saved_step: Optional[int] = None   # the newest step this run made durable

    def _setup_training(self, loss_fn: Callable, health_prefix: str = ""):
        """After ``self.model`` is built: the optimizer over its parameters,
        the compute dtype, the loss (see ``_LossBackward``), the counts and,
        under ``obs.health``, the group taps (groups namespaced by
        ``health_prefix``)."""
        self.names = [n for n, _ in self.model.named_parameters()]
        self._loss_backward = _LossBackward(self.model, loss_fn)
        params = list(self.model.parameters())
        self.num_params = count_params(self.model)
        shards = self._shard_masters(params) if self.mesh.shape["fsdp"] > 1 else None
        self.optimizer = make_optimizer(self.train_cfg.optim, params,
                                        lr_scale=self.train_cfg.runtime_lr_scale,
                                        health=self.health, shards=shards)
        if self.health:
            self._taps = GroupTaps(self.model, self.names, params,
                                   self.train_cfg.obs.health_group_depth, health_prefix)
        self.dtype = compute_dtype(self.train_cfg.precision)

    def _shard_masters(self, params) -> ShardLayout:
        """fsdp: keep this rank's slice of every master the rules split
        (``parallel/partition.py``) → the optimizer's ``ShardLayout``."""
        from ..parallel.partition import make_param_shardings
        mesh = self.mesh
        parts, index = mesh.shape["fsdp"], mesh.coords["fsdp"]
        dims = make_param_shardings(mesh, self.model)
        self._shard_dims = [dims[n] for n in self.names]
        by_id = {id(p): d for p, d in zip(params, self._shard_dims)}
        # every name a sliced tensor goes by in state_dict (shared layers too)
        self._shard_keys = {n: by_id[id(p)] for n, p in
                            self.model.named_parameters(remove_duplicate=False)
                            if by_id.get(id(p)) is not None}
        with torch.no_grad():
            for p, d in zip(params, self._shard_dims):
                if d is not None:
                    p.data = shard_of(p.data, d, index, parts).clone()
        return ShardLayout(self._shard_dims, mesh.group("fsdp"), parts)

    @property
    def health(self) -> bool:
        return bool(self.train_cfg.obs.health)

    def _health_columns(self) -> Dict[str, torch.Tensor]:
        """The last step's ``health/*`` tree columns (device scalars); {}
        with health off."""
        if self._taps is None:
            return {}
        return self._taps.columns(self.optimizer.taps)

    def set_lr_scale(self, value: float):
        """The runtime learning-rate scale (``runtime_lr_scale``): multiplies
        every later update; checkpointed and rolled back with the optimizer."""
        self.optimizer.set_lr_scale(value)

    def _backward(self, *args, **kw):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached. Across
        processes the gradients and the returned values are the global
        ones (the module's "Across processes")."""
        if self._shard_dims is not None:
            loss, aux = self._backward_fsdp(args, kw)
        else:
            if self.dtype is None:
                loss, aux = self._loss_backward(*args, **kw)
            else:
                params = cast_floating(dict(self._loss_backward.named_parameters()),
                                       self.dtype)
                loss, aux = functional_call(self._loss_backward, params, args, kw)
            if self._world is not None:
                self._sync_grads(list(self.model.parameters()))
        if self._world is None:
            return loss, aux
        return self._global_values(loss, aux)

    def _data_scale(self) -> float:
        return 1.0 / self.mesh.count("dp", "fsdp")

    def _sync_grads(self, params):
        """dp (and sp): every parameter's gradient summed over the ranks and
        scaled by 1/(dp·fsdp), in flat buckets; a missing one is zero."""
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        all_reduce_many_(grads, self._world)
        if self._data_scale() != 1.0:
            torch._foreach_mul_(grads, self._data_scale())

    def _global_values(self, loss, aux):
        """The loss and the auxiliary scalars summed over the ranks and
        scaled as the gradients: the global batch's (under sp each rank
        returns its share of the sequence's)."""
        keys = list(aux)
        vals = torch.stack([loss.float()] + [aux[k].float() for k in keys])
        all_reduce_(vals, self._world)
        vals.mul_(self._data_scale())
        return vals[0].to(loss.dtype), {k: vals[i + 1].to(aux[k].dtype)
                                        for i, k in enumerate(keys)}

    def _backward_fsdp(self, args, kw):
        """fsdp: all-gather every sliced master's compute-dtype copy, run
        the loss and backward on the whole copies, then reduce their
        gradients in f32: a sliced master's reduce-scattered over the fsdp
        ranks into this rank's slice, then summed over the ranks that hold
        the same slice; a whole master's summed over every rank."""
        group = self.mesh.group("fsdp")
        leaves = {}
        for (name, p), d in zip(self._loss_backward.named_parameters(), self._shard_dims):
            x = p.detach()
            if self.dtype is not None and x.is_floating_point():
                x = x.to(self.dtype)
            if d is not None:
                x = all_gather_dim(x, d, group)
            leaves[name] = x.requires_grad_(p.requires_grad)
        loss, aux = functional_call(self._loss_backward, leaves, args, kw)
        grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in leaves.values()]
        del leaves
        dims = self._shard_dims
        sliced = [i for i, d in enumerate(dims) if d is not None]
        whole = [i for i, d in enumerate(dims) if d is None]
        mine = reduce_scatter_many([grads[i] for i in sliced], [dims[i] for i in sliced],
                                   self.mesh.group("fsdp"), torch.float32)
        all_reduce_many_(mine, self.mesh.group("dp", "sp", "tp"))
        rest = [grads[i].float() for i in whole]
        del grads
        all_reduce_many_(rest, self._world)
        params = list(self.model.parameters())
        for i, g in zip(sliced + whole, mine + rest):
            params[i].grad = g.mul_(self._data_scale())
        return loss, aux

    @contextlib.contextmanager
    def full_params(self):
        """fsdp: the whole masters in the model for the scope (a sample, an
        export), this rank's slices again after; collective. Nothing to do
        otherwise."""
        if self._shard_dims is None:
            yield self.model
            return
        group = self.mesh.group("fsdp")
        params = list(self.model.parameters())
        slices = [p.data for p in params]
        with torch.no_grad():
            for p, d in zip(params, self._shard_dims):
                if d is not None:
                    p.data = all_gather_dim(p.data, d, group)
        try:
            yield self.model
        finally:
            for p, x in zip(params, slices):
                p.data = x

    def _optimize(self, *args, **kw):
        """One optimizer step: the loss and its backward (``_backward``'s
        arguments), then the optimizer's chain, fed the loss; the step
        counter moves on. → (loss, aux, grad_norm before clipping), on the
        device."""
        self.optimizer.zero_grad()
        loss, aux = self._backward(*args, **kw)
        if self.grad_hook is not None:
            self.grad_hook(self)
        grad_norm = self.optimizer.step(loss)
        self.step += 1
        return loss, aux, grad_norm

    # -- batches -------------------------------------------------------------
    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        """One batch leaf as ``dtype`` on the device: a host array or tensor
        through pinned memory without blocking (``device.to_device``), a
        device tensor with ``.to``."""
        if not isinstance(x, torch.Tensor):
            return to_device(np.asarray(x, _NUMPY[dtype]), self.device)
        if x.device.type == "cpu" and self.device.type == "cuda":
            return x.to(dtype).pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device, dtype, non_blocking=True)

    def _to_images(self, images) -> torch.Tensor:
        """(b, H, W, C) images, a tensor or a host array, as f32 on the device."""
        return self._to_device(images, torch.float32)

    def _to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dtype is None else x.to(self.dtype)

    def _put_batch(self, batch, stacked: bool = False):
        """This rank's rows of a batch as ``train_step`` (or, ``stacked``,
        ``train_steps``) takes it → as the step takes them, on the
        device."""
        return batch

    def _place(self, batch, stacked: bool = False):
        """A global batch → this rank's rows (``mesh.shard_batch``; the
        whole batch on one process) through ``_put_batch``, in the
        trainer's ``<span_name>/shard_batch`` span. ``train_step`` and
        ``train_steps`` call it once; fit's prefetcher calls it ahead of
        the step and hands the placed batch to ``_step_placed``."""
        batch = tuple(batch)
        with span(f"{self.span_name}/shard_batch", **({"k": len(batch[0])} if stacked else {})):
            if self.mesh.count("dp", "fsdp") > 1:
                batch = (shard_stacked_batch if stacked else shard_batch)(self.mesh, batch)
            return self._put_batch(batch, stacked)

    # -- metrics -------------------------------------------------------------
    def _finish_step(self, values: Dict[str, torch.Tensor],
                     host: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The metrics of the step just taken (device scalars ``values`` and
        host numbers ``host``) → host floats with ``step``, or ``{}``
        between boundaries; see the module's docstring."""
        tc = self.train_cfg
        host = host or {}
        self._pending = (self.step, values, host, None)
        if self.step % max(tc.metrics_every, 1):
            return {}
        self._pending = entry = (self.step, values, host,
                                 self._partial_breakdown(time.perf_counter()))
        if tc.defer_metrics:
            entry, self._deferred = self._deferred, self._pending
            if entry is None:
                return {}
        else:
            self._pending = None
        return self._read(entry)

    def _read(self, entry, **span_args) -> Dict[str, Any]:
        """An entry's metrics on the host (the one synchronisation), with the
        throughput report, the step breakdown when it has one, and the
        health sentry's breach columns."""
        step, values, host, part = entry
        sync0 = time.perf_counter()
        with span("fit/sync", **span_args):
            nums = torch.stack([v.detach().float() for v in values.values()]).tolist()
        now = time.perf_counter()
        out: Dict[str, Any] = dict(zip(values, nums))
        out.update(host)
        if self.meter is None:
            self.meter = self._new_meter()
        rep = self.meter.step(self.step)
        if rep:
            out.update(rep)
        if part is not None:
            out.update(self._finish_breakdown(dict(part, t_sync_s=now - sync0), now))
        out["step"] = self.step
        if step != self.step:
            out["metrics_step"] = step
        return self._health_observe(step, out)

    def _new_meter(self) -> ThroughputMeter:
        tc = self.train_cfg
        return ThroughputMeter(tc.batch_size, max(tc.log_every, 1),
                               tokens_per_sample=self.tokens_per_sample,
                               flops_per_step=self.flops_per_step, device=self.device)

    def _health_observe(self, step: int, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Run the health sentry over one record read, once per step (every
        path that reads a record comes here). Adds the breach columns."""
        sentry = self.health_sentry
        if sentry is None or not metrics or step == self._health_last_step:
            return metrics
        self._health_last_step = step
        sentry.observe(step, metrics)
        return metrics

    # -- the step breakdown -------------------------------------------------
    def _partial_breakdown(self, dispatch_end: float) -> Optional[Dict[str, float]]:
        """The splits known when the step's dispatch ends: the batch wait,
        the dispatch, the prefetcher's host time for the batch, and the
        previous save's cost. None outside fit."""
        t0 = self._obs_dispatch_t0
        if t0 is None:
            return None
        out = {"t_batch_wait_s": self._obs_last_wait, "t_dispatch_s": dispatch_end - t0,
               "t_h2d_s": self._obs_last_h2d}
        if self._obs_last_ckpt:
            out["t_ckpt_s"] = self._obs_last_ckpt
            self._obs_last_ckpt = 0.0
        return out

    def _finish_breakdown(self, out: Dict[str, float], now: float) -> Dict[str, float]:
        """The starvation ratio over the window since the last record, the
        device gauges every ``device_poll_every`` steps and the Prometheus
        mirror, merged into ``out``."""
        if self._obs_window_t0 is not None and now > self._obs_window_t0:
            out["data_starvation"] = min(self._obs_wait_accum / (now - self._obs_window_t0), 1.0)
        self._obs_window_t0 = now
        self._obs_wait_accum = 0.0
        oc = self.train_cfg.obs
        if oc.device_poll_every > 0:
            bucket = self.step // oc.device_poll_every
            if bucket != self._obs_poll_bucket:
                self._obs_poll_bucket = bucket
                if self._telemetry is None:
                    self._telemetry = DeviceTelemetry(self.device)
                out.update(self._telemetry.poll(self.step))
                if oc.prometheus_path:
                    write_textfile(oc.prometheus_path,
                                   {**out, **metrics_snapshot(), "host_step": self.step})
        return out

    def fetch_metrics(self) -> Dict[str, Any]:
        """Read the latest step's metrics now (one synchronisation), if no
        read has covered them: a save needs them NaN-checked, and a caller
        of ``train_steps`` under ``metrics_every`` > 1 may want them; {}
        otherwise."""
        if self._pending is None:
            return {}
        entry, self._pending = self._pending, None
        if self._deferred is not None and self._deferred[0] == entry[0]:
            self._deferred = None
        return self._read(entry, on_demand=True)

    # -- checkpoints -------------------------------------------------------
    def _meta(self) -> Dict[str, Any]:
        return {"hparams": self.model_cfg.to_dict(), "train": self.train_cfg.to_dict(),
                "model_class": self.model_class, **self.extra_meta}

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the masters, the optimizer's state (its
        count inside), the step, and the generator's state where there is
        one."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self._shard_dims is not None:
            state = self._resliced(state, lambda t, d: all_gather_dim(
                t, d, self.mesh.group("fsdp")))
        if self.generator is not None:
            state["generator"] = self.generator.get_state()
        return state

    def _resliced(self, state, fn):
        """``state`` (the model's and the optimizer's) with ``fn(tensor,
        dim)`` applied to every fsdp-sliced tensor: a new tree, the live
        lists untouched."""
        out = dict(state, model=self._resliced_model(state["model"], fn))
        if "optimizer" in state:
            out["optimizer"] = self._resliced_optimizer(state["optimizer"], fn)
        return out

    def _resliced_model(self, sd, fn):
        return {k: (fn(v, self._shard_keys[k]) if k in self._shard_keys else v)
                for k, v in sd.items()}

    def _resliced_optimizer(self, osd, fn):
        if "core" not in osd:      # a torch.optim state dict
            raise ValueError("fsdp restores the port optimizer's own state only")
        osd = dict(osd)
        dims = self.optimizer.state_dims()
        osd["core"] = {k: [v if v is None or d is None else fn(v, d)
                           for v, d in zip(vs, dims["core"][k])]
                       for k, vs in osd["core"].items()}
        if osd.get("acc") is not None:
            osd["acc"] = [v if d is None else fn(v, d) for v, d in zip(osd["acc"], dims["acc"])]
        return osd

    def _cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's fsdp slice of a whole tensor."""
        return shard_of(t, dim, self.mesh.coords["fsdp"], self.mesh.shape["fsdp"])

    def load_masters(self, sd: Mapping[str, torch.Tensor]):
        """Copy whole masters (a ``state_dict``) into the model: under fsdp
        this rank's slices."""
        if self._shard_dims is not None:
            sd = self._resliced_model(sd, self._cut)
        with torch.no_grad():
            self.model.load_state_dict(sd)

    def load_state_dict(self, state: Mapping[str, Any]):
        if self._shard_dims is not None:
            state = self._resliced(state, self._cut)
        with torch.no_grad():
            self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"], count=state.get("count"))
        self.step = int(state.get("step", self.optimizer.count))
        self._pending = self._deferred = None
        if self.generator is not None:
            self.generator.set_state(state["generator"].cpu())

    def save(self, wait: bool = True):
        """Checkpoint the current step (needs ``checkpoint_dir``). With
        ``wait`` (the default) the checkpoint is on disk when this returns;
        ``fit``'s periodic saves pass False and leave the write in flight.
        Across processes every rank calls it (the gather is collective) and
        rank 0 writes."""
        state = self.state_dict()
        if self.is_root:
            self.ckpt.save(self.step, state, self._meta(), wait=wait)
        self._saved_step = self.step

    def _ckpt_wait(self):
        """Drain the checkpoint write in flight, if any."""
        if self.ckpt is not None:
            with span("ckpt/drain"):
                self.ckpt.wait_until_finished()

    def install_signal_checkpoint(self, log=print):
        """SIGUSR1 → a drained checkpoint at the next step boundary (taming's
        "melk" handler): the handler only sets a flag, and the save happens
        between steps, where the state is whole. Call from the main thread."""
        def handler(_sig, _frame):
            self._signal_save = True
            log("SIGUSR1: will checkpoint at the next step boundary")

        self._signal_save = False
        signal.signal(signal.SIGUSR1, handler)

    def install_preemption_handler(self, log=print):
        """SIGTERM → graceful preemption: ``fit`` finishes the step in
        flight, saves through the SIGUSR1 latch (drained) and returns with
        ``preempted`` set, so the entry point exits 0 with the state on
        disk. A second SIGTERM during the wind-down changes nothing. Call
        from the main thread; calling again re-arms."""
        def handler(_sig, _frame):
            self._signal_save = True
            self._preempt = True
            log("SIGTERM: graceful preemption: will checkpoint at the next step "
                "boundary and exit")

        self._preempt = False
        self.preempted = False
        signal.signal(signal.SIGTERM, handler)

    def restore(self, step: Optional[int] = None):
        """Resume from the checkpoint directory: ``step``, or the newest that
        loads. Returns its metadata."""
        if self.ckpt is None:
            raise ValueError("restore needs train_cfg.checkpoint_dir")
        state, meta = self.ckpt.restore(
            step, map_location="cpu" if self._shard_dims is not None else self.device)
        self.load_state_dict(state)
        return meta

    # -- NaN rollback --------------------------------------------------------
    def _snapshot_mode(self, nbytes: int) -> str:
        mode = self.train_cfg.rollback_snapshot
        if self.device.type != "cuda":
            return "host"
        if mode == "auto":
            headroom = device_memory_headroom(self.device)
            return "device" if nbytes * SNAPSHOT_HEADROOM < headroom else "host"
        return mode

    def _take_snapshot(self, name: str):
        """(mode, step, copies) of the masters and the optimizer state (and
        count), timed into a ``name`` span; → (snapshot, its mode/bytes/ms)."""
        live = self._rollback_state()
        nbytes = _tree_bytes(live)
        mode = self._snapshot_mode(nbytes)
        t0 = time.perf_counter()
        with span(name, mode=mode):
            copies = _copy_tree(live, None if mode == "device" else "cpu")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return (mode, self.step, copies), {"mode": mode, "bytes": nbytes,
                                           "ms": (time.perf_counter() - t0) * 1e3}

    def _snapshot_good(self):
        """Keep a copy of the masters and the optimizer state (and count). A
        fresh snapshot supersedes a parked preemptive rung, which is older."""
        self._good = self._preemptive = None   # freed first: "auto" gauges without them
        self._good, self.last_snapshot = self._take_snapshot("ckpt/snapshot_good")

    def take_preemptive_snapshot(self):
        """Copy the current state into a one-shot rung above the save's
        snapshot (the nan-precursor breach action, ``train/actions.py``):
        the next rollback restores it and consumes it, so a rollback loses
        the steps since the breach rather than since the save; a rollback
        after that falls through to the save's snapshot. Placed as
        ``_snapshot_good`` places its copy."""
        self._preemptive = None
        self._preemptive, self.last_preemptive = self._take_snapshot("ckpt/preemptive_snapshot")

    def _rollback(self) -> Optional[int]:
        """Put back the preemptive rung (consumed) or else the save's snapshot
        (both loads copy into the live tensors, so the save's snapshot
        outlives another NaN); metrics of the poisoned steps die with them.
        Returns the step whose state was restored (None: no snapshot)."""
        self._pending = self._deferred = None
        with span("ckpt/rollback"):
            if self._preemptive is not None:
                (_mode, step, good), self._preemptive = self._preemptive, None
            elif self._good is not None:
                _mode, step, good = self._good
            else:
                return None
            self._load_rollback_state(good)
        return step

    def _rollback_state(self) -> Dict[str, Any]:
        """What a rollback snapshot copies: the masters and the optimizer's
        state (references to the live tensors)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def _load_rollback_state(self, good: Dict[str, Any]):
        with torch.no_grad():
            self.model.load_state_dict(good["model"])
        self.optimizer.load_state_dict(good["optimizer"])

    # -- the loop ------------------------------------------------------------
    def _batches(self, batches: Iterable):
        """fit's stream of (stacked, batch): grouped by ``scan_steps``,
        through the prefetcher when ``device_prefetch`` > 0 (then returned
        second, for its ``last_put_s``; else None)."""
        tc = self.train_cfg
        if tc.scan_steps > 1:
            items = stack_batches(batches, tc.scan_steps)
        else:
            items = ((False, b) for b in batches)
        if tc.device_prefetch > 0:
            pf = DevicePrefetcher(
                items, lambda item: (item[0], self._place(item[1], stacked=item[0])),
                depth=tc.device_prefetch, device=self.device)
            return pf, pf
        return items, None

    def _obs_dir(self, what: str) -> str:
        if not self.train_cfg.checkpoint_dir:
            raise ValueError(f"{what} needs train_cfg.checkpoint_dir (or obs.trace_dir "
                             "for the trace)")
        return self.train_cfg.checkpoint_dir

    def fit(self, batches: Iterable, *, steps: Optional[int] = None, log=print,
            sample_fn: Optional[Callable[[int], Any]] = None, metrics_writer=None,
            on_step: Optional[Callable[[int], Any]] = None):
        """Train on ``batches`` until the step reaches ``steps`` (a resumed
        run continues from its step): a batch at a time through
        ``train_step``, or k at a time through ``train_steps`` with
        ``scan_steps`` = k. Logs at every ``train_cfg.log_every`` boundary
        that has metrics, hands every record read to ``metrics_writer``
        (``.log(step, record)``, e.g. a ``MetricsLogger``), calls
        ``sample_fn(step)`` every ``sample_every_steps``, checkpoints, rolls
        back and records its telemetry as the module's docstring says. With
        device prefetch the lookahead takes up to ``device_prefetch``
        batches more from ``batches`` than the steps use. ``on_step(step)``
        runs after each completed step (the elastic worker's heartbeat; what
        it raises leaves fit). Across processes only rank 0 logs and writes
        records, and ``sample_fn`` runs on every rank with the whole masters
        (``full_params``). Returns the last finite metrics read."""
        tc = self.train_cfg
        if not self.is_root:
            log, metrics_writer = (lambda *a, **k: None), None
        oc = tc.obs
        trace_dir = None
        if oc.trace:
            trace_dir = oc.trace_dir or os.path.join(self._obs_dir("obs.trace"), "obs")
            obs_configure(oc.ring_capacity)
        if tc.profile_step:
            self._obs_dir("profile_step")
        watchdog = None
        if oc.watchdog_deadline_s > 0:
            watchdog = self.last_watchdog = StallWatchdog(
                oc.watchdog_deadline_s, log=log, dump_stacks=oc.watchdog_dump_stacks).start()
        if oc.health and self.health_sentry is None:
            # kept across fit calls, so the baselines survive a resume
            from ..obs.anomaly import HealthSentry
            self.health_sentry = HealthSentry.from_obs_config(oc)
        if self.ckpt is not None:
            self._saved_step = self.ckpt.latest_step()
            if tc.preflight_checkpoint:
                state = self.state_dict()
                if self.is_root:
                    self.ckpt.preflight(self.step, state, self._meta())
                self._saved_step = self.step
        if tc.nan_rollback:
            self._snapshot_good()
        self.meter = self._new_meter()
        metrics: Dict[str, Any] = {}
        items, prefetcher = self._batches(batches)
        it = iter(items)
        self._obs_wait_accum = 0.0
        self._obs_window_t0 = time.perf_counter()
        end = object()
        try:
            while True:
                with span("fit/step") as step_span:
                    t_wait0 = time.perf_counter()
                    with span("fit/batch_wait"):
                        item = next(it, end)
                    if item is end or (steps is not None and self.step >= steps):
                        break
                    self._obs_last_wait = time.perf_counter() - t_wait0
                    self._obs_wait_accum += self._obs_last_wait
                    self._obs_last_h2d = prefetcher.last_put_s if prefetcher is not None else 0.0
                    stacked, batch = item
                    prev = self.step
                    step_span.set(step=prev)
                    # chaos injection point: kill/hang/slow/corrupt faults fire
                    # here, before the dispatch, as in the JAX package's fit
                    chaos_step_hook(prev)
                    m = self._dispatch(stacked, batch, log, placed=prefetcher is not None)
                    if watchdog is not None:
                        watchdog.beat(self.step)
                    if on_step is not None:
                        on_step(self.step)
                    metrics = self._after_step(prev, m, metrics, log, metrics_writer, sample_fn)
                if self.preempted:
                    break
            metrics = self._fit_end(metrics, log, metrics_writer)
        finally:
            self._obs_dispatch_t0 = None   # a bare train_step gets no breakdown
            # a fit that returned leaves its checkpoints durable
            self._ckpt_wait()
            if watchdog is not None:
                watchdog.stop()
            if trace_dir is not None:
                os.makedirs(trace_dir, exist_ok=True)
                export_chrome_trace(os.path.join(trace_dir, "trace.json"))
                export_spans_jsonl(os.path.join(trace_dir, "spans.jsonl"))
        return metrics

    def _fit_end(self, metrics: Dict[str, Any], log, metrics_writer) -> Dict[str, Any]:
        """The end of fit: log a parked record older than the last step, then
        read and NaN-check the last step's before it is saved."""
        if self._deferred is not None and (self._pending is None
                                           or self._deferred[0] != self._pending[0]):
            m = self._read(self._deferred, flush=True)
            self._deferred = None
            log(_line(m))
            if metrics_writer is not None:
                metrics_writer.log(_record_step(m), _record(m))
        m = self.fetch_metrics()
        if not self._rolled_back(m, log) and m:
            metrics = m
            if metrics_writer is not None:
                metrics_writer.log(_record_step(m), _record(m))
        if self.ckpt is not None and self._saved_step != self.step:
            self._save_timed()
        return metrics

    def _dispatch(self, stacked: bool, batch, log, placed: bool) -> Dict[str, Any]:
        """One ``train_step`` (or ``train_steps`` on a stacked group; the
        prefetcher's ``placed`` batch straight to ``_step_placed`` /
        ``_steps_placed``) in a ``fit/dispatch`` span; under
        ``torch.profiler`` when the call holds ``profile_step``."""
        tc = self.train_cfg
        if placed:
            call = functools.partial(self._steps_placed if stacked else self._step_placed,
                                     batch)
        else:
            call = functools.partial(self.train_steps if stacked else self.train_step,
                                     *batch)
        k = len(batch[0]) if stacked else 1
        prev = self.step
        self._obs_dispatch_t0 = time.perf_counter()
        if tc.profile_step and prev < tc.profile_step <= prev + k:
            # the real step that contains profile_step: no extra update
            logdir = os.path.join(tc.checkpoint_dir, f"profile_step{tc.profile_step}")
            with profiled(logdir):
                with span("fit/dispatch", profiled=True):
                    m = call()
            self.last_profile = logdir
            log(f"[profile] step {self.step}: trace → {logdir}")
            return m
        with span("fit/dispatch"):
            return call()

    def _after_step(self, prev: int, m: Dict[str, Any], metrics: Dict[str, Any], log,
                    metrics_writer, sample_fn) -> Dict[str, Any]:
        """A step's events in fit: the save's NaN check, rollback, log and
        writer, save and sample. Returns the latest finite metrics."""
        tc = self.train_cfg
        if self._world is not None:
            # ranks that caught a signal at different steps act together;
            # over the default group, which the backend makes on the host
            # (gloo), so the exchange waits for no kernel
            self._signal_save, self._preempt = agree([self._signal_save, self._preempt],
                                                     world_group())
        # the latch is read once: the save and the metrics read see one value
        signal_save = self._signal_save
        want_save = self.ckpt is not None and (
            signal_save or _crossed(prev, self.step, tc.save_every_steps))
        if want_save and m.get("metrics_step", self.step) != self.step:
            # a deferred record is older than the state to be saved: log it,
            # then read the current step's for the save's NaN check
            log(_line(m))
            if metrics_writer is not None:
                metrics_writer.log(_record_step(m), _record(m))
            m = {}
        if want_save and not m:
            m = self.fetch_metrics()
        if self._rolled_back(m, log):
            return metrics
        if m:
            metrics = m
            if _crossed(prev, self.step, max(tc.log_every, 1)):
                log(_line(m))
            if metrics_writer is not None:
                metrics_writer.log(_record_step(m), _record(m))
        if want_save:
            self._save_timed(wait=signal_save)
            if signal_save:
                self._signal_save = False
            if tc.nan_rollback:
                self._snapshot_good()
        if self._preempt and (want_save or self.ckpt is None):
            # the save above was drained: the state is durable, so leave fit
            self.preempted = True
            self._preempt = False
            log(f"[step {self.step}] graceful preemption: checkpoint durable; exiting fit")
        if sample_fn is not None and _crossed(prev, self.step, tc.sample_every_steps):
            with self.full_params():
                sample_fn(self.step)
        return metrics

    def _save_timed(self, wait: bool = False):
        """``save`` in a ``fit/checkpoint`` span; its seconds go into the
        next record's ``t_ckpt_s``."""
        t0 = time.perf_counter()
        with span("fit/checkpoint", step=self.step):
            self.save(wait=wait)
        self._obs_last_ckpt = time.perf_counter() - t0

    def _rolled_back(self, m: Dict[str, Any], log) -> bool:
        """Roll back when the metrics ``m`` read a loss that is not finite."""
        if not (m and self.train_cfg.nan_rollback and not math.isfinite(m["loss"])):
            return False
        step = self._rollback()
        log(f"[step {_record_step(m)}] non-finite loss: rolled back to the state of "
            f"step {step}")
        return True
