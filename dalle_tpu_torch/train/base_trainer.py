"""The trainers' shared shell: the optimizer step, checkpoints, the fit loop
and NaN rollback.

Port of ``dalle_tpu/train/base_trainer.py`` for the port's three trainers
(``DalleTrainer``, ``VAETrainer``, ``CLIPTrainer``). A subclass builds
``self.model`` (its parameters are the f32 masters), calls
``_setup_training`` with its loss, and defines ``train_step(*batch)`` → a
metrics dict with ``loss`` and ``step``.

* **Two counters.** ``step`` counts the steps taken, NaN steps included:
  it bounds ``fit`` and names checkpoints. ``optimizer.count`` counts the
  updates the optimizer's state holds, and the learning-rate schedule
  reads it. A rollback rewinds the count with that state and leaves the
  step, as the JAX package rewinds ``opt_state`` and not
  ``TrainState.step``. A checkpoint carries both; one without a step (the
  format before this shell) takes its step from the count.
* **NaN rollback** (``train_cfg.nan_rollback``, on by default as in the JAX
  package): ``fit`` snapshots the masters and the optimizer state, its
  count included, at its start and after every save, and puts the snapshot
  back after a step whose loss is not finite. That step's metrics are not
  logged, and no checkpoint is written for it. The snapshot is a copy on
  the card when ``rollback_snapshot`` is "device", or "auto" and
  ``torch.cuda.mem_get_info`` shows free memory for 1.15× its bytes; it is
  in host memory otherwise, and always on the CPU.
* **Checkpoints** (``train/checkpoints.py``, with ``checkpoint_dir``):
  ``fit`` saves before its first step (``preflight_checkpoint``), whenever
  the step crosses a multiple of ``save_every_steps``, and at its end;
  ``restore`` brings back the masters, the optimizer's state and count, the
  step and the trainer's generator. The metadata carries the model's
  identity (``_meta``) and ``extra_meta``.

Not ported yet (``ROADMAP.md`` Queue 1 items 3 and 12): device prefetch,
deferred metrics, scanned multi-steps, the preemptive snapshot rung
(``take_preemptive_snapshot``), the signal and preemption handlers, and the
obs and health taps.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from .checkpoints import CheckpointManager
from .metrics import count_params
from .train_state import cast_floating, compute_dtype, make_optimizer

SNAPSHOT_HEADROOM = 1.15    # "auto" keeps the snapshot on the card below this share of free


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
    tokens_per_sample = 0                          # for the logged tokens/s

    def __init__(self, train_cfg, device=None):
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir,
                                       keep_n=train_cfg.keep_n_checkpoints)
                     if train_cfg.checkpoint_dir else None)
        self.extra_meta: Dict[str, Any] = {}
        self.step = 0
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self._good = None   # (mode, step, count, copies of the model and optimizer state)

    def _setup_training(self, loss_fn: Callable):
        """After ``self.model`` is built: the optimizer over its parameters,
        the compute dtype, the loss (see ``_LossBackward``) and the counts."""
        self.names = [n for n, _ in self.model.named_parameters()]
        self._loss_backward = _LossBackward(self.model, loss_fn)
        self.optimizer = make_optimizer(self.train_cfg.optim, list(self.model.parameters()))
        self.dtype = compute_dtype(self.train_cfg.precision)
        self.num_params = count_params(self.model)

    def _backward(self, *args, **kw):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached."""
        if self.dtype is None:
            return self._loss_backward(*args, **kw)
        params = cast_floating(dict(self._loss_backward.named_parameters()), self.dtype)
        return functional_call(self._loss_backward, params, args, kw)

    def _optimize(self, *args, **kw):
        """One update: the loss and its backward (``_backward``'s
        arguments), clipping and the optimizer's step; the step counter
        moves on. → (loss, aux, grad_norm before clipping), on the device."""
        self.optimizer.zero_grad()
        loss, aux = self._backward(*args, **kw)
        grad_norm = self.optimizer.step()
        self.step += 1
        return loss, aux, grad_norm

    def _to_images(self, images) -> torch.Tensor:
        """(b, H, W, C) images, a tensor or a host array, as f32 on the device."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        return images.to(self.device, torch.float32)

    # -- checkpoints -------------------------------------------------------
    def _meta(self) -> Dict[str, Any]:
        return {"hparams": self.model_cfg.to_dict(), "train": self.train_cfg.to_dict(),
                "model_class": self.model_class, **self.extra_meta}

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the masters, the optimizer's state and
        count, the step, and the generator's state where there is one."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.core.state_dict(),
                 "count": self.optimizer.count, "step": self.step}
        if self.generator is not None:
            state["generator"] = self.generator.get_state()
        return state

    def load_state_dict(self, state: Mapping[str, Any]):
        with torch.no_grad():
            self.model.load_state_dict(state["model"])
        self.optimizer.core.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["count"])
        self.step = int(state.get("step", state["count"]))
        if self.generator is not None:
            self.generator.set_state(state["generator"].cpu())

    def save(self):
        """Checkpoint the current step (needs ``checkpoint_dir``)."""
        self.ckpt.save(self.step, self.state_dict(), self._meta())

    def restore(self, step: Optional[int] = None):
        """Resume from the checkpoint directory: ``step``, or the newest that
        loads. Returns its metadata."""
        if self.ckpt is None:
            raise ValueError("restore needs train_cfg.checkpoint_dir")
        state, meta = self.ckpt.restore(step, map_location=self.device)
        self.load_state_dict(state)
        return meta

    # -- NaN rollback --------------------------------------------------------
    def _snapshot_mode(self, nbytes: int) -> str:
        mode = self.train_cfg.rollback_snapshot
        if self.device.type != "cuda":
            return "host"
        if mode == "auto":
            free, _total = torch.cuda.mem_get_info(self.device)
            return "device" if nbytes * SNAPSHOT_HEADROOM < free else "host"
        return mode

    def _snapshot_good(self):
        """Keep a copy of the masters and the optimizer state (and count)."""
        self._good = None    # freed first: "auto" gauges the memory without it
        live = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.core.state_dict()}
        nbytes = _tree_bytes(live)
        mode = self._snapshot_mode(nbytes)
        t0 = time.perf_counter()
        copies = _copy_tree(live, None if mode == "device" else "cpu")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._good = (mode, self.step, self.optimizer.count, copies)
        self.last_snapshot = {"mode": mode, "bytes": nbytes,
                              "ms": (time.perf_counter() - t0) * 1e3}

    def _rollback(self):
        """Put the snapshot back. The optimizer gets a copy: it updates its
        state in place, and the snapshot must outlive another NaN."""
        _mode, _step, count, good = self._good
        with torch.no_grad():
            self.model.load_state_dict(good["model"])
        self.optimizer.core.load_state_dict(_copy_tree(good["optimizer"]))
        self.optimizer.count = count

    # -- the loop ------------------------------------------------------------
    def fit(self, batches: Iterable, *, steps: Optional[int] = None, log=print,
            sample_fn: Optional[Callable[[int], Any]] = None):
        """Call ``train_step(*batch)`` for each batch until the step reaches
        ``steps`` (a resumed run continues from its step). Logs every
        ``train_cfg.log_every`` steps with the samples and tokens per second
        since the last log, calls ``sample_fn(step)`` every
        ``sample_every_steps``, checkpoints and rolls back as the module's
        docstring says. Returns the last finite step's metrics."""
        tc = self.train_cfg
        if self.ckpt is not None and tc.preflight_checkpoint:
            self.ckpt.preflight(self.step, self.state_dict(), self._meta())
        if tc.nan_rollback:
            self._snapshot_good()
        metrics: Dict[str, Any] = {}
        t0, last = time.perf_counter(), self.step
        for batch in batches:
            if steps is not None and self.step >= steps:
                break
            prev = self.step
            m = self.train_step(*batch)
            if tc.nan_rollback and not math.isfinite(m["loss"]):
                self._rollback()
                log(f"[step {self.step}] non-finite loss: rolled back to the state "
                    f"of step {self._good[1]}")
                continue
            metrics = m
            if _crossed(prev, self.step, max(tc.log_every, 1)):
                now = time.perf_counter()
                sps = len(batch[0]) * (self.step - last) / (now - t0)
                metrics.update(sample_per_sec=sps, tokens_per_sec=sps * self.tokens_per_sample)
                t0, last = now, self.step
                log(f"[step {self.step}] " + " ".join(
                    f"{k}={v:.5g}" for k, v in metrics.items() if k != "step"))
            if self.ckpt is not None and _crossed(prev, self.step, tc.save_every_steps):
                self.save()
                if tc.nan_rollback:
                    self._snapshot_good()
            if sample_fn is not None and _crossed(prev, self.step, tc.sample_every_steps):
                sample_fn(self.step)
        if self.ckpt is not None and self.ckpt.latest_step() != self.step:
            self.save()
        return metrics
