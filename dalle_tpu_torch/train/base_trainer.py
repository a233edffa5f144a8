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
it, so the two give the same bits); both end in ``_finish_step``.

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
  ``depth`` batches already on the card (``data/device_prefetch.py``,
  through ``_put_batch``).
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
  ``restore`` brings back the masters, the optimizer's state (moments,
  counts, accumulator, plateau state, runtime lr scale), the step and the
  trainer's generator. The metadata carries the model's identity
  (``_meta``) and ``extra_meta``. A checkpoint written before the port's
  own optimizer (a ``torch.optim`` state dict beside ``count``) restores.
* **Chaos** (``chaos.step_hook``): ``fit`` calls it with the step before
  each dispatch, where the JAX package's fit does, so an installed
  ``FaultPlan`` kills, hangs, slows or corrupts there.

Not ported yet (``ROADMAP.md`` Queue 1 items 3 and 12): asynchronous
checkpoint writes, the preemptive snapshot rung
(``take_preemptive_snapshot``), the signal and preemption handlers, and the
obs and health taps.
"""

from __future__ import annotations

import itertools
import math
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..chaos.faults import step_hook as chaos_step_hook
from ..data.device_prefetch import DevicePrefetcher
from ..device import resolve_device, to_device
from .checkpoints import CheckpointManager
from .metrics import count_params
from .train_state import cast_floating, compute_dtype, make_optimizer

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
    """A metrics record as fit logs it, under the step it belongs to."""
    return f"[step {m.get('metrics_step', m['step'])}] " + " ".join(
        f"{k}={v:.5g}" for k, v in m.items() if k not in ("step", "metrics_step"))


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
        self._good = None   # (mode, step, copies of the model and optimizer state)
        # (step, device metrics, host metrics): the latest step's, until read
        # or NaN-checked, and under defer_metrics the parked boundary's
        self._pending = None
        self._deferred = None

    def _setup_training(self, loss_fn: Callable):
        """After ``self.model`` is built: the optimizer over its parameters,
        the compute dtype, the loss (see ``_LossBackward``) and the counts."""
        self.names = [n for n, _ in self.model.named_parameters()]
        self._loss_backward = _LossBackward(self.model, loss_fn)
        self.optimizer = make_optimizer(self.train_cfg.optim, list(self.model.parameters()),
                                        lr_scale=self.train_cfg.runtime_lr_scale)
        self.dtype = compute_dtype(self.train_cfg.precision)
        self.num_params = count_params(self.model)

    def set_lr_scale(self, value: float):
        """The runtime learning-rate scale (``runtime_lr_scale``): multiplies
        every later update; checkpointed and rolled back with the optimizer."""
        self.optimizer.set_lr_scale(value)

    def _backward(self, *args, **kw):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached."""
        if self.dtype is None:
            return self._loss_backward(*args, **kw)
        params = cast_floating(dict(self._loss_backward.named_parameters()), self.dtype)
        return functional_call(self._loss_backward, params, args, kw)

    def _optimize(self, *args, **kw):
        """One optimizer step: the loss and its backward (``_backward``'s
        arguments), then the optimizer's chain, fed the loss; the step
        counter moves on. → (loss, aux, grad_norm before clipping), on the
        device."""
        self.optimizer.zero_grad()
        loss, aux = self._backward(*args, **kw)
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
        """A batch as ``train_step`` (or, ``stacked``, ``train_steps``) takes
        it, on the device: what the step does to it first. The prefetcher
        calls it ahead of the step."""
        return batch

    # -- metrics -------------------------------------------------------------
    def _finish_step(self, values: Dict[str, torch.Tensor],
                     host: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The metrics of the step just taken (device scalars ``values`` and
        host numbers ``host``) → host floats with ``step``, or ``{}``
        between boundaries; see the module's docstring."""
        tc = self.train_cfg
        self._pending = (self.step, values, host or {})
        if self.step % max(tc.metrics_every, 1):
            return {}
        entry = self._pending
        if tc.defer_metrics:
            entry, self._deferred = self._deferred, self._pending
            if entry is None:
                return {}
        else:
            self._pending = None
        return self._read(entry)

    def _read(self, entry) -> Dict[str, Any]:
        step, values, host = entry
        nums = torch.stack([v.detach().float() for v in values.values()]).tolist()
        out: Dict[str, Any] = dict(zip(values, nums))
        out.update(host)
        out["step"] = self.step
        if step != self.step:
            out["metrics_step"] = step
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
        return self._read(entry)

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
        if self.generator is not None:
            state["generator"] = self.generator.get_state()
        return state

    def load_state_dict(self, state: Mapping[str, Any]):
        with torch.no_grad():
            self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"], count=state.get("count"))
        self.step = int(state.get("step", self.optimizer.count))
        self._pending = self._deferred = None
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
        live = self._rollback_state()
        nbytes = _tree_bytes(live)
        mode = self._snapshot_mode(nbytes)
        t0 = time.perf_counter()
        copies = _copy_tree(live, None if mode == "device" else "cpu")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._good = (mode, self.step, copies)
        self.last_snapshot = {"mode": mode, "bytes": nbytes,
                              "ms": (time.perf_counter() - t0) * 1e3}

    def _rollback(self):
        """Put the snapshot back (both loads copy into the live tensors, so
        the snapshot outlives another NaN); metrics of the poisoned steps
        die with them."""
        _mode, _step, good = self._good
        self._load_rollback_state(good)
        self._pending = self._deferred = None

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
        through the prefetcher when ``device_prefetch`` > 0."""
        tc = self.train_cfg
        if tc.scan_steps > 1:
            items = stack_batches(batches, tc.scan_steps)
        else:
            items = ((False, b) for b in batches)
        if tc.device_prefetch > 0:
            items = DevicePrefetcher(
                items, lambda item: (item[0], self._put_batch(item[1], stacked=item[0])),
                depth=tc.device_prefetch, device=self.device)
        return items

    def fit(self, batches: Iterable, *, steps: Optional[int] = None, log=print,
            sample_fn: Optional[Callable[[int], Any]] = None):
        """Train on ``batches`` until the step reaches ``steps`` (a resumed
        run continues from its step): a batch at a time through
        ``train_step``, or k at a time through ``train_steps`` with
        ``scan_steps`` = k. Logs at every ``train_cfg.log_every`` boundary
        that has metrics, with the samples and tokens per second since the
        last log, calls ``sample_fn(step)`` every ``sample_every_steps``,
        checkpoints and rolls back as the module's docstring says. With
        device prefetch the lookahead takes up to ``device_prefetch``
        batches more from ``batches`` than the steps use. Returns the last
        finite metrics read."""
        tc = self.train_cfg
        if self.ckpt is not None and tc.preflight_checkpoint:
            self.ckpt.preflight(self.step, self.state_dict(), self._meta())
        if tc.nan_rollback:
            self._snapshot_good()
        metrics: Dict[str, Any] = {}
        t0, last = time.perf_counter(), self.step
        for stacked, batch in self._batches(batches):
            if steps is not None and self.step >= steps:
                break
            prev = self.step
            # chaos injection point: kill/hang/slow/corrupt faults fire here,
            # before the dispatch, as in the JAX package's fit
            chaos_step_hook(prev)
            m = (self.train_steps if stacked else self.train_step)(*batch)
            want_save = self.ckpt is not None and _crossed(prev, self.step,
                                                          tc.save_every_steps)
            if want_save and m.get("metrics_step", self.step) != self.step:
                # a deferred record is older than the state to be saved: log
                # it, then read the current step's for the save's NaN check
                log(_line(m))
                m = {}
            if want_save and not m:
                m = self.fetch_metrics()
            if self._rolled_back(m, log):
                continue
            if m:
                metrics = m
                if _crossed(prev, self.step, max(tc.log_every, 1)):
                    now = time.perf_counter()
                    b = len(batch[0][0]) if stacked else len(batch[0])
                    sps = b * (self.step - last) / (now - t0)
                    metrics.update(sample_per_sec=sps,
                                   tokens_per_sec=sps * self.tokens_per_sample)
                    t0, last = now, self.step
                    log(_line(metrics))
            if want_save:
                self.save()
                if tc.nan_rollback:
                    self._snapshot_good()
            if sample_fn is not None and _crossed(prev, self.step, tc.sample_every_steps):
                sample_fn(self.step)
        # the end: log a parked record older than the last step, then read
        # and NaN-check the last step's before it is saved
        if self._deferred is not None and (self._pending is None
                                           or self._deferred[0] != self._pending[0]):
            log(_line(self._read(self._deferred)))
            self._deferred = None
        m = self.fetch_metrics()
        if not self._rolled_back(m, log) and m:
            metrics = m
        if self.ckpt is not None and self.ckpt.latest_step() != self.step:
            self.save()
        return metrics

    def _rolled_back(self, m: Dict[str, Any], log) -> bool:
        """Roll back when the metrics ``m`` read a loss that is not finite."""
        if not (m and self.train_cfg.nan_rollback and not math.isfinite(m["loss"])):
            return False
        self._rollback()
        log(f"[step {m.get('metrics_step', m['step'])}] non-finite loss: rolled back to "
            f"the state of step {self._good[1]}")
        return True
