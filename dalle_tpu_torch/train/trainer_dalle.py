"""DALL·E trainer: one training step on the card, and a loop around it.

Port of ``dalle_tpu/train/trainer_dalle.py`` (``_make_dalle_loss_fn``,
``_dalle_step_body``, ``DalleTrainer``) and the core of
``base_trainer.BaseTrainer.fit``. A step: CFG text dropout, the loss on
copies of the f32 master weights cast to the compute dtype, the backward
into the masters, global-norm clipping and the optimizer update. PyTorch
runs it eagerly; the JAX package jits it into one program.

``train_cfg.mesh.sp`` > 1 trains sequence parallel: the model's attention
runs as ring attention over sp ranks in this process
(``parallel/ring_attention.LocalRing``), the JAX trainer's ``sp`` mesh axis;
full, axial and conv_like layers only. dp, fsdp and tp > 1 need more than
one card and raise ``NotImplementedError``.

With ``train_cfg.checkpoint_dir`` set, the trainer checkpoints as
``base_trainer.BaseTrainer`` does (``train/checkpoints.py``): ``fit`` saves
before its first step (``preflight_checkpoint``), whenever the step crosses
a multiple of ``save_every_steps``, and at its end; ``restore`` brings back
the master weights, the optimizer's state, the step and the CFG dropout
generator. The metadata carries the model's identity (``_meta``).

Later slices bring NaN rollback, device prefetch, scanned multi-steps and
the observability taps.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..config import DalleConfig, TrainConfig
from ..convert import adam_state_from_optax, dalle_state_dict
from ..device import resolve_device
from ..models.dalle import init_dalle
from .checkpoints import CheckpointManager
from .metrics import count_params, transformer_train_flops
from .train_state import cast_floating, compute_dtype, make_optimizer


def _ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(device)


class _LossBackward(torch.nn.Module):
    """The loss and its backward in one call. ``functional_call`` swaps the
    cast copies in for the parameters only for the duration of a call; the
    backward recomputes remat'd blocks and loss chunks from the module, so
    it has to run inside the same call to see the same copies."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, text, image_ids, **kw):
        loss, aux = self.model(text, image_ids, True, **kw)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}


class DalleTrainer:
    """Consumes batches of (text ids, image codebook ids). The model is built
    by ``init_dalle`` (random weights from ``train_cfg.seed``) in train mode;
    its parameters are the f32 masters the optimizer updates. ``extra_meta``
    is merged into every checkpoint's metadata (the CLI puts the VAE's
    identity there)."""

    model_class = "DALLE"

    def __init__(self, model_cfg: DalleConfig, train_cfg: TrainConfig, device=None,
                 null_cond_prob: float = 0.0):
        if train_cfg.runtime_lr_scale:
            raise NotImplementedError("runtime_lr_scale is not ported yet")
        mesh = train_cfg.mesh
        if max(mesh.dp, mesh.fsdp, mesh.tp) > 1:
            raise NotImplementedError("dp, fsdp and tp > 1 are not ported: the port "
                                      "trains on one card (mesh.sp runs its ranks there)")
        if mesh.sp > 1:
            sp_ok = {"full", "axial_row", "axial_col", "conv_like"}
            bad = set(model_cfg.attn_types or ("full",)) - sp_ok
            if bad:
                raise ValueError(
                    f"sequence parallelism (sp > 1) supports attn_types {sorted(sp_ok)}; "
                    f"got unsupported {sorted(bad)} (tabled 'sparse' masks have no "
                    "element test on global positions)")
        self.model_cfg, self.train_cfg = model_cfg, train_cfg
        self.device = resolve_device(device)
        self.null_cond_prob = null_cond_prob
        self.model = init_dalle(model_cfg, seed=train_cfg.seed, device=self.device,
                                sp=mesh.sp).train()
        self.names = [n for n, _ in self.model.named_parameters()]
        self._loss_backward = _LossBackward(self.model)
        self.optimizer = make_optimizer(train_cfg.optim, list(self.model.parameters()))
        self.dtype = compute_dtype(train_cfg.precision)
        # CFG dropout draws (the JAX package folds the step into its key)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.num_params = count_params(self.model)
        self.flops_per_step = transformer_train_flops(
            self.num_params, train_cfg.batch_size * model_cfg.total_seq_len)
        self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir,
                                       keep_n=train_cfg.keep_n_checkpoints)
                     if train_cfg.checkpoint_dir else None)
        self.extra_meta: Dict[str, Any] = {}

    @property
    def step(self) -> int:
        return self.optimizer.count

    def loss_and_backward(self, text, image_ids, null_mask: Optional[torch.Tensor] = None):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached."""
        args = (text, image_ids)
        kw = dict(null_cond_prob=self.null_cond_prob, null_mask=null_mask,
                  generator=self.generator)
        if self.dtype is None:
            return self._loss_backward(*args, **kw)
        params = cast_floating(dict(self._loss_backward.named_parameters()), self.dtype)
        return functional_call(self._loss_backward, params, args, kw)

    def train_step(self, text, image_ids, null_mask=None) -> Dict[str, float]:
        """One optimizer step on a batch → {"loss", "loss_text", "loss_img",
        "grad_norm" (global, before clipping), "step" (after the update)}.
        ``null_mask`` ((b,) bool) fixes which rows get null text, in place of
        drawing them with ``null_cond_prob``."""
        text, image_ids = _ids(text, self.device), _ids(image_ids, self.device)
        if null_mask is not None:
            null_mask = torch.as_tensor(np.asarray(null_mask, bool)).to(self.device)
        self.optimizer.zero_grad()
        loss, aux = self.loss_and_backward(text, image_ids, null_mask)
        grad_norm = self.optimizer.step()
        vals = torch.stack([loss.float(), aux["loss_text"].float(),
                            aux["loss_img"].float(), grad_norm]).tolist()
        return {"loss": vals[0], "loss_text": vals[1], "loss_img": vals[2],
                "grad_norm": vals[3], "step": self.step}

    # -- checkpoints -------------------------------------------------------
    def _meta(self) -> Dict[str, Any]:
        return {"hparams": self.model_cfg.to_dict(), "train": self.train_cfg.to_dict(),
                "model_class": self.model_class, **self.extra_meta}

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the masters, the optimizer's state, its
        step count and the CFG dropout generator's state."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.core.state_dict(),
                "count": self.optimizer.count,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping[str, Any]):
        with torch.no_grad():
            self.model.load_state_dict(state["model"])
        self.optimizer.core.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["count"])
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

    def fit(self, batches: Iterable, *, steps: Optional[int] = None, log=print):
        """Step through ``batches`` ((text, image_ids) pairs) until the step
        count reaches ``steps`` (a resumed run continues from its step),
        logging every ``train_cfg.log_every`` steps with the samples and
        tokens per second since the last log. With a checkpoint directory:
        a pre-flight save first, a save whenever the step crosses a
        multiple of ``save_every_steps``, and one at the end. Returns the
        last step's metrics."""
        tc = self.train_cfg
        every = max(tc.log_every, 1)
        metrics: Dict[str, Any] = {}
        if self.ckpt is not None and tc.preflight_checkpoint:
            self.ckpt.preflight(self.step, self.state_dict(), self._meta())
        t0, last = time.perf_counter(), self.step
        for text, image_ids in batches:
            if steps is not None and self.step >= steps:
                break
            prev = self.step
            metrics = self.train_step(text, image_ids)
            if metrics["step"] % every == 0:
                now = time.perf_counter()
                sps = len(text) * (metrics["step"] - last) / (now - t0)
                metrics.update(sample_per_sec=sps,
                               tokens_per_sec=sps * self.model_cfg.total_seq_len)
                t0, last = now, metrics["step"]
                log(f"[step {metrics['step']}] " + " ".join(
                    f"{k}={v:.5g}" for k, v in metrics.items() if k != "step"))
            save_every = tc.save_every_steps
            if (self.ckpt is not None and save_every > 0
                    and prev // save_every != self.step // save_every):
                self.save()
        if self.ckpt is not None and self.ckpt.latest_step() != self.step:
            self.save()
        return metrics

    def load_jax_state(self, params: Mapping[str, Any], opt_state=None):
        """Continue a JAX run: its flax params (numpy) into the masters and,
        when given, its optax Adam/AdamW state (``count``, ``mu``, ``nu``,
        found anywhere in ``opt_state``) into the optimizer, with the
        schedule's step count."""
        with torch.no_grad():
            self.model.load_state_dict(dalle_state_dict(params))
        if opt_state is not None:
            count, state = adam_state_from_optax(opt_state, self.names)
            core = self.optimizer.core
            sd = core.state_dict()
            sd["state"] = {i: {k: v.to(self.device) if k != "step" else v
                               for k, v in s.items()} for i, s in state.items()}
            core.load_state_dict(sd)
            self.optimizer.count = count
