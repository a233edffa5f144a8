"""DALL·E trainer: training steps on the card, on the trainers' shell.

Port of ``dalle_tpu/train/trainer_dalle.py`` (``_make_dalle_loss_fn``,
``_dalle_step_body``, ``make_dalle_train_multi_step``, ``DalleTrainer``). A
step: CFG text dropout, the loss on copies of the f32 master weights cast to
the compute dtype (with attention and feed-forward dropout when the model
has it), the backward into the masters, and the optimizer's chain
(``train/train_state.py``: accumulation, clipping, the core, the plateau
and runtime scales). ``train_steps`` takes k stacked batches to k steps
with no host read between them; every draw (CFG nulls, dropout masks) comes
from the trainer's generator in ``train_step``'s order, so k ``train_step``
calls give the same bits. PyTorch runs a step eagerly; the JAX package jits
it (``lax.scan`` for the k steps). The loop, checkpoints, the metrics
cadence, NaN rollback and the telemetry are the shell's
(``train/base_trainer.py``); under ``obs.health`` a step's metrics carry
the per-layer-group ``health/*`` columns (``transformer``, ``text_emb``,
``image_emb``, ... at depth 1), device scalars read with the loss.

``train_cfg.mesh.sp`` > 1 trains sequence parallel: the model's attention
runs as ring attention over sp ranks in this process
(``parallel/ring_attention.LocalRing``), the JAX trainer's ``sp`` mesh axis;
full, axial and conv_like layers only. dp, fsdp and tp > 1 need more than
one card and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from ..config import DalleConfig, TrainConfig
from ..convert import dalle_state_dict, optimizer_state_from_optax
from ..models.dalle import init_dalle
from ..obs import span
from .base_trainer import BaseTrainer
from .metrics import transformer_train_flops


def _dalle_loss(model, text, image_ids, **kw):
    return model(text, image_ids, True, **kw)


class DalleTrainer(BaseTrainer):
    """Consumes batches of (text ids, image codebook ids). The model is built
    by ``init_dalle`` (random weights from ``train_cfg.seed``) in train mode;
    its parameters are the f32 masters the optimizer updates."""

    model_class = "DALLE"

    def __init__(self, model_cfg: DalleConfig, train_cfg: TrainConfig, device=None,
                 null_cond_prob: float = 0.0):
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
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.null_cond_prob = null_cond_prob
        self.model = init_dalle(model_cfg, seed=train_cfg.seed, device=self.device,
                                sp=mesh.sp).train()
        self._setup_training(_dalle_loss)
        # CFG and dropout draws (the JAX package folds the step into its key)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.use_dropout = model_cfg.attn_dropout > 0 or model_cfg.ff_dropout > 0
        self.tokens_per_sample = model_cfg.total_seq_len
        self.flops_per_step = transformer_train_flops(
            self.num_params, train_cfg.batch_size * model_cfg.total_seq_len)

    def loss_and_backward(self, text, image_ids, null_mask: Optional[torch.Tensor] = None):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached."""
        return self._backward(text, image_ids, **self._loss_kw(null_mask))

    def _loss_kw(self, null_mask):
        return dict(null_cond_prob=self.null_cond_prob, null_mask=null_mask,
                    generator=self.generator, dropout=self.use_dropout)

    def _put_batch(self, batch, stacked: bool = False):
        """(text, image ids[, null_mask]) → int64 ids (and a bool mask) on
        the device."""
        text, image_ids, *rest = batch
        null_mask = rest[0] if rest else None
        return (self._to_device(text, torch.long), self._to_device(image_ids, torch.long),
                None if null_mask is None else self._to_device(null_mask, torch.bool))

    def _metrics(self, loss, aux, grad_norm) -> Dict[str, torch.Tensor]:
        return {"loss": loss, "loss_text": aux["loss_text"], "loss_img": aux["loss_img"],
                "grad_norm": grad_norm, **self._health_columns()}

    def train_step(self, text, image_ids, null_mask=None) -> Dict[str, float]:
        """One optimizer step on a batch → {"loss", "loss_text", "loss_img",
        "grad_norm" (global, before clipping), "step" (after the update)},
        or {} between ``metrics_every`` boundaries. ``null_mask`` ((b,)
        bool) fixes which rows get null text, in place of drawing them with
        ``null_cond_prob``."""
        with span("dalle/shard_batch"):
            text, image_ids, null_mask = self._put_batch((text, image_ids, null_mask))
        with span("dalle/step"):
            loss, aux, grad_norm = self._optimize(text, image_ids, **self._loss_kw(null_mask))
            return self._finish_step(self._metrics(loss, aux, grad_norm))

    def train_steps(self, texts, image_ids, null_masks=None) -> Dict[str, float]:
        """k = ``texts.shape[0]`` optimizer steps on stacked (k, b, …)
        batches, with no host read between them → the last step's metrics
        plus ``loss_mean`` over the k, at the cadence of ``train_step``; the
        step advances by k."""
        k = len(texts)
        with span("dalle/shard_batch", k=k):
            texts, image_ids, null_masks = self._put_batch((texts, image_ids, null_masks),
                                                           stacked=True)
        if texts.dim() != 3:
            raise ValueError(f"train_steps takes stacked (k, b, seq) batches, got "
                             f"{tuple(texts.shape)}")
        with span("dalle/steps", k=k):
            losses = []
            for i in range(texts.shape[0]):
                loss, aux, grad_norm = self._optimize(
                    texts[i], image_ids[i],
                    **self._loss_kw(None if null_masks is None else null_masks[i]))
                losses.append(loss)
            m = self._metrics(loss, aux, grad_norm)
            m["loss_mean"] = torch.stack(losses).float().mean()
            return self._finish_step(m)

    def load_jax_state(self, params: Mapping[str, Any], opt_state=None,
                       lr_scale: Optional[float] = None):
        """Continue a JAX run: its flax params (numpy) into the masters and,
        when given, its optax state (Adam/AdamW or Adafactor, with the
        ``MultiSteps`` accumulator and the plateau state where present;
        ``convert.optimizer_state_from_optax``) into the optimizer, with the
        step its counts give; ``lr_scale`` is ``TrainState.lr_scale``."""
        with torch.no_grad():
            self.model.load_state_dict(dalle_state_dict(params))
        if opt_state is not None:
            self.optimizer.load_state_dict(optimizer_state_from_optax(
                opt_state, params, self.names, self.train_cfg.optim.optimizer))
            opt = self.optimizer
            self.step = opt.count * opt.accum + opt.mini_step
        if lr_scale is not None:
            self.set_lr_scale(lr_scale)
