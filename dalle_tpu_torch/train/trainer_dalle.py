"""DALL·E trainer: one training step on the card, on the trainers' shell.

Port of ``dalle_tpu/train/trainer_dalle.py`` (``_make_dalle_loss_fn``,
``_dalle_step_body``, ``DalleTrainer``). A step: CFG text dropout, the loss
on copies of the f32 master weights cast to the compute dtype, the backward
into the masters, global-norm clipping and the optimizer update. PyTorch
runs it eagerly; the JAX package jits it into one program. The loop,
checkpoints and NaN rollback are the shell's (``train/base_trainer.py``).

``train_cfg.mesh.sp`` > 1 trains sequence parallel: the model's attention
runs as ring attention over sp ranks in this process
(``parallel/ring_attention.LocalRing``), the JAX trainer's ``sp`` mesh axis;
full, axial and conv_like layers only. dp, fsdp and tp > 1 need more than
one card and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import DalleConfig, TrainConfig
from ..convert import adam_state_from_optax, dalle_state_dict
from ..models.dalle import init_dalle
from .base_trainer import BaseTrainer
from .metrics import transformer_train_flops


def _ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(device)


def _dalle_loss(model, text, image_ids, **kw):
    return model(text, image_ids, True, **kw)


class DalleTrainer(BaseTrainer):
    """Consumes batches of (text ids, image codebook ids). The model is built
    by ``init_dalle`` (random weights from ``train_cfg.seed``) in train mode;
    its parameters are the f32 masters the optimizer updates."""

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
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.null_cond_prob = null_cond_prob
        self.model = init_dalle(model_cfg, seed=train_cfg.seed, device=self.device,
                                sp=mesh.sp).train()
        self._setup_training(_dalle_loss)
        # CFG dropout draws (the JAX package folds the step into its key)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.tokens_per_sample = model_cfg.total_seq_len
        self.flops_per_step = transformer_train_flops(
            self.num_params, train_cfg.batch_size * model_cfg.total_seq_len)

    def loss_and_backward(self, text, image_ids, null_mask: Optional[torch.Tensor] = None):
        """The loss on the compute-dtype copies of the masters, and its
        backward into the masters' ``.grad`` → (loss, aux), detached."""
        return self._backward(text, image_ids, **self._loss_kw(null_mask))

    def _loss_kw(self, null_mask):
        return dict(null_cond_prob=self.null_cond_prob, null_mask=null_mask,
                    generator=self.generator)

    def train_step(self, text, image_ids, null_mask=None) -> Dict[str, float]:
        """One optimizer step on a batch → {"loss", "loss_text", "loss_img",
        "grad_norm" (global, before clipping), "step" (after the update)}.
        ``null_mask`` ((b,) bool) fixes which rows get null text, in place of
        drawing them with ``null_cond_prob``."""
        text, image_ids = _ids(text, self.device), _ids(image_ids, self.device)
        if null_mask is not None:
            null_mask = torch.as_tensor(np.asarray(null_mask, bool)).to(self.device)
        loss, aux, grad_norm = self._optimize(text, image_ids, **self._loss_kw(null_mask))
        vals = torch.stack([loss.float(), aux["loss_text"].float(),
                            aux["loss_img"].float(), grad_norm]).tolist()
        return {"loss": vals[0], "loss_text": vals[1], "loss_img": vals[2],
                "grad_norm": vals[3], "step": self.step}

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
            self.optimizer.count = self.step = count
