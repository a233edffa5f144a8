"""CLIP trainer: the contrastive training step on the trainers' shell.

Port of ``dalle_tpu/train/trainer_clip.py``: the symmetric cross-entropy of
``CLIP.forward(return_loss=True)`` on the compute-dtype copies of the f32
masters, clipping and the optimizer's update. The step draws nothing. A
checkpoint's ``model`` is the ``CLIP`` state dict and its ``hparams`` the
``ClipConfig``: what ``generate --clip_path`` reads.

Not ported yet: ``train_steps`` (scanned multi-steps) and the health taps
(``ROADMAP.md`` Queue 1 items 3 and 12).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ClipConfig, TrainConfig
from ..models.clip import init_clip
from .base_trainer import BaseTrainer
from .metrics import transformer_train_flops


def _clip_loss(model, text, images):
    return model(text, images, return_loss=True), {}


def _text_ids(text, device) -> torch.Tensor:
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.asarray(text, dtype=np.int64))
    return text.to(device, torch.long)


class CLIPTrainer(BaseTrainer):
    """Consumes batches of (text ids (b, text_seq_len), images (b, H, W, C)
    in [0, 1]). The model is built by ``init_clip`` (random weights from
    ``train_cfg.seed``) in train mode."""

    model_class = "CLIP"

    def __init__(self, model_cfg: ClipConfig, train_cfg: TrainConfig, device=None):
        if train_cfg.runtime_lr_scale:
            raise NotImplementedError("runtime_lr_scale is not ported yet")
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.model = init_clip(model_cfg, seed=train_cfg.seed, device=self.device).train()
        self._setup_training(_clip_loss)
        self.tokens_per_sample = (model_cfg.text_seq_len + (
            model_cfg.visual_image_size // model_cfg.visual_patch_size) ** 2)
        self.flops_per_step = transformer_train_flops(
            self.num_params, train_cfg.batch_size * self.tokens_per_sample)

    def train_step(self, text, images) -> Dict[str, float]:
        """One optimizer step → {"loss", "grad_norm" (before clipping),
        "step" (after the update)}."""
        images = self._to_images(images)
        if self.dtype is not None:
            images = images.to(self.dtype)
        loss, _, grad_norm = self._optimize(_text_ids(text, self.device), images)
        vals = torch.stack([loss.float(), grad_norm]).tolist()
        return {"loss": vals[0], "grad_norm": vals[1], "step": self.step}

    @torch.no_grad()
    def similarity(self, text, images) -> torch.Tensor:
        """Per-pair rerank scores (b,) on the f32 masters."""
        return self.model(_text_ids(text, self.device), self._to_images(images))
