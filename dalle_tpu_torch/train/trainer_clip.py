"""CLIP trainer: the contrastive training step on the trainers' shell.

Port of ``dalle_tpu/train/trainer_clip.py``: the symmetric cross-entropy of
``CLIP.forward(return_loss=True)`` on the compute-dtype copies of the f32
masters, clipping and the optimizer's update. The step draws nothing. A
checkpoint's ``model`` is the ``CLIP`` state dict and its ``hparams`` the
``ClipConfig``: what ``generate --clip_path`` reads. ``train_steps`` runs
k stacked batches with no host read between them. Under ``obs.health`` a
step's metrics carry the per-layer-group ``health/*`` columns, as the JAX
trainer's do.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import ClipConfig, TrainConfig
from ..models.clip import init_clip
from ..obs import span
from .base_trainer import BaseTrainer
from .metrics import transformer_train_flops


def _clip_loss(model, text, images):
    return model(text, images, return_loss=True), {}


class CLIPTrainer(BaseTrainer):
    """Consumes batches of (text ids (b, text_seq_len), images (b, H, W, C)
    in [0, 1]). The model is built by ``init_clip`` (random weights from
    ``train_cfg.seed``) in train mode."""

    model_class = "CLIP"

    def __init__(self, model_cfg: ClipConfig, train_cfg: TrainConfig, device=None):
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.model = init_clip(model_cfg, seed=train_cfg.seed, device=self.device).train()
        self._setup_training(_clip_loss)
        self.tokens_per_sample = (model_cfg.text_seq_len + (
            model_cfg.visual_image_size // model_cfg.visual_patch_size) ** 2)
        self.flops_per_step = transformer_train_flops(
            self.num_params, train_cfg.batch_size * self.tokens_per_sample)

    def _put_batch(self, batch, stacked: bool = False):
        """(text, images) → int64 ids and images in the compute dtype on the
        device."""
        text, images = batch
        return (self._to_device(text, torch.long),
                self._to_compute(self._to_images(images)))

    def train_step(self, text, images) -> Dict[str, float]:
        """One optimizer step → {"loss", "grad_norm" (before clipping),
        "step" (after the update)}, or {} between ``metrics_every``
        boundaries."""
        with span("clip/shard_batch"):
            batch = self._put_batch((text, images))
        with span("clip/step"):
            loss, _, grad_norm = self._optimize(*batch)
            return self._finish_step({"loss": loss, "grad_norm": grad_norm,
                                      **self._health_columns()})

    def train_steps(self, texts, images) -> Dict[str, float]:
        """k steps on stacked (k, b, seq) texts and (k, b, H, W, C) images,
        with no host read between them → the last step's metrics plus
        ``loss_mean``."""
        k = len(texts)
        with span("clip/shard_batch", k=k):
            texts, images = self._put_batch((texts, images), stacked=True)
        if texts.dim() != 3 or images.dim() != 5:
            raise ValueError("train_steps takes stacked (k, b, seq) texts and "
                             "(k, b, H, W, C) images")
        with span("clip/steps", k=k):
            losses = []
            for i in range(texts.shape[0]):
                loss, _, grad_norm = self._optimize(texts[i], images[i])
                losses.append(loss)
            return self._finish_step({"loss": loss, "grad_norm": grad_norm,
                                      **self._health_columns(),
                                      "loss_mean": torch.stack(losses).float().mean()})

    @torch.no_grad()
    def similarity(self, text, images) -> torch.Tensor:
        """Per-pair rerank scores (b,) on the f32 masters."""
        return self.model(self._to_device(text, torch.long), self._to_images(images))
