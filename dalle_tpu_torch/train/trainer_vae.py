"""dVAE trainer: the gumbel-softmax training step on the trainers' shell.

Port of ``dalle_tpu/train/trainer_vae.py``: the temperature anneal
``max(starting_temp · exp(−anneal_rate · step), temp_min)``, read at each
step (and rebased by ``reanneal_gumbel``, which the checkpoint metadata
carries), the loss of ``DiscreteVAE.forward`` on the compute-dtype copies
of the f32 masters, clipping and the optimizer's update, and the codebook
histogram that shows a collapse. The gumbel draws come from a
``torch.Generator`` seeded by ``train_cfg.seed`` whose state travels in the
checkpoint (the JAX package folds the step into its key). A checkpoint's
``model`` is the ``DiscreteVAE`` state dict and its ``hparams`` the
``DVAEConfig``: what ``train_dalle --vae_path`` reads. ``train_steps`` runs
k stacked batches with each step's temperature and gumbel draws as k
``train_step`` calls would take them. Under ``obs.health`` a step's
metrics carry the forward's codebook and gumbel vitals
(``DiscreteVAE(return_health=True)``) and the per-layer-group tree columns,
as the JAX trainer's do; ``reanneal_gumbel`` is the codebook-collapse
breach action's re-warm (``train/actions.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config import AnnealConfig, DVAEConfig, TrainConfig
from ..models.dvae import init_dvae
from ..obs import span
from .base_trainer import BaseTrainer


def anneal_temperature(cfg: AnnealConfig, global_step: int) -> float:
    return max(cfg.starting_temp * math.exp(-cfg.anneal_rate * global_step), cfg.temp_min)


def _vae_loss(model, images, temp, noise, generator, health=False):
    out = model(images, temp=temp, return_loss=True, noise=noise, generator=generator,
                return_health=health)
    return out if health else (out, {})


class VAETrainer(BaseTrainer):
    """Consumes batches of (b, H, W, C) images in [0, 1], optionally with
    their gumbel draws (``train_step``'s ``noise``). The model is built by
    ``init_dvae`` (random weights from ``train_cfg.seed``)."""

    model_class = "DiscreteVAE"

    def __init__(self, model_cfg: DVAEConfig, train_cfg: TrainConfig,
                 anneal_cfg: Optional[AnnealConfig] = None, device=None):
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.anneal_cfg = anneal_cfg or AnnealConfig()
        self._anneal_step0 = 0   # the anneal's rebase point (reanneal_gumbel)
        self.model = init_dvae(model_cfg, seed=train_cfg.seed, device=self.device).train()
        self._setup_training(_vae_loss)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.tokens_per_sample = model_cfg.image_seq_len
        self.flops_per_step = 6.0 * self.num_params * train_cfg.batch_size * model_cfg.image_seq_len

    def _temp_at(self, step: int) -> float:
        """The anneal at ``step - _anneal_step0``."""
        return anneal_temperature(self.anneal_cfg, max(step - self._anneal_step0, 0))

    def reanneal_gumbel(self, step: int) -> float:
        """Restart the temperature's anneal from ``step`` (re-warming a
        collapsed codebook). The rebase point goes into every later
        checkpoint's metadata, so a resumed run keeps it. Returns the
        temperature at ``step``."""
        self._anneal_step0 = int(step)
        self.extra_meta["anneal_step0"] = self._anneal_step0
        return self._temp_at(step)

    def restore(self, step: Optional[int] = None):
        meta = super().restore(step)
        if meta and meta.get("anneal_step0"):
            self._anneal_step0 = int(meta["anneal_step0"])
            self.extra_meta["anneal_step0"] = self._anneal_step0
        return meta

    def _put_batch(self, batch, stacked: bool = False):
        """(images[, noise]) → images in the compute dtype and f32 gumbel
        noise on the device."""
        images, *rest = batch
        noise = rest[0] if rest else None
        return (self._to_compute(self._to_images(images)),
                None if noise is None else self._to_device(noise, torch.float32))

    def _step(self, images, noise):
        temp = self._temp_at(self.step)
        loss, aux, grad_norm = self._optimize(images, temp, noise, self.generator, self.health)
        return ({"loss": loss, "grad_norm": grad_norm, **aux, **self._health_columns()},
                {"temperature": temp})

    def train_step(self, images, noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One optimizer step → {"loss", "grad_norm" (before clipping),
        "temperature", "step" (after the update)}, or {} between
        ``metrics_every`` boundaries. ``noise`` ((b, h, w, num_tokens),
        standard Gumbel) replaces the generator's draw."""
        with span("vae/shard_batch"):
            batch = self._put_batch((images, noise))
        with span("vae/step"):
            return self._finish_step(*self._step(*batch))

    def train_steps(self, images, noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """k steps on stacked (k, b, H, W, C) images (and optional stacked
        noise), with no host read between them → the last step's metrics
        plus ``loss_mean``; each step reads the temperature at its own step."""
        k = len(images)
        with span("vae/shard_batch", k=k):
            images, noise = self._put_batch((images, noise), stacked=True)
        if images.dim() != 5:
            raise ValueError(f"train_steps takes stacked (k, b, H, W, C) images, got "
                             f"{tuple(images.shape)}")
        with span("vae/steps", k=k):
            losses = []
            for i in range(images.shape[0]):
                m, host = self._step(images[i], None if noise is None else noise[i])
                losses.append(m["loss"])
            m["loss_mean"] = torch.stack(losses).float().mean()
            return self._finish_step(m, host)

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, images, hard: bool = True) -> torch.Tensor:
        """(b, H, W, C) reconstructions on the f32 masters: the argmax's
        codes with ``hard``, else a gumbel sample from a generator seeded by
        ``train_cfg.seed`` (the training draws are not disturbed)."""
        gen = None
        if not hard:
            gen = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed)
        return self.model(self._to_images(images), hard_recons=hard, generator=gen)

    def codebook_histogram(self, images) -> np.ndarray:
        """(num_tokens,) counts of each code among the images' argmax codes."""
        idx = self.model.get_codebook_indices(self._to_images(images))
        return torch.bincount(idx.reshape(-1), minlength=self.model_cfg.num_tokens).cpu().numpy()
