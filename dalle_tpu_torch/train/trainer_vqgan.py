"""VQGAN trainer: the adversarial autoencoder step on the trainers' shell.

Port of ``dalle_tpu/train/trainer_vqgan.py`` (taming's two-optimizer
``VQModel.training_step``). A ``gan`` step is the JAX package's
``make_vqgan_train_step``:

1. The autoencoder, on compute-dtype copies of its f32 masters: encode,
   quantize, decode; nll = pixel-weighted L1 + perceptual-weighted LPIPS
   (frozen); the generator term g = -mean D(recon), D's batch statistics
   used and not kept; the adaptive weight at the decoder's ``conv_out``
   weight (``models/gan.adaptive_disc_weight``); loss = nll + d_weight ·
   disc_factor · g + codebook_weight · vq loss, disc_factor 0 before
   ``disc_start``. The discriminator's parameters take no gradient here.
2. The discriminator, in f32: D on the images, then on the reconstruction
   of step 1 (detached), each pass moving its BatchNorm's running
   statistics; disc_factor × the hinge (or vanilla) loss; its own
   optimizer.

``nodisc`` (L1 + codebook) and ``segmentation`` (BCE over label logits +
codebook) are the single-optimizer variants. The gumbel quantizer's
temperature follows ``LambdaWarmUpCosineScheduler`` by default; its draws
and dropout's come from the trainer's generator, whose state the
checkpoint carries. A checkpoint's ``model`` is the ``VQModel`` state dict
and its ``hparams`` the ``VQGANConfig``; the discriminator and its
optimizer travel beside them, and roll back with them on a NaN. Under
``obs.health`` a step's metrics carry the quantizer's codebook vitals
(``VQModel.health_taps`` of the encode's own ``VQOutput``) and the tree
columns of both optimizers, the generator's groups under ``gen/`` and the
discriminator's under ``disc/``, as the JAX trainer's do.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from ..config import OptimConfig, TrainConfig, VQGANConfig
from ..models.gan import (GANLossConfig, NLayerDiscriminator, adaptive_disc_weight,
                          adopt_weight, bce_with_quant_loss, hinge_d_loss, vanilla_d_loss)
from ..models.lpips import init_lpips, load_tiny_perceptual
from ..models.vqgan import init_vqgan
from ..obs import GroupTaps, span
from ..obs.health import codebook_health
from .base_trainer import BaseTrainer
from .train_state import make_optimizer

LOSS_MODES = ("gan", "nodisc", "segmentation")


class LambdaWarmUpCosineScheduler:
    """Linear warm-up from ``lr_start`` to ``lr_max``, then a cosine decay to
    ``lr_min`` at ``max_decay_steps`` (taming's ``lr_scheduler.py``); the
    gumbel quantizer's temperature schedule."""

    def __init__(self, warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                 max_decay_steps: int):
        self.warm_up_steps = warm_up_steps
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.lr_start = lr_start
        self.max_decay_steps = max_decay_steps

    def __call__(self, n: int) -> float:
        if n < self.warm_up_steps:
            return (self.lr_max - self.lr_start) / self.warm_up_steps * n + self.lr_start
        t = min((n - self.warm_up_steps) / max(self.max_decay_steps - self.warm_up_steps, 1),
                1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + math.cos(t * math.pi))


def _ae_loss(model, images, temp, step, noise, generator, trainer):
    """The autoencoder's loss (step 1 of the module's docstring) → (loss,
    aux); aux carries the reconstruction for the discriminator's step."""
    lc = trainer.loss_cfg
    x = trainer._to_compute(images)
    q = model.encode(x, temp, deterministic=False, noise=noise, generator=generator)
    recon = model.decode(q.quantized, deterministic=False, generator=generator)
    r = recon.float()
    rec = lc.pixelloss_weight * torch.abs(images - r)
    nll = torch.mean(rec)
    if trainer.lpips is not None and lc.perceptual_weight != 0:
        nll = nll + lc.perceptual_weight * torch.mean(trainer.lpips(images, r).float())
    g_loss = -torch.mean(trainer.disc(r, train=True, update_stats=False))
    d_weight = adaptive_disc_weight(nll, g_loss, model.decoder.conv_out.weight, lc.disc_weight)
    disc_factor = adopt_weight(lc.disc_factor, step, lc.disc_start)
    loss = nll + d_weight * disc_factor * g_loss + lc.codebook_weight * q.loss
    health = model.health_taps(q, temp) if trainer.health else {}
    return loss, {"recon": recon, "nll_loss": nll, "g_loss": g_loss,
                  "quant_loss": q.loss.float(), "d_weight": d_weight, **health}


def _simple_loss(model, images, targets, temp, noise, generator, trainer):
    """``nodisc`` / ``segmentation`` → (loss, aux)."""
    lc = trainer.loss_cfg
    recon, qloss, indices = model(trainer._to_compute(images), temp, deterministic=False,
                                  noise=noise, generator=generator)
    recon32 = recon.float()
    health = {}
    if trainer.health:
        with torch.no_grad():
            health = codebook_health(indices, model.cfg.n_embed)
    if trainer.loss_mode == "segmentation":
        loss, parts = bce_with_quant_loss(recon32, targets, qloss, lc.codebook_weight)
        return loss, {"nll_loss": parts["bce_loss"], "quant_loss": qloss.float(), **health}
    rec = torch.mean(torch.abs(targets - recon32)) * lc.pixelloss_weight
    return rec + lc.codebook_weight * qloss, {"nll_loss": rec, "quant_loss": qloss.float(),
                                              **health}


class VQGANTrainer(BaseTrainer):
    """Consumes batches of (b, H, W, C) images in [-1, 1] (taming's data
    convention), with label one-hots as ``targets`` in ``segmentation``
    mode. ``loss_mode``: "gan", "nodisc" or "segmentation" (set
    ``cfg.out_ch`` to the label count). Both optimizers follow
    ``train_cfg.optim`` unless ``disc_optim`` is given (taming: Adam with
    betas (0.5, 0.9) for both)."""

    model_class = "VQModel"

    def __init__(self, model_cfg: VQGANConfig, train_cfg: TrainConfig,
                 loss_cfg: Optional[GANLossConfig] = None, device=None,
                 disc_optim: Optional[OptimConfig] = None,
                 temp_scheduler: Optional[Callable[[int], float]] = None,
                 loss_mode: str = "gan"):
        if loss_mode not in LOSS_MODES:
            raise ValueError(f"loss_mode must be one of {LOSS_MODES}, got {loss_mode!r}")
        super().__init__(train_cfg, device)
        self.model_cfg = model_cfg
        self.loss_cfg = lc = loss_cfg or GANLossConfig()
        self.loss_mode = loss_mode
        self.model = init_vqgan(model_cfg, seed=train_cfg.seed, device=self.device).train()
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.disc = self.lpips = self.disc_optimizer = None
        self.extra_meta["loss_cfg"] = lc.to_dict()
        self.extra_meta["loss_mode"] = loss_mode
        if loss_mode != "gan":
            self._setup_training(_simple_loss)
        else:
            with torch.device(self.device):
                self.disc = NLayerDiscriminator(lc.disc_ndf, lc.disc_num_layers,
                                                lc.use_actnorm, model_cfg.in_channels)
            gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed + 1)
            self.disc.reset_parameters(gen).train()
            if lc.use_actnorm:
                # ActNorm's data-dependent init on the zeros flax initializes with
                res = model_cfg.resolution
                with torch.no_grad():
                    self.disc(torch.zeros(2, res, res, model_cfg.in_channels,
                                          device=self.device))
            if lc.perceptual_weight > 0:
                self.lpips = (load_tiny_perceptual(device=self.device)
                              if lc.perceptual_net == "tiny"
                              else init_lpips(seed=train_cfg.seed + 2, device=self.device))
            self._setup_training(_ae_loss, health_prefix="gen")
            self.disc_optim = disc_optim or train_cfg.optim
            disc_params = list(self.disc.parameters())
            self.disc_optimizer = make_optimizer(self.disc_optim, disc_params,
                                                 health=self.health)
            if self.health:
                self._disc_taps = GroupTaps(
                    self.disc, [n for n, _ in self.disc.named_parameters()], disc_params,
                    train_cfg.obs.health_group_depth, "disc")
        self.temp_scheduler = temp_scheduler
        if temp_scheduler is None and model_cfg.quantizer == "gumbel":
            self.temp_scheduler = LambdaWarmUpCosineScheduler(
                0, 1e-6, 1.0, 1.0, train_cfg.optim.total_steps)

    # -- the step ------------------------------------------------------------
    def _put_batch(self, batch, stacked: bool = False):
        """(images[, targets[, noise]]) → f32 tensors on the device."""
        return tuple(None if x is None else self._to_device(x, torch.float32) for x in batch)

    def _temp(self) -> float:
        return self.temp_scheduler(self.step) if self.temp_scheduler is not None else 1.0

    def _step(self, images, targets, noise):
        temp = self._temp()
        host = {"temperature": temp} if self.temp_scheduler is not None else {}
        if self.loss_mode != "gan":
            t = images if targets is None else targets
            loss, aux, _ = self._optimize(images, t, temp, noise, self.generator, self)
            return {"loss": loss, **aux, **self._health_columns()}, host
        lc = self.loss_cfg
        step = self.step
        self.disc.requires_grad_(False)
        try:
            loss, aux, _ = self._optimize(images, temp, step, noise, self.generator, self)
        finally:
            self.disc.requires_grad_(True)
        recon = aux.pop("recon").float()
        self.disc_optimizer.zero_grad()
        logits_real = self.disc(images, train=True)
        logits_fake = self.disc(recon, train=True)
        d_loss_fn = hinge_d_loss if lc.disc_loss == "hinge" else vanilla_d_loss
        d_loss = adopt_weight(lc.disc_factor, step, lc.disc_start) * d_loss_fn(logits_real,
                                                                              logits_fake)
        d_loss.backward()
        self.disc_optimizer.step(d_loss.detach())
        m = {"loss": loss, "disc_loss": d_loss.detach(), **aux,
             "logits_real": logits_real.detach().mean(),
             "logits_fake": logits_fake.detach().mean(), **self._health_columns()}
        if self.health:
            m.update(self._disc_taps.columns(self.disc_optimizer.taps))
        return m, host

    def train_step(self, images, targets=None, noise=None) -> Dict[str, Any]:
        """One step (both updates in ``gan`` mode) → {"loss", "nll_loss",
        "quant_loss", and in ``gan`` mode "disc_loss", "g_loss",
        "d_weight", "logits_real", "logits_fake"; "temperature" under a
        schedule; "step"}, or {} between ``metrics_every`` boundaries.
        ``targets`` are the segmentation one-hots (default: the images);
        ``noise`` ((b, h, w, n_embed)) replaces the gumbel quantizer's
        draw."""
        with span("vqgan/shard_batch"):
            batch = self._put_batch((images, targets, noise))
        with span("vqgan/step"):
            return self._finish_step(*self._step(*batch))

    def train_steps(self, images, targets=None, noise=None) -> Dict[str, Any]:
        """k steps on stacked (k, b, H, W, C) images, each with its own
        temperature and draws as k ``train_step`` calls take them → the last
        step's metrics plus ``loss_mean``."""
        k = len(images)
        with span("vqgan/shard_batch", k=k):
            images, targets, noise = self._put_batch((images, targets, noise), stacked=True)
        if images.dim() != 5:
            raise ValueError(f"train_steps takes stacked (k, b, H, W, C) images, got "
                             f"{tuple(images.shape)}")
        with span("vqgan/steps", k=k):
            losses = []
            for i in range(images.shape[0]):
                m, host = self._step(images[i], None if targets is None else targets[i],
                                     None if noise is None else noise[i])
                losses.append(m["loss"])
            m["loss_mean"] = torch.stack(losses).float().mean()
            return self._finish_step(m, host)

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        if self.disc is not None:
            state["disc"] = self.disc.state_dict()
            state["disc_optimizer"] = self.disc_optimizer.state_dict()
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        if self.disc is not None:
            with torch.no_grad():
                self.disc.load_state_dict(state["disc"])
            self.disc_optimizer.load_state_dict(state["disc_optimizer"])

    def _rollback_state(self) -> Dict[str, Any]:
        live = super()._rollback_state()
        if self.disc is not None:
            live["disc"] = self.disc.state_dict()
            live["disc_optimizer"] = self.disc_optimizer.state_dict()
        return live

    def _load_rollback_state(self, good):
        super()._load_rollback_state(good)
        if self.disc is not None:
            with torch.no_grad():
                self.disc.load_state_dict(good["disc"])
            self.disc_optimizer.load_state_dict(good["disc_optimizer"])

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, images) -> torch.Tensor:
        """(b, H, W, C) reconstructions on the f32 masters, deterministic."""
        recon, _, _ = self.model(self._to_images(images), deterministic=True)
        return recon

    def get_codebook_indices(self, images) -> torch.Tensor:
        return self.model.get_codebook_indices(self._to_images(images))
