"""Net2Net: the conditional transformer over VQGAN codes.

Port of ``dalle_tpu/models/cond_transformer.py`` (taming's
``Net2NetTransformer``): first-stage VQGAN codes conditioned on
cond-stage codes (another VQGAN, a ``CoordStage`` or an unconditional
``SOSProvider``), a minGPT over the concatenated sequence, ``pkeep`` token
corruption in training, top-k sampling through the cached sampler
(``mingpt.make_sampler``, K2 on the card), and a permuter for the
generation order. The stages are frozen callables: ``from_vqgan`` closes
over a ``VQModel``. The corruption's draws come from the caller's
generator, or its masks are injected (``masks``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.permuter import Permuter
from .mingpt import GPT, GPTConfig, init_gpt, make_sampler


class CoordStage:
    """Coordinate conditioning (taming's ``CoordStage``): area-downsample a
    (b, H, W, 1) coordinate map in [0, 1] by ``down_factor``, quantize into
    ``n_embed`` integer bins (the top bin clamped into the vocabulary)."""

    def __init__(self, n_embed: int, down_factor: int):
        self.n_embed = n_embed
        self.down_factor = down_factor

    def encode(self, c: torch.Tensor):
        if c.dim() != 4 or c.shape[-1] != 1:
            raise ValueError(f"CoordStage takes (b, H, W, 1) maps, got {tuple(c.shape)}")
        b, h, w, _ = c.shape
        f = self.down_factor
        c = c.reshape(b, h // f, f, w // f, f, 1).mean(dim=(2, 4))
        c = torch.clamp(c, 0.0, 1.0) * self.n_embed
        c_quant = torch.clamp(torch.round(c), max=self.n_embed - 1)
        return c_quant, c_quant.long().reshape(b, -1)

    def decode(self, c_quant: torch.Tensor):
        c = (c_quant / self.n_embed).permute(0, 3, 1, 2)
        c = F.interpolate(c, scale_factor=self.down_factor, mode="nearest")
        return c.permute(0, 2, 3, 1)


class SOSProvider:
    """The unconditional stand-in: one start-of-sequence token per row."""

    def __init__(self, sos_token: int):
        self.sos_token = sos_token

    def encode(self, c):
        return None, torch.full((c.shape[0], 1), self.sos_token, dtype=torch.long,
                                device=c.device)


class Net2NetTransformer:
    """A GPT with frozen first and cond stages: ``first_stage_encode(x)`` →
    (b, n) ids, ``first_stage_decode(ids)`` → images, ``cond_encode(c)`` →
    (…, (b, m) ids) or ids."""

    def __init__(self, gpt: GPT, first_stage_encode: Callable, first_stage_decode: Callable,
                 cond_encode: Callable, permuter: Optional[Permuter] = None,
                 pkeep: float = 1.0, first_stage_vocab: Optional[int] = None):
        self.gpt = gpt
        self.first_stage_encode = first_stage_encode
        self.first_stage_decode = first_stage_decode
        self.cond_encode = cond_encode
        self.permuter = permuter
        self.pkeep = pkeep
        # ids at or above this are cond-stage vocabulary: never sampled into z
        self.first_stage_vocab = first_stage_vocab
        self._samplers = {}

    @classmethod
    def from_vqgan(cls, gpt_cfg: GPTConfig, vq_model, *, cond_encode: Callable,
                   permuter: Optional[Permuter] = None, pkeep: float = 1.0,
                   gpt: Optional[GPT] = None, seed: int = 0, device=None):
        """Over a ``VQModel`` (images in [-1, 1]); the GPT is ``gpt`` or a
        new one from ``seed`` on the VQGAN's device unless ``device``."""
        if gpt is None:
            gpt = init_gpt(gpt_cfg, seed=seed,
                           device=device or vq_model.codebook.weight.device)
        return cls(gpt, vq_model.get_codebook_indices, vq_model.decode_code, cond_encode,
                   permuter, pkeep, first_stage_vocab=vq_model.cfg.n_embed)

    # -- token plumbing ------------------------------------------------------
    def encode_to_z(self, x) -> torch.Tensor:
        with torch.no_grad():
            ids = self.first_stage_encode(x)
        return self.permuter(ids) if self.permuter is not None else ids

    def encode_to_c(self, c) -> torch.Tensor:
        with torch.no_grad():
            out = self.cond_encode(c)
        ids = out[-1] if isinstance(out, tuple) else out
        return ids.reshape(ids.shape[0], -1)

    def decode_to_img(self, ids) -> torch.Tensor:
        if self.permuter is not None:
            ids = self.permuter(ids, reverse=True)
        with torch.no_grad():
            return self.first_stage_decode(ids)

    # -- training ------------------------------------------------------------
    def forward(self, x, c, *, generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                train: bool = True):
        """→ (logits over the z positions, target z ids). In training with
        ``pkeep`` < 1 each input id is kept with probability ``pkeep`` and
        else replaced by a uniform id of the GPT's vocabulary: ``masks`` =
        (keep (b, n) bool, replacement ids (b, n)) when given, else drawn
        from ``generator``."""
        z = self.encode_to_z(x)
        c_ids = self.encode_to_c(c)
        a = z
        if train and self.pkeep < 1.0:
            if masks is None:
                keep = torch.rand(z.shape, generator=generator, device=z.device) < self.pkeep
                rand = torch.randint(0, self.gpt.cfg.vocab_size, z.shape, generator=generator,
                                     device=z.device)
            else:
                keep, rand = (t.to(z.device) for t in masks)
            a = torch.where(keep, z, rand.to(z.dtype))
        cz = torch.cat([c_ids, a], dim=1)
        logits = self.gpt(cz[:, :-1], deterministic=not train, generator=generator)
        return logits[:, c_ids.shape[1] - 1:], z

    def loss(self, x, c, **kw) -> torch.Tensor:
        """Mean cross-entropy of the z positions (``forward``'s keywords)."""
        logits, target = self.forward(x, c, **kw)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, target[..., None]).mean()

    # -- sampling ------------------------------------------------------------
    def sample(self, c_images, steps: int, *, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, temperature: float = 1.0,
               top_k: Optional[int] = None, z_prime: Optional[torch.Tensor] = None,
               return_ids: bool = False):
        """``steps`` z tokens conditioned on ``c_images`` (after ``z_prime``
        when given), decoded to images; with ``return_ids`` (images, z ids).
        ``noise`` (steps, b, vocab) replaces the generator's draws."""
        c_ids = self.encode_to_c(c_images)
        prompt = c_ids if z_prime is None else torch.cat([c_ids, z_prime], dim=1)
        key = (steps, top_k, temperature)
        if key not in self._samplers:
            self._samplers[key] = make_sampler(self.gpt, steps, top_k=top_k,
                                               temperature=temperature,
                                               vocab_limit=self.first_stage_vocab)
        out = self._samplers[key](prompt, generator=generator, noise=noise)
        z = out[:, c_ids.shape[1]:]
        images = self.decode_to_img(z)
        return (images, z) if return_ids else images
