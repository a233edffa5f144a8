"""Rotary position embeddings: numpy table builders, tensor application.

The tables are the JAX package's (``dalle_tpu/ops/rotary.py``), copied:
``lang`` freqs 1/theta^(2i/dim), ``pixel`` freqs linspace(1, max_freq/2)·π,
each repeated twice adjacently; text positions over the lang bank with image
tokens pinned at 8192, image tokens over a 2D axial pixel bank with text
pinned at -10. ``apply_rotary`` rotates the leading slice of each head dim.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lang_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))


def pixel_freqs(dim: int, max_freq: float = 10.0) -> np.ndarray:
    return np.linspace(1.0, max_freq / 2, dim // 2).astype(np.float32) * math.pi


def freqs_table(positions: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """outer(positions, freqs) with each column doubled adjacently → (n, 2*(dim//2))."""
    table = np.einsum("i,j->ij", positions.astype(np.float32), freqs)
    return np.repeat(table, 2, axis=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise (x1,x2) → (-x2,x1) on adjacent feature pairs."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rotary(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``freqs.shape[-1]`` features of ``t``; pass the rest
    through. The angles are cast to ``t``'s dtype before cos/sin, as in the
    JAX package."""
    rot_dim = freqs.shape[-1]
    freqs = freqs.to(t.dtype)
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    t_rot = t_rot * freqs.cos() + rotate_half(t_rot) * freqs.sin()
    return torch.cat((t_rot, t_pass), dim=-1)


def dalle_pos_emb(text_len: int, image_fmap_size: int, dim_head: int) -> np.ndarray:
    """The DALLE combined rotary table, shape (text_len + fmap², 3·2·(rot//2)).
    ``text_len`` includes the <bos> slot."""
    rot_dim = dim_head // 3
    img_seq_len = image_fmap_size ** 2
    lang = lang_freqs(rot_dim)
    pixel = pixel_freqs(rot_dim)

    # 1D lang-band: text positions 0..text_len-1; images pinned far away at 8192
    text_freqs = freqs_table(np.arange(text_len), lang)
    img_to_text = freqs_table(np.full((img_seq_len,), 8192.0), lang)
    band1 = np.concatenate((text_freqs, img_to_text), axis=0)

    # 2D pixel-band: rows/cols over linspace(-1,1); text pinned at -10 on both axes
    axial = freqs_table(np.linspace(-1.0, 1.0, image_fmap_size), pixel)  # (f, d)
    rows = np.broadcast_to(axial[:, None, :], (image_fmap_size, image_fmap_size, axial.shape[-1]))
    cols = np.broadcast_to(axial[None, :, :], (image_fmap_size, image_fmap_size, axial.shape[-1]))
    img2d = np.concatenate((rows, cols), axis=-1).reshape(img_seq_len, -1)
    text_axial = freqs_table(np.full((text_len,), -10.0), pixel)
    text_axial = np.concatenate((text_axial, text_axial), axis=-1)
    band2 = np.concatenate((text_axial, img2d), axis=0)

    return np.concatenate((band1, band2), axis=-1)
