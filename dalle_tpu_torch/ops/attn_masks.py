"""Static attention-mask builders for every sparse variant (numpy).

A copy of ``dalle_tpu/ops/attn_masks.py``. All masks are (seq, seq) boolean,
True = may attend, and already include causality. ``seq = text_len +
fmap**2`` where text_len counts <bos>. The transformer keeps them as int32
device tensors, so one row feeds the decode kernel's ``mask_row`` directly.
"""

from __future__ import annotations

import numpy as np


def causal_mask(seq: int) -> np.ndarray:
    return np.tril(np.ones((seq, seq), dtype=bool))


def axial_mask(text_len: int, fmap: int, axis: int) -> np.ndarray:
    """axial_row (axis=0) / axial_col (axis=1): text→text causal; image→all text;
    image→image causal along one axis only."""
    seq = text_len + fmap * fmap
    m = np.zeros((seq, seq), dtype=bool)
    m[:, :text_len] = True
    idx = np.arange(fmap * fmap)
    r, c = idx // fmap, idx % fmap
    if axis == 0:   # same row
        same = r[:, None] == r[None, :]
    else:           # same column
        same = c[:, None] == c[None, :]
    m[text_len:, text_len:] = same
    return m & causal_mask(seq)


def conv_like_mask(text_len: int, fmap: int, kernel_size: int = 5,
                   dilation: int = 1) -> np.ndarray:
    """conv_like: text→text causal; image→all text; image query (r,c) → image keys
    in the k×k dilated window whose bottom-right corner is (r,c)."""
    assert kernel_size % 2 == 1, "kernel size must be odd"
    seq = text_len + fmap * fmap
    span = (kernel_size - 1) * dilation
    m = np.zeros((seq, seq), dtype=bool)
    m[:, :text_len] = True
    idx = np.arange(fmap * fmap)
    r, c = idx // fmap, idx % fmap
    dr = r[:, None] - r[None, :]
    dc = c[:, None] - c[None, :]
    win = (dr >= 0) & (dr <= span) & (dr % dilation == 0) & \
          (dc >= 0) & (dc <= span) & (dc % dilation == 0)
    m[text_len:, text_len:] = win
    return m & causal_mask(seq)


def block_sparse_mask(seq: int, text_len: int, block: int = 128,
                      num_random_blocks: int | None = None,
                      seed: int = 0, causal: bool = True) -> np.ndarray:
    """DeepSpeed VariableSparsityConfig-equivalent pattern: global text
    blocks, local diagonal blocks, plus ``num_random_blocks`` random blocks
    per block-row (default seq//block//4); unidirectional when causal."""
    nb = (seq + block - 1) // block
    if num_random_blocks is None:
        num_random_blocks = max(seq // block // 4, 0)
    n_global = (text_len + block - 1) // block
    bm = np.zeros((nb, nb), dtype=bool)
    np.fill_diagonal(bm, True)                  # local
    bm[:, :n_global] = True                     # attend to global text blocks
    bm[:n_global, :] = True                     # global blocks attend everywhere
    rng = np.random.RandomState(seed)
    for i in range(nb):
        hi = i + 1 if causal else nb
        if hi > 0 and num_random_blocks > 0:
            cols = rng.randint(0, hi, size=num_random_blocks)
            bm[i, cols] = True
    mask = np.kron(bm, np.ones((block, block), dtype=bool))[:seq, :seq]
    if causal:
        mask &= causal_mask(seq)
    return mask


def build_mask(attn_type: str, text_len: int, fmap: int, *, kernel_size: int = 5,
               dilation: int = 1, block: int = 128,
               num_random_blocks: int | None = None, seed: int = 0) -> np.ndarray:
    """``num_random_blocks``: None or 0 → the reference default seq//block//4."""
    seq = text_len + fmap * fmap
    if attn_type == "full":
        return causal_mask(seq)
    if attn_type == "axial_row":
        return axial_mask(text_len, fmap, axis=0)
    if attn_type == "axial_col":
        return axial_mask(text_len, fmap, axis=1)
    if attn_type == "conv_like":
        return conv_like_mask(text_len, fmap, kernel_size, dilation)
    if attn_type == "sparse":
        if not num_random_blocks:   # 0/None → reference default
            num_random_blocks = None
        return block_sparse_mask(seq, text_len, block=block,
                                 num_random_blocks=num_random_blocks, seed=seed)
    raise ValueError(f'attention type "{attn_type}" is not valid')
