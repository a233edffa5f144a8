"""Attention-mode resolution and the structured mask specs.

A copy of the parts of ``dalle_tpu/ops/flash_attention.py`` that choose the
training attention: ``resolve_use_pallas`` (same setting strings) and
``elem_fn_from_spec`` (the (qpos, kpos) visibility test of the axial and
conv specs). The flash kernel itself (K4) is not ported yet: the settings
that would select it raise ``NotImplementedError``.

Where the JAX package asks for the TPU, the port asks for a CUDA device.
The TPU's ``fused_fits`` / ``fused_fwd_fits`` gates and the
``fused_qkv_attention_xbwd`` tier have no counterpart here: they budget
Mosaic's scoped VMEM, which holds the whole (n, n) score tile of a batch
row. The CUDA kernels tile the sequence, so every shape the kernel takes
runs both its forward and its backward kernel.
"""

from __future__ import annotations

from typing import Union

import torch

# the JAX package's measured dense/flash crossover on the TPU; here it only
# marks where "auto" stops choosing the fused kernel, since the flash kernel
# that takes over at and above it is not ported
PALLAS_AUTO_MIN_SEQ = 2048


def elem_fn_from_spec(spec):
    """The element visibility test of a structured mask spec,
    ("axial", text_len, fmap, axis) or ("conv", text_len, fmap, kernel,
    dilation), as a function of (qpos, kpos) arrays; None for the block spec
    and for no spec. Causality is not part of it."""
    if spec is None:
        return None
    kind = spec[0]
    if kind == "block":
        return None
    if kind == "axial":
        _, text_len, fmap, axis = spec

        def fn(qpos, kpos):
            qi, ki = qpos - text_len, kpos - text_len
            if axis == 0:
                same = (qi // fmap) == (ki // fmap)
            else:
                same = (qi % fmap) == (ki % fmap)
            img_pair = (qpos >= text_len) & (kpos >= text_len)
            return (kpos < text_len) | (img_pair & same)
        return fn
    if kind == "conv":
        _, text_len, fmap, kernel, dil = spec
        span = (kernel - 1) * dil

        def fn(qpos, kpos):
            qi, ki = qpos - text_len, kpos - text_len
            dr = qi // fmap - ki // fmap
            dc = qi % fmap - ki % fmap
            win = (dr >= 0) & (dr <= span) & (dc >= 0) & (dc <= span)
            if dil > 1:
                win &= (dr % dil == 0) & (dc % dil == 0)
            img_pair = (qpos >= text_len) & (kpos >= text_len)
            return (kpos < text_len) | (img_pair & win)
        return fn
    raise ValueError(f"unknown mask spec {spec!r}")


def resolve_use_pallas(setting: Union[str, bool], seq_len: int,
                       device=None) -> Union[str, bool]:
    """A config's ``use_pallas`` → "fused" (K1) or False (dense), for a
    model whose tensors live on ``device``.

    * "fused": K1 on any device — its CUDA kernels on the card, its plain
      version on the CPU (so CPU runs exercise the fused math).
    * "auto": K1 on the card below ``PALLAS_AUTO_MIN_SEQ`` tokens, dense on
      the CPU (as the JAX package is dense off the TPU).
    * "off"/False: dense.
    * "flash"/"on"/True (K4), "persist" (K8), and "auto" on the card at or
      above ``PALLAS_AUTO_MIN_SEQ`` (K4) raise ``NotImplementedError``:
      those kernels are not ported yet."""
    on_card = device is not None and torch.device(device).type == "cuda"
    s = str(setting).lower()
    if setting is True or s in ("1", "true", "on", "yes", "flash"):
        raise NotImplementedError(
            "use_pallas='flash' selects K4 (ops/flash_attention.py), which is "
            "not ported yet")
    if setting is False or s in ("0", "false", "off", "no", "none"):
        return False
    if s == "persist":
        raise NotImplementedError(
            "use_pallas='persist' selects K8 (ops/persistent_attention.py), "
            "which is not ported yet")
    if s == "fused":
        return "fused"
    if s == "auto":
        if not on_card:
            return False
        if seq_len >= PALLAS_AUTO_MIN_SEQ:
            raise NotImplementedError(
                f"use_pallas='auto' at seq_len {seq_len} >= "
                f"{PALLAS_AUTO_MIN_SEQ} selects K4 (ops/flash_attention.py), "
                "which is not ported yet; pass use_pallas='fused' or 'off'")
        return "fused"
    raise ValueError(
        f"use_pallas must be auto/fused/persist/on/off, got {setting!r}")
