"""int8 weight quantization for the decode path.

Port of ``dalle_tpu/ops/quantize_weights.py``. A decode step of one token
reads every weight matrix for a few rows of work, so it is bound by weight
bytes: int8 weights with one f32 scale per output channel halve them
against bf16. ``QLinear`` is the JAX package's ``QDense``: an
``nn.Linear`` (the same ``weight``/``bias`` names, shapes, init and float
behaviour) that, once its weight is int8, holds a per-output-channel
``weight_scale`` buffer (N,) and multiplies through the W8 kernel
(``ops/int8w_linear.py``), which converts the int8 bytes in registers so
that only they cross HBM.

Symmetric per-channel quantization: scale = max(amax, 1e-8) / 127 over the
contraction axis, q = clip(round(w / scale), -127, 127), round half to
even. The port's Linear weight is (out, in), so the JAX package's
contraction axis 0 of a (in, out) kernel is the port's axis 1; the int8
values and scales equal the JAX package's bit for bit from the same f32
weights.
"""

from __future__ import annotations

import copy
import torch
from torch import nn

from .int8w_linear import int8w_linear


class QLinear(nn.Linear):
    """``nn.Linear`` that runs the W8 product when its weight is int8.

    ``set_int8(q, scale)`` turns the layer int8: ``weight`` becomes an int8
    parameter without gradient and ``weight_scale`` the (out,) f32 scales.
    ``load_state_dict`` of an int8 ``weight`` with its ``weight_scale``
    makes the layer int8; a float state into an int8 layer is refused (it
    would be cast to int8 without scales). The scales stay f32 through a
    cast of the module."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.register_buffer("weight_scale", None)

    @property
    def is_int8(self) -> bool:
        return self.weight.dtype == torch.int8

    def set_int8(self, q: torch.Tensor, scale: torch.Tensor) -> "QLinear":
        if q.dtype != torch.int8 or tuple(q.shape) != tuple(self.weight.shape):
            raise ValueError(f"int8 weight must be int8 {tuple(self.weight.shape)}, "
                             f"got {q.dtype} {tuple(q.shape)}")
        if tuple(scale.shape) != (self.out_features,):
            raise ValueError(f"weight_scale must be ({self.out_features},), "
                             f"got {tuple(scale.shape)}")
        self.weight = nn.Parameter(q.to(self.weight.device).contiguous(),
                                   requires_grad=False)
        self.weight_scale = scale.to(self.weight.device, torch.float32).contiguous()
        return self

    def _apply(self, fn, recurse=True):
        scale = self.weight_scale
        super()._apply(fn, recurse)
        if scale is not None:
            # a cast of the module (``.to(torch.bfloat16)``) moves the scales
            # with it but keeps them f32
            self.weight_scale = scale.to(self.weight.device)
        return self

    def forward(self, x):
        if self.is_int8:
            if self.weight_scale is None:
                raise ValueError("int8 weight without a weight_scale: quantize with "
                                 "quantize_params_int8")
            return int8w_linear(x, self.weight, self.weight_scale, self.bias)
        return super().forward(x)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        w = state_dict.get(prefix + "weight")
        if w is not None and (w.dtype == torch.int8) != self.is_int8:
            scale = state_dict.get(prefix + "weight_scale")
            if w.dtype != torch.int8 or scale is None:
                error_msgs.append(f"{prefix}weight: a {w.dtype} weight"
                                  + (" without weight_scale" if w.dtype == torch.int8 else "")
                                  + f" into a {self.weight.dtype} layer")
                return
            self.set_int8(torch.empty_like(w), torch.empty_like(scale, dtype=torch.float32))
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)


def assert_float_params(module: nn.Module) -> None:
    """Refuse a module built on plain ``nn.Linear`` (CLIP) that holds int8
    parameters: it would multiply by the int8 values without their scales.
    Only ``QLinear``-based models (DALLE) take int8 weights."""
    for p in module.parameters():
        if p.dtype == torch.int8:
            raise ValueError(
                f"{type(module).__name__} holds int8 params but is built on "
                "plain nn.Linear, which cannot apply the quant scales — int8 "
                "weight quantization is only supported for QLinear-based "
                "models (DALLE). Re-load float params for this model.")


def quantize_kernel_int8(w: torch.Tensor, axis: int = 1):
    """(int8 q, f32 scale with ``axis`` kept at size 1): symmetric per-channel
    over ``axis``, the contraction axis (1 for a (out, in) Linear weight; the
    scales attach to the outputs)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_params_int8(model: nn.Module, compute_dtype=torch.bfloat16) -> nn.Module:
    """A NEW model from ``model`` (which is not touched): every ``QLinear``
    weight int8 with per-output-channel scales, and a DALLE's tied
    ``shared_emb`` table int8 with per-row scales (rows are the output
    channels of the tied logits product and the gathered embeddings);
    every other float parameter and buffer cast to ``compute_dtype`` (None
    keeps them). Quantized from the source's own f32 values."""
    new = copy.deepcopy(model)
    if compute_dtype is not None:
        new.to(compute_dtype)
    src = dict(model.named_modules())
    for name, m in new.named_modules():
        if isinstance(m, QLinear):
            q, scale = quantize_kernel_int8(src[name].weight, axis=1)
            m.set_int8(q, scale[:, 0])
    shared = getattr(model, "shared_emb", None)
    if isinstance(shared, nn.Parameter):
        q, scale = quantize_kernel_int8(shared, axis=1)
        new.set_shared_emb_int8(q, scale)
    return new
