"""Flax parameter trees (as numpy) → the port's ``state_dict``s.

The port names its modules after the flax tree, so a parameter's path maps
across one to one; only leaves change:

* Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in). ``to_qkv`` keeps
  its head-major [q|k|v] column order, which ``Attention._split`` expects.
* LayerNorm ``scale``/``bias`` → ``weight``/``bias``; LayerScale ``scale``
  (1, 1, dim) stays ``scale``.
* ``Embed.embedding`` → ``Embedding.weight``; ``shared_emb``,
  ``logits_bias`` and the axial ``row``/``col`` tables map across as they are.
* Conv kernel HWIO → OIHW.
* ConvTranspose kernel (the dVAE decoder's ``up_*``): flax does not flip its
  kernel, torch's transposed convolution does, so the kernel is flipped
  spatially and laid out (in, out, kh, kw); see ``models/dvae.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_leaf(path: Tuple[str, ...], x: np.ndarray):
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 4 and parent.startswith("up_"):
            return "weight", x[::-1, ::-1].transpose(2, 3, 0, 1)
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {x.shape}")
    if name == "scale" and x.ndim == 1:
        return "weight", x
    if name == "embedding":
        return "weight", x
    return name, x


def flax_to_state_dict(params: Mapping[str, Any], *,
                       skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree ({"params": ...} or the bare params) to a
    ``state_dict``; top-level subtrees named in ``skip`` are left out."""
    if "quant" in params:
        raise NotImplementedError("int8-quantized weights are not ported yet")
    tree = params.get("params", params)
    out = {}
    for path, x in _leaves(tree):
        if path[0] in skip:
            continue
        leaf, y = _convert_leaf(path, x)
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.ascontiguousarray(y))
    return out


def dalle_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``models/dalle.DALLE`` state_dict from ``dalle_tpu``'s DALLE params."""
    return flax_to_state_dict(params)


def dvae_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``models/dvae.DiscreteVAE`` state_dict from ``dalle_tpu``'s dVAE
    params (the encoder is not ported yet and is left out)."""
    return flax_to_state_dict(params, skip=("encoder",))
