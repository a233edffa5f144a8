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

An optax Adam/AdamW state maps the same way: its first and second moments
(``mu``, ``nu``) are trees shaped like the params, so each leaf takes the
path and the layout of its parameter (``adam_state_from_optax``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

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


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree ({"params": ...} or the bare params) to a
    ``state_dict``."""
    if "quant" in params:
        raise NotImplementedError("int8-quantized weights are not ported yet")
    tree = params.get("params", params)
    out = {}
    for path, x in _leaves(tree):
        leaf, y = _convert_leaf(path, x)
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.array(y))
    return out


def dalle_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``models/dalle.DALLE`` state_dict from ``dalle_tpu``'s DALLE params."""
    return flax_to_state_dict(params)


def dvae_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``models/dvae.DiscreteVAE`` state_dict from ``dalle_tpu``'s dVAE
    params, encoder and decoder."""
    return flax_to_state_dict(params)


def clip_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``models/clip.CLIP`` state_dict from ``dalle_tpu``'s CLIP params: the
    embeddings, the biased ``to_visual_embedding``, the two towers, the
    latent projections and the root scalar ``temperature``."""
    return flax_to_state_dict(params)


def _find_adam_state(state):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (``ScaleByAdamState``); None when there is none."""
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state
    children = (state.values() if isinstance(state, Mapping)
                else state if isinstance(state, (tuple, list)) else ())
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def adam_state_from_optax(opt_state, names: List[str]) -> Tuple[int, Dict[int, Dict]]:
    """An optax Adam/AdamW state → (step count, the ``state`` part of a
    ``torch.optim.Adam``/``AdamW`` state_dict) for the parameters ``names``,
    in the optimizer's parameter order (``model.named_parameters()``):
    ``exp_avg`` from ``mu``, ``exp_avg_sq`` from ``nu``, ``step`` from
    ``count``. Leaves are numpy or anything ``np.asarray`` takes."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    count = int(np.asarray(adam.count))
    mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError(f"optax moments do not match the parameters: "
                         f"{sorted(set(mu) ^ set(names))}")
    step = torch.tensor(float(count))
    return count, {i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                   for i, name in enumerate(names)}
