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
* An int8-weight tree (``dalle_tpu``'s ``quantize_params_int8``: int8
  ``kernel`` leaves beside a ``quant`` collection of scales) maps to the
  port's int8 state: an int8 kernel (in, out) → weight (out, in) as any
  kernel, its ``quant/…/kernel_scale`` (1, out) → ``….weight_scale``
  (out,), and ``shared_emb_scale`` (rows, 1) stays as it is. Loading it
  makes the ``QLinear``s and the tied table int8
  (``ops/quantize_weights.py``).
* ConvTranspose kernel (the dVAE decoder's ``up_*``): flax does not flip its
  kernel, torch's transposed convolution does, so the kernel is flipped
  spatially and laid out (in, out, kh, kw); see ``models/dvae.py``.

An optax Adam/AdamW state maps the same way: its first and second moments
(``mu``, ``nu``) are trees shaped like the params, so each leaf takes the
path and the layout of its parameter (``adam_state_from_optax``). An optax
Adafactor state (``FactoredState``) holds, for a factored parameter, the
moving averages of g² over its largest axis (``v_row``) and its
second-largest (``v_col``): each takes its parameter's layout with the
averaged axis kept at size 1; where the two sizes tie, the port may average
over the other physical axis (a square ``Linear``), and ``v_row`` and
``v_col`` swap (``adafactor_state_from_optax``). ``optimizer_state_from_optax`` adds the
``MultiSteps`` accumulator and the plateau schedule's state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .train.train_state import factored_dims


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


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A host tensor of ``x``; numpy's bfloat16 (``ml_dtypes``, which torch
    does not take) goes across through f32, exactly."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree ({"params": ...} or the bare params) to a
    ``state_dict``."""
    tree = params.get("params", params)
    out = {}
    for path, x in _leaves(tree):
        leaf, y = _convert_leaf(path, x)
        out[".".join(path[:-1] + (leaf,))] = _tensor(y)
    for path, x in _leaves(params.get("quant", {})):
        if path[-1] == "kernel_scale":
            key, x = path[:-1] + ("weight_scale",), x.reshape(-1)
        elif path[-1] == "shared_emb_scale":
            key = path
        else:
            raise ValueError(f"unexpected quant leaf {'/'.join(path)}")
        out[".".join(key)] = torch.from_numpy(np.array(x, dtype=np.float32))
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


def _find_state(state, attrs: Tuple[str, ...]):
    """The first node of an optax state tree with every field of ``attrs``
    (e.g. ``ScaleByAdamState``'s count, mu, nu); None when there is none."""
    if all(hasattr(state, a) for a in attrs):
        return state
    children = (state.values() if isinstance(state, Mapping)
                else state if isinstance(state, (tuple, list)) else ())
    for child in children:
        found = _find_state(child, attrs)
        if found is not None:
            return found
    return None


def _find_adam_state(state):
    return _find_state(state, ("count", "mu", "nu"))


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


def _port_axis(path: Tuple[str, ...], ndim: int, jax_axis: int) -> int:
    """Where axis ``jax_axis`` of a leaf at ``path`` lands in the port's
    layout (``_convert_leaf`` on a probe with distinct sizes)."""
    _, out = _convert_leaf(path, np.empty(tuple(range(2, 2 + ndim)), np.float32))
    return list(out.shape).index(2 + jax_axis)


def _by_name(tree, names: List[str], what: str) -> List[torch.Tensor]:
    sd = flax_to_state_dict(tree)
    if set(sd) != set(names):
        raise ValueError(f"optax {what} do not match the parameters: "
                         f"{sorted(set(sd) ^ set(names))}")
    return [sd[n] for n in names]


def adafactor_state_from_optax(opt_state, params: Mapping[str, Any],
                               names: List[str]) -> Tuple[int, Dict[str, list]]:
    """An optax Adafactor state (``FactoredState``: count, v_row, v_col, v)
    over the flax ``params`` → (count, the port's ``_Adafactor`` state:
    ``v_row``, ``v_col``, ``v`` lists in the order of ``names``, None where
    a parameter holds none). Each statistic takes its parameter's layout
    with its averaged axis kept at size 1; the port factors over the two
    largest axes of its own layout, and where the two sizes tie argsort's
    order can pick the other physical axis (a square ``to_out``): there
    ``v_row`` and ``v_col`` swap."""
    fs = _find_state(opt_state, ("count", "v_row", "v_col", "v"))
    if fs is None:
        raise ValueError("no Adafactor state (count, v_row, v_col, v) in the optax state")
    tree = params.get("params", params)
    rows = dict(_leaves(fs.v_row.get("params", fs.v_row)))
    cols = dict(_leaves(fs.v_col.get("params", fs.v_col)))
    fulls = dict(_leaves(fs.v.get("params", fs.v)))
    out: Dict[str, Dict[str, Optional[torch.Tensor]]] = {}
    for path, p in _leaves(tree):
        leaf, port_p = _convert_leaf(path, p)
        name = ".".join(path[:-1] + (leaf,))
        st = out[name] = {"v_row": None, "v_col": None, "v": None}
        dims = factored_dims(p.shape)
        if dims is None:
            st["v"] = torch.from_numpy(np.array(_convert_leaf(path, fulls[path])[1]))
            continue
        port_dims = factored_dims(port_p.shape)
        for stat, axis in ((rows[path], dims[1]), (cols[path], dims[0])):
            q = _port_axis(path, p.ndim, axis)
            _, full = _convert_leaf(path, np.expand_dims(stat, axis))
            # the port averages over its largest axis into v_row
            key = "v_row" if q == port_dims[1] else "v_col"
            st[key] = torch.from_numpy(np.array(np.squeeze(full, q)))
    if set(out) != set(names):
        raise ValueError(f"optax Adafactor state does not match the parameters: "
                         f"{sorted(set(out) ^ set(names))}")
    return (int(np.asarray(fs.count)),
            {k: [out[n][k] for n in names] for k in ("v_row", "v_col", "v")})


PLATEAU_FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count",
                  "avg_value")


def optimizer_state_from_optax(opt_state, params: Mapping[str, Any], names: List[str],
                               optimizer: str) -> Dict[str, Any]:
    """A JAX trainer's whole optax state → the port's ``Optimizer.state_dict``
    (host tensors): the core's (Adam/AdamW ``mu``/``nu``, or Adafactor's
    statistics), its count, and where present the ``MultiSteps``
    accumulator with its mini-step and the plateau schedule's state. The
    runtime lr scale lives beside the optax state (``TrainState.lr_scale``)
    and is not part of it."""
    if optimizer in ("adam", "adamw"):
        count, state = adam_state_from_optax(opt_state, names)
        core = {"mu": [state[i]["exp_avg"] for i in range(len(names))],
                "nu": [state[i]["exp_avg_sq"] for i in range(len(names))]}
    elif optimizer == "adafactor":
        count, core = adafactor_state_from_optax(opt_state, params, names)
    else:
        raise ValueError(f"no optax state converter for {optimizer!r}")
    multi = _find_state(opt_state, ("mini_step", "gradient_step", "acc_grads"))
    plateau = _find_state(opt_state, PLATEAU_FIELDS)
    return {"optimizer": optimizer, "count": count, "core": core,
            "mini_step": 0 if multi is None else int(np.asarray(multi.mini_step)),
            "acc": None if multi is None else _by_name(multi.acc_grads, names,
                                                       "accumulated gradients"),
            "plateau": None if plateau is None else {
                k: torch.from_numpy(np.array(getattr(plateau, k))) for k in PLATEAU_FIELDS},
            "lr_scale": None}
