"""Model-health taps: the training step's vitals and the decode-quality
taps, as device scalars.

Port of ``dalle_tpu/obs/health.py`` under its names and metric keys. Every
tap reduces tensors the step already holds, in f32 whatever the compute
dtype, and returns tensors on their device: the trainers put them in the
step's metrics dict, so they ride the step's one host read of its metrics
and add no synchronisation. Keys are ``health/<metric>/<layer_group>`` or
``health/<metric>`` for model-wide taps; :mod:`.anomaly` turns them into
``dalle_health_*`` gauges, breach events and ``obs_report``'s MODEL-HEALTH
verdict.

**Layer groups** are the JAX package's: a parameter's flax path, its
``params`` levels dropped, cut to ``depth`` components (1 on DALL·E:
``image_emb``, ``text_emb``, ``transformer``, ...), namespaced by
``prefix`` (``gen``/``disc`` on the VQGAN). A port parameter's flax path
comes from the converter's name map (``convert.flax_path``), not from its
torch name. ``layer_groups`` and the reductions below take a nested mapping
of tensors (a flax-layout tree) or a module (its parameters under their
flax paths; ``module_tree`` builds the mapping, of the parameters or of
their gradients).

The trainers do not walk trees: ``GroupTaps`` sums the optimizer's
per-parameter reductions (``train_state.StepTaps``) into groups, a handful
of small ops a step. The decode-quality taps (``decode_quality``) are the
serve engine's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

# the flat-key naming contract is the host-side consumers' (anomaly.py)
from .anomaly import HEALTH_PREFIX, split_health_key  # noqa: F401


def module_tree(module: torch.nn.Module, grads: bool = False) -> Dict:
    """``module``'s parameters (``grads``: their ``.grad``, zeros where
    none) as a nested dict under their flax paths."""
    from ..convert import flax_path
    tree: Dict = {}
    for name, p in module.named_parameters():
        *parents, leaf = flax_path(module, name)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = (p.grad if p.grad is not None else torch.zeros_like(p)) if grads else p
    return tree


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _group_key(path: Sequence[str], depth: int, prefix: str) -> str:
    parts = [p for p in path if p != "params"]
    key = "/".join(parts[:depth]) if parts else ""
    if prefix:
        key = f"{prefix}/{key}" if key else prefix
    return key or "root"


def layer_groups(tree, depth: int = 1, prefix: str = "") -> Dict[str, list]:
    """The leaves of ``tree`` (a nested mapping in the flax layout, or a
    module) grouped by truncated path: ``{group: [leaves]}``, in the JAX
    package's order (leaves by sorted path)."""
    if isinstance(tree, torch.nn.Module):
        tree = module_tree(tree)
    out: Dict[str, list] = {}
    for path, leaf in _leaves(tree):
        out.setdefault(_group_key(path, depth, prefix), []).append(leaf)
    return out


def _sq_sum_f32(leaves) -> torch.Tensor:
    """Σ x² over a leaf list, each element upcast to f32 before the square."""
    total = None
    for leaf in leaves:
        if not leaf.is_floating_point():
            continue
        x = leaf.detach().float()
        s = torch.sum(x * x)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros(())


def group_norms(tree, depth: int = 1, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Per-layer-group L2 norms of a tree (f32 scalars, on its device)."""
    return {g: torch.sqrt(_sq_sum_f32(ls))
            for g, ls in layer_groups(tree, depth, prefix).items()}


def nonfinite_fractions(tree, depth: int = 1, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Per-group fraction of non-finite (inf/nan) elements: the NaN
    precursor, seen before the loss itself goes NaN."""
    out = {}
    for g, ls in layer_groups(tree, depth, prefix).items():
        fl = [leaf for leaf in ls if leaf.is_floating_point()]
        if not fl:
            continue
        n = sum(leaf.numel() for leaf in fl)
        bad = sum(torch.sum(~torch.isfinite(leaf.detach())).float() for leaf in fl)
        out[g] = bad / float(n)
    return out


def tree_health(grads, params, updates=None, *, depth: int = 1,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """The per-layer-group training vitals as ``health/*`` columns:

      * ``health/grad_norm/<g>``: L2 of this step's gradients;
      * ``health/param_norm/<g>``: L2 of the parameters after the update;
      * ``health/update_ratio/<g>``: |update| / |param|, the step the
        optimizer took;
      * ``health/nonfinite_frac/<g>``: inf/nan fraction of the gradients.
    """
    metrics: Dict[str, torch.Tensor] = {}
    for g, v in group_norms(grads, depth, prefix).items():
        metrics[f"{HEALTH_PREFIX}grad_norm/{g}"] = v
    pnorms = group_norms(params, depth, prefix)
    for g, v in pnorms.items():
        metrics[f"{HEALTH_PREFIX}param_norm/{g}"] = v
    if updates is not None:
        for g, v in group_norms(updates, depth, prefix).items():
            pn = pnorms.get(g)
            if pn is not None:
                metrics[f"{HEALTH_PREFIX}update_ratio/{g}"] = v / (pn + 1e-12)
    for g, v in nonfinite_fractions(grads, depth, prefix).items():
        metrics[f"{HEALTH_PREFIX}nonfinite_frac/{g}"] = v
    return metrics


class GroupTaps:
    """``tree_health`` for one optimizer's parameters, from its per-parameter
    reductions: ``columns(optimizer.taps)`` sums them into the layer groups
    of ``names`` (the parameters of ``module``, in the optimizer's order).
    Built once a trainer; each call is a few small ops on the device and
    no host read."""

    def __init__(self, module: torch.nn.Module, names: Sequence[str],
                 params: Sequence[torch.Tensor], depth: int = 1, prefix: str = ""):
        from ..convert import flax_path
        paths: List[Tuple[str, ...]] = [flax_path(module, n) for n in names]
        keys = [_group_key(p, depth, prefix) for p in paths]
        # the JAX order: a group first seen at its smallest path
        first = {}
        for p, k in sorted(zip(paths, keys)):
            first.setdefault(k, len(first))
        self.groups = sorted(first, key=first.get)
        device = params[0].device
        assign = torch.zeros(len(self.groups), len(keys))
        for j, k in enumerate(keys):
            assign[first[k], j] = 1.0
        self._assign = assign.to(device)
        self._numel = (assign * torch.tensor([float(p.numel()) for p in params])).sum(1).to(device)

    def _sum(self, per_param: torch.Tensor) -> torch.Tensor:
        return (self._assign * per_param).sum(1)

    def columns(self, taps) -> Dict[str, torch.Tensor]:
        """The ``health/*`` columns of one ``StepTaps``, in ``tree_health``'s
        order."""
        grad = self._sum(taps.grad_sq).sqrt()
        param = self._sum(taps.param_sq).sqrt()
        ratio = self._sum(taps.update_sq).sqrt() / (param + 1e-12)
        bad = self._sum(taps.nonfinite) / self._numel
        out: Dict[str, torch.Tensor] = {}
        for metric, vals in (("grad_norm", grad), ("param_norm", param),
                             ("update_ratio", ratio), ("nonfinite_frac", bad)):
            for i, g in enumerate(self.groups):
                out[f"{HEALTH_PREFIX}{metric}/{g}"] = vals[i]
        return out


def codebook_health(indices: torch.Tensor, num_tokens: int,
                    prefix: str = "codebook") -> Dict[str, torch.Tensor]:
    """Codebook-usage vitals from a batch's token indices (any int shape):

      * ``health/<p>_perplexity``: exp(entropy of the usage distribution),
        ``num_tokens`` at uniform usage, → 1 as the codebook collapses;
      * ``health/<p>_dead_frac``: fraction of codes unused in this batch;
      * ``health/<p>_usage_entropy``: the entropy (nats).

    The histogram is an ``index_add_`` into ``num_tokens`` bins
    (``torch.bincount`` reads its size back from the card)."""
    idx = indices.reshape(-1)
    counts = torch.zeros(num_tokens, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    p = counts / float(idx.shape[0])
    pos = p > 0
    ent = -torch.sum(torch.where(pos, p * torch.log(torch.where(pos, p, torch.ones_like(p))),
                                 torch.zeros_like(p)))
    return {
        f"{HEALTH_PREFIX}{prefix}_perplexity": torch.exp(ent),
        f"{HEALTH_PREFIX}{prefix}_dead_frac": torch.mean((counts == 0).float()),
        f"{HEALTH_PREFIX}{prefix}_usage_entropy": ent,
    }


def gumbel_health(logits: torch.Tensor, one_hot: torch.Tensor, temp) -> Dict[str, torch.Tensor]:
    """Gumbel / straight-through vitals of the relaxed quantizers:

      * ``health/gumbel_temp``: the annealed temperature;
      * ``health/st_sharpness``: mean max of the (relaxed) one-hot the
        decoder consumed, ≈ 1 when hard;
      * ``health/encoder_confidence``: mean max softmax probability of the
        encoder's logits (temperature-free).
    """
    probs = torch.softmax(logits.float(), dim=-1)
    return {
        f"{HEALTH_PREFIX}gumbel_temp": logits.new_full((), float(temp), dtype=torch.float32),
        f"{HEALTH_PREFIX}st_sharpness": torch.mean(torch.amax(one_hot.float(), dim=-1)),
        f"{HEALTH_PREFIX}encoder_confidence": torch.mean(torch.amax(probs, dim=-1)),
    }


def decode_quality(logits: torch.Tensor, topk: int = 32) -> Dict[str, torch.Tensor]:
    """Per-row stats of (B, V) next-token logits, (B,) f32 each:

      * ``entropy``: nats of the next-token distribution;
      * ``topk_mass``: the probability mass of the ``topk`` most likely
        tokens (all of them when ``topk`` ≥ V).

    In f32 whatever the logits' dtype (bf16 and int8w engines emit bf16)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(lp)
    ent = -torch.sum(p * lp, dim=-1)
    k = min(int(topk), logits.shape[-1])
    top = torch.topk(p, k, dim=-1).values
    return {"entropy": ent, "topk_mass": torch.sum(top, dim=-1)}
