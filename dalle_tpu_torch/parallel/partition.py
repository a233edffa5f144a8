"""Parameter partitioning: regex path rules → which dimension of each torch
parameter is split over the ``fsdp`` axis.

Port of ``dalle_tpu/parallel/partition.py``. The rules are the JAX
package's, verbatim, matched on flax paths (``convert.flax_path`` names each
torch parameter as the flax tree does), and ``spec_for`` / ``_fit_spec``
give the same ``PartitionSpec`` for the same path, shape and mesh. What the
port adds is the step from a flax spec to the torch layout
(``torch_fsdp_dim``, through ``convert._port_axis``):

* a ``Dense`` kernel (in, out) is a ``Linear.weight`` (out, in), so the
  flax ``P("fsdp", "tp")`` splits the torch weight's dim 1 over fsdp;
* a conv kernel HWIO is OIHW, so ``P(None, None, None, "fsdp")`` is dim 0
  (a transposed conv's IOHW: dim 1);
* embeddings keep their (vocabulary, feature) layout.

Only ``fsdp`` places anything in the port (``train/base_trainer.py`` keeps
each rank's slice of a master and its optimizer state). ``tp`` entries are
dropped by ``_fit_spec`` on a tp=1 mesh and tp > 1 is not trained (ROADMAP
Queue 1 item 11c). ``constrain`` and ``commit_to_mesh`` have nothing to do
in eager PyTorch and return their input.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, each None (not
    split), an axis name, or a tuple of axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# Rules: (path_regex, PartitionSpec). First match wins. Paths are '/'-joined
# flax param paths, e.g. "transformer/layers_0/attn/to_qkv/kernel".
#
# Conventions:
#   - Linear kernels are (in, out).
#   - QKV/out projections: shard the head-structured dim over tp.
#   - FF in/out: shard hidden dim over tp.
#   - Embeddings: shard vocab over tp (gives sharded logits matmul).
#   - fsdp shards the *other* large dim (ZeRO-style), composable with tp.
DEFAULT_RULES: Tuple[Tuple[str, P], ...] = (
    # attention projections
    (r".*attn.*(to_qkv|to_q|to_kv|query|key|value)/kernel$", P("fsdp", "tp")),
    (r".*attn.*(to_out|out_proj)/kernel$",                   P("tp", "fsdp")),
    # feed-forward
    (r".*(ff|mlp).*(w1|wi|fc1|dense_in)/kernel$",            P("fsdp", "tp")),
    (r".*(ff|mlp).*(w2|wo|fc2|dense_out)/kernel$",           P("tp", "fsdp")),
    # embeddings + output head. Vocab shards over BOTH axes with the feature
    # dim replicated: a gather from a vocab-sharded table emits a replicated
    # feature dim, so activations stay batch-sharded at remat-block boundaries
    # (feature-sharded tables force an involuntary full-remat reshard in the
    # SPMD partitioner: dim-over-fsdp gather output vs batch-over-(dp,fsdp)
    # block inputs).
    (r".*(tok_emb|text_emb|image_emb|embedding)/embedding$", P(("tp", "fsdp"),)),
    (r".*(to_logits|logits|head)/kernel$",                   P("fsdp", "tp")),
    # conv kernels (dVAE/VQGAN): shard output channels over fsdp only
    (r".*conv.*/kernel$",                                    P(None, None, None, "fsdp")),
    # biases / norms / scales: replicate ('g' only as a full component name)
    (r".*(bias|scale|embedding_pos)$|(^|.*/)g$",             P()),
)


def spec_for(path: str, shape: Tuple[int, ...],
             rules: Optional[Sequence[Tuple[str, P]]] = None,
             mesh=None) -> P:
    """The spec of the flax leaf at ``path`` with ``shape`` on ``mesh``."""
    rules = DEFAULT_RULES if rules is None else rules
    for pat, spec in rules:
        if re.match(pat, path):
            return _fit_spec(spec, shape, mesh)
    return P()


def _fit_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Clip a spec to the array rank and drop axes that don't divide the dim
    (falls back to replication on that dim, like t5x's logical-axis
    fallback). Size-1 mesh axes are dropped from tuple entries: ``('tp',
    'fsdp')`` on a tp=1 mesh becomes ``'fsdp'``, the JAX package's
    spelling."""
    parts = list(spec)
    parts = parts[: len(shape)] + [None] * (len(shape) - len(parts))
    if mesh is not None:
        for i, ax in enumerate(parts):
            if ax is None:
                continue
            axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                         if mesh.shape.get(a, 1) > 1)
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            if size == 1 or shape[i] % size != 0:
                parts[i] = None
            else:
                parts[i] = axes[0] if len(axes) == 1 else axes
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _flax_leaf(module, name: str, shape: Tuple[int, ...]):
    """(flax path string, flax shape) of the torch parameter ``name``."""
    from ..convert import _port_axis, flax_path
    path = flax_path(module, name)
    ndim = len(shape)
    flax_shape = tuple(shape[_port_axis(path, ndim, j)] for j in range(ndim))
    return path, flax_shape


def torch_fsdp_dim(module, name: str, shape: Tuple[int, ...], mesh,
                   rules: Optional[Sequence[Tuple[str, P]]] = None) -> Optional[int]:
    """The dimension of the torch parameter ``name`` (of ``shape``) that the
    rules split over ``fsdp`` on ``mesh``, or None (replicated)."""
    from ..convert import _port_axis
    path, flax_shape = _flax_leaf(module, name, tuple(shape))
    spec = spec_for("/".join(path), flax_shape, rules, mesh)
    for j, ax in enumerate(spec):
        if ax == "fsdp" or (isinstance(ax, tuple) and "fsdp" in ax):
            return _port_axis(path, len(shape), j)
    return None


def make_param_shardings(mesh, module, rules=None) -> Dict[str, Optional[int]]:
    """{parameter name: its fsdp dimension or None} for ``module``."""
    return {n: torch_fsdp_dim(module, n, tuple(p.shape), mesh, rules)
            for n, p in module.named_parameters()}


def shard_params(mesh, module, params: Dict[str, "np.ndarray"], rules=None):
    """This rank's slice of each full tensor in ``params`` (named as
    ``module``'s parameters): its fsdp dimension cut into ``mesh``'s fsdp
    parts, part ``coords["fsdp"]``; replicated leaves whole."""
    dims = make_param_shardings(mesh, module, rules)
    parts, index = mesh.shape["fsdp"], mesh.coords["fsdp"]
    out = {}
    for n, x in params.items():
        d = dims.get(n)
        if d is None:
            out[n] = x
        else:
            k = x.shape[d] // parts
            out[n] = x.narrow(d, index * k, k) if hasattr(x, "narrow") else \
                np.take(x, range(index * k, (index + 1) * k), axis=d)
    return out


def constrain(mesh, x, *spec_axes):
    """The JAX activation sharding constraint: eager PyTorch places each
    rank's activations where its step computes them, so ``x`` as it is."""
    return x


def commit_to_mesh(mesh, tree):
    """A no-op: it mends a JAX retrace (uncommitted scalars beside
    mesh-committed arrays) that eager PyTorch does not have."""
    return tree
