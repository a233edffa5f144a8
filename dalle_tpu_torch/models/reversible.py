"""Reversible residual blocks: activation memory constant in depth.

Port of ``dalle_tpu/models/reversible.py`` (the reference's
``ReversibleSequence``). The channels are duplicated into two streams, each
block computes y1 = x1 + f(x2), y2 = x2 + g(y1), and the output is the
streams' mean. ``reversible_sequence`` is a ``torch.autograd.Function``
whose forward runs the blocks without a graph and keeps only (y1, y2); its
backward walks the blocks in reverse, inverting the coupling,
x2 = y2 - g(y1) and x1 = y1 - f(x2), and recomputing each f and g under
``torch.enable_grad()`` for ``torch.autograd.grad`` at the block's inputs
and parameters. The cost is one extra forward, as in the reference.

A block function is ``f(p, h)`` with ``p`` a tuple of tensors. The backward
differentiates the recompute at those very tensors, so ``f`` may read them
from ``p`` (a pure function, as the JAX package's) or from a module whose
parameters they are (the ``Transformer``'s layers; inside a
``torch.func.functional_call`` these are the cast copies the step runs on).
A tensor used by several blocks (layers shared through ``shared_attn_ids``
/ ``shared_ff_ids``) is one input of the Function, its gradient summed over
its uses. Randomness must be fixed before the forward: the ``Transformer``
draws its dropout masks first and closes each block over its own, so the
recompute sees the same masks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

LayerFns = Tuple[Callable[[Any, torch.Tensor], torch.Tensor],
                 Callable[[Any, torch.Tensor], torch.Tensor]]


def reversible_forward_naive(fns: Sequence[LayerFns], params, x1, x2):
    """The coupling through autograd's stored activations: the oracle."""
    for (f, g), (pf, pg) in zip(fns, params):
        x1 = x1 + f(pf, x2)
        x2 = x2 + g(pg, x1)
    return x1, x2


def _grads(out, inputs: List[torch.Tensor], cotangent):
    want = [t for t in inputs if t.requires_grad]
    got = iter(torch.autograd.grad(out, want, cotangent, allow_unused=True) if want else [])
    return [next(got) if t.requires_grad else None for t in inputs]


class _Reversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fns, slots, x1, x2, *tensors):
        params = [(tuple(tensors[i] for i in sf), tuple(tensors[i] for i in sg))
                  for sf, sg in slots]
        y1, y2 = reversible_forward_naive(fns, params, x1, x2)
        ctx.fns, ctx.slots, ctx.params = fns, slots, tensors
        ctx.save_for_backward(y1, y2)
        return y1, y2

    @staticmethod
    def backward(ctx, d1, d2):
        y1, y2 = ctx.saved_tensors
        tensors = ctx.params
        grads: List[Any] = [None] * len(tensors)

        def add(slot, gs):
            for i, g in zip(slot, gs):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g

        for (f, g), (sf, sg) in zip(reversed(ctx.fns), reversed(ctx.slots)):
            pg = tuple(tensors[i] for i in sg)
            with torch.enable_grad():
                h = y1.detach().requires_grad_()
                g_out = g(pg, h)
                dh, *dpg = _grads(g_out, [h, *pg], d2)
            x2 = y2 - g_out.detach()
            if dh is not None:
                d1 = d1 + dh
            add(sg, dpg)
            pf = tuple(tensors[i] for i in sf)
            with torch.enable_grad():
                h = x2.detach().requires_grad_()
                f_out = f(pf, h)
                dh, *dpf = _grads(f_out, [h, *pf], d1)
            x1 = y1 - f_out.detach()
            if dh is not None:
                d2 = d2 + dh
            add(sf, dpf)
            y1, y2 = x1, x2
        return (None, None, d1, d2, *grads)


def reversible_sequence(fns: Sequence[LayerFns], params, x1, x2):
    """(y1, y2) of the coupling, keeping only them for the backward; see the
    module's docstring. ``params[i]`` = (pf, pg), tuples of tensors."""
    index, tensors, slots = {}, [], []
    for pf, pg in params:
        pair = []
        for p in (pf, pg):
            slot = []
            for t in p:
                if id(t) not in index:
                    index[id(t)] = len(tensors)
                    tensors.append(t)
                slot.append(index[id(t)])
            pair.append(tuple(slot))
        slots.append(tuple(pair))
    return _Reversible.apply(tuple(fns), tuple(slots), x1, x2, *tensors)


def run_reversible(fns: Sequence[LayerFns], params, x, *, naive: bool = False):
    """Duplicate ``x`` into two streams, run the coupling (``naive``: through
    autograd's stored activations), average the streams."""
    run = reversible_forward_naive if naive else reversible_sequence
    y1, y2 = run(tuple(fns), tuple(params), x, x)
    return (y1 + y2) / 2.0
