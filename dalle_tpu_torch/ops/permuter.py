"""Orders for autoregressive image-token generation over an h×w grid.

Port of ``dalle_tpu/ops/permuter.py`` (taming's ``Identity``, ``Subsample``,
``ZCurve``, ``SpiralOut``, ``SpiralIn``, ``Random``, ``AlternateParsing``):
each is an index table computed once on the host with numpy, its inverse
``argsort(idx)``; applying one is a gather along the token axis
(``index_select`` on a tensor, ``np.take`` on an array).
"""

from __future__ import annotations

import numpy as np
import torch


def take(x, table: np.ndarray, axis: int):
    """Gather ``table``'s positions along ``axis`` of a tensor or array."""
    if isinstance(x, np.ndarray):
        return np.take(x, table, axis=axis)
    return x.index_select(axis, torch.as_tensor(table, device=x.device))


class Permuter:
    """Permutation + inverse over a flattened (h·w) token axis."""

    def __init__(self, idx: np.ndarray):
        idx = np.asarray(idx, np.int64)
        n = idx.shape[0]
        assert np.array_equal(np.sort(idx), np.arange(n)), "not a permutation"
        self.idx = idx
        self.inv = np.argsort(idx)

    def __call__(self, x, reverse: bool = False, axis: int = -1):
        """Permute the token axis of ``x`` (ids (..., n) use the default
        ``axis=-1``; embedded tokens (..., n, d) pass ``axis=-2``)."""
        table = self.inv if reverse else self.idx
        if x.shape[axis] != table.shape[0]:
            raise ValueError(
                f"axis {axis} has size {x.shape[axis]}, expected {table.shape[0]}")
        return take(x, table, axis)


def identity(h: int, w: int) -> Permuter:
    return Permuter(np.arange(h * w))


def subsample(h: int, w: int) -> Permuter:
    """Hierarchical coarse-to-fine: recursively split the grid into 2×2
    sub-lattices (permuter.py:21-44)."""
    c, H, W = 1, h, w
    indices = np.arange(h * w).reshape(c, h, w)
    while min(H, W) > 1:
        indices = indices.reshape(c, H // 2, 2, W // 2, 2)
        indices = indices.transpose(0, 2, 4, 1, 3)
        indices = indices.reshape(c * 4, H // 2, W // 2)
        H, W, c = H // 2, W // 2, c * 4
    assert H == W == 1
    return Permuter(indices.ravel())


def zcurve(h: int, w: int) -> Permuter:
    """Morton (Z-order) traversal (permuter.py:47-78): interleave the bits of
    (row, col); token k of the output is the raster position with the k-th
    smallest morton code."""
    def morton(i: int, j: int) -> int:
        z = 0
        for bit in range(32):
            z |= ((j >> bit) & 1) << (2 * bit)
            z |= ((i >> bit) & 1) << (2 * bit + 1)
        return z

    codes = np.array([morton(i, j) for i in range(h) for j in range(w)])
    return Permuter(np.argsort(codes, kind="stable"))


def _spiral_indices(size: int) -> np.ndarray:
    """Outward spiral from the center (permuter.py:81-135 walk)."""
    grid = np.arange(size * size).reshape(size, size)
    i, j = size // 2, size // 2 - 1
    idx = [grid[i, j]]
    step = 0
    for c in range(1, size // 2 + 1):
        step += 1
        for _ in range(step):
            i -= 1
            idx.append(grid[i, j])
        for _ in range(step):
            j += 1
            idx.append(grid[i, j])
        step += 1
        if c < size // 2:
            for _ in range(step):
                i += 1
                idx.append(grid[i, j])
            for _ in range(step):
                j -= 1
                idx.append(grid[i, j])
        else:
            for _ in range(step - 1):
                i += 1
                idx.append(grid[i, j])
    assert len(idx) == size * size
    return np.asarray(idx)


def spiral_out(h: int, w: int) -> Permuter:
    assert h == w, "spiral permuters need a square grid"
    return Permuter(_spiral_indices(h))


def spiral_in(h: int, w: int) -> Permuter:
    """Inward spiral = reversed outward walk (permuter.py:138-196)."""
    assert h == w, "spiral permuters need a square grid"
    return Permuter(_spiral_indices(h)[::-1].copy())


def random(h: int, w: int, seed: int = 1) -> Permuter:
    """Fixed random shuffle; the reference seeds numpy with 1
    (permuter.py:199-215)."""
    rng = np.random.RandomState(seed)
    return Permuter(rng.permutation(h * w))


def alternate_parsing(h: int, w: int) -> Permuter:
    """Boustrophedon: odd rows reversed (permuter.py:218-233)."""
    grid = np.arange(h * w).reshape(h, w)
    rows = [grid[r, ::-1] if r % 2 else grid[r] for r in range(h)]
    return Permuter(np.concatenate(rows))


PERMUTERS = {
    "identity": identity,
    "subsample": subsample,
    "zcurve": zcurve,
    "spiral_out": spiral_out,
    "spiral_in": spiral_in,
    "random": random,
    "alternate_parsing": alternate_parsing,
}


def make_permuter(kind: str, h: int, w: int) -> Permuter:
    if kind not in PERMUTERS:
        raise ValueError(f"unknown permuter {kind!r}; have {sorted(PERMUTERS)}")
    return PERMUTERS[kind](h, w)
