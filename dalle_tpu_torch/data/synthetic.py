"""Synthetic labeled-shapes dataset: the deterministic end-to-end training
fixture of ``train_dalle --synthetic``.

A copy of ``dalle_tpu/data/synthetic.py`` (numpy only): a pure-numpy
rasterizer of 8 shapes × 12 colors × 4 scales, with rotation by inverse
coordinate mapping and ordered dithering, deterministic given a seed.
Captions read "large red circle". ``ShapesDataset.save_folder`` is left out:
it writes PNGs through PIL, which the card's machine lacks, for a folder
loader the port does not have yet.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

SHAPES = ("circle", "square", "triangle", "diamond", "ring", "cross", "star", "hexagon")

COLORS = {
    "red": (230, 40, 40), "orange": (240, 140, 30), "yellow": (235, 220, 50),
    "green": (60, 180, 70), "cyan": (60, 200, 210), "blue": (50, 90, 220),
    "purple": (140, 60, 200), "magenta": (220, 60, 180), "pink": (245, 150, 180),
    "brown": (140, 90, 50), "white": (240, 240, 240), "gray": (128, 128, 128),
}

SCALES = {"tiny": 0.25, "small": 0.4, "medium": 0.6, "large": 0.85}


def _grid(size: int, rotation: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Centered coordinates in [-1,1], optionally rotated (inverse mapping)."""
    c = (np.arange(size) + 0.5) / size * 2 - 1
    x, y = np.meshgrid(c, c)
    if rotation:
        ca, sa = np.cos(-rotation), np.sin(-rotation)
        x, y = ca * x - sa * y, sa * x + ca * y
    return x, y


def shape_mask(shape: str, size: int, scale: float, rotation: float = 0.0) -> np.ndarray:
    """Boolean inside-mask for a shape of half-extent ``scale`` on a size×size grid."""
    x, y = _grid(size, rotation)
    r = np.sqrt(x ** 2 + y ** 2)
    s = scale
    if shape == "circle":
        return r <= s
    if shape == "ring":
        return (r <= s) & (r >= 0.55 * s)
    if shape == "square":
        return (np.abs(x) <= s) & (np.abs(y) <= s)
    if shape == "diamond":
        return (np.abs(x) + np.abs(y)) <= s
    if shape == "triangle":
        # upward triangle: inside three half-planes
        return (y <= s * 0.8) & (y >= -s * 0.8 + 1.6 * np.abs(x)) & (np.abs(x) <= s)
    if shape == "cross":
        arm = 0.35 * s
        return ((np.abs(x) <= arm) & (np.abs(y) <= s)) | ((np.abs(y) <= arm) & (np.abs(x) <= s))
    if shape == "hexagon":
        return (np.abs(x) * 0.866 + np.abs(y) * 0.5 <= s * 0.866) & (np.abs(y) <= s * 0.866)
    if shape == "star":
        theta = np.arctan2(y, x)
        spokes = 0.55 + 0.45 * np.cos(5 * theta)
        return r <= s * spokes
    raise ValueError(f"unknown shape {shape!r}")


_BAYER4 = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                    [3, 11, 1, 9], [15, 7, 13, 5]], dtype=np.float32) / 16.0


def render(shape: str, color: str, scale_name: str, size: int = 128, *,
           rotation: float = 0.0, dither: bool = False,
           background: Tuple[int, int, int] = (0, 0, 0)) -> np.ndarray:
    """Render one labeled image → uint8 (size, size, 3)."""
    mask = shape_mask(shape, size, SCALES[scale_name], rotation)
    if dither:
        # ordered (Bayer) dithering of the fill — capability parity with the
        # reference's Floyd–Steinberg fill transform (sampler.py:156-168)
        tile = np.tile(_BAYER4, (size // 4 + 1, size // 4 + 1))[:size, :size]
        mask = mask & (tile < 0.5)
    img = np.empty((size, size, 3), dtype=np.uint8)
    img[:] = np.asarray(background, dtype=np.uint8)
    img[mask] = np.asarray(COLORS[color], dtype=np.uint8)
    return img


@dataclass
class Sample:
    image: np.ndarray          # uint8 HWC
    caption: str
    label: Tuple[str, str, str]  # (color, shape, scale)


def all_combinations() -> List[Tuple[str, str, str]]:
    return [(c, s, sc) for c, s, sc in
            itertools.product(COLORS.keys(), SHAPES, SCALES.keys())]


class ShapesDataset:
    """In-memory deterministic dataset of rendered shapes with text captions.

    ``variants`` adds rotated/dithered copies per base combination, mirroring the
    reference's transform axis (sampler.py:275-344).
    """

    def __init__(self, image_size: int = 128, variants: int = 1, seed: int = 0,
                 combos: Optional[Sequence[Tuple[str, str, str]]] = None):
        self.image_size = image_size
        self.combos = list(combos) if combos is not None else all_combinations()
        self.variants = variants
        self.seed = seed

    def __len__(self):
        return len(self.combos) * self.variants

    def __getitem__(self, i: int) -> Sample:
        combo_i, var_i = divmod(i, self.variants)
        color, shape, scale = self.combos[combo_i]
        rng = np.random.RandomState(self.seed * 100003 + i)
        rotation = 0.0 if var_i == 0 else float(rng.uniform(0, np.pi / 2))
        dither = var_i % 3 == 2
        img = render(shape, color, scale, self.image_size,
                     rotation=rotation, dither=dither)
        caption = f"{scale} {color} {shape}"
        return Sample(img, caption, (color, shape, scale))

    def as_arrays(self, limit: Optional[int] = None):
        """(images float32 [0,1] NHWC, captions list)."""
        n = min(len(self), limit) if limit else len(self)
        samples = [self[i] for i in range(n)]
        imgs = np.stack([s.image for s in samples]).astype(np.float32) / 255.0
        return imgs, [s.caption for s in samples]


def batch_iterator(ds: ShapesDataset, batch_size: int, *, seed: int = 0,
                   epochs: Optional[int] = None, drop_last: bool = True):
    """Shuffled epoch iterator yielding (images f32 NHWC in [0,1], captions)."""
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(ds))
        for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[start:start + batch_size]
            samples = [ds[int(i)] for i in idx]
            imgs = np.stack([s.image for s in samples]).astype(np.float32) / 255.0
            yield imgs, [s.caption for s in samples]
        epoch += 1
