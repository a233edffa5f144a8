"""A folder of images with caption files.

Port of ``dalle_tpu/data/text_image.py``'s ``TextImageDataset``: images and
``*.txt`` captions paired by path stem, a random caption line per access,
a random square crop resized to ``image_size``, and corrupt images or empty
captions skipped by resampling. It draws from ``random.Random(seed)`` with
the JAX package's calls in its order (``choice`` for the line, ``uniform``
and ``randint`` for the crop, ``shuffle`` for the order, ``randrange`` for
a resample), so the captions, crops and order equal the JAX loader's
sample by sample; the pixels differ from PIL's resize by a level at most.

An image the port's codec does not decode (``UnsupportedImage``) raises
instead of being skipped: skipping it would train on another sample set
than the JAX package, whose PIL decodes it.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .image_codec import UnsupportedImage, read_image, resize_bilinear

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def _random_crop_resize(img: np.ndarray, size: int, resize_ratio: float,
                        rng: random.Random) -> np.ndarray:
    """RandomResizedCrop(scale=(resize_ratio, 1), ratio 1:1)."""
    h, w = img.shape[:2]
    short = min(w, h)
    scale = rng.uniform(resize_ratio, 1.0)
    crop = max(int(short * scale ** 0.5), 1)
    left = rng.randint(0, w - crop) if w > crop else 0
    top = rng.randint(0, h - crop) if h > crop else 0
    return resize_bilinear(img[top:top + crop, left:left + crop], (size, size))


def text_from_filename(image_path: Path) -> str:
    """Filename labels: "medium_red_circle_00042" → "medium red circle"."""
    return " ".join(p for p in image_path.stem.split("_") if not p.isdigit())


class TextImageDataset:
    """Yields (caption str, image float32 [0, 1] HWC); see the module."""

    def __init__(self, folder: str, image_size: int = 128, resize_ratio: float = 0.75,
                 shuffle: bool = False, seed: int = 0, text_from_filename: bool = False):
        self.image_size = image_size
        self.resize_ratio = resize_ratio
        self.shuffle = shuffle
        self.text_from_filename = text_from_filename
        self.rng = random.Random(seed)

        root = Path(folder)
        images = {p.stem: p for p in root.rglob("*") if p.suffix.lower() in IMAGE_EXTS}
        if text_from_filename:
            keys = sorted(images.keys())
            self.pairs: List[Tuple[Optional[Path], Path]] = [(None, images[k]) for k in keys]
        else:
            texts = {p.stem: p for p in root.rglob("*.txt")}
            keys = sorted(images.keys() & texts.keys())
            self.pairs = [(texts[k], images[k]) for k in keys]
        if not self.pairs:
            raise ValueError(f"no usable text/image pairs under {folder}")

    def __len__(self):
        return len(self.pairs)

    def _caption_from(self, text_path: Optional[Path], image_path: Path) -> str:
        if text_path is None:
            return text_from_filename(image_path)
        lines = [l.strip() for l in text_path.read_text().splitlines() if l.strip()]
        if not lines:
            raise ValueError(f"empty caption file {text_path}")
        return self.rng.choice(lines)

    def _load(self, i: int):
        text_path, image_path = self.pairs[i]
        caption = self._caption_from(text_path, image_path)
        img = _random_crop_resize(read_image(image_path), self.image_size,
                                  self.resize_ratio, self.rng)
        return caption, np.asarray(img, dtype=np.float32) / 255.0

    def __getitem__(self, i: int):
        for _ in range(len(self.pairs)):
            try:
                return self._load(i)
            except UnsupportedImage:
                raise
            except Exception:  # noqa: BLE001 - a corrupt image or an empty caption
                # is skipped by resampling (the reference's contract)
                i = self.rng.randrange(len(self.pairs)) if self.shuffle \
                    else (i + 1) % len(self.pairs)
        raise RuntimeError("every sample in the dataset failed to load")

    def batches(self, batch_size: int, epochs: Optional[int] = None, drop_last: bool = True):
        """Yields (images f32 NHWC, captions list)."""
        epoch = 0
        order = list(range(len(self)))
        while epochs is None or epoch < epochs:
            if self.shuffle:
                self.rng.shuffle(order)
            stop = len(order) - (batch_size - 1 if drop_last else 0)
            for s in range(0, max(stop, 0), batch_size):
                items = [self[i] for i in order[s:s + batch_size]]
                yield np.stack([im for _, im in items]), [c for c, _ in items]
            epoch += 1
