"""Fork-style loaders: image folders, filename labels, a word-level vocab.

Port of ``dalle_tpu/data/loaders.py``: ``ImageFolderDataset`` (an
ImageFolder with resize and centre crop), ``load_labels`` (labels from
filename stems split on ``_``), ``Token`` (a word-level vocabulary with 0
as pad), taming's ``ImagePaths`` file list, ``batch_arrays``,
``grid_shape``, ``tile_images`` and ``print_labels``. Images are decoded
by the port's codec (``data/image_codec.py``) and resized in torch on the
host, PIL's bilinear within one level; they come out (H, W, C) float32,
with the ``data/load_image`` and ``data/batch_arrays`` spans.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.trace import span
from .image_codec import read_image, resize_bilinear

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def finish_image(img: np.ndarray, image_size: int, *, center_crop: bool = True,
                 to_unit_interval: bool = True) -> np.ndarray:
    """The JAX package's ``_finish_pil`` on (H, W, 3) uint8 samples:
    shorter-side resize and centre crop (or a plain resize) → float32 HWC
    in [0, 1] or [−1, 1]."""
    h, w = img.shape[:2]
    if center_crop:
        scale = image_size / min(w, h)
        nw, nh = max(image_size, round(w * scale)), max(image_size, round(h * scale))
        img = resize_bilinear(img, (nw, nh))
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        img = img[top:top + image_size, left:left + image_size]
    else:
        img = resize_bilinear(img, (image_size, image_size))
    arr = np.asarray(img, np.float32) / 255.0
    if not to_unit_interval:
        arr = arr * 2.0 - 1.0
    return arr


def load_image(path, image_size: int, *, center_crop: bool = True,
               to_unit_interval: bool = True) -> np.ndarray:
    with span("data/load_image"):
        return finish_image(read_image(path), image_size, center_crop=center_crop,
                            to_unit_interval=to_unit_interval)


class ImageFolderDataset:
    """torchvision's ImageFolder: ``root/class_x/img.png`` → (image [0, 1]
    HWC, class index). A flat folder is one class."""

    def __init__(self, root: str, image_size: int = 128):
        self.image_size = image_size
        root_p = Path(root)
        classes = sorted(d.name for d in root_p.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[Path, int]] = []
        if classes:
            for c in classes:
                for p in sorted((root_p / c).rglob("*")):
                    if p.suffix.lower() in IMAGE_EXTS:
                        self.samples.append((p, self.class_to_idx[c]))
        else:
            self.samples = [(p, 0) for p in sorted(root_p.iterdir())
                            if p.suffix.lower() in IMAGE_EXTS]
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        path, cls = self.samples[i]
        return load_image(path, self.image_size), cls


def load_labels(source, sep: str = "_") -> List[List[str]]:
    """Word labels from filename stems split on ``sep``, of an
    ``ImageFolderDataset`` or a directory."""
    if isinstance(source, ImageFolderDataset):
        stems = [p.stem for p, _ in source.samples]
    else:
        stems = []
        for dirpath, _dirs, files in os.walk(str(source)):
            for f in sorted(files):
                p = Path(dirpath) / f
                if p.suffix.lower() in IMAGE_EXTS:
                    stems.append(p.stem)
    return [s.split(sep) for s in stems]


class Token:
    """A word-level vocabulary over caption word lists; id 0 is pad.
    ``parse()`` → padded int32 array; ``caption_mask()`` → its ``!= 0``."""

    def __init__(self, labels: Sequence[Sequence[str]]):
        self._org = [list(l) for l in labels]
        words = sorted({w for cap in self._org for w in cap})
        self.pairs = {w: i for i, w in enumerate(words, start=1)}

    @property
    def num_pairs(self) -> int:
        """Vocabulary size with the pad."""
        return len(self.pairs) + 1

    @property
    def sequence_len(self) -> int:
        return max(len(cap) for cap in self._org)

    def parse(self, captions: Optional[Sequence[Sequence[str]]] = None,
              seq_len: Optional[int] = None) -> np.ndarray:
        """(n, seq_len) int32, 0-padded; an unknown word raises."""
        caps = self._org if captions is None else [list(c) for c in captions]
        n = seq_len or self.sequence_len
        out = np.zeros((len(caps), n), np.int32)
        for i, cap in enumerate(caps):
            ids = [self.pairs[w] for w in cap]
            out[i, :len(ids)] = ids[:n]
        return out

    def caption_mask(self, captions=None, seq_len: Optional[int] = None) -> np.ndarray:
        return self.parse(captions, seq_len) != 0

    def decode(self, ids: Iterable[int]) -> List[str]:
        rev = {v: k for k, v in self.pairs.items()}
        return [rev[int(i)] for i in ids if int(i) != 0]


class ImagePaths:
    """taming's file-list dataset: paths → resized, centre-cropped [−1, 1]
    images, with optional labels."""

    def __init__(self, paths: Sequence[str], size: int = 256, labels: Optional[dict] = None):
        self.paths = list(paths)
        self.size = size
        self.labels = labels or {}

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int):
        out = {"image": load_image(self.paths[i], self.size, to_unit_interval=False)}
        for k, v in self.labels.items():
            out[k] = v[i]
        return out


@span("data/batch_arrays")
def batch_arrays(dataset, indices: Sequence[int]):
    """Stack ``dataset[i]`` tuples or dicts into batched numpy arrays."""
    items = [dataset[i] for i in indices]
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items])
                if isinstance(first[k], np.ndarray) else [it[k] for it in items]
                for k in first}
    cols = list(zip(*items))
    return tuple(np.stack(c) if isinstance(c[0], np.ndarray) else np.asarray(c)
                 for c in cols)


def grid_shape(n: int, cols: Optional[int] = None) -> Tuple[int, int]:
    """(rows, cols) covering n items, near-square by default."""
    if n == 0:
        return (0, cols or 0)
    if cols is None:
        rows = max(int(math.sqrt(n)), 1)
        cols = math.ceil(n / rows)
    rows = math.ceil(n / cols)
    return rows, cols


def tile_images(images: Sequence[np.ndarray], cols: Optional[int] = None) -> np.ndarray:
    """Tile HWC images into one grid image; the last row may be partly empty."""
    images = [np.asarray(im) for im in images]
    if not images:
        raise ValueError("tile_images needs at least one image")
    rows, cols = grid_shape(len(images), cols)
    h, w, c = images[0].shape
    grid = np.zeros((rows * h, cols * w, c), images[0].dtype)
    for i, im in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    return grid


def print_labels(labels: Sequence[Sequence[str]], sep: str = "_", printer=print,
                 cols: Optional[int] = None) -> None:
    """The labels row by row in ``tile_images``' grid shape."""
    rows, cols = grid_shape(len(labels), cols)
    for r in range(rows):
        row = labels[r * cols:(r + 1) * cols]
        printer(":".join(sep.join(l) for l in row))
