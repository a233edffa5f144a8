"""The taming-transformers dataset family over local files.

Port of ``dalle_tpu/data/taming_datasets.py``: ``NumpyPaths``, the custom
file lists (``CustomTrain``, ``CustomTest``), ImageNet's synset folders
(``ImageNetTrain``, ``ImageNetValidation``), ``CocoCaptions``, image and
mask pairs (``SegmentationPairs``, ``ADE20k``, ``SFLCKR``), ``FacesHQ``,
and the ``prepare_*``, ``is_prepared`` and ``mark_prepared`` helpers that
unpack archives already on disk. Nothing is downloaded. Items are
``{"image": float32 HWC in [−1, 1], ...}``; images decode through the
port's codec (``data/image_codec.py``), masks resize with PIL's nearest
rule, bit for bit.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .image_codec import decode_raw, resize_nearest, to_rgb
from .loaders import IMAGE_EXTS, ImagePaths, finish_image, load_image


class NumpyPaths(ImagePaths):
    """.npy image arrays (HWC) instead of encoded files
    (taming/data/base.py:73-89).

    ``assume_range`` resolves the inherent ambiguity of float stores:
    "auto" (default) treats max ≤ 2.0 as [0,1]-intent (tolerating
    interpolation overshoot) and anything brighter as 0-255; pass "unit" or
    "255" when the dataset's convention is known — a dark 0-255 float image
    (max ≤ 2) is indistinguishable from a [0,1] one by inspection."""

    def __init__(self, paths, size: int = 256, labels=None,
                 assume_range: str = "auto"):
        super().__init__(paths, size=size, labels=labels)
        assert assume_range in ("auto", "unit", "255"), assume_range
        self.assume_range = assume_range

    def __getitem__(self, i: int):
        arr = np.load(self.paths[i])
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.dtype == np.uint8:
            u8 = arr
        elif np.issubdtype(arr.dtype, np.unsignedinteger):
            # wide unsigned stores (uint16 PNGs) use the dtype's full range —
            # must not wrap modulo 256
            info = np.iinfo(arr.dtype)
            u8 = (arr.astype(np.float64) * (255.0 / info.max)).astype(np.uint8)
        elif np.issubdtype(arr.dtype, np.integer):
            # signed ints (numpy's default) conventionally hold 0-255 pixels
            u8 = np.clip(arr, 0, 255).astype(np.uint8)
        else:
            f = arr.astype(np.float64)
            if self.assume_range == "255" or (self.assume_range == "auto"
                                              and f.max() > 2.0):
                f = f / 255.0
            u8 = (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
        # shorter-side resize and centre crop through the file path's tail,
        # with no codec round trip
        if u8.shape[-1] == 4:
            u8 = to_rgb(u8, "RGBA")
        img = finish_image(np.ascontiguousarray(u8), self.size, to_unit_interval=False)
        out = {"image": img}
        for k, v in self.labels.items():
            out[k] = v[i]
        return out


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


class CustomBase:
    """File-list dataset (taming/data/custom.py): a txt file of image paths."""

    def __init__(self, size: int, images_list_file: str):
        self.data = ImagePaths(_read_list(images_list_file), size=size)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i: int):
        return self.data[i]


class CustomTrain(CustomBase):
    def __init__(self, size: int, training_images_list_file: str):
        super().__init__(size, training_images_list_file)


class CustomTest(CustomBase):
    def __init__(self, size: int, test_images_list_file: str):
        super().__init__(size, test_images_list_file)


class ImageNetBase:
    """Synset-subdir layout ``root/nXXXXXXXX/*.JPEG`` → items with
    ``class_label``/``human_label`` (taming/data/imagenet.py semantics without
    the download/untar machinery — point ``root`` at an extracted tree)."""

    def __init__(self, root: str, size: int = 256,
                 synset_to_human: Optional[Dict[str, str]] = None):
        self.size = size
        root_p = Path(root)
        synsets = sorted(d.name for d in root_p.iterdir() if d.is_dir())
        if not synsets:
            raise ValueError(f"no synset subdirectories under {root}")
        self.synset_to_idx = {s: i for i, s in enumerate(synsets)}
        self.synset_to_human = synset_to_human or {}
        self.items: List[tuple] = []
        for s in synsets:
            for p in sorted((root_p / s).iterdir()):
                if p.suffix.lower() in IMAGE_EXTS:
                    self.items.append((p, s))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        path, synset = self.items[i]
        img = load_image(path, self.size, to_unit_interval=False)
        return {"image": img, "class_label": self.synset_to_idx[synset],
                "synset": synset,
                "human_label": self.synset_to_human.get(synset, synset)}


class ImageNetTrain(ImageNetBase):
    pass


class ImageNetValidation(ImageNetBase):
    pass


class CocoCaptions:
    """COCO-style images + captions json (taming/data/coco.py capability:
    items carry image + caption; segmentation variant below). ``annotations``
    is a COCO ``captions_*.json`` file."""

    def __init__(self, images_root: str, annotations: str, size: int = 256):
        self.size = size
        self.root = Path(images_root)
        with open(annotations) as f:
            ann = json.load(f)
        files = {im["id"]: im["file_name"] for im in ann["images"]}
        caps: Dict[int, List[str]] = {}
        for a in ann["annotations"]:
            caps.setdefault(a["image_id"], []).append(a["caption"])
        self.items = [(files[i], caps.get(i, [""])) for i in sorted(files)
                      if (self.root / files[i]).exists()]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        fname, captions = self.items[i]
        img = load_image(self.root / fname, self.size, to_unit_interval=False)
        # random-caption-per-access, like TextImageDataset (loader.py:77-81)
        cap = captions[np.random.randint(len(captions))]
        return {"image": img, "caption": cap, "all_captions": captions}


class SegmentationPairs:
    """Image + per-pixel label-map pairs — the shared shape of the reference's
    ADE20k (ade20k.py) and SFLCKR (sflckr.py) datasets: parallel directories
    of images and PNG segmentation masks matched by stem."""

    def __init__(self, images_root: str, masks_root: str, size: int = 256,
                 n_labels: int = 151):
        self.size = size
        self.n_labels = n_labels
        imgs = {p.stem: p for p in Path(images_root).rglob("*")
                if p.suffix.lower() in IMAGE_EXTS}
        masks = {p.stem: p for p in Path(masks_root).rglob("*.png")}
        keys = sorted(imgs.keys() & masks.keys())
        if not keys:
            raise ValueError("no image/mask stem matches")
        self.pairs = [(imgs[k], masks[k]) for k in keys]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int):
        img_p, mask_p = self.pairs[i]
        img = load_image(img_p, self.size, to_unit_interval=False)
        raw, _mode, _palette = decode_raw(Path(mask_p).read_bytes(), str(mask_p))
        seg = resize_nearest(raw, (self.size, self.size)).astype(np.int32)
        if seg.ndim == 3:
            seg = seg[..., 0]
        onehot = np.eye(self.n_labels, dtype=np.float32)[
            np.clip(seg, 0, self.n_labels - 1)]
        return {"image": img, "segmentation": onehot, "mask": seg}


class ADE20k(SegmentationPairs):
    """151-class scene parsing (taming/data/ade20k.py)."""


class SFLCKR(SegmentationPairs):
    """Landscape segmentation conditioning (taming/data/sflckr.py)."""

    def __init__(self, images_root, masks_root, size=256, n_labels=182):
        super().__init__(images_root, masks_root, size, n_labels)


# --------------------------------------------------------------------------
# prepare helpers: build the expected directory trees from ALREADY-DOWNLOADED
# archives — the no-network half of the reference's download/untar machinery
# (imagenet.py:134-242 _prepare; bdu.is_prepared/mark_prepared ".ready" flag).
# The network half (academictorrents / heibox fetches) is left out: the
# port reads local files only.
# --------------------------------------------------------------------------

_READY = ".ready"


def _extract_tar(archive, dest) -> None:
    """extractall with the safe 'data' filter where available (3.12+ /
    late 3.10/3.11 backports); older interpreters in our >=3.10 range lack
    the kwarg, so the fallback path re-implements the traversal checks
    (reject absolute paths, ``..`` components, and links escaping dest)."""
    import tarfile

    with tarfile.open(archive, "r:*") as tar:
        try:
            tar.extractall(path=dest, filter="data")
        except TypeError:
            for member in tar.getmembers():
                name = Path(member.name)
                if name.is_absolute() or ".." in name.parts:
                    raise ValueError(
                        f"unsafe path in archive {archive!r}: {member.name!r}")
                if member.islnk() or member.issym():
                    link = Path(member.linkname)
                    if link.is_absolute() or ".." in link.parts:
                        raise ValueError(
                            f"unsafe link in archive {archive!r}: "
                            f"{member.name!r} -> {member.linkname!r}")
                elif not (member.isfile() or member.isdir()):
                    # the 'data' filter also rejects FIFOs/devices — a FIFO
                    # at an image path would block the first dataset pass
                    raise ValueError(
                        f"unsupported member type in archive {archive!r}: "
                        f"{member.name!r}")
            tar.extractall(path=dest)


def is_prepared(root) -> bool:
    """taming.data.utils.is_prepared equivalent: the ``.ready`` flag file."""
    return (Path(root) / _READY).exists()


def mark_prepared(root) -> None:
    Path(root).mkdir(parents=True, exist_ok=True)
    (Path(root) / _READY).touch()


def _write_filelist(root: Path, datadir: Path) -> int:
    """filelist.txt of sorted datadir-relative JPEG paths
    (imagenet.py:168-173)."""
    files = sorted(str(p.relative_to(datadir))
                   for p in datadir.rglob("*")
                   if p.suffix.upper() == ".JPEG")
    (root / "filelist.txt").write_text("\n".join(files) + "\n")
    return len(files)


def prepare_imagenet_train(archive: str, root: str) -> int:
    """ILSVRC2012_img_train.tar (a tar of per-synset sub-tars) → the
    ``root/data/nXXXXXXXX/*.JPEG`` tree ImageNetTrain reads + filelist.txt +
    ``.ready`` (imagenet.py:134-176 minus the torrent fetch). Returns the
    image count. Idempotent: a prepared root is left untouched."""
    root_p = Path(root)
    if is_prepared(root_p):
        return sum(1 for _ in open(root_p / "filelist.txt"))
    datadir = root_p / "data"
    datadir.mkdir(parents=True, exist_ok=True)
    _extract_tar(archive, datadir)
    for subpath in sorted(datadir.glob("*.tar")):
        subdir = datadir / subpath.stem          # nXXXXXXXX.tar → nXXXXXXXX/
        subdir.mkdir(exist_ok=True)
        _extract_tar(subpath, subdir)
        subpath.unlink()
    n = _write_filelist(root_p, datadir)
    mark_prepared(root_p)
    return n


def prepare_imagenet_validation(archive: str, synset_map: str,
                                root: str) -> int:
    """ILSVRC2012_img_val.tar (flat JPEGs) + validation_synset.txt
    ("<file> <synset>" lines) → synset-foldered ``root/data`` + filelist.txt
    + ``.ready`` (imagenet.py:192-242 minus the two downloads)."""
    import shutil

    root_p = Path(root)
    if is_prepared(root_p):
        return sum(1 for _ in open(root_p / "filelist.txt"))
    datadir = root_p / "data"
    datadir.mkdir(parents=True, exist_ok=True)
    _extract_tar(archive, datadir)
    synset_dict = dict(line.split()
                       for line in Path(synset_map).read_text().splitlines()
                       if line.strip())
    for s in sorted(set(synset_dict.values())):
        (datadir / s).mkdir(exist_ok=True)
    for fname, synset in synset_dict.items():
        src = datadir / fname
        if src.exists():
            shutil.move(str(src), str(datadir / synset / fname))
    n = _write_filelist(root_p, datadir)
    mark_prepared(root_p)
    return n


def prepare_coco(root: str, images_zip: Optional[str] = None,
                 annotations_zip: Optional[str] = None,
                 stuffthingmaps_zip: Optional[str] = None) -> None:
    """Unpack already-downloaded COCO zips (train2017/val2017 images,
    annotations_trainval2017, stuffthingmaps) into the taming layout
    (coco.py CocoImagesAndCaptionsTrain/Examples expect
    ``root/{train2017,val2017,annotations,stuffthingmaps}``). Pass any subset;
    each zip's internal paths already carry the right prefixes. Idempotent:
    a prepared root is left untouched."""
    import zipfile

    root_p = Path(root)
    if is_prepared(root_p):
        return
    root_p.mkdir(parents=True, exist_ok=True)
    for z in (images_zip, annotations_zip, stuffthingmaps_zip):
        if z:
            with zipfile.ZipFile(z) as zf:
                zf.extractall(root_p)
    mark_prepared(root_p)


class FacesHQ:
    """CelebAHQ + FFHQ concatenated (taming/data/faceshq.py FacesHQTrain):
    two file lists with a ``class`` flag distinguishing the sources."""

    def __init__(self, celeba_list: Optional[str] = None,
                 ffhq_list: Optional[str] = None, size: int = 256):
        paths: List[str] = []
        labels: List[int] = []
        for cls, lst in enumerate((celeba_list, ffhq_list)):
            if lst:
                p = _read_list(lst)
                paths.extend(p)
                labels.extend([cls] * len(p))
        if not paths:
            raise ValueError("provide at least one of celeba_list/ffhq_list")
        self.data = ImagePaths(paths, size=size, labels={"class": labels})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i: int):
        return self.data[i]
