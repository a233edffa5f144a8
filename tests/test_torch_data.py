"""The port's data loaders against the JAX package's, on the same files,
sample by sample (no JAX computation: the JAX package's data modules are
numpy and PIL).

* ``loaders``: ``ImageFolderDataset`` (class folders and a flat one),
  ``load_labels``, ``Token``, ``ImagePaths``, ``batch_arrays``,
  ``grid_shape``, ``tile_images``, ``print_labels``.
* ``TextImageDataset`` with one seed: the same captions in the same order,
  the same skips of a corrupt image and an empty caption, images within
  ``RESIZE_TOL`` (the port resizes in torch, PIL's bilinear within a
  level); an image the port cannot decode raises where the JAX loader
  (PIL) reads it.
* The WebDataset chain: ``expand_shards``, per-process splitting, the
  shard order (shuffled, repeated), the samples, ``decode``, ``map``,
  ``select``, ``map_dict``, ``to_tuple``, the shuffle buffer,
  ``batched``, ``prefetch`` and ``pipe:`` sources; ``warn_and_continue``
  skips the same corrupt sample and raises on ``UnsupportedImage``.
* Every taming dataset and the ``prepare_*`` helpers; masks bit for bit.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from dalle_tpu.data import loaders as jl
from dalle_tpu.data import taming_datasets as jt
from dalle_tpu.data import text_image as jti
from dalle_tpu.data import webdataset as jw
from dalle_tpu_torch.data import image_codec as ic
from dalle_tpu_torch.data import loaders as tl
from dalle_tpu_torch.data import taming_datasets as tt
from dalle_tpu_torch.data import text_image as tti
from dalle_tpu_torch.data import webdataset as tw

RESIZE_TOL = 2 / 255 + 1e-6     # float images: PIL's bilinear within a level, and a level more
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
JPEGS = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
WORDS = ["red", "blue", "green", "circle", "square", "small", "large"]


def _image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) % 256], -1)
    return np.clip(a + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _encoded(rng, i, h=None, w=None):
    """(ext, bytes): PNG, BMP or a committed JPEG fixture, in turn."""
    h = h or int(rng.randint(24, 48))
    w = w or int(rng.randint(24, 48))
    kind = i % 3
    if kind == 0:
        return "png", ic.encode_png(_image(rng, h, w))
    if kind == 1:
        return "bmp", ic.encode_bmp(_image(rng, h, w))
    with open(JPEGS[i % len(JPEGS)], "rb") as f:
        return "jpg", f.read()


def _close(a, b, tol=RESIZE_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a.astype(np.float64) - b).max() <= tol


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Class folders of images with captions: 12 pairs, one corrupt image,
    one empty caption, one caption file with several lines."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(0)
    for i in range(12):
        cls = root / ("cats" if i % 2 else "dogs")
        cls.mkdir(exist_ok=True)
        ext, data = _encoded(rng, i)
        stem = f"{WORDS[i % 7]}_{WORDS[(i + 3) % 7]}_{i:05d}"
        (cls / f"{stem}.{ext}").write_bytes(data)
        lines = [" ".join(rng.choice(WORDS, 3)) for _ in range(1 + i % 3)]
        (cls / f"{stem}.txt").write_text("" if i == 5 else "\n".join(lines) + "\n")
    (root / "dogs" / "broken_00099.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    (root / "dogs" / "broken_00099.txt").write_text("a broken image\n")
    return root


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def test_image_folder_labels_and_batches_equal_jax(folder, tmp_path):
    for root in (folder, folder / "cats"):          # class folders, a flat folder
        ours, theirs = tl.ImageFolderDataset(str(root), 20), jl.ImageFolderDataset(str(root), 20)
        assert [(str(p), c) for p, c in ours.samples] == [(str(p), c) for p, c in theirs.samples]
        assert ours.class_to_idx == theirs.class_to_idx
        good = [i for i, (p, _) in enumerate(ours.samples) if "broken" not in p.name]
        for i in good:
            (a, ca), (b, cb) = ours[i], theirs[i]
            assert ca == cb
            _close(a, b)
        xa, ya = tl.batch_arrays(ours, good[:4])
        xb, yb = jl.batch_arrays(theirs, good[:4])
        _close(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert tl.load_labels(ours) == jl.load_labels(theirs)
        assert tl.load_labels(str(root)) == jl.load_labels(str(root))
    with pytest.raises(ValueError):
        tl.ImageFolderDataset(str(tmp_path))


def test_token_grid_tile_and_print_equal_jax():
    labels = [["red", "circle"], ["blue", "square", "small"], ["red"]]
    ours, theirs = tl.Token(labels), jl.Token(labels)
    assert (ours.pairs, ours.num_pairs, ours.sequence_len) == (
        theirs.pairs, theirs.num_pairs, theirs.sequence_len)
    np.testing.assert_array_equal(ours.parse(), theirs.parse())
    np.testing.assert_array_equal(ours.parse([["blue", "red"]], 4), theirs.parse([["blue", "red"]], 4))
    np.testing.assert_array_equal(ours.caption_mask(), theirs.caption_mask())
    assert ours.decode([2, 0, 1]) == theirs.decode([2, 0, 1])
    with pytest.raises(KeyError):
        ours.parse([["green"]])
    for n, cols in ((0, None), (1, None), (7, None), (10, 3), (5, 5)):
        assert tl.grid_shape(n, cols) == jl.grid_shape(n, cols)
    ims = [np.full((3, 4, 3), i, np.uint8) for i in range(5)]
    np.testing.assert_array_equal(tl.tile_images(ims), jl.tile_images(ims))
    np.testing.assert_array_equal(tl.tile_images(ims, cols=2), jl.tile_images(ims, cols=2))
    got, want = [], []
    tl.print_labels(labels + [["x"]], printer=got.append)
    jl.print_labels(labels + [["x"]], printer=want.append)
    assert got == want


def test_image_paths_equal_jax(folder):
    paths = sorted(str(p) for p in folder.rglob("*") if p.suffix in (".png", ".bmp", ".jpg")
                   and "broken" not in p.name)
    labels = {"n": list(range(len(paths)))}
    ours, theirs = tl.ImagePaths(paths, 16, labels), jl.ImagePaths(paths, 16, labels)
    for i in range(len(paths)):
        a, b = ours[i], theirs[i]
        assert a["n"] == b["n"]
        _close(a["image"], b["image"], 2 * RESIZE_TOL)      # [−1, 1]: twice the step
    batch_a, batch_b = tl.batch_arrays(ours, [0, 2]), jl.batch_arrays(theirs, [0, 2])
    _close(batch_a["image"], batch_b["image"], 2 * RESIZE_TOL)
    assert batch_a["n"] == batch_b["n"]


# ---------------------------------------------------------------------------
# TextImageDataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle, from_filename", [(True, False), (False, False), (True, True)])
def test_text_image_dataset_equals_jax_sample_by_sample(folder, shuffle, from_filename):
    kw = dict(image_size=16, shuffle=shuffle, seed=7, text_from_filename=from_filename)
    ours, theirs = tti.TextImageDataset(str(folder), **kw), jti.TextImageDataset(str(folder), **kw)
    assert [(str(t), str(i)) for t, i in ours.pairs] == [(str(t), str(i)) for t, i in theirs.pairs]
    got = list(ours.batches(3, epochs=2))
    want = list(theirs.batches(3, epochs=2))
    assert len(got) == len(want) > 0
    for (ia, ca), (ib, cb) in zip(got, want):
        assert ca == cb
        _close(ia, ib)
    assert ours.rng.getstate() == theirs.rng.getstate()    # the same draws, all of them


def test_text_image_dataset_raises_on_an_unsupported_image(tmp_path):
    a = np.random.RandomState(0).randint(0, 256, (20, 20, 3)).astype(np.uint8)
    Image.fromarray(a).save(tmp_path / "only.gif")
    (tmp_path / "only.txt").write_text("a gif\n")
    with pytest.raises(ic.UnsupportedImage, match="only.gif.*GIF"):
        tti.TextImageDataset(str(tmp_path))[0]
    assert jti.TextImageDataset(str(tmp_path))[0][0] == "a gif"     # PIL reads it
    assert tti.text_from_filename(tmp_path / "big_red_circle_00042.png") == "big red circle"


# ---------------------------------------------------------------------------
# WebDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(1)
    samples = []
    for i in range(14):
        ext, data = _encoded(rng, i)
        if ext == "bmp":                       # shards carry jpg/png members
            ext, data = "png", ic.encode_png(ic.decode(data))
        s = {"__key__": f"sample{i:04d}", ext: data, "txt": f"{WORDS[i % 7]} {i}",
             "cls": str(i % 3).encode(), "json": json.dumps({"i": i}).encode()}
        if i == 6:
            s[ext] = b"corrupt bytes"          # skipped by warn_and_continue
        samples.append(s)
    paths = tw.write_shards(iter(samples), str(root / "shard-{:03d}.tar"), samples_per_shard=4)
    theirs = jw.write_shards(iter(samples), str(tmp_path_factory.mktemp("j") / "s-{:03d}.tar"),
                             samples_per_shard=4)
    assert len(paths) == len(theirs) == 4
    for a, b in zip(paths, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    return root, paths


def _chain(mod, url, **kw):
    return (mod.WebDataset(url, shuffle_shards=True, seed=3, repeat=2, **kw)
            .decode(image_size=16, workers=2)
            .map(lambda s: (next(s[k] for k in ("jpg", "jpeg", "png") if k in s), s["txt"],
                            s["cls"], s["json"]["i"]))
            .select(lambda t: t[2] != 2)
            .shuffle(5)
            .batched(3, partial=True))


def test_webdataset_chain_equals_jax(shards, capsys):
    root, paths = shards
    for a, b in ((str(root / "shard-{000..003}.tar"), None), (str(root), None),
                 (str(root / "shard-*.tar"), None), (paths, None)):
        assert tw.expand_shards(a) == jw.expand_shards(a)
    assert tw.expand_shards("pipe:cat x") == ["pipe:cat x"]
    assert tw.split_shards_per_host(paths) == paths                # one process
    assert tw.split_shards_per_host(paths, 1, 3) == jw.split_shards_per_host(paths, 1, 3)
    got = list(_chain(tw, paths))
    want = list(_chain(jw, paths, split_by_host=False))
    assert len(got) == len(want) > 4
    for ga, wa in zip(got, want):
        _close(ga[0], wa[0])
        for j in (1, 2, 3):
            assert list(ga[j]) == list(wa[j])
    err = capsys.readouterr().err
    assert err.count("skipping after error") == 2 * 2       # one bad sample, two epochs, both sides
    # the same through the prefetch thread, and from a pipe: source
    pf = list(_chain(tw, [f"pipe:cat {p}" for p in paths]).prefetch(2))
    assert [list(b[3]) for b in pf] == [list(b[3]) for b in got]


def test_webdataset_stages_and_handlers(shards):
    root, paths = shards
    raw = list(tw.iter_tar_samples(paths[0], tw.reraise))
    assert raw == list(jw.iter_tar_samples(paths[0], jw.reraise))
    assert [s["__key__"] for s in raw] == [f"sample{i:04d}" for i in range(4)]
    ds = (tw.WebDataset(paths[:1]).map_dict(txt=lambda t: t.decode().upper())
          .to_tuple("__key__", "txt"))
    assert list(ds) == [(s["__key__"], s["txt"].decode().upper()) for s in raw]
    one = tw.decode_sample(raw[0], image_size=8)
    two = jw.decode_sample(raw[0], image_size=8)
    assert one.keys() == two.keys() and one["txt"] == two["txt"] and one["cls"] == two["cls"]
    with pytest.raises(ValueError):
        list(tw.WebDataset(paths[1:2], handler=tw.reraise).decode())    # the corrupt sample
    assert tw.warn_and_continue(ValueError("x")) and not tw.reraise(ValueError("x"))
    assert not tw.warn_and_continue(ic.UnsupportedImage("f", "GIF"))
    gif = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(gif, "GIF")
    bad = str(root / "gif.tar")
    with tarfile.open(bad, "w") as tf:
        for name, data in (("g.png", gif.getvalue()), ("g.txt", b"gif")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    with pytest.raises(ic.UnsupportedImage):
        list(tw.WebDataset(bad).decode())
    with pytest.raises(ValueError, match="shard list is empty"):
        list(tw.WebDataset([]))


# ---------------------------------------------------------------------------
# taming datasets and the prepare helpers
# ---------------------------------------------------------------------------

def test_numpy_paths_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    arrays = [rng.randint(0, 256, (20, 30, 3)).astype(np.uint8),
              rng.randint(0, 65536, (25, 18)).astype(np.uint16),
              rng.rand(22, 22, 3).astype(np.float32),
              rng.rand(22, 22, 3).astype(np.float32) * 255,
              rng.randint(-5, 300, (19, 21, 3)).astype(np.int64),
              rng.randint(0, 256, (20, 20, 4)).astype(np.uint8)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], a)
    for rng_kind in ("auto", "unit", "255"):
        ours = tt.NumpyPaths(paths, 16, {"k": list(range(6))}, assume_range=rng_kind)
        theirs = jt.NumpyPaths(paths, 16, {"k": list(range(6))}, assume_range=rng_kind)
        for i in range(len(paths)):
            assert ours[i]["k"] == theirs[i]["k"]
            _close(ours[i]["image"], theirs[i]["image"], 2 * RESIZE_TOL)


def test_taming_file_datasets_equal_jax(folder, tmp_path):
    files = sorted(str(p) for p in folder.rglob("*") if p.suffix in (".png", ".bmp", ".jpg")
                   and "broken" not in p.name)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(files[:5]) + "\n\n")
    other = tmp_path / "other.txt"
    other.write_text("\n".join(files[5:8]) + "\n")
    pairs = [(tt.CustomTrain(16, str(lst)), jt.CustomTrain(16, str(lst))),
             (tt.CustomTest(16, str(lst)), jt.CustomTest(16, str(lst))),
             (tt.FacesHQ(str(lst), str(other), 16), jt.FacesHQ(str(lst), str(other), 16)),
             (tt.ImageNetTrain(str(folder), 16), jt.ImageNetTrain(str(folder), 16)),
             (tt.ImageNetValidation(str(folder), 16), jt.ImageNetValidation(str(folder), 16))]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) > 0
        paths = [p for p, _ in ours.items] if hasattr(ours, "items") else ours.data.paths
        for i in range(len(ours)):
            if "broken" in str(paths[i]):        # a corrupt file raises on both sides
                with pytest.raises(Exception):
                    theirs[i]
                with pytest.raises(ValueError):
                    ours[i]
                continue
            a, b = ours[i], theirs[i]
            assert {k: v for k, v in a.items() if k != "image"} == \
                {k: v for k, v in b.items() if k != "image"}
            _close(a["image"], b["image"], 2 * RESIZE_TOL)
    with pytest.raises(ValueError):
        tt.FacesHQ()


def test_coco_and_segmentation_equal_jax(folder, tmp_path):
    imgs = sorted(p for p in folder.rglob("*") if p.suffix in (".png", ".bmp", ".jpg")
                  and "broken" not in p.name)[:4]
    ann = {"images": [{"id": i, "file_name": str(p.relative_to(folder))}
                      for i, p in enumerate(imgs)] + [{"id": 9, "file_name": "gone.png"}],
           "annotations": [{"image_id": i % 3, "caption": f"caption {i}"} for i in range(7)]}
    (tmp_path / "captions.json").write_text(json.dumps(ann))
    ours = tt.CocoCaptions(str(folder), str(tmp_path / "captions.json"), 16)
    theirs = jt.CocoCaptions(str(folder), str(tmp_path / "captions.json"), 16)
    assert ours.items == theirs.items
    for i in range(len(ours)):
        np.random.seed(i)
        a = ours[i]
        np.random.seed(i)
        b = theirs[i]
        assert (a["caption"], a["all_captions"]) == (b["caption"], b["all_captions"])
        _close(a["image"], b["image"], 2 * RESIZE_TOL)
    # masks: mode L and mode P PNGs, resized with the nearest rule, bit for bit
    masks = tmp_path / "masks"
    masks.mkdir()
    rng = np.random.RandomState(4)
    for j, p in enumerate(imgs):
        m = rng.randint(0, 200, (13 + j, 29)).astype(np.uint8)
        im = Image.fromarray(m)
        if j % 2:
            im = im.convert("P")
            im.putpalette(list(rng.randint(0, 256, 768)))
        im.save(masks / (p.stem + ".png"))
    for cls in ("SegmentationPairs", "ADE20k", "SFLCKR"):
        ours, theirs = (getattr(m, cls)(str(folder), str(masks), size=12) for m in (tt, jt))
        assert [tuple(map(str, q)) for q in ours.pairs] == [tuple(map(str, q))
                                                              for q in theirs.pairs]
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            np.testing.assert_array_equal(a["mask"], b["mask"])
            np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
            _close(a["image"], b["image"], 2 * RESIZE_TOL)
    with pytest.raises(ValueError, match="no image/mask"):
        tt.SegmentationPairs(str(folder), str(tmp_path / "captions.json"))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_prepare_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "src"
    src.mkdir()
    # a train archive of per-synset sub-tars, a flat validation archive
    train = tmp_path / "train.tar"
    with tarfile.open(train, "w") as outer:
        for s in ("n01", "n02"):
            sub = src / f"{s}.tar"
            with tarfile.open(sub, "w") as inner:
                for k in range(2):
                    p = src / f"{s}_{k}.JPEG"
                    p.write_bytes(ic.encode_png(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)))
                    inner.add(p, arcname=p.name)
            outer.add(sub, arcname=sub.name)
    val = tmp_path / "val.tar"
    with tarfile.open(val, "w") as tf:
        for k in range(3):
            tf.add(src / f"n01_{k % 2}.JPEG", arcname=f"v{k}.JPEG")
    synsets = tmp_path / "synsets.txt"
    synsets.write_text("v0.JPEG n01\nv1.JPEG n02\nv2.JPEG n01\n")
    for name, mod in (("t", tt), ("j", jt)):
        assert mod.prepare_imagenet_train(str(train), str(tmp_path / name / "train")) == 4
        assert mod.prepare_imagenet_validation(str(val), str(synsets),
                                               str(tmp_path / name / "val")) == 3
        assert mod.is_prepared(tmp_path / name / "val")
        assert mod.prepare_imagenet_train(str(train), str(tmp_path / name / "train")) == 4
        mod.mark_prepared(tmp_path / name / "x")
        mod.prepare_coco(str(tmp_path / name / "coco"))
    for sub in ("train", "val", "x", "coco"):
        assert _tree(tmp_path / "t" / sub) == _tree(tmp_path / "j" / sub)
    assert (tmp_path / "t" / "train" / "filelist.txt").read_text() == \
        (tmp_path / "j" / "train" / "filelist.txt").read_text()
    ours = tt.ImageNetTrain(str(tmp_path / "t" / "train" / "data"), 8)
    assert [ours[i]["synset"] for i in range(len(ours))] == ["n01"] * 2 + ["n02"] * 2
