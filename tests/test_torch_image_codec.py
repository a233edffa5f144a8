"""The port's image codec (``dalle_tpu_torch/data/image_codec.py``) against
PIL, which is the oracle here only (the port itself never imports it).

* PNG, every colour type and bit depth the codec reads, every row filter
  (written by this file's own filtering encoder), and BMP (24- and 32-bit,
  bottom-up and top-down): bit for bit PIL's ``convert("RGB")`` and, for
  the raw samples, ``np.asarray(Image.open(...))``.
* Baseline JPEG at qualities 50, 90 and 95, sampled 4:4:4, 4:2:2 and
  4:2:0, and grey, with and without restart markers, at sizes that are not
  multiples of 16: within ``JPEG_MAX`` levels of PIL anywhere and
  ``JPEG_MEAN`` on average. The bounds were stated before the first run;
  every case measured 0 (bit for bit), since the core follows libjpeg's
  integer IDCT, fancy upsampling and colour tables. The committed fixtures
  (``tests/torch_fixtures``, PIL's decodes beside them) are held to the
  same bounds.
* Formats come from the bytes: a PNG named ``.jpg`` decodes; progressive
  JPEG, GIF, WebP, TIFF, 16-bit and interlaced PNG and palette BMP raise
  ``UnsupportedImage`` naming the file and the format.
* Truncated and mutated files (a hypothesis fuzz) only ever raise
  ``ValueError``; the process survives.
* Resizing: ``resize_bilinear`` within ``RESIZE_MAX`` level of PIL's
  ``BILINEAR``, ``resize_nearest`` bit for bit PIL's ``NEAREST``.
* A failed build of the native core raises with the compiler's output.
"""

import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from dalle_tpu_torch.data import image_codec as ic

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
JPEG_MAX = 3          # levels, anywhere
JPEG_MEAN = 0.5       # levels, on average
RESIZE_MAX = 1        # levels: torch's antialiased bilinear against PIL's


def _pattern(h, w, seed=0, channels=3):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(x / 5.0 - y / 9.0),
                  (x * 3 + y * 2) % 256, 255 - (x * 5) % 256], -1)[..., :channels]
    return np.clip(a + rng.randn(h, w, channels) * 12, 0, 255).astype(np.uint8)


def _pil(data, raw=False):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if raw else im.convert("RGB"))


# ---------------------------------------------------------------------------
# PNG, with this file's own filtering encoder
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Scanlines (h, row_bytes) uint8 filtered with ``filters[y % len]``."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, upleft)}[f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png(rows, w, h, depth, color, filters, palette=None, interlace=0):
    bpp = max(depth * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] // 8, 1)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (ic.PNG_MAGIC + body + _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, filters)))
            + _chunk(b"IEND", b""))


COLOR_CASES = [(0, 8, 1), (2, 8, 3), (3, 8, 1), (4, 8, 2), (6, 8, 4),
               (0, 1, 1), (0, 2, 1), (0, 4, 1), (3, 1, 1), (3, 2, 1), (3, 4, 1)]


@pytest.mark.parametrize("color, depth, channels", COLOR_CASES,
                         ids=[f"type{c}_{d}bit" for c, d, _ in COLOR_CASES])
def test_png_every_colour_type_and_filter_equals_pil(color, depth, channels):
    h, w = 13, 21
    rng = np.random.RandomState(color * 10 + depth)
    palette = rng.randint(0, 256, (200, 3)) if color == 3 else None
    top = min(1 << depth, 200 if color == 3 else 256)
    samples = rng.randint(0, top, (h, w * channels)).astype(np.uint8)
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples
        shifts = np.arange(per - 1, -1, -1) * depth
        rows = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    else:
        rows = samples
    for filters in ([0], [1], [2], [3], [4], [4, 0, 3, 1, 2]):
        data = _png(rows, w, h, depth, color, filters, palette)
        np.testing.assert_array_equal(ic.decode(data), _pil(data))
        arr, mode, _ = ic.decode_raw(data)
        np.testing.assert_array_equal(arr, _pil(data, raw=True).astype(arr.dtype))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_png_as_pil_writes_it(mode):
    a = _pattern(19, 27, channels=4)
    img = (Image.fromarray(a[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=100)
           if mode == "P" else Image.fromarray(a).convert(mode))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    np.testing.assert_array_equal(ic.decode(buf.getvalue()), _pil(buf.getvalue()))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_bmp_equals_pil(mode):
    a = _pattern(23, 30, channels=4)
    buf = io.BytesIO()
    Image.fromarray(a).convert(mode).save(buf, "BMP")
    np.testing.assert_array_equal(ic.decode(buf.getvalue()), _pil(buf.getvalue()))
    # ours, and a top-down copy (negative height), as PIL reads them
    ours = ic.encode_bmp(a[..., :3])
    np.testing.assert_array_equal(_pil(ours), a[..., :3])
    top_down = bytearray(ours)
    h, w = a.shape[:2]
    top_down[22:26] = struct.pack("<i", -h)
    stride = (w * 3 + 3) // 4 * 4
    body = np.frombuffer(ours, np.uint8, offset=54).reshape(h, stride)[::-1]
    top_down[54:] = body.tobytes()
    np.testing.assert_array_equal(ic.decode(bytes(top_down)), _pil(bytes(top_down)))
    np.testing.assert_array_equal(ic.decode(ours), a[..., :3])


# ---------------------------------------------------------------------------
# baseline JPEG
# ---------------------------------------------------------------------------

def _jpeg(a, grey=False, **opts):
    img = Image.fromarray(a)
    if grey:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **opts)
    return buf.getvalue()


def _within_jpeg_bound(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN, (d.max(), d.mean())


JPEG_CASES = [(q, sub) for q in (50, 90, 95) for sub in ("4:4:4", "4:2:2", "4:2:0", "grey")]


@pytest.mark.parametrize("quality, sampling", JPEG_CASES,
                         ids=[f"q{q}_{s}" for q, s in JPEG_CASES])
def test_baseline_jpeg_within_bound_of_pil(quality, sampling):
    grey = sampling == "grey"
    opts = dict(quality=quality)
    if not grey:
        opts["subsampling"] = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling]
    for (h, w) in ((37, 53), (17, 9), (1, 1), (8, 3), (61, 130)):
        a = _pattern(h, w, seed=h + w)
        for restart in (None, 2):
            kw = dict(opts) if restart is None else dict(opts, restart_marker_blocks=restart)
            data = _jpeg(a, grey, **kw)
            assert (b"\xff\xdd" in data) == (restart is not None)
            _within_jpeg_bound(ic.decode(data), _pil(data))


@pytest.mark.parametrize("name", sorted(f[:-4] for f in os.listdir(FIXTURES)
                                        if f.endswith(".jpg")))
def test_committed_fixtures_equal_their_pil_decodes(name):
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIXTURES, name + ".npy"))
    _within_jpeg_bound(ic.decode(data, name), want)
    np.testing.assert_array_equal(_pil(data), want)     # the oracle's own decode


def test_format_comes_from_the_bytes_not_the_name(tmp_path):
    a = _pattern(9, 11)
    path = tmp_path / "actually_a.jpg"
    ic.write_png(str(path), a)
    np.testing.assert_array_equal(ic.read_image(path), a)
    with pytest.raises(ValueError, match="cannot identify"):
        ic.decode(b"not an image at all", "x.png")


def test_unsupported_formats_raise_naming_file_and_format():
    a = _pattern(16, 16)
    cases = {"JPEG": _jpeg(a, quality=90, progressive=True)}
    for fmt in ("GIF", "TIFF"):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt)
        cases[fmt] = buf.getvalue()
    cases["WebP"] = b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8)
    rows = np.zeros((4, 1 + 4 * 6), np.uint8)[:, 1:]
    cases["PNG"] = _png(rows, 4, 4, 16, 0, [0])
    cases["PNG "] = _png(np.zeros((4, 12), np.uint8), 4, 4, 8, 2, [0], interlace=1)
    buf = io.BytesIO()
    Image.fromarray(a).convert("P").save(buf, "BMP")
    cases["BMP"] = buf.getvalue()
    for fmt, data in cases.items():
        with pytest.raises(ic.UnsupportedImage, match=f"file_{fmt.strip()}.*{fmt.strip()}"):
            ic.decode(data, f"file_{fmt.strip()}")


# ---------------------------------------------------------------------------
# robustness: untrusted bytes only ever raise
# ---------------------------------------------------------------------------

_SEEDS = {"png": ic.encode_png(_pattern(12, 10)), "bmp": ic.encode_bmp(_pattern(7, 5)),
          "jpeg": _jpeg(_pattern(20, 18), quality=90, subsampling=2, restart_marker_blocks=1)}


@settings(max_examples=200, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(kind=st.sampled_from(sorted(_SEEDS)), cut=st.integers(0, 4000),
       flips=st.lists(st.tuples(st.integers(0, 4000), st.integers(0, 255)), max_size=6))
def test_truncated_and_mutated_bytes_only_raise(kind, cut, flips):
    data = bytearray(_SEEDS[kind])
    for pos, val in flips:
        data[pos % len(data)] = val
    data = bytes(data[:max(cut % (len(data) + 1), 0)]) if cut % 3 else bytes(data)
    try:
        out = ic.decode(data, "fuzz")
    except ValueError:
        return
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


def test_truncated_files_raise():
    for kind, data in _SEEDS.items():
        with pytest.raises(ValueError):
            ic.decode(data[:len(data) * 2 // 3], kind)


def test_decode_threads_agree_with_one_thread():
    blobs = [_jpeg(_pattern(40 + i, 33, seed=i), quality=90, subsampling=i % 3)
             for i in range(8)]
    one = [ic.decode(b) for b in blobs]
    with ThreadPoolExecutor(4) as pool:
        many = list(pool.map(ic.decode, blobs))
    assert all(np.array_equal(a, b) for a, b in zip(one, many))


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------

RESIZE_CASES = [((37, 53), (16, 16)), ((256, 300), (128, 128)), ((64, 64), (100, 90)),
                ((100, 37), (37, 100)), ((5, 7), (7, 5))]


@pytest.mark.parametrize("src, dst", RESIZE_CASES, ids=[f"{s}->{d}" for s, d in RESIZE_CASES])
def test_resize_bilinear_within_a_level_of_pil(src, dst):
    a = np.random.RandomState(sum(src)).randint(0, 256, src + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.BILINEAR))
    got = ic.resize_bilinear(a, dst[::-1])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= RESIZE_MAX


@pytest.mark.parametrize("src, dst", RESIZE_CASES, ids=[f"{s}->{d}" for s, d in RESIZE_CASES])
def test_resize_nearest_equals_pil(src, dst):
    a = np.random.RandomState(1).randint(0, 151, src).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.NEAREST))
    np.testing.assert_array_equal(ic.resize_nearest(a, dst[::-1]), want)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "image_codec.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(ic, "SRC", bad)
    monkeypatch.setattr(ic, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)image codec failed.*error"):
        ic.build()
    assert not any((tmp_path / "build").glob("*.so"))
