"""The port's image decoder and writer, in place of PIL.

The card's machine has no PIL, so the port reads its training images
itself. The format comes from the file's first bytes, never from its name
(a PNG named ``.jpg`` is read as a PNG):

* **PNG**: 8-bit gray, gray+alpha, RGB and RGBA, and palette or gray at
  1, 2, 4 or 8 bits; all five row filters; not interlaced. ``zlib``
  inflates, the native core undoes the filters.
* **BMP**: 24- and 32-bit, uncompressed, bottom-up or top-down.
* **Baseline JPEG** (SOF0, SOF1): 8-bit Huffman, restart intervals, gray
  and YCbCr at any sampling (4:4:4, 4:2:2, 4:2:0, ...), any size, decoded
  by the native core as libjpeg decodes by default (the integer inverse
  DCT, "fancy" triangle upsampling of the chroma, its YCbCr tables), so
  the pixels stay near PIL's.

Anything else (progressive JPEG, GIF, WebP, TIFF, 16-bit PNG, palette
BMP) raises :class:`UnsupportedImage`, naming the file and the format.
Loaders do not skip it as they skip a corrupt file: skipping would train
on another sample set than the JAX package, whose PIL decodes those
files. A truncated or corrupt file raises ``ValueError``.

Resizing runs on the host in torch: PIL's ``BILINEAR`` is
``F.interpolate(mode="bilinear", antialias=True)`` rounded to 8 bits
(within one level of PIL), PIL's ``NEAREST`` its own index rule (bit for
bit).

The native core (``native/image_codec.cpp``) is built with ``g++`` at
first use into ``build/native/`` (``utils/native_build.py``); a failed
build raises. Its ``ctypes`` calls release the GIL, so decode threads run
in parallel. ``write_png`` is the port's one PNG writer; ``encode_bmp``
writes BMPs.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import native_build

SRC = Path(__file__).resolve().parent / "native" / "image_codec.cpp"
BUILD_DIR = native_build.BUILD_DIR
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
MAX_PIXELS = 178956970            # PIL's decompression-bomb limit
_OK, _CORRUPT, _UNSUPPORTED = 0, -1, -2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class UnsupportedImage(ValueError):
    """A file in a format the port does not decode (PIL would)."""

    def __init__(self, name: str, fmt: str, detail: str = ""):
        super().__init__(f"{name}: {fmt} is not decoded by the port's image codec"
                         + (f" ({detail})" if detail else ""))
        self.name = name
        self.format = fmt


def build() -> Path:
    """Compile the core unless an up-to-date library is there."""
    return native_build.build(SRC, BUILD_DIR, "libimage_codec", "image codec")


def load() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p, err = ctypes.c_void_p, ctypes.c_char_p
            i32, i64, i32p = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, i64, i32, i32, i32, u8p, err, i32]
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_info.argtypes = [u8p, i64, i32p, i32p, i32p, err, i32]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [u8p, i64, u8p, i32, i32, i32, err, i32]
            _lib = lib
        return _lib


def sniff(data: bytes) -> Optional[str]:
    """The format named by the leading bytes, or None."""
    if data[:8] == PNG_MAGIC:
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:2] == b"BM":
        return "BMP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return None


def _call(fn, name: str, fmt: str, *args):
    msg = ctypes.create_string_buffer(256)
    rc = fn(*args, msg, len(msg))
    if rc == _UNSUPPORTED:
        raise UnsupportedImage(name, fmt, msg.value.decode(errors="replace"))
    if rc != _OK:
        raise ValueError(f"{name}: corrupt {fmt}: {msg.value.decode(errors='replace')}")


# -- PNG ---------------------------------------------------------------------

def _png_chunks(data: bytes, name: str):
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: PNG is truncated")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"{name}: PNG is truncated")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:end])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its checksum")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _decode_png(data: bytes, name: str):
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: bad PNG header")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{name}: PNG without a header")
    w, h, depth, color, _compression, _filter, interlace = ihdr
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: bad PNG size {w}x{h}")
    if interlace:
        raise UnsupportedImage(name, "PNG", "interlaced")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise ValueError(f"{name}: bad PNG colour type {color}")
    if depth == 16 or (depth != 8 and color not in (0, 3)) or depth not in (1, 2, 4, 8, 16):
        raise UnsupportedImage(name, "PNG", f"{depth}-bit colour type {color}")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a palette")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: corrupt PNG data: {exc}") from exc
    row_bytes = (w * channels * depth + 7) // 8
    out = np.empty((h, row_bytes), np.uint8)
    bpp = max(channels * depth // 8, 1)
    _call(load().png_unfilter, name, "PNG", raw, len(raw), row_bytes // bpp, h, bpp,
          out.ctypes.data)
    if depth < 8:
        bits = np.unpackbits(out, axis=1)[:, :w * depth].reshape(h, w, depth)
        out = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
        if color == 0 and depth > 1:     # PIL's "L;2" and "L;4" span 0..255
            out = out * np.uint8(255 // ((1 << depth) - 1))
    arr = out.reshape(h, w, channels)
    mode = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[color]
    if color == 0 and depth == 1:
        mode = "1"                        # PIL's bilevel mode: samples 0 and 1
    if mode in ("1", "L", "P"):
        arr = arr[..., 0]
    return arr, mode, palette


# -- BMP ---------------------------------------------------------------------

def _decode_bmp(data: bytes, name: str):
    if len(data) < 30:
        raise ValueError(f"{name}: BMP is truncated")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize == 12:
        w, h, _planes, bpp = struct.unpack("<HHHH", data[18:26])
        compression = 0
    elif hsize >= 40 and len(data) >= 14 + 40:
        w, h, _planes, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    else:
        raise ValueError(f"{name}: bad BMP header")
    if bpp not in (24, 32) or compression != 0:
        raise UnsupportedImage(name, "BMP", f"{bpp}-bit, compression {compression}")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: bad BMP size {w}x{h}")
    stride = (w * bpp + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: BMP is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    px = rows[:, :w * (bpp // 8)].reshape(h, w, bpp // 8)[..., 2::-1]
    return np.ascontiguousarray(px if top_down else px[::-1]), "RGB", None


# -- JPEG --------------------------------------------------------------------

def _decode_jpeg(data: bytes, name: str):
    lib = load()
    w, h, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    _call(lib.jpeg_info, name, "JPEG", data, len(data), ctypes.byref(w), ctypes.byref(h),
          ctypes.byref(n))
    out = np.empty((h.value, w.value, n.value), np.uint8)
    _call(lib.jpeg_decode, name, "JPEG", data, len(data), out.ctypes.data, w.value, h.value,
          n.value)
    return (out[..., 0], "L", None) if n.value == 1 else (out, "RGB", None)


# -- the entry points ----------------------------------------------------------

def decode_raw(data: bytes, name: str = "<bytes>"):
    """(samples, mode, palette) as PIL opens the file: mode "1", "L" or
    "P" gives (H, W) (0/1 for "1", palette indices for "P" with the (n, 3)
    palette beside),
    "LA", "RGB" and "RGBA" give (H, W, C); uint8."""
    fmt = sniff(data)
    if fmt == "PNG":
        return _decode_png(data, name)
    if fmt == "JPEG":
        return _decode_jpeg(data, name)
    if fmt == "BMP":
        return _decode_bmp(data, name)
    if fmt is not None:
        raise UnsupportedImage(name, fmt)
    raise ValueError(f"{name}: cannot identify the image format")


def to_rgb(arr: np.ndarray, mode: str, palette: Optional[np.ndarray] = None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of ``decode_raw``'s samples: gray is
    repeated, alpha dropped, a palette looked up (missing entries black)."""
    if mode == "RGB":
        return arr
    if mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3])
    if mode == "1":
        arr = arr * np.uint8(255)
    if mode in ("1", "L", "LA"):
        g = arr if mode != "LA" else arr[..., 0]
        return np.repeat(g[..., None], 3, axis=2)
    if mode == "P":
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[arr]
    raise ValueError(f"unknown mode {mode!r}")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Encoded bytes → (H, W, 3) uint8 RGB."""
    return to_rgb(*decode_raw(data, name))


def read_image(path) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode(f.read(), str(path))


def read_png(path) -> np.ndarray:
    """A PNG file → (H, W, 3) uint8 RGB (a file of another format raises)."""
    with open(path, "rb") as f:
        data = f.read()
    if sniff(data) != "PNG":
        raise ValueError(f"{path} is not a PNG")
    return to_rgb(*_decode_png(data, str(path)))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an 8-bit RGB PNG (no filtering)."""
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray):
    """One (H, W, 3) uint8 image as an 8-bit RGB PNG file."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def encode_bmp(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → a 24-bit uncompressed, bottom-up BMP."""
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"encode_bmp takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = image[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return header + info + rows.tobytes()


# -- resizing ----------------------------------------------------------------

def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``resize((w, h), BILINEAR)`` of an (H, W, C) uint8 image:
    antialiased bilinear in torch on the host, rounded to uint8."""
    w, h = size
    if (h, w) == img.shape[:2]:
        return img.copy()
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    out = F.interpolate(t, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).round_().clamp_(0, 255).to(torch.uint8).numpy()


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    # PIL's scale loop: x = s/2, then x += s per output, in float64, truncated
    s = n_in / n_out
    x = np.cumsum(np.concatenate([[s * 0.5], np.full(n_out - 1, s)]))
    return np.minimum(x.astype(np.int64), n_in - 1)


def resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``resize((w, h), NEAREST)``, bit for bit: its source indices,
    accumulated as PIL accumulates them."""
    w, h = size
    return arr[_nearest_index(arr.shape[0], h)][:, _nearest_index(arr.shape[1], w)]
