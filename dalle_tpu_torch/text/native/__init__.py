"""The native BPE merge core (``bpe_core.cpp``) behind ``ctypes``.

Built with ``g++`` at first use into ``build/native/`` at the repository
root (``utils/native_build.py``), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one reused. A
failed build or load raises with the compiler's output; nothing falls back
to the Python merge loop.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

from ...utils import native_build

SRC = Path(__file__).resolve().parent / "bpe_core.cpp"
BUILD_DIR = native_build.BUILD_DIR

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    return native_build.target(SRC, BUILD_DIR, "libbpe_core")


def build() -> Path:
    """Compile the core unless an up-to-date library is there; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    return native_build.build(SRC, BUILD_DIR, "libbpe_core", "BPE core")


def load() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.bpe_new.restype = ctypes.c_void_p
            lib.bpe_new.argtypes = [ctypes.c_char_p]
            lib.bpe_free.restype = None
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_encode_word.restype = ctypes.c_int32
            lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_char_p, ctypes.c_int32]
            _lib = lib
        return _lib


class NativeBPE:
    """One merge table in the C++ core. Symbols cross the boundary as
    UTF-8 joined by ``SEP``, which no byte-level symbol contains."""

    SEP = "\x01"

    def __init__(self, merges: List[tuple]):
        self._lib = load()
        text = "\n".join(self.SEP.join(pair) for pair in merges)
        self._handle = self._lib.bpe_new(text.encode("utf-8"))
        self._buf = ctypes.create_string_buffer(1 << 16)

    def encode_word(self, symbols: List[str]) -> List[str]:
        word = self.SEP.join(symbols).encode("utf-8")
        if len(word) + 1 > len(self._buf):   # merging only shortens a word
            self._buf = ctypes.create_string_buffer(len(word) + 1)
        n = self._lib.bpe_encode_word(self._handle, word, self._buf, len(self._buf))
        if n < 0:
            raise ValueError("word too long for the native BPE buffer")
        return self._buf.raw[:n].decode("utf-8").split(self.SEP)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None
