"""The native BPE merge core (``bpe_core.cpp``) behind ``ctypes``.

Built with ``g++`` at first use into ``build/native/`` at the repository
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one reused. A failed build or load raises with the
compiler's output; nothing falls back to the Python merge loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

SRC = Path(__file__).resolve().parent / "bpe_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libbpe_core-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless an up-to-date library is there; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native BPE core is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temp name, renamed into place: a process building at the
    # same time never loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native BPE core failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


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
