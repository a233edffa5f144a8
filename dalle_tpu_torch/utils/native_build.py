"""Build a host C++ core into a shared library at first use.

The port's native cores (the BPE merge loop, ``text/native/``; the image
decoder, ``data/native/``) are compiled with ``g++`` into
``build/native/`` at the repository root, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one
reused. A failed build raises with the compiler's output; nothing falls
back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def target(src: Path, build_dir: Path, stem: str,
           flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Where the library of ``src`` built with ``flags`` lives."""
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + Path(src).read_bytes())
    return Path(build_dir) / f"{stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path, stem: str, what: str,
          flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Compile ``src`` unless an up-to-date library is there; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    out = target(src, build_dir, stem, flags)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {what} is built at first use")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    # a private temp name, renamed into place: a process building at the
    # same time never loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native {what} failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out
