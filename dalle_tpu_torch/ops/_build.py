"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and loaded with ``ctypes``.
Nothing happens at import: the first call that needs a kernel builds it. All
sources build at once, one ``nvcc`` process each, started together.

The library lands in ``build/kernels/`` at the repository root, named by a
hash of its source, the local headers it includes (``#include "x.cuh"``,
followed through headers) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, spills) per source built
build_logs: Dict[str, str] = {}
# what this process compiled and loaded at run time: nvcc runs started and
# libraries loaded (obs/device.CompileCounter reads them)
compile_events: Dict[str, int] = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use and need the CUDA toolkit")
    return nvcc


def _sources(src: Path) -> List[Path]:
    """``src`` and the local headers it includes, directly or through other
    headers, each once (a quoted include found next to its includer)."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        text = f.read_text(encoding="utf-8", errors="replace")
        todo += [f.parent / name for name in _INCLUDE.findall(text)
                 if (f.parent / name).is_file()]
    return seen


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all in
    parallel. Returns {source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    todo = {k: v for k, v in targets.items() if not v[1].exists()}
    procs = {}
    for name, (src, out) in todo.items():
        # a private temp name, renamed into place: concurrent builders never
        # load a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
        compile_events["builds"] += 1
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {k: v[1] for k, v in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
            compile_events["loads"] += 1
        return lib
