"""Device telemetry: memory gauges and a run-time compile counter.

Port of ``dalle_tpu/obs/device.py`` under the same names and gauge keys.
Two questions a slow run raises, answered in-process without a profiler:

  * *Is the card's memory filling up?* ``device_memory_stats`` reads the
    caching allocator (``torch.cuda.memory_stats``: bytes allocated now
    and at peak) and the card's size (``torch.cuda.mem_get_info``). On the
    CPU the gauge is the process's resident set, so it is always present
    and always means "bytes this process holds on its device".
  * *Is it compiling?* The JAX package counts XLA compiles. What the port
    compiles at run time is its CUDA kernels: ``ops/_build.py`` runs one
    ``nvcc`` per source that has no up-to-date library (``build_all``) and
    loads each library once (``library``). ``CompileCounter`` counts both,
    so ``recompiles_per_100_steps`` above 0 after the first steps means a
    kernel was built or loaded mid-run.

``DeviceTelemetry`` bundles both into the poller ``fit`` calls at metrics
boundaries: memory in use and at peak, the compile total and its rate over
a sliding window of steps.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Optional

import torch


class CompileCounter:
    """The kernel builds and library loads of ``ops/_build.py`` in this
    process (``count``), read from its counters."""

    @property
    def count(self) -> int:
        from ..ops import _build
        return _build.compile_events["builds"] + _build.compile_events["loads"]


_counter: Optional[CompileCounter] = None


def install_compile_counter() -> CompileCounter:
    """The process's one counter (its source is ``ops/_build.py``'s, which
    counts from the process's start)."""
    global _counter
    if _counter is None:
        _counter = CompileCounter()
    return _counter


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _resident_bytes() -> int:
    """The process's resident set (``/proc/self/statm``), else its peak."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def device_memory_stats(device=None) -> dict:
    """Memory gauges of one device: ``{"hbm_bytes_in_use", "hbm_peak_bytes",
    "hbm_bytes_limit"}`` on a card (the caching allocator's bytes allocated
    now and at peak, and the card's size); ``{"hbm_bytes_in_use"}`` on the
    CPU (the resident set; ``DeviceTelemetry`` tracks its peak). Plain
    ints. Reads no tensor, so it synchronises nothing."""
    dev = _device(device)
    if dev.type != "cuda":
        return {"hbm_bytes_in_use": _resident_bytes()}
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"hbm_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "hbm_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "hbm_bytes_limit": int(total)}


def device_memory_headroom(device=None) -> Optional[int]:
    """Bytes an allocation on the device could still get: the card's free
    memory plus what the caching allocator holds unallocated; None on the
    CPU (no device limit). The gate of ``rollback_snapshot="auto"``."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    cached = (int(stats.get("reserved_bytes.all.current", 0))
              - int(stats.get("allocated_bytes.all.current", 0)))
    return int(free) + max(cached, 0)


class DeviceTelemetry:
    """Polled device gauges for the fit loop: memory in use and at peak, and
    the compile rate over a sliding window of steps
    (``recompiles_per_100_steps``)."""

    def __init__(self, device=None, window: int = 200):
        self.device = _device(device)
        self.counter = install_compile_counter()
        self.window = window
        self._hist: deque = deque()      # (step, cumulative compile count)
        self._peak = 0

    def poll(self, step: int) -> dict:
        out = device_memory_stats(self.device)
        self._peak = max(self._peak, out["hbm_bytes_in_use"])
        out.setdefault("hbm_peak_bytes", self._peak)
        compiles = self.counter.count
        self._hist.append((step, compiles))
        while len(self._hist) > 1 and step - self._hist[0][0] > self.window:
            self._hist.popleft()
        out["compiles_total"] = compiles
        step0, count0 = self._hist[0]
        if step > step0:
            out["recompiles_per_100_steps"] = 100.0 * (compiles - count0) / (step - step0)
        return out
