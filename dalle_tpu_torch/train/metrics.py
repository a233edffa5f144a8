"""Throughput, MFU, the profiler hook and the metrics sink.

Port of ``dalle_tpu/train/metrics.py``: ``ThroughputMeter`` (samples/s,
tokens/s and MFU every ``interval`` steps), the analytic FLOP and parameter
counts, ``profile_trace`` (``torch.profiler`` around one call, where the
JAX package runs ``jax.profiler``) and ``MetricsLogger`` (JSONL records
with the obs layer's counters and gauges merged in).

The MFU denominator comes from ``PEAK_TFLOPS``, keyed by
``torch.cuda.get_device_name()``: each entry is its card's data-sheet bf16
dense rate, at the power limit the data sheet assumes. A device without an
entry (the CPU among them) gets a 100 TFLOP/s placeholder and its reports
are tagged ``mfu_estimated``, as in the JAX package.

``MetricsLogger(use_wandb=True)`` raises: the card's machine has no
``wandb`` package and no network.
"""

from __future__ import annotations

import json
import time
import warnings
from typing import Optional

import torch

# bf16 dense tensor-core TFLOP/s by torch.cuda.get_device_name(), from each
# card's data sheet: (rate, the part and the power limit it assumes)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": (989.0, "H100 SXM5, 700 W"),
    "NVIDIA H100 PCIe": (756.0, "H100 PCIe, 350 W"),
}
UNKNOWN_PEAK_TFLOPS = 100.0

_warned_unknown_peak = False


def device_peak_tflops_info(device=None) -> tuple:
    """(peak bf16 TFLOP/s, estimated?): ``estimated`` is True when the
    device has no entry in ``PEAK_TFLOPS`` and the placeholder is used."""
    global _warned_unknown_peak
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    entry = PEAK_TFLOPS.get(name)
    if entry is not None:
        return entry[0], False
    if not _warned_unknown_peak:
        warnings.warn(f"unknown device {name!r}: MFU uses a {UNKNOWN_PEAK_TFLOPS:g} TFLOP/s "
                      "guess and reports are tagged mfu_estimated; add the card's "
                      "data-sheet rate to train/metrics.PEAK_TFLOPS")
        _warned_unknown_peak = True
    return UNKNOWN_PEAK_TFLOPS, True


def device_peak_tflops(device=None) -> float:
    return device_peak_tflops_info(device)[0]


class ThroughputMeter:
    """samples/s, tokens/s and MFU, reported every ``interval`` steps."""

    def __init__(self, batch_size: int, interval: int = 10, tokens_per_sample: int = 0,
                 flops_per_step: float = 0.0, num_chips: int = 1, device=None):
        self.batch = batch_size
        self.interval = interval
        self.tokens_per_sample = tokens_per_sample
        self.flops_per_step = flops_per_step
        self.num_chips = max(num_chips, 1)
        self.device = device
        self._t0 = time.perf_counter()
        self._last_step = 0
        self._last_report = None

    def step(self, step_num: int):
        """Call at any step numbers (e.g. only at metrics boundaries); rates
        use the steps actually elapsed. None between reports."""
        if step_num - self._last_step < self.interval or step_num == 0:
            return None
        now = time.perf_counter()
        dt = now - self._t0
        n_steps = step_num - self._last_step
        self._t0 = now
        self._last_step = step_num
        sps = self.batch * n_steps / dt
        rep = {"sample_per_sec": sps, "step_time_s": dt / n_steps}
        if self.tokens_per_sample:
            rep["tokens_per_sec"] = sps * self.tokens_per_sample
            rep["tokens_per_sec_per_chip"] = sps * self.tokens_per_sample / self.num_chips
        if self.flops_per_step:
            achieved = self.flops_per_step * n_steps / dt
            peak_tflops, estimated = device_peak_tflops_info(self.device)
            rep["mfu"] = achieved / (peak_tflops * 1e12 * self.num_chips)
            if estimated:
                rep["mfu_estimated"] = True
        self._last_report = rep
        return rep


def count_params(model: torch.nn.Module) -> int:
    """Elements over every parameter; a layer shared between depths counts
    once, as in the flax tree."""
    return sum(p.numel() for p in model.parameters())


def transformer_train_flops(n_params: int, tokens_per_batch: int) -> float:
    """6·N·D analytic training FLOPs per step (forward + backward)."""
    return 6.0 * n_params * tokens_per_batch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class profiled:
    """``with profiled(logdir):`` runs its body under ``torch.profiler`` (the
    CPU, and the card when there is one), synchronises the card before the
    profiler stops, and writes ``<logdir>/trace.json`` (Chrome trace
    format). ``prof`` is the profiler, for ``key_averages()``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.prof = None

    def __enter__(self):
        import os
        os.makedirs(self.logdir, exist_ok=True)
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        return False


def profile_trace(logdir: str, fn, *args):
    """A ``torch.profiler`` trace around one call of ``fn`` into ``logdir``
    (``trace.json``); returns what ``fn`` returns."""
    with profiled(logdir):
        out = fn(*args)
    return out


class MetricsLogger:
    """Experiment metrics as JSONL on disk: one record a ``log`` call, with
    the obs layer's counters and gauges (``obs.metrics_snapshot``) merged
    in and numeric scalars of any kind (0-d tensors and numpy scalars
    among them) as floats."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 project: str = "dalle-tpu", config: Optional[dict] = None,
                 run_name: Optional[str] = None):
        if use_wandb:
            raise ImportError("use_wandb needs the wandb package, which the card's machine "
                              "does not have (and it has no network); the JSONL is written "
                              "without it")
        self._fh = open(path, "a") if path else None

    @staticmethod
    def _coerce_scalar(v):
        """Numeric scalars → float (bools, ints, strings as they are); None
        for anything else."""
        if isinstance(v, (bool, int, float, str)):
            return v
        if getattr(v, "ndim", None) == 0:
            try:
                return float(v)
            except (TypeError, ValueError):
                return None
        return None

    def log(self, step: int, metrics: dict):
        from ..obs import metrics_snapshot
        merged = {**metrics, **metrics_snapshot()}
        coerced = ((k, self._coerce_scalar(v)) for k, v in merged.items())
        rec = {"step": step, "time": time.time(),
               **{k: v for k, v in coerced if v is not None}}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def log_images(self, step: int, images, key: str = "samples", captions=None):
        """No-op: image logging goes to wandb in the JAX package."""

    def log_artifact(self, path: str, name: str, type: str = "model",
                     metadata: Optional[dict] = None):
        """No-op: artifact upload goes to wandb in the JAX package."""

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
