"""The flight recorder: a bounded black box for the serving path.

A copy of ``dalle_tpu/obs/recorder.py`` (it imports no JAX). It keeps what
explains a failure from before the failure, and dumps it as one bundle:

  * **lifecycle events**: a bounded ring of wall-clock-stamped dicts
    (``record_event``: request_admitted, request_completed, decode_quality,
    chaos_fault, ...), one deque append under a lock each.
  * **state snapshots**: ``register_state_provider`` lets a live subsystem
    (the decode engine, while ``run`` is active) expose a snapshot
    callable; the recorder collects them at dump time, and an optional
    sampler thread keeps a short history.
  * **counter deltas**: the obs metrics at each dump, with deltas against
    the previous dump.
  * **recent spans**: the span ring as a Perfetto trace with request
    tracks.

A bundle is a directory staged under a dot-tmp name beside its final name
and moved into place with ``os.replace``, so no reader sees half of one.
Dumps are rate-limited per reason.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# state providers: process-wide, so a reader can use them without a
# configured recorder
# ---------------------------------------------------------------------------

_providers: Dict[str, Callable[[], dict]] = {}
_providers_lock = threading.Lock()


def register_state_provider(name: str, fn: Callable[[], dict]) -> str:
    """Register a snapshot callable under ``name`` (the last registration
    wins); returns the name. Providers must be cheap and thread-safe."""
    with _providers_lock:
        _providers[name] = fn
    return name


def unregister_state_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def collect_state() -> dict:
    """Every registered provider's snapshot; one that raises gives an
    error string instead."""
    with _providers_lock:
        items = list(_providers.items())
    out = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 - a provider racing its own
            # teardown must not kill the dump
            out[name] = f"<provider error: {exc!r}>"
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded black box and atomic bundle writer (module docstring).

    ``outdir``: where bundles land, one directory a dump. ``capacity``
    bounds the event ring (overflow is counted). ``min_dump_interval_s``
    rate-limits dumps per reason (a suppressed dump is counted).
    ``sample_interval_s`` (None = off) starts a daemon thread that samples
    the state providers into a short history."""

    def __init__(self, outdir: str, *, capacity: int = 4096,
                 min_dump_interval_s: float = 5.0,
                 sample_interval_s: Optional[float] = None,
                 sample_keep: int = 256):
        self.outdir = outdir
        self.capacity = int(capacity)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.events: deque = deque(maxlen=self.capacity)
        self.events_dropped = 0
        self.dumps: List[str] = []
        self.dumps_suppressed = 0
        self.samples: deque = deque(maxlen=int(sample_keep))
        self._lock = threading.Lock()
        self._last_dump_at: Dict[str, float] = {}
        self._last_metrics: dict = {}
        self._seq = 0
        self._stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        if sample_interval_s is not None:
            self._sampler = threading.Thread(
                target=self._sample_loop, args=(float(sample_interval_s),),
                name="graftscope-sampler", daemon=True)
            self._sampler.start()

    # -- steady state ------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one wall-clock-stamped event. O(1), one lock."""
        rec = {"t": time.time(), "kind": kind, **fields}
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self.events_dropped += 1
            self.events.append(rec)

    def snapshot_events(self) -> List[dict]:
        """A copy of the event ring."""
        with self._lock:
            return list(self.events)

    def _sample_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            sample = {"t": time.time(), "state": collect_state()}
            # under the lock: dump() snapshots this deque
            with self._lock:
                self.samples.append(sample)

    def close(self) -> None:
        self._stop.set()
        if self._sampler is not None and self._sampler.is_alive():
            self._sampler.join(timeout=1.0)

    # -- the dump ----------------------------------------------------------
    def dump(self, reason: str, extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write a bundle; returns its path, or None when rate-limited (the
        same reason within ``min_dump_interval_s``, unless ``force``).

          postmortem.json: reason, wall time, events, state snapshots and
            their sampled history, metrics with deltas against the previous
            dump, open span stacks, thread names and ``extra``.
          trace.json: the span ring as a Perfetto trace with request tracks.
        """
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_at.get(reason)
            if not force and last is not None and \
                    now - last < self.min_dump_interval_s:
                self.dumps_suppressed += 1
                return None
            self._last_dump_at[reason] = now
            self._seq += 1
            seq = self._seq
            events = list(self.events)
            samples = list(self.samples)
        from . import trace as _trace
        snapshot = _trace.metrics_snapshot()
        with self._lock:
            prev = self._last_metrics
            self._last_metrics = dict(snapshot)
        deltas = {k: v - prev.get(k, 0) for k, v in snapshot.items()
                  if isinstance(v, (int, float))
                  and v != prev.get(k, 0)}
        doc = {
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "events": events,
            "events_dropped": self.events_dropped,
            "state": collect_state(),
            "state_samples": samples,
            "metrics": snapshot,
            "metrics_delta_since_last_dump": deltas,
            "open_spans": _trace.open_spans(),
            "threads": sorted(t.name for t in threading.enumerate()),
        }
        if extra:
            doc["extra"] = extra

        name = f"postmortem_{reason}_{seq:03d}_{int(time.time() * 1000)}"
        final = os.path.join(self.outdir, name)
        staging = os.path.join(self.outdir, f".tmp-{name}")
        os.makedirs(staging, exist_ok=True)
        with open(os.path.join(staging, "postmortem.json"), "w") as fh:
            json.dump(doc, fh, indent=1, default=repr)
        _trace.export_chrome_trace(os.path.join(staging, "trace.json"),
                                   request_tracks=True)
        os.replace(staging, final)
        self.dumps.append(final)
        return final


# ---------------------------------------------------------------------------
# the process-wide recorder and its hooks
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None


def configure_recorder(outdir: str, **kw) -> FlightRecorder:
    """Install the process-wide flight recorder (replacing any). Until
    then the hooks below are one ``None`` check each."""
    global _recorder
    if _recorder is not None:
        _recorder.close()
    _recorder = FlightRecorder(outdir, **kw)
    return _recorder


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def disable_recorder() -> None:
    global _recorder
    if _recorder is not None:
        _recorder.close()
    _recorder = None


def record_event(kind: str, **fields) -> None:
    """Append an event; no-op without a configured recorder."""
    rec = _recorder
    if rec is not None:
        rec.event(kind, **fields)


def dump_recorder(reason: str, extra: Optional[dict] = None,
                  force: bool = False) -> Optional[str]:
    """Dump a bundle; no-op without a configured recorder. A failing dump
    (a full disk, a teardown race) is printed and swallowed: the triggers
    sit on failure paths that must go on."""
    rec = _recorder
    if rec is None:
        return None
    try:
        return rec.dump(reason, extra=extra, force=force)
    except Exception as exc:  # noqa: BLE001 - see docstring
        print(f"[graftscope] {reason} bundle dump failed: {exc!r}")
        return None


def install_signal_dump(signum: Optional[int] = None) -> bool:
    """SIGQUIT (default) dumps a bundle with reason ``sigquit`` without
    killing the process. Main thread only; False where the platform or the
    thread forbids it."""
    import signal
    if signum is None:
        signum = getattr(signal, "SIGQUIT", None)
        if signum is None:        # windows
            return False

    def _handler(_sig, _frame):
        path = dump_recorder("sigquit", force=True)
        print(f"[graftscope] SIGQUIT bundle: {path}", flush=True)

    try:
        signal.signal(signum, _handler)
    except ValueError:            # not the main thread
        return False
    return True
