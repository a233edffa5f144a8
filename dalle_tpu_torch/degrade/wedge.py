"""Wedged-engine self-detection: the liveness probe a replica runs on itself.

A copy of ``dalle_tpu/degrade/wedge.py`` (it imports no JAX). A decode
engine that hangs mid-iteration (a stuck device call, a chaos ``wedge``
fault) leaves a process that still accepts connections and answers the
health verb. The missing signal is engine progress: a monotonic iteration
counter only the decode loop advances (``EngineStats.progress``).
:class:`WedgeWatchdog` polls a probe returning ``(progress, busy)`` and
declares a wedge when the engine is busy but its progress froze past the
timeout:

  * arm gate: no trip while the counter still reads 0 (a cold engine's
    first dispatch builds its kernels; slow, not wedged). The counter's
    value is the evidence, not a change between two polls;
  * idle is healthy: ``busy=False`` resets the clock;
  * edge-triggered: ``on_wedge`` fires once per frozen episode, and the
    counter advancing re-arms it. The sink usually latches
    ``Replica.mark_wedged``, so the health verb self-reports ``wedged`` and
    the fleet controller drains and replaces the replica.

The timeout bounds the longest legitimate dispatch: one decode iteration
(``steps_per_sync`` steps) or one prefill window.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple


class WedgeWatchdog:
    """``probe() -> (progress: int, busy: bool)`` polled every ``poll_s``;
    ``on_wedge(detail: str)`` fired on each healthy→wedged edge."""

    def __init__(self, probe: Callable[[], Tuple[int, bool]],
                 timeout_s: float, *,
                 on_wedge: Optional[Callable[[str], None]] = None,
                 poll_s: float = 0.25, clock=time.monotonic, log=print):
        assert timeout_s > 0
        self.probe = probe
        self.timeout_s = float(timeout_s)
        self.on_wedge = on_wedge
        self.poll_s = float(poll_s)
        self.clock = clock
        self.log = log
        self.wedged = False
        self.trips = 0
        self._armed = False
        self._last_progress: Optional[int] = None
        self._frozen_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the check (called by the thread; public for deterministic tests) --
    def check(self, now: Optional[float] = None) -> bool:
        """One poll. Returns True on a NEW healthy→wedged edge."""
        now = self.clock() if now is None else now
        try:
            progress, busy = self.probe()
        except Exception as exc:  # noqa: BLE001 - a dying probe must not
            # take the watchdog thread with it; the engine's own failure
            # path (worker death → replica_failed) owns that case
            self.log(f"[wedge-watchdog] probe failed: {exc!r}")
            return False
        # arm gate = the COUNTER's own evidence (progress > 0 means the
        # engine completed at least one dispatch this run — the
        # hung_workers "≥1 step" rule), NOT "changed between two polls":
        # a request can race the engine from idle to wedged inside one
        # poll interval, and a first-observation baseline at the frozen
        # value would then never arm
        if progress > 0:
            self._armed = True
        if self._last_progress is None:
            self._last_progress = progress
            self._frozen_since = now
            return False
        if progress != self._last_progress:
            self._last_progress = progress
            self._frozen_since = now
            if self.wedged:
                self.wedged = False            # progress resumed: re-arm
            return False
        if not busy:
            self._frozen_since = now           # idle ≠ wedged
            return False
        if (self._armed and not self.wedged
                and now - self._frozen_since > self.timeout_s):
            self.wedged = True
            self.trips += 1
            detail = (f"engine busy with no iteration progress for "
                      f"{now - self._frozen_since:.1f}s "
                      f"(> {self.timeout_s}s) at counter {progress}")
            if self.on_wedge is not None:
                try:
                    self.on_wedge(detail)
                except Exception as exc:  # noqa: BLE001 - the sink must
                    # not kill the watchdog; the wedge is already latched
                    self.log(f"[wedge-watchdog] on_wedge failed: {exc!r}")
            return True
        return False

    # -- thread lifecycle --------------------------------------------------
    def start(self) -> "WedgeWatchdog":
        assert self._thread is None
        self._thread = threading.Thread(target=self._loop,
                                        name="wedge-watchdog", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
