"""Heartbeat watchdog: "is the run hung or just building?" as a log line.

A copy of ``dalle_tpu/obs/watchdog.py`` (it imports no JAX). A daemon
thread watches a heartbeat the fit loop feeds once per step. If no beat
lands within the deadline it emits a stall report: the step, the seconds
idle, every thread's open span stack (a stall inside ``fit/batch_wait`` is
data starvation, inside ``fit/dispatch`` a device hang or a long kernel
build), the registered state providers' snapshots and a ``faulthandler``
dump of every thread's stack. One report per stall episode: the next beat
re-arms the trigger.

The deadline should exceed the worst expected gap: the first call of a
process builds the CUDA kernels (one ``nvcc`` per source, about a minute),
so runs on the card want ``watchdog_deadline_s`` of 120 s or more.
"""

from __future__ import annotations

import faulthandler
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .recorder import collect_state, dump_recorder
from .trace import open_spans


@dataclass
class StallReport:
    step: int
    idle_s: float
    wall_time: float
    open_spans: dict = field(default_factory=dict)
    stack_dump: str = ""
    # live-subsystem snapshots (obs/recorder.py state providers): a serving
    # stall report carries the engine's queue depth, slot occupancy and
    # in-flight request ids — "stuck with 14 queued and slot 3 on request
    # 8f2a… for 40 s" instead of just a span name
    state: dict = field(default_factory=dict)

    def format(self) -> str:
        lines = [f"[watchdog] STALL: no step completed for {self.idle_s:.1f}s "
                 f"(host step {self.step})"]
        if self.open_spans:
            for thread, stack in self.open_spans.items():
                lines.append(f"[watchdog]   open spans [{thread}]: "
                             + " > ".join(stack))
        else:
            lines.append("[watchdog]   no open spans (tracing off or idle "
                         "between spans)")
        for name, snap in self.state.items():
            lines.append(f"[watchdog]   state [{name}]: {snap}")
        if self.stack_dump:
            lines.append("[watchdog]   thread stacks:")
            lines.extend("[watchdog]     " + ln
                         for ln in self.stack_dump.splitlines())
        return "\n".join(lines)


def _dump_all_stacks() -> str:
    """All-threads python stacks via faulthandler (needs a real fd, so route
    through a temp file)."""
    with tempfile.TemporaryFile(mode="w+b") as fh:
        faulthandler.dump_traceback(file=fh, all_threads=True)
        fh.seek(0)
        return fh.read().decode("utf-8", errors="replace")


class StallWatchdog:
    """``beat(step)`` once per completed step; a daemon thread raises a stall
    report through ``log`` (and the optional ``on_stall`` callback) when the
    gap between beats exceeds ``deadline_s``. ``stall_count``/``last_report``
    are inspectable afterwards (the CI smoke asserts the watchdog stayed
    quiet; the unit test asserts a deliberate stall fires it)."""

    def __init__(self, deadline_s: float, *, log: Callable = print,
                 dump_stacks: bool = True, poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[StallReport], None]] = None):
        if deadline_s <= 0:
            raise ValueError("watchdog deadline must be > 0 (0 disables the "
                             "watchdog at the config layer, not here)")
        self.deadline_s = deadline_s
        self.log = log
        self.dump_stacks = dump_stacks
        self.on_stall = on_stall
        self.poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 1.0)
        self.stall_count = 0
        self.last_report: Optional[StallReport] = None
        self._step = 0
        self._last_beat = time.monotonic()
        self._armed = True            # one report per stall episode
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="grafttrace-watchdog")

    def start(self) -> "StallWatchdog":
        self._last_beat = time.monotonic()
        self._thread.start()
        return self

    def beat(self, step: int) -> None:
        self._step = step
        self._last_beat = time.monotonic()
        self._armed = True

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(self.poll_s * 4, 1.0))

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            idle = time.monotonic() - self._last_beat
            if idle <= self.deadline_s or not self._armed:
                continue
            self._armed = False
            report = StallReport(
                step=self._step, idle_s=idle, wall_time=time.time(),
                open_spans=open_spans(),
                stack_dump=_dump_all_stacks() if self.dump_stacks else "",
                state=collect_state())
            self.stall_count += 1
            self.last_report = report
            try:
                self.log(report.format())
                if self.on_stall is not None:
                    self.on_stall(report)
                # flight recorder (no-op unless configured): a stall is a
                # post-mortem trigger — the bundle freezes the spans and
                # serve state the report only summarizes
                dump_recorder("watchdog_stall", extra={
                    "step": report.step, "idle_s": report.idle_s,
                    "open_spans": report.open_spans, "state": report.state})
            except Exception as e:  # noqa: BLE001 - a crashing log sink must
                # not kill the watchdog thread (it would die silently and the
                # run would lose its only stall detector)
                print(f"[watchdog] stall-report sink failed: {e!r}")
