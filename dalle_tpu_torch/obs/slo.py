"""The SLO sentry: multi-window error-budget burn rates.

A copy of ``dalle_tpu/obs/slo.py`` (it imports no JAX), with the same
gauges and counters. The SRE Workbook's alerting chapter replaces "error
rate > X" with burn rates: how fast the service spends its error budget
(1 − objective), over several windows at once. A short window catches an
outage in minutes, a long one a slow leak, and requiring both keeps an
incident that already ended from paging anyone. The default page is a 14.4×
burn over 1 h gated on the same burn over the last 5 m.

``BurnRateSentry`` reads the gateway's outcomes: a completion is good; an
admission reject, a deadline shed, a replica failure or a deadline miss is
bad. Each window keeps time-bucketed good/bad counts (window/60 a bucket),
so a record costs O(1) under one lock. ``evaluate`` publishes
``slo.burn_rate{window=}``, ``slo.burn_threshold{window=}``,
``slo.burning`` and ``slo.error_budget`` and fires ``on_breach`` once per
ok→burning transition. The clock is injectable for tests.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence, Tuple

from .trace import gauge_set

# default: the SRE Workbook's fast-burn page — both the 5 m and 1 h windows
# exceeding 14.4× (2% of a 30-day budget burned in 1 h). The 5 m window is
# the "is it still happening" gate; the 1 h window is the pager.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((300.0, 14.4),
                                                    (3600.0, 14.4))

_BUCKETS_PER_WINDOW = 60


def window_label(seconds: float) -> str:
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


class _Window:
    """One sliding window as bucketed counts: a deque of
    ``[bucket_index, total, bad]`` plus running sums maintained on append
    and prune — O(1) per record, O(buckets) memory, never a history scan."""

    __slots__ = ("win_s", "threshold", "bucket_s", "buckets",
                 "total", "bad")

    def __init__(self, win_s: float, threshold: float):
        self.win_s = float(win_s)
        self.threshold = float(threshold)
        self.bucket_s = self.win_s / _BUCKETS_PER_WINDOW
        self.buckets: deque = deque()       # [idx, total, bad]
        self.total = 0
        self.bad = 0

    def prune(self, now: float) -> None:
        # drop buckets that lie ENTIRELY outside the window (their end is
        # older than now - win_s); the trailing partial bucket is kept, so
        # the window over-retains by at most bucket_s = win_s/60
        min_end = now - self.win_s
        dq = self.buckets
        while dq and (dq[0][0] + 1) * self.bucket_s <= min_end:
            _, t, b = dq.popleft()
            self.total -= t
            self.bad -= b

    def add(self, now: float, is_bad: bool) -> None:
        self.prune(now)
        idx = int(now / self.bucket_s)
        dq = self.buckets
        if not dq or dq[-1][0] != idx:
            dq.append([idx, 0, 0])
        dq[-1][1] += 1
        self.total += 1
        if is_bad:
            dq[-1][2] += 1
            self.bad += 1


class BurnRateSentry:
    """Error-budget burn over ``windows`` = ((seconds, threshold), ...).

    ``objective`` is the availability target (0.999 → 0.1% error budget).
    The sentry is BURNING when every window's burn rate meets its
    threshold (the multi-window AND — a window with no events yet counts
    as not burning, so a cold sentry never pages). ``min_events`` guards
    the short window against declaring a 1-for-1 outage on the first
    request of the process."""

    def __init__(self, objective: float = 0.999,
                 windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                 *, min_events: int = 10,
                 on_breach: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        assert 0.0 < objective < 1.0
        assert windows
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows = tuple((float(s), float(th)) for s, th in windows)
        self.min_events = int(min_events)
        self.on_breach = on_breach
        self.clock = clock
        self._wins = [_Window(s, th) for s, th in self.windows]
        self._lock = threading.Lock()
        self.burning = False
        self.breaches = 0
        self.good_total = 0
        self.bad_total = 0

    # -- feed --------------------------------------------------------------
    def record(self, good: bool, reason: str = "") -> None:
        """One request outcome. ``reason`` names the failure class for the
        labeled counter (quota / slo / queue_full / deadline_shed /
        deadline_miss / replica_failed)."""
        now = self.clock()
        with self._lock:
            for w in self._wins:
                w.add(now, not good)
            if good:
                self.good_total += 1
            else:
                self.bad_total += 1
        if not good and reason:
            from .trace import counter_add
            counter_add("slo.bad_events_total", 1.0,
                        labels={"reason": reason})
        self.evaluate(now)

    # -- judge -------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Prune, compute per-window burn, publish gauges, fire on_breach
        on the ok→burning transition. Returns
        ``{"burning": bool, "dominating": label|None, "windows": [...]}``
        — the dominating window is the one with the highest burn/threshold
        ratio among windows that have events."""
        if now is None:
            now = self.clock()
        rows = []
        burning = True
        dominating = None
        dom_ratio = -1.0
        with self._lock:
            for w in self._wins:
                w.prune(now)
                error_rate = w.bad / w.total if w.total else 0.0
                burn = error_rate / self.budget
                window_burning = (w.total >= self.min_events
                                  and burn >= w.threshold)
                burning = burning and window_burning
                label = window_label(w.win_s)
                rows.append({"window": label, "seconds": w.win_s,
                             "events": w.total, "bad": w.bad,
                             "error_rate": error_rate, "burn": burn,
                             "threshold": w.threshold,
                             "burning": window_burning})
                if w.total and burn / w.threshold > dom_ratio:
                    dom_ratio = burn / w.threshold
                    dominating = label
            was_burning = self.burning
            self.burning = burning
            if burning and not was_burning:
                self.breaches += 1
        for r in rows:
            labels = {"window": r["window"]}
            gauge_set("slo.burn_rate", r["burn"], labels=labels)
            gauge_set("slo.burn_threshold", r["threshold"], labels=labels)
        gauge_set("slo.burning", 1.0 if burning else 0.0)
        gauge_set("slo.error_budget", self.budget)
        out = {"burning": burning, "dominating": dominating,
               "windows": rows}
        if burning and not was_burning and self.on_breach is not None:
            try:
                self.on_breach(out)
            except Exception as exc:  # noqa: BLE001 - a crashing breach
                # sink (recorder dump racing shutdown) must not take the
                # serving thread that recorded the outcome down with it
                print(f"[graftscope] on_breach sink failed: {exc!r}")
        return out
