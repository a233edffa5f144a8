"""Straggler detection over heartbeat progress.

A copy of ``dalle_tpu/degrade/detector.py`` (it imports no JAX). In
lockstep SPMD every worker's step ends at a collective, so step rates and
arrival times are equal across the fleet and cannot name a slow worker.
What differs is how long each worker waited at the collective: the healthy
peers dispatch and park, the straggler arrives late and waits for nobody.
Heartbeats carry ``blocked_s`` beside ``step`` and ``step_time``;
:class:`StragglerDetector` aligns the fleet on common completed steps,
takes each worker's wait deficit (the median of the OTHER workers' blocked
time minus its own), smooths it (EWMA), normalises it by the fleet's step
interval, and needs the excess to sustain for several steps, with a
hysteresis band below the trip threshold, before an edge-triggered
verdict. Heartbeats without ``blocked_s`` make the detector inert, not
wrong. ``frozen_progress`` is the fresh-but-frozen check the fleet
transport's outside-in replica probe shares. Time enters only through the
heartbeat docs, so tests drive it deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


def frozen_progress(step, step_time, now: float, timeout_s: float) -> bool:
    """The fresh-but-frozen core shared by training liveness
    (``parallel/elastic.py hung_workers``) and the fleet's outside-in
    replica check (``fleet/transport.py``): a progress counter that has
    completed at least one unit (``step is not None`` — the arm gate that
    keeps a long first-step compile from reading as a hang) but has not
    advanced for ``timeout_s``."""
    return (step is not None and step_time is not None
            and now - float(step_time) > timeout_s)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    """One ok→straggling edge: ``deficit_s`` is the worker's EWMA wait
    deficit behind the median of its peers' collective waits,
    ``interval_s`` the fleet's EWMA step interval, ``ratio`` their
    quotient (≥ the detector's ``factor``)."""

    worker_id: int
    step: int
    deficit_s: float
    interval_s: float
    ratio: float


class _WorkerTrack:
    __slots__ = ("samples", "last_step", "deficit_ewma", "streak", "flagged")

    def __init__(self):
        # step -> (arrival wall clock, blocked_s or None)
        self.samples: Dict[int, Tuple[float, Optional[float]]] = {}
        self.last_step: Optional[int] = None
        self.deficit_ewma: Optional[float] = None
        self.streak = 0
        self.flagged = False


class StragglerDetector:
    """Feed :meth:`observe` the fleet's heartbeat docs every poll; it
    returns the NEW straggler verdicts (edge-triggered, empty most polls).

    Knobs:
      * ``factor`` — trip when EWMA wait deficit > ``factor`` × EWMA step
        interval (and > ``min_deficit_s`` absolute, so millisecond jitter
        on fast steps never trips). A host-side slowdown of ``d`` per step
        gives the victim a deficit of ≈ ``d`` against a coupled interval
        of ≈ ``base + d`` — the default 0.4 flags a worker responsible for
        ≳40% of every fleet step.
      * ``sustain`` — consecutive over-threshold steps required (the
        single-spike guard).
      * ``recover_ratio`` — a flagged worker clears only when its deficit
        falls under ``recover_ratio`` × the trip threshold (hysteresis:
        between the two thresholds the current state holds).
      * ``warmup_steps`` — completed fleet steps before any verdict (EWMAs
        need a baseline, and the symmetric first-step compile must not
        seed them; restore/compile phases are excluded by construction
        since samples only exist once steps advance).
    """

    def __init__(self, *, factor: float = 0.4, sustain: int = 3,
                 recover_ratio: float = 0.5, warmup_steps: int = 2,
                 alpha: float = 0.4, min_deficit_s: float = 0.05,
                 history: int = 64):
        assert factor > 0 and 0 < recover_ratio <= 1.0
        self.factor = float(factor)
        self.sustain = int(sustain)
        self.recover_ratio = float(recover_ratio)
        self.warmup_steps = int(warmup_steps)
        self.alpha = float(alpha)
        self.min_deficit_s = float(min_deficit_s)
        self.history = int(history)
        self._tracks: Dict[int, _WorkerTrack] = {}
        self._processed: int = 0               # completed fleet steps seen
        self._last_step: Optional[int] = None  # newest processed step
        self._last_median: Optional[float] = None
        self.interval_ewma: Optional[float] = None

    def reset(self) -> None:
        """Forget everything — a membership epoch change replaces the
        worker set and restarts the clocks; stale EWMAs from the previous
        gang must not pre-trip (or pre-clear) anyone in the new one."""
        self._tracks.clear()
        self._processed = 0
        self._last_step = None
        self._last_median = None
        self.interval_ewma = None

    @property
    def processed(self) -> int:
        """Completed fleet steps processed so far — the ladder's
        escalation clock (wall time would couple escalation speed to step
        speed exactly when a straggler has stretched the steps)."""
        return self._processed

    # -- per-worker state reads -------------------------------------------
    def deficit_of(self, worker_id: int) -> Optional[float]:
        t = self._tracks.get(worker_id)
        return t.deficit_ewma if t is not None else None

    def is_flagged(self, worker_id: int) -> bool:
        t = self._tracks.get(worker_id)
        return bool(t is not None and t.flagged)

    # -- the poll ----------------------------------------------------------
    def observe(self, beats: Dict[int, dict],
                members: List[int]) -> List[StragglerVerdict]:
        """Ingest one heartbeat snapshot (``elastic.read_heartbeats``
        shape: ``{wid: {"step": .., "step_time": .., "blocked_s": ..}}``)
        scoped to ``members``. Returns new verdicts (edges only)."""
        if len(members) < 2:
            return []                 # nobody to wait for
        for wid in members:
            doc = beats.get(wid)
            if doc is None:
                continue
            step, st = doc.get("step"), doc.get("step_time")
            if step is None or st is None:
                continue
            track = self._tracks.setdefault(int(wid), _WorkerTrack())
            if track.last_step is None or int(step) > track.last_step:
                track.last_step = int(step)
                blocked = doc.get("blocked_s")
                track.samples[int(step)] = (
                    float(st), float(blocked) if blocked is not None
                    else None)
                if len(track.samples) > self.history:
                    for s in sorted(track.samples)[:-self.history]:
                        del track.samples[s]
        return self._process(members)

    def _process(self, members: List[int]) -> List[StragglerVerdict]:
        tracks = {w: self._tracks.get(w) for w in members}
        if any(t is None for t in tracks.values()):
            return []
        verdicts: List[StragglerVerdict] = []
        while True:
            # the next fleet step every member has completed
            common = set.intersection(
                *(set(t.samples) for t in tracks.values()))
            pending = sorted(s for s in common
                             if self._last_step is None
                             or s > self._last_step)
            if not pending:
                return verdicts
            step = pending[0]
            arrivals = {w: t.samples[step][0] for w, t in tracks.items()}
            blocked = {w: t.samples[step][1] for w, t in tracks.items()}
            med_all = _median(list(arrivals.values()))
            if self._last_median is not None and self._last_step is not None:
                d_med = ((med_all - self._last_median)
                         / max(step - self._last_step, 1))
                if d_med > 0:
                    self.interval_ewma = (
                        d_med if self.interval_ewma is None
                        else self.interval_ewma
                        + self.alpha * (d_med - self.interval_ewma))
            self._last_step, self._last_median = step, med_all
            self._processed += 1
            if any(b is None for b in blocked.values()):
                continue              # no wait signal this step: inert
            for wid, t in tracks.items():
                others = [b for w, b in blocked.items() if w != wid]
                # median of the OTHERS: with n=2 this is the peer, so the
                # victim carries the full inversion instead of half of it
                # (and its peer goes negative rather than being dragged up)
                deficit = _median(others) - blocked[wid]
                t.deficit_ewma = (deficit if t.deficit_ewma is None
                                  else t.deficit_ewma
                                  + self.alpha
                                  * (deficit - t.deficit_ewma))
                if (self._processed <= self.warmup_steps
                        or self.interval_ewma is None):
                    continue
                thresh = max(self.min_deficit_s,
                             self.factor * self.interval_ewma)
                if t.flagged:
                    if t.deficit_ewma < self.recover_ratio * thresh:
                        t.flagged = False
                        t.streak = 0
                    continue
                if t.deficit_ewma > thresh:
                    t.streak += 1
                    if t.streak >= self.sustain:
                        t.flagged = True
                        verdicts.append(StragglerVerdict(
                            worker_id=wid, step=step,
                            deficit_s=t.deficit_ewma,
                            interval_s=self.interval_ewma,
                            ratio=t.deficit_ewma / self.interval_ewma))
                else:
                    t.streak = 0
