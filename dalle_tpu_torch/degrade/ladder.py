"""The response ladder: degradation verdicts → paged → drained (graftward).

Port of ``dalle_tpu/degrade/ladder.py`` (pure stdlib, as there).

:class:`DegradeMonitor` is the decide leg between the detectors and the
:class:`~..parallel.elastic.ElasticAgent`'s act leg. Each agent poll
feeds it the fleet's heartbeat snapshot; it returns :class:`DegradeAction`
rows — each emitted exactly ONCE per ok→degraded edge:

  * **straggler ladder** — a :class:`~.detector.StragglerDetector` verdict
    first **pages** (``DegradeAction(kind="page")``: log + counter +
    flight event, no membership change). If the worker stays flagged for
    ``straggler_escalate`` further completed fleet steps, the ladder
    escalates to **drain** — the agent then SIGTERMs the gang (everyone
    takes the graceful-preemption save at the next checkpoint boundary)
    and starts the next epoch *without* the straggler (the agent's shrink
    path; a slow host is hardware-suspect, so it loses its slot). A worker
    that recovers between the rungs resets to rung 0; a later relapse
    re-pages (edge semantics, never a page storm).
  * **health page** — a worker whose graftpulse sentry breached writes the
    breach into its heartbeat file (``Heartbeat.page``); the monitor
    treats the marker like a detector verdict already past its own
    hysteresis and goes straight to **drain** with
    ``reason="health_page"`` — the agent reshapes around it and
    **quarantine-respawns** (policy ``respawn``: the sick process is torn
    down and a fresh one takes the same slot; ``max_reconfigures`` bounds
    the crash loop if the fresh one pages again).

Pure stdlib. ``reset()`` on every epoch change — verdict state must never
outlive the membership it was computed over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .detector import StragglerDetector

# bounded reason tokens: these ride metric labels
# (``degrade.actions_total{reason=}``) and the agent's event log
REASON_STRAGGLER = "straggler"
REASON_HEALTH_PAGE = "health_page"


@dataclasses.dataclass(frozen=True)
class DegradeAction:
    kind: str              # "page" | "drain"
    worker_id: int
    reason: str            # REASON_STRAGGLER | REASON_HEALTH_PAGE
    detail: str = ""


class DegradeMonitor:
    def __init__(self, detector: Optional[StragglerDetector] = None, *,
                 straggler_escalate: int = 2, page_drain: bool = True):
        self.detector = (detector if detector is not None
                         else StragglerDetector())
        self.straggler_escalate = int(straggler_escalate)
        self.page_drain = bool(page_drain)
        # worker -> detector.processed at page time (escalation baseline)
        self._paged_at: Dict[int, int] = {}
        self._drained: set = set()
        self._health_paged: set = set()

    def reset(self) -> None:
        self.detector.reset()
        self._paged_at.clear()
        self._drained.clear()
        self._health_paged.clear()

    def observe(self, beats: Dict[int, dict],
                members: List[int]) -> List[DegradeAction]:
        actions: List[DegradeAction] = []
        # health pages first: a breach marker is a detector verdict that
        # already served its hysteresis inside the sentry
        if self.page_drain:
            for wid in members:
                page = (beats.get(wid) or {}).get("page")
                if not page or wid in self._health_paged:
                    continue
                self._health_paged.add(wid)
                actions.append(DegradeAction("page", wid, REASON_HEALTH_PAGE,
                                             detail=str(page)))
                if wid not in self._drained:
                    self._drained.add(wid)
                    actions.append(DegradeAction(
                        "drain", wid, REASON_HEALTH_PAGE, detail=str(page)))
        for v in self.detector.observe(beats, members):
            if v.worker_id in self._drained:
                continue
            self._paged_at[v.worker_id] = self.detector.processed
            actions.append(DegradeAction(
                "page", v.worker_id, REASON_STRAGGLER,
                detail=(f"wait deficit {v.deficit_s:.3f}s = {v.ratio:.2f}x "
                        f"the fleet step interval {v.interval_s:.3f}s "
                        f"at step {v.step}")))
        # escalation: still flagged straggler_escalate completed steps
        # after its page → drain (once)
        for wid, paged_at in list(self._paged_at.items()):
            if not self.detector.is_flagged(wid):
                self._paged_at.pop(wid)        # recovered between rungs
                continue
            if (self.detector.processed - paged_at
                    >= self.straggler_escalate and wid not in self._drained):
                self._drained.add(wid)
                self._paged_at.pop(wid)
                deficit = self.detector.deficit_of(wid)
                actions.append(DegradeAction(
                    "drain", wid, REASON_STRAGGLER,
                    detail=(f"sustained straggler after page "
                            f"(wait-deficit EWMA {deficit:.3f}s)"
                            if deficit is not None
                            else "sustained straggler after page")))
        return actions


def install_breach_pager(worker, sentry) -> None:
    """Chain a graftpulse :class:`~..obs.anomaly.HealthSentry`'s
    ``on_breach`` to the elastic worker's heartbeat page: a breach on THIS
    worker becomes a fleet-visible marker the agent's
    :class:`DegradeMonitor` drains on. Chains — never replaces — an
    existing sink (the ``train/actions.py BreachActions`` precedent), so
    local remediations and the fleet page both fire."""
    prev = sentry.on_breach

    def paged(breach, _prev=prev):
        if _prev is not None:
            _prev(breach)
        worker.page(f"{breach.detector}:{getattr(breach, 'group', '')}")

    sentry.on_breach = paged
