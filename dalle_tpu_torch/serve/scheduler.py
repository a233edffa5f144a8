"""Slot scheduler + scheduling policies for the decode batch.

A copy of ``dalle_tpu/serve/scheduler.py`` (it imports no JAX).

The device state is B anonymous slots; ``SlotScheduler`` maps slots ↔
requests and enforces the two scheduling invariants the engine tests pin
down:

  * work-conserving — after every admission pass, either no slot is free or
    the queue is empty (no idle slot while the queue holds work);
  * FIFO fairness — requests are admitted strictly in submission order (the
    queue pops FIFO and ``admit`` pairs them with free slots in order), so
    no request can be overtaken while waiting.

The POLICY layer (``PolicyQueue`` + ``SchedulingPolicy``) is the gateway's
multi-tenant extension: it changes which queued request is taken next —
priority tiers, earliest-deadline-first, and shedding of requests whose
deadline has already passed (serving a guaranteed SLO miss burns slot time
a live request could use; Orca's iteration-level scheduling makes the shed
point every admission pass, not just enqueue). FIFO stays the DEFAULT and
its fairness/work-conservation invariants stay pinned — a bare
``RequestQueue`` never reorders or sheds.

Pure Python: the engine owns the device tensors, this owns the mapping.
"""

from __future__ import annotations

import collections
import time
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Tuple)

from .queue import Request, RequestQueue


class SlotScheduler:
    def __init__(self, n_slots: int):
        assert n_slots >= 1
        self.n_slots = n_slots
        self._slots: List[Optional[Request]] = [None] * n_slots
        self.admitted_total = 0
        self.completed_total = 0
        # request ids in admit order, for FIFO-fairness auditing; bounded so
        # a long-lived engine stays O(1) — the most recent window is all a
        # fairness check needs
        self._admission_order: Deque[int] = collections.deque(maxlen=10_000)

    # -- queries -----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    def request_at(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    @property
    def any_active(self) -> bool:
        return any(r is not None for r in self._slots)

    @property
    def occupancy(self) -> float:
        """Fraction of slots holding an in-flight request."""
        return len(self.active_slots()) / self.n_slots

    @property
    def admission_order(self) -> List[int]:
        return list(self._admission_order)

    # -- transitions -------------------------------------------------------
    def admit(self, requests: Sequence[Request]) -> List[Tuple[int, Request]]:
        """Pair requests (already FIFO from the queue) with free slots in
        slot order. Raises if handed more requests than free slots — the
        engine must size its ``take`` by ``free_slots()``."""
        free = self.free_slots()
        if len(requests) > len(free):
            raise ValueError(
                f"admit({len(requests)} requests) with only {len(free)} "
                "free slots")
        pairs = []
        for slot, req in zip(free, requests):
            self._slots[slot] = req
            self._admission_order.append(req.request_id)
            self.admitted_total += 1
            pairs.append((slot, req))
        return pairs

    def complete(self, slot: int) -> Request:
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._slots[slot] = None
        self.completed_total += 1
        return req


# ---------------------------------------------------------------------------
# scheduling policies (the gateway's admission-order layer)
# ---------------------------------------------------------------------------

class SchedulingPolicy:
    """Decides which queued requests are taken next. ``order_key`` sorts the
    backlog ascending (ties broken by submission order — the queue passes
    the arrival index); ``should_shed`` drops a request at take time."""

    name = "fifo"

    def order_key(self, req: Request, arrival_idx: int):
        return arrival_idx

    def should_shed(self, req: Request, now: float) -> bool:
        return False


class FifoPolicy(SchedulingPolicy):
    """Strict submission order, never sheds — the pinned default."""


class PriorityDeadlinePolicy(SchedulingPolicy):
    """Priority tiers, then earliest deadline, then FIFO — and requests
    whose deadline already passed are shed at take time instead of occupying
    a slot for a guaranteed SLO miss. ``shed_slack_s`` keeps a just-expired
    request servable when the miss is marginal (default 0: any passed
    deadline sheds)."""

    name = "priority_deadline"

    def __init__(self, shed_slack_s: float = 0.0):
        self.shed_slack_s = float(shed_slack_s)

    def order_key(self, req: Request, arrival_idx: int):
        deadline = (req.deadline_at if req.deadline_at is not None
                    else float("inf"))
        return (-req.priority, deadline, arrival_idx)

    def should_shed(self, req: Request, now: float) -> bool:
        return (req.deadline_at is not None
                and now > req.deadline_at + self.shed_slack_s)


class PolicyQueue(RequestQueue):
    """A ``RequestQueue`` whose ``take`` follows a ``SchedulingPolicy``.

    Drop-in for the engine (same submit/take/close surface), so policy
    scheduling needs no engine change: the engine still takes up to its
    free-slot count per iteration; the policy only changes WHICH requests
    those are. Shed requests are handed to ``on_shed`` (called outside the
    lock — the gateway completes their streams with a deadline error) and
    counted in ``shed_total``. With the default ``FifoPolicy`` behavior is
    bit-identical to the base queue."""

    def __init__(self, maxsize: Optional[int] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 on_shed: Optional[Callable[[Request], None]] = None):
        super().__init__(maxsize=maxsize)
        self.policy = policy if policy is not None else FifoPolicy()
        self.on_shed = on_shed
        self.shed_total = 0

    def take(self, max_n: int) -> List[Request]:
        now = time.perf_counter()
        shed: List[Request] = []
        out: List[Request] = []
        with self._lock:
            keep = []
            for req in self._q:
                if self.policy.should_shed(req, now):
                    shed.append(req)
                else:
                    keep.append(req)
            # FIFO tie-break via request_id: ids are issued monotonically
            # under the queue lock (the high-water-mark rule), so they ARE
            # the arrival order — no side table to race with submit or leak
            keep.sort(key=lambda r: self.policy.order_key(r, r.request_id))
            out = keep[:max_n]
            self._q.clear()
            self._q.extend(keep[max_n:])
            self.shed_total += len(shed)
        if self.on_shed is not None:
            for req in shed:
                self.on_shed(req)
        return out
