"""Replica router: health-checked, queue-depth-aware dispatch + failover.

A copy of ``dalle_tpu/gateway/router.py`` (it imports no JAX), with the
same events, counters and failover reasons.

The router is the fleet's one policy point: every admitted request is
dispatched to the healthy replica with the least backlog (queued +
in-slot — join-the-shortest-queue, the right greedy under homogeneous
replicas), overflowing to the next-best when a bounded queue rejects. On a
mid-stream replica death it resubmits the request — same text, same seed —
to another replica and splices the two streams: generation is deterministic
per seed, so the resumed stream's rows are bit-identical and the router
simply skips rows the client already has. Failover is therefore EXACT, not
best-effort; the only client-visible artifact is added latency.

``drain()`` is the graceful-shutdown half: stop accepting (the gateway
returns 503), let every replica finish its queued + in-flight work, join
the workers.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

from ..obs import counter_add, dump_recorder, gauge_set, record_event
from ..obs.context import new_trace_id
from ..serve.queue import QueueFull
from .replica import GroupStream, Replica, ResultStream, classify_failure

_gids = itertools.count()


class NoReplicaAvailable(RuntimeError):
    """No healthy replica could accept the request (all dead or all full)."""


def _count_failover(trace_id: str, replica_id: str, failovers: int,
                    payload, group: bool = False) -> str:
    """Shared failover bookkeeping for single and group streams: the
    stable unlabeled total (pre-fleet dashboards), the reason-labeled
    family (``classify_failure`` — the one mapping, shared with the fleet
    transport), and the lifecycle event — all BEFORE the resubmission
    attempt so a post-mortem bundle holds the classification next to the
    death. The wire contract pins 'failover' to the request machine's
    decode->failed->readmitted transitions (wire_flow.EVENT_EDGES); an
    event name this plane emits without a declared transition fails
    wire_audit."""
    reason = classify_failure(payload)
    counter_add("gateway.failovers_total", 1.0)
    counter_add("gateway.failover_total", 1.0, labels={"reason": reason})
    record_event("failover", trace_id=trace_id, from_replica=replica_id,
                 failovers=failovers, reason=reason,
                 **({"group": True} if group else {}), detail=payload)
    return reason


class RoutedStream:
    """A request's event stream across failovers. Yields normalized,
    JSON-ready events:

      ("row",  {"row": r, "tokens": [...]})
      ("done", {"tokens": [...], "ttft_s": .., "latency_s": ..,
                "replica": id, "failovers": n})
      ("error",{"reason": "deadline_shed" | "replica_failed", "detail": ..})

    Rows repeat after a failover (the replacement replica regenerates from
    token 0); the stream suppresses every row below the high-water mark, so
    consumers see each row exactly once and in order."""

    def __init__(self, router: "ReplicaRouter", stream: ResultStream,
                 replica: Replica, submit_kwargs: dict, gateway_id: int):
        self.router = router
        self.gateway_id = gateway_id
        self._stream = stream
        self._replica = replica
        self._kw = submit_kwargs
        self.failovers = 0

    @property
    def replica_id(self) -> str:
        return self._replica.replica_id

    @property
    def trace_id(self) -> str:
        return self._kw["trace_id"]

    def events(self, timeout: Optional[float] = 30.0):
        next_row = 0
        while True:
            for kind, payload in self._stream.events(
                    timeout=timeout,
                    # a quiet stream on a HEALTHY replica is backlog, not
                    # failure: keep waiting instead of resubmitting work
                    # that is still queued (duplicate-load spiral)
                    still_alive=lambda: self._replica.healthy):
                if kind == "row":
                    row, tokens = payload
                    if row < next_row:
                        continue           # already delivered pre-failover
                    next_row = row + 1
                    yield ("row", {"row": row, "tokens": tokens})
                elif kind == "done":
                    yield ("done", {
                        "tokens": [int(t) for t in payload.tokens],
                        "ttft_s": payload.ttft_s,
                        "latency_s": payload.latency_s,
                        # slot-time consumed (admission→done): the
                        # gateway's estimator feed, topology-uniform —
                        # local CompletedRequest and the wire's
                        # RemoteCompletion both carry it
                        "decode_s": getattr(payload, "decode_s",
                                            payload.latency_s),
                        "replica": self._replica.replica_id,
                        "failovers": self.failovers})
                    return
                elif kind == "shed":
                    yield ("error", {"reason": "deadline_shed",
                                     "detail": "deadline passed while "
                                               "queued; request shed"})
                    return
                else:                      # replica_failed
                    self.failovers += 1
                    # lifecycle event BEFORE the resubmission attempt, then
                    # a post-mortem bundle: the bundle's event ring holds
                    # this failover next to the replica_failed event, and
                    # its trace still holds the dead worker's last spans
                    _count_failover(self._kw["trace_id"],
                                    self._replica.replica_id,
                                    self.failovers, payload)
                    if self.failovers > len(self.router.replicas):
                        # failover budget: a request that has killed (or
                        # been failed by) more replicas than the fleet has
                        # is itself the likely poison — stop resubmitting
                        # it before it takes the whole fleet down again
                        yield ("error", {"reason": "replica_failed",
                                         "detail": "failover budget "
                                                   "exhausted"})
                        return
                    try:
                        # resubmission reuses self._kw VERBATIM — same
                        # text, same seed, same trace_id — so the resumed
                        # stream is bit-identical AND the request keeps one
                        # timeline identity across both replicas
                        self._replica, self._stream = \
                            self.router._dispatch(**self._kw)
                    except (NoReplicaAvailable, QueueFull) as exc:
                        yield ("error", {"reason": "replica_failed",
                                         "detail": f"no failover target: "
                                                   f"{exc}"})
                        return
                    dump_recorder("failover", extra={
                        "trace_id": self._kw["trace_id"],
                        "resubmitted_to": self._replica.replica_id})
                    break                  # re-enter on the new stream
            else:
                return


class RoutedGroup:
    """A multi-candidate (/v1/images) request's merged event stream across
    failovers. Yields normalized, JSON-ready events:

      ("row",  {"candidate": c, "row": r, "tokens": [...]})
      ("done", {"candidates": [[tokens]...], "ttft_s": .., "latency_s": ..,
                "replica": id, "failovers": n})
      ("error",{"reason": "deadline_shed" | "replica_failed", "detail": ..})

    Failover resubmits the WHOLE group — same text, same per-candidate
    seeds, same trace_id — so every candidate's regenerated stream is
    bit-identical; per-candidate row high-water marks suppress repeats, and
    candidates that already completed before the death keep their first
    (identical) result."""

    def __init__(self, router: "ReplicaRouter", stream: GroupStream,
                 replica: Replica, submit_kwargs: dict, gateway_id: int):
        self.router = router
        self.gateway_id = gateway_id
        self._stream = stream
        self._replica = replica
        self._kw = submit_kwargs
        self.failovers = 0
        self.n = len(submit_kwargs["seeds"])

    @property
    def replica_id(self) -> str:
        return self._replica.replica_id

    @property
    def trace_id(self) -> str:
        return self._kw["trace_id"]

    def events(self, timeout: Optional[float] = 30.0):
        next_row = [0] * self.n
        done: dict = {}
        while True:
            for idx, kind, payload in self._stream.events(
                    timeout=timeout,
                    still_alive=lambda: self._replica.healthy):
                if kind == "row":
                    row, tokens = payload
                    if row < next_row[idx]:
                        continue           # already delivered pre-failover
                    next_row[idx] = row + 1
                    yield ("row", {"candidate": idx, "row": row,
                                   "tokens": tokens})
                elif kind == "done":
                    # post-failover regeneration of an already-finished
                    # candidate is bitwise the first result — keep the first
                    done.setdefault(idx, payload)
                    if len(done) == self.n:
                        crs = [done[i] for i in range(self.n)]
                        yield ("done", {
                            "candidates": [[int(t) for t in cr.tokens]
                                           for cr in crs],
                            "ttft_s": min(cr.ttft_s for cr in crs),
                            "latency_s": max(cr.latency_s for cr in crs),
                            # slowest candidate's slot time: one
                            # per-request service-rate sample per group
                            # for the estimator (candidates decode
                            # concurrently, so summing would overcount)
                            "decode_s": max(
                                getattr(cr, "decode_s", cr.latency_s)
                                for cr in crs),
                            "replica": self._replica.replica_id,
                            "failovers": self.failovers})
                        return
                elif kind == "shed":
                    yield ("error", {"reason": "deadline_shed",
                                     "detail": "deadline passed while "
                                               "queued; request shed"})
                    return
                else:                      # replica_failed → group failover
                    self.failovers += 1
                    _count_failover(self._kw["trace_id"],
                                    self._replica.replica_id,
                                    self.failovers, payload, group=True)
                    if self.failovers > len(self.router.replicas):
                        yield ("error", {"reason": "replica_failed",
                                         "detail": "failover budget "
                                                   "exhausted"})
                        return
                    try:
                        # the WHOLE group resubmits with self._kw VERBATIM —
                        # same text, same seeds, same trace_id — so the
                        # shared prefill happens once on the new replica and
                        # every candidate regenerates bit-identically
                        self._replica, self._stream = \
                            self.router._dispatch_group(**self._kw)
                    except (NoReplicaAvailable, QueueFull) as exc:
                        yield ("error", {"reason": "replica_failed",
                                         "detail": f"no failover target: "
                                                   f"{exc}"})
                        return
                    dump_recorder("failover", extra={
                        "trace_id": self._kw["trace_id"],
                        "group": True,
                        "resubmitted_to": self._replica.replica_id})
                    break                  # re-enter on the new stream
            else:
                return


class ReplicaRouter:
    """Replicas may be in-process :class:`~.replica.Replica` threads or
    :class:`~..fleet.transport.RemoteReplica` processes — the
    router dispatches to both uniformly (the fleet contract).
    Membership is dynamic: the fleet controller adds/removes replicas
    while requests are in flight, so the list is snapshotted under a lock
    at every read."""

    def __init__(self, replicas: List[Replica]):
        assert replicas
        self._replicas = list(replicas)
        self._members_lock = threading.Lock()
        self.draining = False

    @property
    def replicas(self) -> List[Replica]:
        with self._members_lock:
            return list(self._replicas)

    # -- fleet membership (the fleet controller) --------------------------
    def add_replica(self, replica) -> None:
        with self._members_lock:
            self._replicas.append(replica)
        gauge_set("gateway.replicas", float(len(self.replicas)))

    def remove_replica(self, replica_or_id) -> Optional[Replica]:
        """Take a replica out of dispatch (by object or replica_id).
        In-flight streams on it are NOT touched here — the caller drains,
        migrates or lets failover handle them. Returns the removed replica
        (None when not present — removing twice is a no-op, not an
        error)."""
        removed = None
        with self._members_lock:
            for r in self._replicas:
                if r is replica_or_id or r.replica_id == replica_or_id:
                    removed = r
                    break
            if removed is not None:
                self._replicas.remove(removed)
        gauge_set("gateway.replicas", float(len(self.replicas)))
        return removed

    # -- fleet state -------------------------------------------------------
    def healthy_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    def health(self) -> dict:
        rows = [r.health() for r in self.replicas]
        healthy = sum(1 for r in rows if r["healthy"])
        gauge_set("gateway.replicas_healthy", float(healthy))
        return {"status": ("draining" if self.draining else
                           "ok" if healthy else "unavailable"),
                "replicas": rows}

    @property
    def total_backlog(self) -> int:
        return sum(r.load for r in self.healthy_replicas())

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, **submit_kwargs):
        """(replica, stream) on the least-loaded healthy replica, walking
        the load order on QueueFull; raises when the fleet is exhausted."""
        candidates = sorted(self.healthy_replicas(), key=lambda r: r.load)
        if not candidates:
            raise NoReplicaAvailable("no healthy replicas")
        last: Optional[BaseException] = None
        for replica in candidates:
            try:
                return replica, replica.submit(**submit_kwargs)
            except RuntimeError as exc:
                # QueueFull, ReplicaFailure and a closed queue (racing
                # drain) are all RuntimeErrors → try next-best; anything
                # escaping here would drop the client connection instead
                # of a clean 429/503
                last = exc
        raise last if isinstance(last, QueueFull) else \
            NoReplicaAvailable(repr(last))

    def submit(self, text, seed: int, *, max_tokens: Optional[int] = None,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               cond_scale: float = 1.0) -> RoutedStream:
        """Dispatch one request; raises QueueFull / NoReplicaAvailable when
        nothing can take it (the gateway maps those to 429/503).
        ``trace_id`` is the propagated trace identity (minted here for
        direct callers); it rides the resubmission kwargs, so a failover
        keeps the request on one timeline."""
        if self.draining:
            raise NoReplicaAvailable("gateway is draining")
        if trace_id is None:
            trace_id = new_trace_id()
        deadline_at = (time.perf_counter() + deadline_s
                       if deadline_s is not None else None)
        kw = dict(text=text, seed=seed, max_tokens=max_tokens,
                  tenant=tenant, priority=priority, deadline_at=deadline_at,
                  trace_id=trace_id, cond_scale=cond_scale)
        replica, stream = self._dispatch(**kw)
        return RoutedStream(self, stream, replica, kw, next(_gids))

    def _dispatch_group(self, **submit_kwargs):
        """(replica, GroupStream) on the least-loaded healthy replica that
        can take the WHOLE group — candidates must land on one replica to
        share their prefix prefill (and a split group would rank against
        half its candidates)."""
        candidates = sorted(self.healthy_replicas(), key=lambda r: r.load)
        if not candidates:
            raise NoReplicaAvailable("no healthy replicas")
        last: Optional[BaseException] = None
        for replica in candidates:
            try:
                return replica, replica.submit_group(**submit_kwargs)
            except RuntimeError as exc:
                last = exc
        raise last if isinstance(last, QueueFull) else \
            NoReplicaAvailable(repr(last))

    def submit_images(self, text, seeds, *,
                      max_tokens: Optional[int] = None,
                      tenant: str = "default", priority: int = 0,
                      deadline_s: Optional[float] = None,
                      trace_id: Optional[str] = None,
                      cond_scale: float = 1.0) -> "RoutedGroup":
        """Dispatch one multi-candidate request (the /v1/images fan-out):
        ``seeds`` fixes every candidate's sampling stream, so the group —
        including its failover resubmission — is deterministic end to
        end."""
        if self.draining:
            raise NoReplicaAvailable("gateway is draining")
        if trace_id is None:
            trace_id = new_trace_id()
        deadline_at = (time.perf_counter() + deadline_s
                       if deadline_s is not None else None)
        kw = dict(text=text, seeds=list(seeds), max_tokens=max_tokens,
                  tenant=tenant, priority=priority, deadline_at=deadline_at,
                  trace_id=trace_id, cond_scale=cond_scale)
        replica, stream = self._dispatch_group(**kw)
        return RoutedGroup(self, stream, replica, kw, next(_gids))

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful: stop accepting, finish all accepted work, join all
        workers."""
        self.draining = True
        for r in self.replicas:
            try:
                r.queue.close()
            except Exception:  # noqa: BLE001 - double-close race is fine
                pass
        for r in self.replicas:
            r.drain(timeout=timeout)
