"""One serving replica: a decode engine + policy queue + worker thread.

Port of ``dalle_tpu/gateway/replica.py``, with the same streams, events,
counters and health fields. A replica is the unit of capacity and of
failure. It owns a ``DecodeEngine``, a ``PolicyQueue`` feeding it, and the
single worker thread running ``engine.run`` on that thread's default CUDA
stream (the gateway's preview decodes and pipeline stages run on side
streams of their own). Every submitted request gets a ``ResultStream``, a
thread-safe event pipe the engine callbacks feed (rows, completion) and an
HTTP handler drains from its own thread; the engine thread never blocks on
a slow consumer. The rows reach the stream as plain ints.

Failure semantics: if the worker thread dies (a device error, a poisoned
request; in tests ``fail_after_rows``), the replica records the exception,
dumps the flight recorder, marks itself unhealthy, and every in-flight and
still-queued request's stream gets a terminal ``replica_failed`` event.
The router turns that into failover: per-request seeds make regeneration
deterministic, so a resubmitted stream's rows are bit-identical and the
client sees only the rows it has not received yet.

``aot_dir`` (the JAX package's serialized executables) raises: its
counterpart is CUDA-graph capture, ``ROADMAP.md`` Queue 1 item 2.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
from typing import Callable, List, Optional, Tuple

from ..obs import counter_add, dump_recorder, record_event
from ..serve.queue import QueueFull, Request
from ..serve.scheduler import PolicyQueue, SchedulingPolicy

Event = Tuple[str, object]     # ("row"|"done"|"shed"|"replica_failed", ...)

_ids = itertools.count()


class ReplicaFailure(RuntimeError):
    """Injected worker failure (tests / chaos): the worker thread treats it
    like any other crash — unhealthy replica, failover events."""


def classify_failure(payload) -> str:
    """The ONE payload→failover-reason mapping, shared by the router's
    labeled counter (in-process failures) and the fleet transport's wire
    frames (remote failures) so the same failure gets the same
    ``gateway.failover_total{reason=}`` label on both topologies. Dict
    payloads carry their reason explicitly (``conn_reset``/``conn_timeout``
    from the fleet transport, ``drain``/``health_page``/``decode_degraded``
    from a migrate); the stream's bare "event timeout" string means an
    unhealthy replica went quiet; any other string is a worker-thread
    death (repr of the killing exception)."""
    if isinstance(payload, dict):
        return str(payload.get("reason", "worker_death"))
    if payload == "event timeout":
        return "unhealthy_timeout"
    return "worker_death"


class ResultStream:
    """Per-request event pipe: engine thread puts, consumer thread gets.
    Terminal events: ``done``, ``shed``, ``replica_failed``."""

    TERMINAL = ("done", "shed", "replica_failed")

    def __init__(self, request: Optional[Request]):
        self.request = request
        self._q: _queue.Queue = _queue.Queue()

    def put(self, kind: str, payload=None) -> None:
        self._q.put((kind, payload))

    def events(self, timeout: Optional[float] = 30.0, still_alive=None):
        """Yield events until a terminal one (inclusive). ``timeout``
        between events guards a consumer against a WEDGED replica —
        surfaced as ``replica_failed`` so the router's failover path
        handles both identically. ``still_alive`` (a callable) refines
        that: while it returns True the wait just continues, because a
        healthy replica with a deep backlog legitimately produces no
        events for a long time, and declaring it failed would resubmit
        work that is still queued — doubling offered load exactly when
        the system is backlogged (the metastable-overload failure mode)."""
        while True:
            try:
                kind, payload = self._q.get(timeout=timeout)
            except _queue.Empty:
                if still_alive is not None and still_alive():
                    continue
                yield ("replica_failed", "event timeout")
                return
            yield (kind, payload)
            if kind in self.TERMINAL:
                return


class _GroupMember:
    """Per-candidate adapter registered in the replica's stream table: the
    engine callbacks address candidates by request_id, the consumer reads
    ONE multiplexed queue of (candidate_index, kind, payload)."""

    def __init__(self, group: "GroupStream", idx: int):
        self.group = group
        self.idx = idx
        self.request: Optional[Request] = None

    def put(self, kind: str, payload=None) -> None:
        self.group._q.put((self.idx, kind, payload))


class GroupStream:
    """Merged event pipe for all N candidates of one shared-prefix group
    (a ``/v1/images`` request): yields ``(candidate_index, kind, payload)``
    until every candidate reached a terminal event — or the replica died,
    which is GROUP-terminal (the router resubmits the whole group with the
    same seeds, so exactness survives failover candidate-by-candidate)."""

    def __init__(self, n: int):
        self.n = int(n)
        self._q: _queue.Queue = _queue.Queue()
        self.request_ids: List[int] = []

    def events(self, timeout: Optional[float] = 30.0, still_alive=None):
        finished = 0
        while finished < self.n:
            try:
                idx, kind, payload = self._q.get(timeout=timeout)
            except _queue.Empty:
                if still_alive is not None and still_alive():
                    continue
                yield (None, "replica_failed", "event timeout")
                return
            yield (idx, kind, payload)
            if kind == "replica_failed":
                return                  # group-terminal; siblings' copies
                                        # of the death event die with us
            if kind in ResultStream.TERMINAL:
                finished += 1


class Replica:
    """``start()`` → serving; ``submit`` → ResultStream; ``drain()`` →
    graceful stop (finish queued + in-flight work, then the worker exits).
    """

    def __init__(self, engine, *, replica_id: Optional[str] = None,
                 maxsize: Optional[int] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 aot_dir: Optional[str] = None,
                 on_served: Optional[Callable] = None):
        self.replica_id = (replica_id if replica_id is not None
                           else f"replica-{next(_ids)}")
        if aot_dir is not None:
            raise NotImplementedError(
                "aot_dir is not ported yet: serialized engine executables wait "
                "for CUDA-graph capture (ROADMAP.md Queue 1 item 2)")
        self.engine = engine
        self.aot_loaded = False
        self.queue = PolicyQueue(maxsize=maxsize, policy=policy,
                                 on_shed=self._on_shed)
        self.on_served = on_served
        self._streams: dict = {}            # request_id -> ResultStream
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.failed: Optional[BaseException] = None
        self.migrated = False
        # wedged-engine self-report (degrade/wedge.py): latched
        # by the in-process WedgeWatchdog when the decode loop stops
        # committing iterations while busy. Makes ``healthy`` False and
        # rides the health verb as {"wedged": true, "reason": "wedged"} —
        # the fleet controller's no-operator drain trigger.
        self.wedged = False
        self.wedge_detail: Optional[str] = None
        self._fail_after_rows: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Replica":
        assert self._thread is None, "replica already started"
        self._thread = threading.Thread(target=self._work,
                                        name=self.replica_id, daemon=True)
        self._thread.start()
        return self

    def _take_all_streams(self) -> list:
        """Shared teardown core for worker death AND migrate: stop
        accepting, then claim every queued + in-flight stream (cleared
        from the table so late engine callbacks drop harmlessly). The
        caller terminates each claimed stream with its own payload."""
        try:
            self.queue.close()
        except Exception:  # noqa: BLE001 - already-closed race is fine
            pass
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        return streams

    def _work(self):
        try:
            self.engine.run(self.queue, on_complete=self._on_complete,
                            on_rows=self._on_rows)
        except BaseException as exc:  # noqa: BLE001 - any worker death is a
            # replica failure; the fleet (not this thread) decides what's
            # recoverable, so classify nothing here and fail the streams
            self.failed = exc
            counter_add("gateway.replica_failures_total", 1.0)
            streams = self._take_all_streams()
            # black box first, THEN fail the streams: the bundle freezes
            # the dying worker's last spans and in-flight ids before the
            # router starts resubmitting (obs/recorder.py; no-op unless a
            # recorder is configured)
            record_event("replica_failed", replica_id=self.replica_id,
                         error=repr(exc),
                         inflight=[s.request.trace_id if s.request else None
                                   for s in streams])
            dump_recorder("replica_death",
                          extra={"replica_id": self.replica_id,
                                 "error": repr(exc)})
            for s in streams:
                s.put("replica_failed", repr(exc))

    @property
    def healthy(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and self.failed is None and not self.migrated
                and not self.wedged)

    def mark_wedged(self, detail: str = "") -> None:
        """Latch the wedge self-report: the router stops
        dispatching here (``healthy`` → False), the health verb answers
        ``{"healthy": false, "wedged": true, "reason": "wedged"}``, and
        the fleet controller's next tick migrate-drains the in-flight
        streams (same-seed resubmission keeps the splice bitwise) and
        replaces the process — no operator ``request_drain``. Latched, not
        self-clearing: a loop that wedged once is forfeit; the REPLACEMENT
        process is the recovery."""
        self.wedged = True
        self.wedge_detail = detail
        counter_add("degrade.wedged_total", 1.0)
        record_event("replica_wedged", replica_id=self.replica_id,
                     detail=detail)
        dump_recorder("replica_wedged",
                      extra={"replica_id": self.replica_id,
                             "detail": detail})

    @property
    def progress(self) -> Optional[int]:
        """The engine's monotonic iteration counter: rides the
        health verb so the fleet transport can run the outside-in
        fresh-heartbeat-but-frozen-progress check, and feeds the
        in-process WedgeWatchdog probe. None for engines without stats
        (test fakes)."""
        stats = getattr(self.engine, "stats", None)
        return stats.progress if stats is not None else None

    @property
    def draining(self) -> bool:
        return self.queue.closed

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful: no new submissions; queued + in-flight requests finish
        and their streams complete; then the worker thread exits."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout)

    def migrate(self, reason: str = "drain") -> int:
        """Fast hand-off: stop accepting, then terminate EVERY
        queued + in-flight request's stream NOW with a dict
        ``replica_failed`` payload carrying ``reason`` — the router
        resubmits each elsewhere (same text, same seed), and its row
        high-water dedup makes the splice bitwise-invisible to clients.
        Unlike :meth:`drain`, nothing waits for in-flight decode: the slots
        keep decoding unobserved until the queue drains and the worker
        exits, which is fine because a migrated replica is about to be
        killed anyway (controller drain-on-degradation / preemption).
        Returns the number of streams migrated."""
        self.migrated = True               # healthy → False: no new dispatch
        streams = self._take_all_streams()
        counter_add("gateway.migrated_streams_total", float(len(streams)))
        record_event("replica_migrate", replica_id=self.replica_id,
                     reason=reason, streams=len(streams))
        for s in streams:
            s.put("replica_failed",
                  {"reason": reason,
                   "detail": f"{self.replica_id} draining; resubmit"})
        return len(streams)

    # -- load --------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self.queue.qsize()

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._streams)

    @property
    def load(self) -> int:
        """Dispatch metric for the router: everything accepted and not yet
        completed. A stream is registered at submit and removed at
        completion/shed/failure, so ``inflight`` counts queued AND in-slot
        requests — exactly the backlog a new request would wait behind."""
        return self.inflight

    # -- submission --------------------------------------------------------
    def submit(self, text, seed: int, *, max_tokens: Optional[int] = None,
               tenant: str = "default", priority: int = 0,
               deadline_at: Optional[float] = None,
               trace_id: Optional[str] = None,
               cond_scale: float = 1.0) -> ResultStream:
        if not self.healthy:
            raise ReplicaFailure(f"{self.replica_id} is not serving")
        # register the stream BEFORE the request becomes takeable: the
        # engine thread polls every ~20ms, so a post-submit registration
        # races a fast completion whose events would be dropped. _lock is
        # held across the submit itself — releasing between the id peek and
        # the enqueue would let a concurrent submitter reserve the same id
        # (next_request_id only advances at submit) and clobber the table.
        with self._lock:
            rid = self.queue.next_request_id
            stream = ResultStream(None)
            self._streams[rid] = stream
            try:
                req = self.queue.submit(text, seed, request_id=rid,
                                        max_tokens=max_tokens, tenant=tenant,
                                        priority=priority,
                                        deadline_at=deadline_at,
                                        trace_id=trace_id,
                                        cond_scale=cond_scale)
            except BaseException:  # noqa: BLE001 - re-raised; the
                # pre-registered stream must be unwound for ANY submit
                # failure (incl. KeyboardInterrupt) or the id leaks a dead
                # stream entry
                self._streams.pop(rid, None)
                raise
        stream.request = req
        return stream

    def submit_group(self, text, seeds, *, max_tokens: Optional[int] = None,
                     tenant: str = "default", priority: int = 0,
                     deadline_at: Optional[float] = None,
                     trace_id: Optional[str] = None,
                     group_id: Optional[int] = None,
                     cond_scale: float = 1.0) -> GroupStream:
        """Submit all N candidates of one shared-prefix group atomically:
        consecutive request ids (FIFO keeps them adjacent, so the engine
        admits them together and pays ONE text prefill), one merged event
        stream. Capacity is checked up front — a group that would only
        partially fit raises QueueFull with NOTHING enqueued, because half
        an admitted group would decode candidates whose results nobody is
        waiting for."""
        if not self.healthy:
            raise ReplicaFailure(f"{self.replica_id} is not serving")
        n = len(seeds)
        assert n >= 1
        group = GroupStream(n)
        with self._lock:
            if (self.queue.maxsize is not None
                    and self.queue.maxsize - self.queue.qsize() < n):
                raise QueueFull(
                    f"group of {n} exceeds remaining queue capacity")
            rid0 = self.queue.next_request_id
            gid = group_id if group_id is not None else rid0
            members = [_GroupMember(group, i) for i in range(n)]
            for i, m in enumerate(members):
                self._streams[rid0 + i] = m
            try:
                for i, seed in enumerate(seeds):
                    members[i].request = self.queue.submit(
                        text, seed, request_id=rid0 + i,
                        max_tokens=max_tokens, tenant=tenant,
                        priority=priority, deadline_at=deadline_at,
                        trace_id=trace_id, group_id=gid, group_size=n,
                        group_index=i, cond_scale=cond_scale)
            except BaseException:  # noqa: BLE001 - re-raised; the capacity
                # precheck rules out mid-group QueueFull, leaving only a
                # racing close(). Unwind every registration: already-queued
                # members then decode unobserved (wasted slots, nothing
                # dangling) while the caller sees one clean failure
                for i in range(n):
                    self._streams.pop(rid0 + i, None)
                raise
        group.request_ids = list(range(rid0, rid0 + n))
        return group

    # -- engine callbacks (engine thread) ----------------------------------
    def _stream_for(self, request_id: int,
                    pop: bool = False) -> Optional[ResultStream]:
        with self._lock:
            if pop:
                return self._streams.pop(request_id, None)
            return self._streams.get(request_id)

    def _on_rows(self, req: Request, row: int, tokens: List[int]) -> None:
        if self._fail_after_rows is not None:
            self._fail_after_rows -= 1
            if self._fail_after_rows < 0:
                raise ReplicaFailure(
                    f"injected failure on {self.replica_id}")
        s = self._stream_for(req.request_id)
        if s is not None:
            s.put("row", (row, [int(t) for t in tokens]))

    def _on_complete(self, cr) -> None:
        s = self._stream_for(cr.request_id, pop=True)
        if self.on_served is not None:
            self.on_served(cr)
        if s is not None:
            s.put("done", cr)

    def _on_shed(self, req: Request) -> None:
        counter_add("gateway.shed_total", 1.0)
        counter_add("gateway.shed_by_total", 1.0,
                    labels={"tenant": req.tenant})
        record_event("request_shed", request_id=req.request_id,
                     trace_id=req.trace_id, tenant=req.tenant)
        s = self._stream_for(req.request_id, pop=True)
        if s is not None:
            s.put("shed", req)

    # -- chaos hook (tests / smoke) ----------------------------------------
    def fail_after_rows(self, n: int) -> None:
        """Kill the worker after ``n`` more streamed rows — deterministic
        mid-stream replica death for failover tests."""
        self._fail_after_rows = int(n)

    def health(self) -> dict:
        # co-sender of the wire contract's health.reply channel with
        # ReplicaServer._health (which wraps this dict for the socket
        # path): the union of both builders' keys is pinned in
        # contracts/wire.json, so field drift here is a wire_audit failure
        return {"replica_id": self.replica_id, "healthy": self.healthy,
                "draining": self.draining, "queue_depth": self.queue_depth,
                "inflight": self.inflight, "aot_loaded": self.aot_loaded,
                # the engine-iteration progress counter + the
                # wedge self-report — a live process with a stuck decode
                # loop answers health fine, so liveness must read PROGRESS
                "progress": self.progress,
                "wedged": self.wedged,
                **({"reason": "wedged", "wedge_detail": self.wedge_detail}
                   if self.wedged else {}),
                "shed_total": self.queue.shed_total,
                # engine shape facts a REMOTE consumer (gateway over
                # RemoteReplica, fleet controller) can't read off .engine
                "slots": self.engine.slots,
                "image_seq_len": self.engine.n_steps,
                "image_fmap_size": self.engine.row_len,
                # paged KV: page-pool occupancy + radix hit counters — the
                # fleet controller's cache-pressure signal; a dense engine
                # (or a test fake without kv_stats) answers {"paged": False}
                "kv": (self.engine.kv_stats()
                       if hasattr(self.engine, "kv_stats")
                       else {"paged": False}),
                "error": repr(self.failed) if self.failed else None}
