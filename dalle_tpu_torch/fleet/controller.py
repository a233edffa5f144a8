"""The fleet controller: the SLO-driven autoscaling + self-protection loop.

A copy of ``dalle_tpu/fleet/controller.py`` (it imports no JAX), with the
same decisions, counters and gauges. A small synchronous control loop turns
the serving signals (the ``slo.*`` burn gauges, the ``SloEstimator``'s
backlog prediction, the per-request ``health.decode_*`` gauges, the wedge
self-report) into fleet actions, with hysteresis (every condition must
hold for N consecutive ticks, and every capacity change starts a cooldown)
and bounds (``min_replicas ≤ fleet ≤ max_replicas``).

Decisions, in priority order per tick:

  * **replace**: a replica whose process exited, whose heartbeats went
    missing or that answers health unhealthy is removed from the router,
    reaped, and replaced. Repair ignores the cooldown.
  * **drain**: a wedged replica (its own watchdog, or the transport's
    frozen-progress check), one whose decode-quality gauges degrade for
    ``health_sustain`` ticks, or one an operator paged via
    :meth:`request_drain`, is migrate-drained: removed from the router,
    its in-flight streams failed over (same-seed resubmission keeps the
    hand-off bitwise), the process killed after a grace period, and a
    replacement attached if the fleet fell below min.
  * **scale_up**: the burn-rate sentry burning, or the estimator predicting
    backlog beyond ``backlog_slo_s``, for ``up_sustain`` ticks → attach one
    replica.
  * **scale_down**: a fully idle fleet for ``down_sustain`` ticks →
    gracefully drain and stop the least-loaded replica.

Every decision is one ``fleet_action`` flight-recorder event, one
``fleet.actions_total{action=}`` increment and one row of
:attr:`decisions`; ``fleet.size``/``fleet.warm_pool``/``fleet.state`` are
the loop's posture. The clock is injectable for tests.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..obs import counter_add, gauge_set, record_event
from .manager import FleetManager, ReplicaProcess, SpawnError

# fleet.state gauge values (obs_report's FLEET verdict input)
STEADY, SCALING, DRAINING = 0.0, 1.0, 2.0


class FleetController:
    def __init__(self, router, manager: FleetManager, *,
                 sentry=None, estimator=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_sustain: int = 2, down_sustain: int = 8,
                 cooldown_ticks: int = 4, retire_grace_ticks: int = 2,
                 backlog_slo_s: Optional[float] = None,
                 request_tokens: int = 256,
                 drain_repeat_ratio: Optional[float] = None,
                 drain_entropy_floor: Optional[float] = None,
                 health_sustain: int = 3,
                 slots_per_replica: Optional[int] = None,
                 clock=time.monotonic):
        assert 1 <= min_replicas <= max_replicas
        self.router = router
        self.manager = manager
        self.sentry = sentry
        self.estimator = estimator
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_sustain = int(up_sustain)
        self.down_sustain = int(down_sustain)
        self.cooldown_ticks = int(cooldown_ticks)
        self.retire_grace_ticks = int(retire_grace_ticks)
        self.backlog_slo_s = backlog_slo_s
        self.request_tokens = int(request_tokens)
        self.drain_repeat_ratio = drain_repeat_ratio
        self.drain_entropy_floor = drain_entropy_floor
        self.health_sustain = int(health_sustain)
        self.slots_per_replica = slots_per_replica
        self.clock = clock
        self.decisions: List[dict] = []
        self.tick_count = 0
        self._lock = threading.Lock()
        self._procs: Dict[str, ReplicaProcess] = {}   # attached, by id
        self._retiring: List[tuple] = []              # (proc, kill_at_tick)
        self._up_streak = 0
        self._idle_streak = 0
        self._degraded_streaks: Dict[str, int] = {}
        self._cooldown_until = 0
        self._cooldown_cause = None           # "drain" | "scale"
        self._pending_drains: List[tuple] = []        # (replica_id, reason)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- fleet membership --------------------------------------------------
    def attach(self, rp: ReplicaProcess) -> None:
        """Put a replica process into service (router + supervision)."""
        with self._lock:
            self._procs[rp.replica_id] = rp
        self.router.add_replica(rp.remote)
        self._sync_parallelism()

    def adopt(self, rp: ReplicaProcess) -> None:
        """Supervise a replica that is ALREADY routed (the boot-time fleet
        the router was constructed with)."""
        with self._lock:
            self._procs[rp.replica_id] = rp
        self._sync_parallelism()

    def _detach(self, rp: ReplicaProcess) -> None:
        with self._lock:
            self._procs.pop(rp.replica_id, None)
        # a later replica registered under the same id (operator-chosen
        # ids, pid reuse) must start with a clean degradation streak
        self._degraded_streaks.pop(rp.replica_id, None)
        self.router.remove_replica(rp.remote)
        self._sync_parallelism()

    def _sync_parallelism(self) -> None:
        # the admission predictor's fluid model drains backlog at
        # rate × total slots; keep it tracking the live fleet size
        if self.estimator is None or self.slots_per_replica is None:
            return
        n = max(len(self.router.replicas), 1)
        self.estimator.set_parallelism(self.slots_per_replica * n)

    @property
    def fleet_size(self) -> int:
        return len(self.router.replicas)

    def request_drain(self, replica_id: str,
                      reason: str = "health_page") -> None:
        """Operator/pager hook: drain ``replica_id`` at the next tick with
        ``reason`` (rides the same migrate + replace path as the automatic
        degradation drain)."""
        with self._lock:
            self._pending_drains.append((replica_id, reason))

    # -- decision bookkeeping ----------------------------------------------
    def _decide(self, action: str, reason: str, replica: Optional[str],
                **extra) -> dict:
        row = {"tick": self.tick_count, "t": time.time(), "action": action,
               "reason": reason, "replica": replica,
               "fleet": self.fleet_size, **extra}
        self.decisions.append(row)
        counter_add("fleet.actions_total", 1.0, labels={"action": action})
        record_event("fleet_action", **row)
        return row

    # -- signals -----------------------------------------------------------
    def _pressure(self) -> dict:
        burn = (self.sentry.evaluate()["burning"]
                if self.sentry is not None else False)
        predicted = None
        if self.estimator is not None and self.backlog_slo_s is not None:
            predicted = self.estimator.predict_completion_s(
                self.router.total_backlog * self.request_tokens,
                self.request_tokens)
        backlog = (predicted is not None
                   and predicted > self.backlog_slo_s)
        return {"up": burn or backlog, "burn": burn, "backlog": backlog,
                "predicted_s": predicted}

    def _degraded(self, health: dict) -> Optional[str]:
        d = health.get("decode") or {}
        if (self.drain_repeat_ratio is not None and "repeat_ratio" in d
                and d["repeat_ratio"] >= self.drain_repeat_ratio):
            return (f"decode_repeat_ratio {d['repeat_ratio']:.3f} >= "
                    f"{self.drain_repeat_ratio}")
        if (self.drain_entropy_floor is not None and "entropy" in d
                and d["entropy"] <= self.drain_entropy_floor):
            return (f"decode_entropy {d['entropy']:.3f} <= "
                    f"{self.drain_entropy_floor}")
        return None

    # -- actions -----------------------------------------------------------
    def _attach_fresh(self, reason: str, action: str) -> Optional[dict]:
        try:
            rp = self.manager.acquire()
        except SpawnError as exc:
            return self._decide("spawn_failed", f"{reason}: {exc}", None)
        self.attach(rp)
        return self._decide(action, reason, rp.replica_id,
                            pid=rp.pid,
                            aot_loaded=rp.handshake.get("aot_loaded"))

    def _drain_replica(self, rp: ReplicaProcess, reason: str,
                       detail: str = "") -> dict:
        """``reason`` must stay a BOUNDED token (health_page /
        decode_degraded / wedged / operator-chosen): it rides the migrate
        payload into the ``gateway.failover_total{reason=}`` label AND the
        ``degrade.actions_total{reason=}`` family, where every distinct
        value is a Prometheus series held forever. Free-form measurements
        go in ``detail`` (decision log + recorder event only)."""
        # attribution: every proactive drain is a degradation
        # response — the same reason-labeled family the training plane's
        # straggler/health-page drains count into (parallel/elastic.py),
        # read by obs_report's DEGRADE verdict
        counter_add("degrade.actions_total", 1.0, labels={"reason": reason})
        self._detach(rp)
        migrated = rp.remote.migrate(reason=reason)
        with self._lock:
            self._retiring.append((rp, self.tick_count
                                   + self.retire_grace_ticks))
        self._cooldown_until = self.tick_count + self.cooldown_ticks
        self._cooldown_cause = "drain"
        row = self._decide("drain", reason, rp.replica_id,
                           migrated_streams=migrated,
                           **({"detail": detail} if detail else {}))
        if self.fleet_size < self.min_replicas:
            self._attach_fresh(f"below min after drain of {rp.replica_id}",
                               "replace")
        return row

    def _reap_retiring(self) -> None:
        with self._lock:
            retiring = list(self._retiring)
        keep = []
        for rp, kill_at in retiring:
            if self.tick_count >= kill_at or not rp.alive:
                self.manager.kill(rp)
            else:
                keep.append((rp, kill_at))
        with self._lock:
            self._retiring = keep

    # -- the loop ----------------------------------------------------------
    def tick(self) -> List[dict]:
        """One control-loop pass. Returns the decisions taken this tick."""
        self.tick_count += 1
        before = len(self.decisions)
        self._reap_retiring()

        # 1) repair: dead processes, lost heartbeats, AND zombie replicas —
        # a process that still answers health but whose engine worker
        # died (poisoned request) reports healthy=false while alive with
        # fresh heartbeats; the router stops dispatching to it, so
        # without this check it would sit in the fleet as counted-but-
        # serving-nothing capacity forever. Repair ignores the cooldown:
        # restoring lost capacity is never flapping.
        with self._lock:
            attached = list(self._procs.values())
        for rp in attached:
            missed = rp.remote.missed_heartbeats
            draining = getattr(rp.remote, "draining", False)
            # the wedge, BEFORE the generic repair predicate: a
            # wedged replica self-reports unhealthy (its process is alive,
            # its accept/drain threads answer), so the right action is the
            # migrate-DRAIN — in-flight streams fail over with
            # reason="wedged" and splice bitwise — not a blind SIGKILL
            # that would surface as anonymous conn_resets. Two sources,
            # same verdict: the replica's own watchdog (health verb
            # "wedged") and the transport's outside-in frozen-progress
            # check (progress_stalled). Edge-triggered by construction:
            # the drain detaches the replica from supervision.
            wedged = (bool((rp.remote.health() or {}).get("wedged"))
                      or getattr(rp.remote, "progress_stalled", False))
            if rp.alive and wedged and not draining:
                self._drain_replica(
                    rp, "wedged",
                    detail=str((rp.remote.health() or {}).get(
                        "wedge_detail", "frozen engine progress")))
                continue
            if rp.alive and missed < rp.remote.max_missed \
                    and (rp.remote.healthy or draining):
                # draining is DELIBERATELY unhealthy (gateway shutdown,
                # operator drain): replacing it would SIGKILL accepted
                # work mid-graceful-drain and spawn into a teardown
                continue
            reason = ("process_exit" if not rp.alive
                      else f"missed_heartbeats={missed}"
                      if missed >= rp.remote.max_missed
                      else "replica_unhealthy")
            self._detach(rp)
            self.manager.kill(rp)
            self._decide("replace", reason, rp.replica_id)
            if self.fleet_size < self.max_replicas:
                self._attach_fresh(reason, "replace")

        # 2) drains: operator pages, then sustained decode degradation
        with self._lock:
            pending, self._pending_drains = self._pending_drains, []
        for replica_id, reason in pending:
            with self._lock:
                rp = self._procs.get(replica_id)
            if rp is not None:
                self._drain_replica(rp, reason)
        if (self.drain_repeat_ratio is not None
                or self.drain_entropy_floor is not None):
            with self._lock:
                attached = list(self._procs.values())
            for rp in attached:
                why = self._degraded(rp.remote.health())
                rid = rp.replica_id
                if why is None:
                    self._degraded_streaks.pop(rid, None)
                    continue
                streak = self._degraded_streaks.get(rid, 0) + 1
                self._degraded_streaks[rid] = streak
                if streak >= self.health_sustain:
                    self._degraded_streaks.pop(rid, None)
                    self._drain_replica(rp, "decode_degraded", detail=why)

        # 2b) min-bound reconciliation: a replacement spawn that FAILED at
        # the moment of a replace/drain (transient SpawnError) must not
        # leave the fleet undersized forever — with zero replicas there is
        # no traffic, so no burn pressure would ever restore capacity.
        # Retried every tick until the bound holds.
        while self.fleet_size < self.min_replicas:
            if self._attach_fresh("below_min", "replace")["action"] \
                    == "spawn_failed":
                break                     # try again next tick, don't spin

        # 3) scaling, hysteresis-guarded and bounded. "Idle" requires NO
        # pressure on top of zero backlog/in-flight: a burning-but-empty
        # fleet (error-driven burn) must never scale down into the
        # incident it is paging about.
        sig = self._pressure()
        self._up_streak = self._up_streak + 1 if sig["up"] else 0
        idle = (not sig["up"] and self.router.total_backlog == 0
                and all(r.load == 0 for r in self.router.replicas))
        self._idle_streak = self._idle_streak + 1 if idle else 0
        in_cooldown = self.tick_count < self._cooldown_until
        if (not in_cooldown and self._up_streak >= self.up_sustain
                and self.fleet_size < self.max_replicas):
            row = self._attach_fresh(
                "slo_burn" if sig["burn"] else
                f"backlog_predicted_{sig['predicted_s']:.2f}s", "scale_up")
            # streak/cooldown burn only on a SUCCESSFUL attach: a
            # transient spawn failure must retry next tick, not sit out a
            # phantom cooldown while the SLO keeps burning
            if row["action"] != "spawn_failed":
                self._up_streak = 0
                self._cooldown_until = (self.tick_count
                                        + self.cooldown_ticks)
                self._cooldown_cause = "scale"
        elif (not in_cooldown and self._idle_streak >= self.down_sustain
                and self.fleet_size > self.min_replicas):
            with self._lock:
                candidates = list(self._procs.values())
            victim = min(candidates, key=lambda rp: rp.remote.load,
                         default=None)
            # streak/cooldown burn only when an action actually happens —
            # a victimless pass (no supervised replicas) must not leave a
            # phantom cooldown suppressing the next scale_up
            if victim is not None:
                self._idle_streak = 0
                self._cooldown_until = (self.tick_count
                                        + self.cooldown_ticks)
                self._cooldown_cause = "scale"
                self._detach(victim)
                self._decide("scale_down", "sustained_idle",
                             victim.replica_id)
                # idle fleet → nothing in flight; graceful stop off-thread
                # so a slow drain ack never stalls the loop
                threading.Thread(target=self.manager.stop, args=(victim,),
                                 daemon=True).start()

        # 4) posture gauges (the FLEET verdict inputs)
        with self._lock:
            retiring = len(self._retiring)
        took = self.decisions[before:]
        in_cooldown = self.tick_count < self._cooldown_until
        # the posture gauge names the cooldown's CAUSE: the window after a
        # drain must read DRAINING, not "scaling" — an operator watching
        # the FLEET verdict right after a decode_degraded drain would
        # otherwise conclude capacity was being added
        state = (DRAINING if retiring or any(
                     d["action"] in ("drain", "replace") for d in took)
                 or (in_cooldown and self._cooldown_cause == "drain")
                 else SCALING if in_cooldown
                 else STEADY)
        gauge_set("fleet.size", float(self.fleet_size))
        gauge_set("fleet.warm_pool", float(self.manager.warm_available))
        gauge_set("fleet.state", state)
        return took

    # -- background runner -------------------------------------------------
    def start(self, interval_s: float = 0.5) -> "FleetController":
        assert self._thread is None
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 - the control loop
                    # must outlive any single bad tick (a replica dying mid-
                    # health-poll); the failure is recorded, not fatal
                    record_event("fleet_tick_error", error=repr(exc))
        self._thread = threading.Thread(target=_loop, name="fleet-ctl",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
