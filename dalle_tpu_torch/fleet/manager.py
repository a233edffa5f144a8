"""The fleet's process manager: spawn, warm, attach, kill.

Port of ``dalle_tpu/fleet/manager.py``. The controller
(``fleet/controller.py``) decides when the fleet changes; this module owns
the replica processes. Each replica is one ``python -m
dalle_tpu_torch.cli.serve_replica`` process, spawned from an argv template
the caller provides (``subprocess.Popen``: fork then exec at once, so the
child never inherits the parent's CUDA context), identified by the single
JSON handshake line it prints once its socket serves (address, pid,
replica_id), then dialed into a :class:`~.transport.RemoteReplica`.

A replica process pays the torch import, its CUDA context and the load of
the kernels in ``build/kernels``; the caller that owns the replica command
builds them before the first spawn (``ops._build.build_all``), so no child
compiles, and ``spawn_timeout_s`` bounds the handshake.
``prewarm()`` keeps ``warm_pool`` replica processes spawned and
engine-initialized but not routed; ``acquire()`` pops one and refills the
pool in the background. ``kill()`` is SIGKILL-first for dead or poisoned
replicas; the graceful path is ``RemoteReplica.drain`` + ``stop()``. A
replica that never handshakes is killed and reported, not waited on.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ..obs import counter_add, record_event
from ..utils.retry import RetryBudgetExceeded
from .transport import RemoteReplica, TransportError

HANDSHAKE_KEY = "fleet_replica"


class SpawnError(RuntimeError):
    """The replica process died or never handshook within the budget."""


class ReplicaProcess:
    """One spawned replica: the OS process + its transport adapter."""

    def __init__(self, proc: subprocess.Popen, handshake: dict,
                 remote: RemoteReplica):
        self.proc = proc
        self.handshake = handshake
        self.remote = remote

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def replica_id(self) -> str:
        return self.remote.replica_id

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, sig: int = signal.SIGKILL) -> None:
        self.remote.close()
        if self.alive:
            try:
                self.proc.send_signal(sig)
            except ProcessLookupError:
                pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                # un-reapable even after SIGKILL (D-state on a hung
                # mount): record and move on — raising here would abort
                # the caller's kill loop and leak every LATER replica
                record_event("replica_unreaped", pid=self.proc.pid)
        if self.proc.stdout is not None:
            try:
                # releases the parent-side pipe fd (the drain thread sees
                # a closed file and exits); a long-churning fleet must not
                # accumulate one fd per replaced replica
                self.proc.stdout.close()
            except OSError:
                pass


def _handshake_error(msg: str) -> SpawnError:
    # handshake refusals share the wire-protocol error counter
    # (fleet.protocol_errors_total{kind=handshake}) with transport.py's
    # malformed-frame paths: one metric family covers "a peer did not
    # speak the protocol", whatever the channel
    counter_add("fleet.protocol_errors_total", 1.0,
                labels={"kind": "handshake"})
    return SpawnError(msg)


def _read_handshake(proc: subprocess.Popen, timeout_s: float) -> dict:
    """Read stdout lines until the handshake JSON appears. Non-handshake
    lines (warnings, logs) pass through to our stdout so replica logs stay
    visible in CI output."""
    deadline = time.monotonic() + timeout_s
    buf = b""
    fd = proc.stdout.fileno()
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise _handshake_error(
                f"replica process exited rc={proc.returncode} "
                "before handshake")
        ready, _, _ = select.select([fd], [], [], 0.25)
        if not ready:
            continue
        chunk = os.read(fd, 65536)
        if not chunk:
            raise _handshake_error("replica stdout closed before handshake")
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            text = line.decode(errors="replace").strip()
            if not text:
                continue
            if text.startswith("{"):
                try:
                    doc = json.loads(text)
                except ValueError:
                    doc = None
                if doc and HANDSHAKE_KEY in doc:
                    # lines already buffered BEHIND the handshake (a
                    # warning printed in quick succession) still reach CI
                    # logs before the drain thread takes over the pipe
                    for rest in buf.decode(errors="replace").splitlines():
                        if rest.strip():
                            print(f"[replica] {rest}", flush=True)
                    return doc
            print(f"[replica] {text}", flush=True)
    raise _handshake_error(f"no replica handshake within {timeout_s:.0f}s")


def _drain_stdout(proc: subprocess.Popen, rid: str) -> None:
    try:
        fd = proc.stdout.fileno()
        while True:
            chunk = os.read(fd, 65536)
            if not chunk:
                return
            for line in chunk.decode(errors="replace").splitlines():
                if line.strip():
                    print(f"[{rid}] {line}", flush=True)
    except (OSError, ValueError):       # pipe closed at teardown
        pass


class FleetManager:
    """Owns replica processes for one fleet.

    ``argv`` is the spawn template (``[python, -m,
    dalle_tpu_torch.cli.serve_replica, --untrained, ...]``); the manager appends ``--port 0`` and a unique
    ``--replica_id``. ``env`` overlays the parent environment (chaos plans
    ride in per-spawn via ``spawn(extra_env=...)``, so a fault scoped to
    one victim never leaks into its replacement)."""

    def __init__(self, argv: List[str], *, warm_pool: int = 0,
                 spawn_timeout_s: float = 240.0,
                 heartbeat_s: float = 0.25, max_missed: int = 3,
                 progress_timeout_s: float = 0.0,
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 telemetry_dir: Optional[str] = None,
                 collector=None):
        self.argv = list(argv)
        # telemetry plumbing: with a telemetry_dir every spawn gets
        # --telemetry_dir (serve_replica keys a subdir by replica_id), and
        # with a TelemetryCollector every spawn is registered as a source —
        # RPC fetch through its RemoteReplica (whose heartbeats feed the
        # clock-offset estimate) plus the on-disk dir that survives SIGKILL.
        self.telemetry_dir = telemetry_dir
        self.collector = collector
        self.warm_pool = int(warm_pool)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.max_missed = int(max_missed)
        # outside-in wedge backstop (transport._track_progress):
        # busy replica + frozen engine-iteration counter past this →
        # controller drains it {reason=wedged}. 0 (default) disables; arm
        # it on warmed fleets, where no first kernel build can freeze a
        # busy engine.
        self.progress_timeout_s = float(progress_timeout_s)
        self.env = dict(env or {})
        self.log_dir = log_dir
        self._seq = 0
        self._lock = threading.Lock()
        self._warm: List[ReplicaProcess] = []
        self._warm_pending = 0          # spawns in flight FOR the pool
        self._all: List[ReplicaProcess] = []
        self._raw_procs: List[subprocess.Popen] = []
        self._closing = False

    # -- spawning ----------------------------------------------------------
    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"replica-{self._seq}"

    def spawn(self, *, replica_id: Optional[str] = None,
              extra_env: Optional[Dict[str, str]] = None) -> ReplicaProcess:
        """Spawn one replica process and block until it is serving (the
        handshake line). The returned replica is dialed and heartbeating
        but NOT yet attached to any router."""
        rid = replica_id or self._next_id()
        argv = self.argv + ["--port", "0", "--replica_id", rid]
        if self.telemetry_dir is not None and \
                "--telemetry_dir" not in self.argv:
            argv += ["--telemetry_dir", self.telemetry_dir]
        env = dict(os.environ)
        env.update(self.env)
        env.update(extra_env or {})
        stderr = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            stderr = open(os.path.join(self.log_dir, f"{rid}.stderr.log"),
                          "wb")
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=stderr,
                                env=env)
        if stderr is not None:
            stderr.close()              # the child holds its own copy
        with self._lock:
            if self._closing:
                self._discard_proc(proc, tracked=False)
                raise SpawnError("manager is shutting down")
            # tracked from birth so a shutdown racing this spawn still
            # reaps the process even before it becomes a ReplicaProcess
            self._raw_procs.append(proc)
        try:
            shake = _read_handshake(proc, self.spawn_timeout_s)
        except SpawnError:
            self._discard_proc(proc)
            counter_add("fleet.spawn_failures_total", 1.0)
            raise
        # keep draining stdout forever: a full, unread pipe would block
        # the replica's next print() (recorder/watchdog messages) and
        # wedge it mid-decode — the exact hang mode this fleet exists to
        # avoid. Lines pass through to our stdout so replica logs stay
        # visible in CI output.
        threading.Thread(target=_drain_stdout, args=(proc, rid),
                         name=f"stdout-{rid}", daemon=True).start()
        try:
            remote = RemoteReplica(
                shake["addr"], replica_id=rid,
                heartbeat_s=self.heartbeat_s, max_missed=self.max_missed,
                progress_timeout_s=self.progress_timeout_s)
        except (RetryBudgetExceeded, TransportError, OSError) as exc:
            # handshook but won't answer health (died/wedged in between):
            # reap it NOW and surface the one spawn-failure type callers
            # (controller._attach_fresh, warm refill) actually handle
            self._discard_proc(proc)
            counter_add("fleet.spawn_failures_total", 1.0)
            raise SpawnError(
                f"{rid} handshook but failed its first health dial: "
                f"{exc!r}") from exc
        rp = ReplicaProcess(proc, shake, remote)
        with self._lock:
            self._all.append(rp)
        if self.collector is not None:
            path = (os.path.join(self.telemetry_dir, rid)
                    if self.telemetry_dir is not None else None)
            self.collector.add_source(rid, fetch=remote.fetch_telemetry,
                                      path=path, clock=remote.clock)
        counter_add("fleet.spawned_total", 1.0)
        record_event("replica_spawned", replica_id=rid, pid=rp.pid,
                     addr=shake["addr"],
                     aot_loaded=shake.get("aot_loaded"))
        return rp

    def _discard_proc(self, proc: subprocess.Popen,
                      tracked: bool = True) -> None:
        """Kill + fully release a raw process a spawn failure orphaned:
        untrack it and close the parent-side stdout fd. A crash-looping
        spawn template retried every controller tick would otherwise leak
        a Popen + pipe fd per attempt until the control plane hits
        EMFILE."""
        try:
            proc.kill()
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            record_event("replica_unreaped", pid=proc.pid)
        if proc.stdout is not None:
            try:
                proc.stdout.close()
            except OSError:
                pass
        if tracked:
            with self._lock:
                if proc in self._raw_procs:
                    self._raw_procs.remove(proc)

    # -- warm pool ---------------------------------------------------------
    def prewarm(self) -> None:
        """Fill the warm pool to ``warm_pool`` processes, synchronously.
        In-flight pool spawns count toward the target (``_warm_pending``),
        so concurrent refills cannot overfill the pool — each extra warm
        replica would hold params + a KV cache forever."""
        while True:
            with self._lock:
                if (self._closing or len(self._warm) + self._warm_pending
                        >= self.warm_pool):
                    return
                self._warm_pending += 1
            try:
                rp = self.spawn()
            except BaseException:  # noqa: BLE001 - re-raised; the pending
                # reservation must unwind for ANY spawn failure or the pool
                # under-fills forever
                with self._lock:
                    self._warm_pending -= 1
                raise
            with self._lock:
                self._warm_pending -= 1
                self._warm.append(rp)

    def _refill_async(self) -> None:
        def _refill():
            try:
                self.prewarm()
            except SpawnError as exc:
                # the pool heals on the next acquire; a failed background
                # refill must not take down the controller thread
                record_event("warm_refill_failed", error=repr(exc))
        threading.Thread(target=_refill, name="fleet-warm-refill",
                         daemon=True).start()

    @property
    def warm_available(self) -> int:
        with self._lock:
            return sum(1 for rp in self._warm if rp.alive)

    def acquire(self) -> ReplicaProcess:
        """A serving-ready replica: the warm pool's head when one is
        alive (refilled in the background), else a fresh synchronous
        spawn — which ALSO kicks a background refill, so an emptied pool
        (a failed refill, a corpse sweep) heals instead of degrading
        every future scale-up to a cold spawn."""
        while True:
            with self._lock:
                rp = self._warm.pop(0) if self._warm else None
            if rp is None:
                if self.warm_pool:
                    self._refill_async()
                return self.spawn()
            if rp.alive and rp.remote.healthy:
                if self.warm_pool:
                    self._refill_async()
                return rp
            # a corpse in the pool: discard through the bookkeeping path
            # (_forget + counters) so churn can't grow the tracking lists
            self.kill(rp)

    # -- teardown ----------------------------------------------------------
    def _forget(self, rp: ReplicaProcess) -> None:
        # the tracking lists must not grow with fleet churn: a steady
        # diet of heartbeat replaces would otherwise retain every dead
        # Popen (and its memory) for the life of the control plane
        with self._lock:
            if rp in self._all:
                self._all.remove(rp)
            if rp.proc in self._raw_procs:
                self._raw_procs.remove(rp.proc)

    def kill(self, rp: ReplicaProcess, sig: int = signal.SIGKILL) -> None:
        rp.kill(sig)
        self._forget(rp)
        counter_add("fleet.killed_total", 1.0)
        record_event("replica_killed", replica_id=rp.replica_id, pid=rp.pid)

    def stop(self, rp: ReplicaProcess,
             drain_timeout_s: Optional[float] = 30.0) -> None:
        """Graceful: drain (finish accepted work), then terminate."""
        rp.remote.drain(timeout=drain_timeout_s)
        rp.kill(signal.SIGTERM)
        self._forget(rp)

    def shutdown(self) -> None:
        with self._lock:
            self._closing = True
            procs = list(self._all)
            raw = list(self._raw_procs)
            self._warm.clear()
        for rp in procs:
            rp.kill()
        # raw handles cover spawns that never reached ReplicaProcess (a
        # background refill racing this shutdown) — double-kill is a no-op
        for proc in raw:
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
