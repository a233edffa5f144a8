"""The fleet's RPC transport: replicas behind a socket, not a thread.

Port of ``dalle_tpu/fleet/transport.py``, byte-compatible with it: the same
length prefix, verbs, frame fields and failure reasons, so a JAX
``RemoteReplica`` talks to a port ``ReplicaServer`` and the other way
round. A :class:`RemoteReplica` exposes the duck type
``gateway/router.py`` dispatches to (``submit``/``submit_group`` → event
streams, ``healthy``/``load``/``health``/``drain``), so in-process threads
and replica processes mix in one ``ReplicaRouter``.

Wire format: length-prefixed JSON frames (4-byte big-endian length + UTF-8
JSON) over one TCP connection per verb:

  * ``submit`` / ``submit_group``: the request, then a server-pushed
    stream of ``row``/``done``/``shed``/``replica_failed`` frames until
    terminal (per-candidate frames carry ``candidate``; a group ends with
    ``group_end``). The first frame is the ack, ``{"ok": true}`` or
    ``{"error": "queue_full" | ...}``, so admission failures map to the
    router's 429/503 paths.
  * ``health``: the replica's health dict plus process facts (pid, build
    count, decode-quality gauges, requests served, ``server_time``).
  * ``telemetry``: spans after a cursor, the metrics snapshot, recorder
    events (``obs/collect.py``).
  * ``drain``: graceful (finish queued + in-flight, then ack) or
    ``migrate`` (fail every stream now with a reason, so the router
    resubmits elsewhere).

A connection death mid-stream surfaces as ``replica_failed`` with
``reason="conn_reset"``, which the router's failover path handles like a
dead worker thread: a SIGKILLed replica process, a dropped connection and
a crashed worker all heal through one path. Dials go through the retry
layer (``utils/retry.py``); the heartbeat uses a fast two-attempt policy,
because a missed heartbeat is the controller's liveness signal.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..degrade.detector import frozen_progress
from ..gateway.replica import ReplicaFailure, classify_failure
from ..obs import counter_add, metrics_snapshot, record_event
from ..obs.collect import ClockOffsetEstimator, telemetry_payload
from ..serve.queue import QueueFull
from ..utils.retry import RetryBudgetExceeded, retry

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 64 << 20      # a token grid is KBs; 64 MiB is sabotage


class TransportError(RuntimeError):
    """A wire-level failure the caller should treat as replica failure."""


# opt-in frame tap: the wire contract's runtime-conformance hook
# (obs/wiretap.py). When set, every frame is reported as
# ("send"|"recv", decoded_dict) AFTER length/JSON validation — the smokes
# install it and assert every observed frame ⊆ the static golden in
# contracts/wire.json. None (the default) is zero-cost on the hot path.
_frame_tap: Optional[Callable[[str, dict], None]] = None


def set_frame_tap(cb: Optional[Callable[[str, dict], None]]) -> None:
    global _frame_tap
    _frame_tap = cb


def _proto_error(kind: str) -> None:
    # fleet.protocol_errors_total{kind=oversize_frame|torn_frame|bad_json|
    # unknown_verb|handshake}: every malformed-wire path increments
    # exactly one kind, so a corrupt peer is visible in /metrics before
    # anyone reads a stack trace
    counter_add("fleet.protocol_errors_total", 1.0, labels={"kind": kind})


def send_frame(sock: socket.socket, obj: dict) -> None:
    tap = _frame_tap
    if tap is not None:
        tap("send", obj)
    payload = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else _torn(len(buf), n)
        buf.extend(chunk)
    return bytes(buf)


def _torn(got: int, want: int):
    _proto_error("torn_frame")
    raise TransportError(f"torn frame: connection closed after {got}/{want} "
                         "bytes")


def recv_frame(sock: socket.socket,
               timeout: Optional[float] = None) -> Optional[dict]:
    """One frame, or None on clean EOF. ``timeout`` bounds the wait for the
    NEXT frame (raises ``TimeoutError``); a torn frame or oversized length
    raises :class:`TransportError`."""
    sock.settimeout(timeout)
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        _proto_error("oversize_frame")
        raise TransportError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    body = _recv_exact(sock, n)
    if body is None:
        _torn(0, n)
    try:
        obj = json.loads(body.decode())
    except ValueError as exc:
        # must surface as TransportError: callers (the heartbeat loop
        # above all) catch transport failures, and a raw JSONDecodeError
        # would kill the heartbeat thread and freeze health at its last
        # good value
        _proto_error("bad_json")
        raise TransportError(f"undecodable frame body: {exc!r}") from exc
    tap = _frame_tap
    if tap is not None and isinstance(obj, dict):
        tap("recv", obj)
    return obj


def _connect_raw(addr: str, timeout: float = 5.0) -> socket.socket:
    host, _, port = addr.rpartition(":")
    return socket.create_connection((host, int(port)), timeout=timeout)


# every control/submit dial absorbs transient connect blips (a replica
# mid-exec(), a briefly full accept queue) with jittered backoff…
dial = retry("fleet_dial", attempts=4, base_delay_s=0.05,
             max_delay_s=0.5)(_connect_raw)
# …while the heartbeat keeps a two-attempt fast policy: a missed beat is
# the controller's liveness SIGNAL, so hiding one behind a long backoff
# would delay exactly the detection it exists to provide
dial_fast = retry("fleet_heartbeat", attempts=2, base_delay_s=0.02,
                  max_delay_s=0.05)(_connect_raw)


def call(addr: str, msg: dict, *, timeout: float = 10.0,
         dialer: Callable = dial) -> dict:
    """One request/one response verb (health, drain, fault): dial, send,
    read the single reply frame, close."""
    sock = dialer(addr, timeout)
    try:
        send_frame(sock, msg)
        reply = recv_frame(sock, timeout=timeout)
        if reply is None:
            raise TransportError(f"{addr}: connection closed before reply "
                                 f"to {msg.get('verb')!r}")
        return reply
    finally:
        sock.close()


class RemoteCompletion:
    """The ``done`` payload shape the router reads off a completed stream
    (``.tokens`` / ``.ttft_s`` / ``.latency_s``), rebuilt from the wire."""

    __slots__ = ("tokens", "ttft_s", "latency_s", "decode_s", "request_id")

    def __init__(self, frame: dict):
        self.tokens = [int(t) for t in frame["tokens"]]
        self.ttft_s = float(frame.get("ttft_s", 0.0))
        self.latency_s = float(frame.get("latency_s", 0.0))
        # admission→completion in the REPLICA's timebase (durations ship
        # fine across processes; absolute perf_counter stamps would not).
        # Falls back to latency_s — queue wait included, so the estimator
        # under-predicts throughput rather than over-admitting.
        self.decode_s = float(frame.get("decode_s", self.latency_s))
        self.request_id = frame.get("request_id")


class _FrameReader:
    """Timeout-SAFE frame reader for long-lived streams: bytes read before
    a poll timeout stay buffered, so a frame that arrives split across TCP
    segments with a gap longer than one poll (loaded box, chaos slow
    fault, real WAN) resumes cleanly on the next poll instead of
    desyncing the stream. ``recv_frame`` above stays the simple one-shot
    form for single-frame verb connections, where a timeout tears the
    connection down anyway."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()

    def read(self, timeout: Optional[float]) -> Optional[dict]:
        """One frame, None on clean EOF at a frame boundary. Raises
        ``TimeoutError`` when no COMPLETE frame arrived in ``timeout``
        (partial bytes are kept for the next call), ``TransportError`` on
        EOF mid-frame or an oversized length."""
        self._sock.settimeout(timeout)
        while True:
            if len(self._buf) >= _LEN.size:
                (n,) = _LEN.unpack(self._buf[:_LEN.size])
                if n > MAX_FRAME_BYTES:
                    _proto_error("oversize_frame")
                    raise TransportError(
                        f"frame length {n} exceeds {MAX_FRAME_BYTES}")
                if len(self._buf) >= _LEN.size + n:
                    body = bytes(self._buf[_LEN.size:_LEN.size + n])
                    del self._buf[:_LEN.size + n]
                    try:
                        obj = json.loads(body.decode())
                    except ValueError as exc:
                        _proto_error("bad_json")
                        raise TransportError(
                            f"undecodable frame body: {exc!r}") from exc
                    tap = _frame_tap
                    if tap is not None and isinstance(obj, dict):
                        tap("recv", obj)
                    return obj
            chunk = self._sock.recv(65536)
            if not chunk:
                if self._buf:
                    _torn(len(self._buf), _LEN.size)
                return None
            self._buf.extend(chunk)


class RemoteResultStream:
    """Client half of one ``submit``: reads event frames off the connection
    with the same semantics as the in-process ``ResultStream.events`` —
    quiet + ``still_alive()`` keeps waiting (backlog, not failure); quiet +
    dead, EOF, or a reset yields a terminal ``replica_failed`` whose dict
    payload carries the failover ``reason`` the router labels."""

    POLL_S = 0.25
    # frame kinds that end the connection's event stream; the group
    # subclass narrows this (per-candidate "done"s keep flowing until the
    # server's group_end)
    TERMINAL_KINDS = ("done", "shed", "replica_failed")

    def __init__(self, sock: socket.socket, replica_id: str):
        self._sock = sock
        self._reader = _FrameReader(sock)
        self.replica_id = replica_id

    def _fail(self, reason: str, detail: str):
        self._close()
        return ("replica_failed", {"reason": reason, "detail": detail,
                                   "replica_id": self.replica_id})

    def _close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _frames(self, timeout, still_alive):
        quiet = 0.0
        while True:
            try:
                frame = self._reader.read(timeout=self.POLL_S)
            except TimeoutError:
                quiet += self.POLL_S
                if timeout is not None and quiet >= timeout:
                    if still_alive is not None and still_alive():
                        quiet = 0.0     # healthy but backlogged: keep waiting
                        continue
                    yield self._fail("conn_timeout",
                                     f"no event in {timeout}s and the "
                                     "replica stopped answering health")
                    return
                continue
            except (TransportError, OSError) as exc:
                yield self._fail("conn_reset", repr(exc))
                return
            if frame is None:
                yield self._fail("conn_reset",
                                 "connection closed mid-stream")
                return
            quiet = 0.0
            if frame.get("kind") in self.TERMINAL_KINDS:
                # close BEFORE yielding: consumers return the moment they
                # see a terminal event, abandoning this generator at the
                # yield — a close placed after it would wait on GC,
                # accumulating CLOSE_WAIT fds under sustained load
                self._close()
                yield frame
                return
            yield frame

    def events(self, timeout: Optional[float] = 30.0, still_alive=None):
        # the finally covers every abandonment path (a consumer returning
        # mid-iteration finalizes this generator promptly under CPython
        # refcounting) — no socket outlives its stream
        try:
            for frame in self._frames(timeout, still_alive):
                if isinstance(frame, tuple):       # synthesized failure
                    yield frame
                    return
                kind = frame["kind"]
                if kind == "row":
                    yield ("row", (int(frame["row"]),
                                   [int(t) for t in frame["tokens"]]))
                elif kind == "done":
                    yield ("done", RemoteCompletion(frame))
                    return
                elif kind == "shed":
                    yield ("shed", frame)
                    return
                else:                              # replica_failed
                    yield ("replica_failed", frame)
                    return
        finally:
            self._close()


class RemoteGroupStream(RemoteResultStream):
    """Client half of one ``submit_group``: per-candidate frames multiplex
    one connection; yields ``(candidate, kind, payload)`` until every
    candidate reached a terminal event (the server sends ``group_end``) or
    the replica/connection died — group-terminal, mirroring the local
    ``GroupStream``."""

    TERMINAL_KINDS = ("replica_failed", "group_end")

    def events(self, timeout: Optional[float] = 30.0, still_alive=None):
        # finally, not close-on-group_end alone: RoutedGroup returns the
        # moment its last candidate completes, WITHOUT reading group_end —
        # abandonment must still release the socket
        try:
            for frame in self._frames(timeout, still_alive):
                if isinstance(frame, tuple):
                    yield (None, frame[0], frame[1])
                    return
                kind = frame["kind"]
                if kind == "group_end":
                    return
                idx = frame.get("candidate")
                if kind == "row":
                    yield (idx, "row", (int(frame["row"]),
                                        [int(t) for t in frame["tokens"]]))
                elif kind == "done":
                    yield (idx, "done", RemoteCompletion(frame))
                elif kind == "shed":
                    yield (idx, "shed", frame)
                else:
                    yield (idx, "replica_failed", frame)
                    return
        finally:
            self._close()


class _ClosedQueueShim:
    """``ReplicaRouter.drain`` closes every replica's queue before joining;
    a remote replica's queue lives in another process, so ``close()`` here
    just forwards the intent through the drain verb at ``drain()`` time."""

    def close(self) -> None:
        pass


class RemoteReplica:
    """Router-facing adapter for one replica PROCESS.

    Health is pushed down to a heartbeat thread: every ``heartbeat_s`` it
    calls the ``health`` verb (fast two-attempt dial) and keeps the last
    reply; ``healthy`` is false once ``max_missed`` consecutive beats fail
    — the signal the controller turns into a replace. ``load`` reads the
    last health's queued+inflight, so the router's join-the-shortest-queue
    keeps working across hosts with sub-second-stale load info (JSQ is
    robust to that; perfect load info would need a round trip per
    dispatch)."""

    def __init__(self, addr: str, *, replica_id: Optional[str] = None,
                 heartbeat_s: float = 0.25, max_missed: int = 3,
                 dial_timeout: float = 5.0,
                 progress_timeout_s: float = 0.0):
        self.addr = addr
        self.dial_timeout = float(dial_timeout)
        self.heartbeat_s = float(heartbeat_s)
        # outside-in wedge check (the serve twin of elastic.py's
        # fresh-file-but-frozen-step liveness): a replica answering every
        # health dial while its engine-iteration counter is frozen WITH
        # work in flight is wedged even if its own watchdog is off/dead.
        # 0 disables — the default, because a jit-fallback replica paying
        # a first compile mid-request is busy-and-frozen legitimately;
        # arm it on AOT+warmed fleets (the manager plumbs it through).
        self.progress_timeout_s = float(progress_timeout_s)
        self._progress_last: Optional[int] = None
        self._progress_t = 0.0
        self._progress_armed = False
        self._progress_stalled = False
        # liveness probes must FAIL fast, not wait out the generous
        # submit-path dial timeout: against a blackholing partition a 5 s
        # connect per attempt would stretch missed-heartbeat detection to
        # ~30 s while the router keeps dispatching to the corpse
        self.probe_timeout = max(2.0 * self.heartbeat_s, 0.5)
        self.max_missed = int(max_missed)
        self.queue = _ClosedQueueShim()
        self._lock = threading.Lock()
        self._last_health: dict = {}
        self._missed = 0
        self._closed = False
        self._draining = False
        # every health/telemetry exchange doubles as one NTP-style
        # clock sample — t0/t1 wrap the RPC, the reply carries server_time,
        # so the offset is bounded by half the observed round trip
        self.clock = ClockOffsetEstimator()
        t0 = time.time()
        first = call(addr, {"verb": "health"}, timeout=dial_timeout)
        self._observe_clock(t0, first)
        self._last_health = first
        self.replica_id = (replica_id if replica_id is not None
                           else str(first.get("replica_id", addr)))
        self._hb = threading.Thread(target=self._beat,
                                    name=f"hb-{self.replica_id}",
                                    daemon=True)
        self._hb.start()

    # -- liveness ----------------------------------------------------------
    def _observe_clock(self, t0: float, reply: dict) -> None:
        server_time = reply.get("server_time")
        if server_time is not None:
            self.clock.observe(t0, float(server_time), time.time())

    def _beat(self):
        while not self._closed:
            time.sleep(self.heartbeat_s)
            if self._closed:
                return
            try:
                t0 = time.time()
                h = call(self.addr, {"verb": "health"},
                         timeout=self.probe_timeout, dialer=dial_fast)
                self._observe_clock(t0, h)
            except (RetryBudgetExceeded, TransportError, OSError):
                with self._lock:
                    self._missed += 1
                    if self._missed == self.max_missed:
                        counter_add("fleet.heartbeat_lost_total", 1.0)
                        record_event("replica_heartbeat_lost",
                                     replica_id=self.replica_id,
                                     addr=self.addr,
                                     missed=self._missed)
                continue
            with self._lock:
                self._missed = 0
                self._last_health = h
            self._track_progress(h)

    def _track_progress(self, h: dict) -> None:
        """Fresh-but-frozen, serve-side: the health reply carries the
        engine's monotonic ``progress`` counter and its backlog; busy +
        frozen counter past the timeout = wedged (``elastic.hung_workers``
        semantics via the shared ``degrade.frozen_progress`` core). Idle
        replicas and never-yet-advanced engines (compiles) never trip."""
        if self.progress_timeout_s <= 0:
            return
        prog = h.get("progress")
        if prog is None:
            return                    # engine exposes no counter: inert
        busy = (int(h.get("inflight") or 0)
                + int(h.get("queue_depth") or 0)) > 0
        now = time.monotonic()
        # arm on the counter's VALUE (>0 = the engine completed at least
        # one dispatch this run — the wedge.py/hung_workers rule), never
        # on witnessing a change between two polls: a replica can wedge at
        # the first value this monitor ever observes (attach to a warmed
        # replica, first request wedges its first dispatch) and a
        # change-based gate would never arm on it
        if prog > 0:
            self._progress_armed = True
        if self._progress_last is None or prog != self._progress_last:
            self._progress_last, self._progress_t = prog, now
            self._progress_stalled = False      # progress clears the latch
            return
        if not busy:
            self._progress_t = now              # idle ≠ wedged
            return
        if (self._progress_armed and not self._progress_stalled
                and frozen_progress(prog, self._progress_t, now,
                                    self.progress_timeout_s)):
            self._progress_stalled = True
            counter_add("degrade.wedged_total", 1.0)
            record_event("replica_progress_stalled",
                         replica_id=self.replica_id, progress=prog,
                         frozen_s=now - self._progress_t)

    @property
    def progress_stalled(self) -> bool:
        """True while the replica is busy with a frozen engine-iteration
        counter past ``progress_timeout_s`` — the controller treats it
        like a wedge self-report (drain, reason="wedged")."""
        return self._progress_stalled

    @property
    def missed_heartbeats(self) -> int:
        with self._lock:
            return self._missed

    @property
    def draining(self) -> bool:
        """True once drain()/migrate() was requested — deliberately
        unhealthy, NOT a zombie (the controller's repair loop must not
        SIGKILL a replica mid-graceful-drain)."""
        return self._draining

    @property
    def healthy(self) -> bool:
        with self._lock:
            return (not self._closed and not self._draining
                    and self._missed < self.max_missed
                    and bool(self._last_health.get("healthy", False)))

    @property
    def load(self) -> int:
        with self._lock:
            h = self._last_health
        return int(h.get("queue_depth", 0)) + int(h.get("inflight", 0))

    def health(self) -> dict:
        with self._lock:
            h = dict(self._last_health)
        h.update(remote=True, addr=self.addr,
                 missed_heartbeats=self.missed_heartbeats,
                 healthy=self.healthy, draining=self._draining)
        return h

    # -- telemetry ----------------------------------------------------------
    def fetch_telemetry(self, since_seq: int = 0) -> dict:
        """Pull one telemetry flush over the live RPC (spans after
        ``since_seq``, metrics snapshot, recorder events). The exchange is
        also a clock sample — telemetry pulls tighten the offset bound for
        free. Raises on a dead replica; the collector falls back to the
        replica's on-disk telemetry dir."""
        t0 = time.time()
        reply = call(self.addr, {"verb": "telemetry",
                                 "since_seq": int(since_seq)},
                     timeout=self.probe_timeout, dialer=dial_fast)
        self._observe_clock(t0, reply)
        return reply

    # -- submission --------------------------------------------------------
    @staticmethod
    def _deadline_left(deadline_at: Optional[float]) -> Optional[float]:
        # deadline_at is a parent-process perf_counter timestamp — a
        # meaningless number in another process. Ship the REMAINING budget;
        # the server re-anchors it in its own timebase.
        if deadline_at is None:
            return None
        return deadline_at - time.perf_counter()

    def _open_stream(self, msg: dict, cls):
        if not self.healthy:
            raise ReplicaFailure(f"{self.replica_id} is not serving")
        try:
            sock = dial(self.addr, self.dial_timeout)
        except (RetryBudgetExceeded, OSError) as exc:
            raise ReplicaFailure(
                f"{self.replica_id} unreachable: {exc!r}") from exc
        try:
            send_frame(sock, msg)
            ack = recv_frame(sock, timeout=self.dial_timeout)
        except (TimeoutError, TransportError, OSError) as exc:
            sock.close()
            raise ReplicaFailure(
                f"{self.replica_id} dropped the submit: {exc!r}") from exc
        if ack is None or not ack.get("ok", False):
            sock.close()
            err = (ack or {}).get("error", "no ack")
            detail = (ack or {}).get("detail", "connection closed at ack")
            if err == "queue_full":
                raise QueueFull(detail)
            if err == "unknown_verb":
                # a protocol-level disagreement (version skew, bad client),
                # not a replica health problem — count it as such
                _proto_error("unknown_verb")
            raise ReplicaFailure(f"{self.replica_id}: {err}: {detail}")
        return cls(sock, self.replica_id)

    def submit(self, text, seed: int, *, max_tokens: Optional[int] = None,
               tenant: str = "default", priority: int = 0,
               deadline_at: Optional[float] = None,
               trace_id: Optional[str] = None,
               cond_scale: float = 1.0) -> RemoteResultStream:
        return self._open_stream(
            {"verb": "submit", "text": np.asarray(text, np.int32).tolist(),
             "seed": int(seed), "max_tokens": max_tokens, "tenant": tenant,
             "priority": int(priority),
             "deadline_left_s": self._deadline_left(deadline_at),
             "trace_id": trace_id, "cond_scale": float(cond_scale)},
            RemoteResultStream)

    def submit_group(self, text, seeds, *,
                     max_tokens: Optional[int] = None,
                     tenant: str = "default", priority: int = 0,
                     deadline_at: Optional[float] = None,
                     trace_id: Optional[str] = None,
                     cond_scale: float = 1.0) -> RemoteGroupStream:
        return self._open_stream(
            {"verb": "submit_group",
             "text": np.asarray(text, np.int32).tolist(),
             "seeds": [int(s) for s in seeds], "max_tokens": max_tokens,
             "tenant": tenant, "priority": int(priority),
             "deadline_left_s": self._deadline_left(deadline_at),
             "trace_id": trace_id, "cond_scale": float(cond_scale)},
            RemoteGroupStream)

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful: the replica finishes queued + in-flight work, then
        acks. ``timeout=None`` preserves the in-process contract — wait
        as long as the work takes (the blocking read only ends on the ack
        or the replica process dying, which closes the socket). Safe on
        an already-dead process (the drain of a crashed replica is a
        no-op, not an error)."""
        self._draining = True
        try:
            call(self.addr, {"verb": "drain", "migrate": False,
                             "wait_s": timeout},
                 timeout=None if timeout is None else timeout + 5.0)
        except (RetryBudgetExceeded, TransportError, OSError):
            pass

    def migrate(self, reason: str = "drain") -> int:
        """Fail every queued + in-flight stream on the replica NOW with
        ``reason`` so the router resubmits them elsewhere (same seed →
        bit-identical regeneration; the row high-water dedup hides the
        splice). Returns the number of migrated streams (0 if the replica
        is already gone)."""
        self._draining = True
        try:
            reply = call(self.addr, {"verb": "drain", "migrate": True,
                                     "reason": reason})
            return int(reply.get("migrated", 0))
        except (RetryBudgetExceeded, TransportError, OSError):
            return 0

    def close(self) -> None:
        self._closed = True


class ReplicaServer:
    """Serves one local :class:`~..gateway.replica.Replica` over the frame
    protocol — the replica process half (``cli/serve_replica.py``).

    One daemon thread per connection (``submit`` streams can be long-
    lived). Chaos rides the ENGINE loop, not this layer: the decode
    engine's per-iteration ``chaos.step_hook`` (serve/engine.py) lets an
    env-installed :class:`~..chaos.faults.FaultPlan` kill, hang or slow
    this replica PROCESS mid-decode — the scripted deaths
    a fleet smoke heals around."""

    def __init__(self, replica, *, host: str = "127.0.0.1", port: int = 0,
                 compile_counter=None):
        self.replica = replica
        self.compile_counter = compile_counter
        self.requests_served = 0
        self.started_at = time.time()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._closing = False
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        host, port = self._sock.getsockname()[:2]
        return f"{host}:{port}"

    def start(self) -> "ReplicaServer":
        assert self._accept_thread is None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-accept", daemon=True)
        self._accept_thread.start()
        return self

    def shutdown(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            msg = recv_frame(conn, timeout=30.0)
            if msg is None:
                return
            verb = msg.get("verb")
            if verb == "submit":
                self._handle_submit(conn, msg)
            elif verb == "submit_group":
                self._handle_group(conn, msg)
            elif verb == "health":
                send_frame(conn, self._health())
            elif verb == "telemetry":
                send_frame(conn, self._telemetry(msg))
            elif verb == "drain":
                self._handle_drain(conn, msg)
            else:
                send_frame(conn, {"error": "unknown_verb", "detail": verb})
        except (TimeoutError, TransportError, OSError):
            pass                      # client went away; nothing to salvage
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- verbs -------------------------------------------------------------
    def _telemetry(self, msg: dict) -> dict:
        """Telemetry pull: this process's spans (after the caller's
        cursor), full metrics snapshot, and recorder events, stamped with
        ``server_time``/``replica_id`` — the fleet collector's RPC source."""
        reply = telemetry_payload(int(msg.get("since_seq", 0)))
        reply["replica_id"] = getattr(self.replica, "replica_id", None)
        return reply

    def _health(self) -> dict:
        h = self.replica.health()
        snap = metrics_snapshot()
        h.update(
            ok=True, pid=os.getpid(),
            server_time=time.time(),   # clock-offset sample
            requests_served=self.requests_served,
            uptime_s=time.time() - self.started_at,
            backend_compiles=(self.compile_counter.count
                              if self.compile_counter is not None else None),
            # dalle_health_decode_* inputs for the controller's
            # drain-on-degradation predicate (set per completed request by
            # the engine's decode_health taps; absent until one completes).
            # Keys are the bare stat names ("entropy"/"topk_mass"/
            # "repeat_ratio") — the exact keys FleetController._degraded
            # reads.
            decode={k[len("health.decode_"):]: snap[k]
                    for k in ("health.decode_entropy",
                              "health.decode_topk_mass",
                              "health.decode_repeat_ratio") if k in snap})
        return h

    def _submit_kwargs(self, msg: dict) -> dict:
        deadline_left = msg.get("deadline_left_s")
        return dict(
            max_tokens=msg.get("max_tokens"),
            tenant=str(msg.get("tenant", "default")),
            priority=int(msg.get("priority", 0)),
            # re-anchor the shipped remaining budget in THIS process's
            # perf_counter timebase (the queue/policy layer compares
            # deadline_at against it)
            deadline_at=(time.perf_counter() + float(deadline_left)
                         if deadline_left is not None else None),
            trace_id=msg.get("trace_id"),
            # older clients omit the key → 1.0 (no CFG cohort)
            cond_scale=float(msg.get("cond_scale", 1.0)))

    @staticmethod
    def _failed_frame(payload) -> dict:
        """Stamp a local stream's failure payload for the wire via the
        shared ``classify_failure`` mapping (gateway/replica.py) — the
        same failure gets the same reason label whether the replica was
        local or remote."""
        out = {"kind": "replica_failed"}
        if isinstance(payload, dict):
            out.update(payload)
        else:
            out["detail"] = str(payload)
        out.setdefault("reason", classify_failure(payload))
        return out

    def _handle_submit(self, conn, msg):
        text = np.asarray(msg["text"], np.int32)
        try:
            stream = self.replica.submit(text, int(msg["seed"]),
                                         **self._submit_kwargs(msg))
        except QueueFull as exc:
            send_frame(conn, {"error": "queue_full", "detail": str(exc)})
            return
        except RuntimeError as exc:
            send_frame(conn, {"error": "replica_failure",
                              "detail": repr(exc)})
            return
        self.requests_served += 1
        send_frame(conn, {"ok": True})
        for kind, payload in stream.events(
                timeout=30.0, still_alive=lambda: self.replica.healthy):
            if kind == "row":
                row, tokens = payload
                send_frame(conn, {"kind": "row", "row": int(row),
                                  "tokens": [int(t) for t in tokens]})
            elif kind == "done":
                send_frame(conn, {
                    "kind": "done",
                    "tokens": [int(t) for t in payload.tokens],
                    "ttft_s": payload.ttft_s,
                    "latency_s": payload.latency_s,
                    "decode_s": getattr(payload, "decode_s",
                                        payload.latency_s),
                    "request_id": payload.request_id})
            elif kind == "shed":
                send_frame(conn, {"kind": "shed",
                                  "reason": "deadline_shed"})
            else:
                send_frame(conn, self._failed_frame(payload))

    def _handle_group(self, conn, msg):
        text = np.asarray(msg["text"], np.int32)
        try:
            group = self.replica.submit_group(text, msg["seeds"],
                                              **self._submit_kwargs(msg))
        except QueueFull as exc:
            send_frame(conn, {"error": "queue_full", "detail": str(exc)})
            return
        except RuntimeError as exc:
            send_frame(conn, {"error": "replica_failure",
                              "detail": repr(exc)})
            return
        self.requests_served += 1
        send_frame(conn, {"ok": True})
        for idx, kind, payload in group.events(
                timeout=30.0, still_alive=lambda: self.replica.healthy):
            if kind == "row":
                row, tokens = payload
                send_frame(conn, {"kind": "row", "candidate": idx,
                                  "row": int(row),
                                  "tokens": [int(t) for t in tokens]})
            elif kind == "done":
                send_frame(conn, {
                    "kind": "done", "candidate": idx,
                    "tokens": [int(t) for t in payload.tokens],
                    "ttft_s": payload.ttft_s,
                    "latency_s": payload.latency_s,
                    "decode_s": getattr(payload, "decode_s",
                                        payload.latency_s),
                    "request_id": payload.request_id})
            elif kind == "shed":
                send_frame(conn, {"kind": "shed", "candidate": idx,
                                  "reason": "deadline_shed"})
            else:
                send_frame(conn, self._failed_frame(payload))
                return
        send_frame(conn, {"kind": "group_end"})

    def _handle_drain(self, conn, msg):
        if msg.get("migrate", False):
            n = self.replica.migrate(
                reason=str(msg.get("reason", "drain")))
            send_frame(conn, {"ok": True, "migrated": n})
            return
        wait_s = msg.get("wait_s")
        self.replica.drain(timeout=wait_s)
        send_frame(conn, {"ok": True, "migrated": 0})
