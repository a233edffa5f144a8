"""The port's replica fleet ≡ the JAX package's (CPU).

Wire compatibility over a fake engine (deterministic tokens, a semaphore
pacing rows, no device): the port's frames are the JAX frames byte for
byte; torn, oversize and undecodable frames, an unknown verb and a refused
handshake fail as typed errors with their counters; a JAX
``RemoteReplica`` served by the port's ``ReplicaServer`` and the port's
``RemoteReplica`` served by the JAX ``ReplicaServer`` see the same rows,
``done``, group streams, health, queue-full, migrate, worker-death reason
and drain as the JAX pair; the port's frames meet ``contracts/wire.json``
through the port's ``wiretap`` and have the JAX tap's shapes.
``FleetController`` takes the JAX controller's decisions on the scripted
cases of the JAX package's tests, with the same ``fleet.*`` and
``degrade.*`` counters; ``frozen_progress``, ``StragglerDetector`` and
``WedgeWatchdog`` behave alike. ``lockorder`` finds a cycle between two
locks created in ``dalle_tpu_torch`` code and ``uninstall`` restores
``threading.Lock``. One ``serve_replica`` process spawned by
``FleetManager`` (``--device cpu``) is SIGKILLed by a chaos plan
mid-stream and its stream fails over (``conn_reset``) bitwise.
"""

import os
import socket
import struct
import sys
import threading
import time
import types

import numpy as np
import pytest

from dalle_tpu import fleet as jfleet
from dalle_tpu import gateway as jgw
from dalle_tpu import obs as jobs
from dalle_tpu.degrade import detector as jdet
from dalle_tpu.degrade import wedge as jwedge
from dalle_tpu.obs import wiretap as jwiretap
from dalle_tpu.serve import queue as jqueue
from dalle_tpu_torch import fleet as tfleet
from dalle_tpu_torch import gateway as tgw
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.degrade import detector as tdet
from dalle_tpu_torch.degrade import wedge as twedge
from dalle_tpu_torch.fleet import transport as ttransport
from dalle_tpu_torch.obs import lockorder, wiretap
from dalle_tpu_torch.serve import queue as tqueue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = np.array([3, 4, 5, 0, 0, 0], np.int32)
PKG = {"jax": (jfleet, jgw, jqueue, jobs), "port": (tfleet, tgw, tqueue, tobs)}


@pytest.fixture
def tracers():
    jobs.disable()
    tobs.disable()
    jobs.configure()
    tobs.configure()
    yield
    jobs.disable()
    tobs.disable()


def _fleet_only(snap):
    return {k: v for k, v in snap.items()
            if k.startswith(("fleet.", "degrade.", "gateway."))}


# ---------------------------------------------------------------------------
# the frame protocol
# ---------------------------------------------------------------------------

FRAMES = [{"verb": "health"}, {"kind": "row", "row": 3, "tokens": [1, 2, 3]},
          {"ok": True, "migrated": 0, "detail": "é ü"}, {"x": None, "y": [1.5, -2e-9]}]


@pytest.mark.parametrize("obj", FRAMES, ids=["verb", "row", "reply", "floats"])
def test_frames_are_the_jax_frames_byte_for_byte(obj):
    raw = {}
    for name, mod in (("jax", jfleet.transport), ("port", ttransport)):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, obj)
            a.close()
            raw[name] = b.recv(1 << 16)
        finally:
            b.close()
    assert raw["port"] == raw["jax"]
    # and each side reads the other's
    for send, recv in ((jfleet.transport, ttransport), (ttransport, jfleet.transport)):
        a, b = socket.socketpair()
        try:
            send.send_frame(a, obj)
            assert recv.recv_frame(b, timeout=5) == obj
        finally:
            a.close()
            b.close()


def test_frame_errors_are_typed_and_counted(tracers):
    a, b = socket.socketpair()
    try:
        ttransport.send_frame(a, {"verb": "health", "x": [1, 2, 3]})
        assert ttransport.recv_frame(b, timeout=5) == {"verb": "health", "x": [1, 2, 3]}
        a.sendall(struct.pack(">I", 100) + b"{}")
        a.close()
        with pytest.raises(ttransport.TransportError, match="torn frame"):
            ttransport.recv_frame(b, timeout=5)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        with pytest.raises(TimeoutError):
            ttransport.recv_frame(b, timeout=0.05)
        a.sendall(struct.pack(">I", ttransport.MAX_FRAME_BYTES + 1))
        with pytest.raises(ttransport.TransportError, match="exceeds"):
            ttransport.recv_frame(b, timeout=5)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", 5) + b"{nope")
        with pytest.raises(ttransport.TransportError, match="undecodable"):
            ttransport.recv_frame(b, timeout=5)
        reader = ttransport._FrameReader(b)
        a.sendall(struct.pack(">I", 9) + b'{"a"')       # a frame split by a pause
        with pytest.raises(TimeoutError):
            reader.read(timeout=0.05)
        a.sendall(b': 12}')
        assert reader.read(timeout=5) == {"a": 12}
    finally:
        a.close()
        b.close()
    snap = tobs.metrics_snapshot()
    for kind in ("torn_frame", "oversize_frame", "bad_json"):
        assert snap[f'fleet.protocol_errors_total{{kind="{kind}"}}'] == 1.0


def test_refused_handshake_is_a_spawn_error(tracers):
    from dalle_tpu_torch.fleet import manager
    for script, match in (("print('hello'); print('{\"other\": 1}')", "exited|closed"),
                          ("import time; print('x', flush=True); time.sleep(30)", "no replica")):
        import subprocess
        proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE)
        try:
            with pytest.raises(tfleet.SpawnError, match=match):
                manager._read_handshake(proc, 1.5)
        finally:
            proc.kill()
            proc.wait()
            proc.stdout.close()
    assert tobs.metrics_snapshot()['fleet.protocol_errors_total{kind="handshake"}'] == 2.0


# ---------------------------------------------------------------------------
# one fake engine for both packages
# ---------------------------------------------------------------------------

class FakeEngine:
    N_STEPS, ROW_LEN = 8, 4

    def __init__(self, queue_mod, slots=1, gate=None):
        self.queue_mod, self.slots, self.gate = queue_mod, slots, gate
        self.n_steps, self.row_len = self.N_STEPS, self.ROW_LEN

    @staticmethod
    def tokens_for(seed, n=N_STEPS):
        return [(seed * 31 + i) % 97 for i in range(n)]

    def run(self, queue, on_complete=None, on_rows=None):
        while not queue.drained:
            reqs = queue.take(self.slots)
            if not reqs:
                queue.wait_nonempty(timeout=0.02)
                continue
            for req in reqs:
                admitted = time.perf_counter()
                n = min(req.max_tokens or self.n_steps, self.n_steps)
                toks = self.tokens_for(req.seed, n)
                for row in range(-(-n // self.row_len)):
                    if self.gate is not None:
                        self.gate.acquire()
                    on_rows(req, row, toks[row * self.row_len:(row + 1) * self.row_len])
                on_complete(self.queue_mod.CompletedRequest(
                    request_id=req.request_id, tokens=np.asarray(toks, np.int32),
                    seed=req.seed, submitted_at=req.submitted_at, admitted_at=admitted,
                    first_token_at=admitted, completed_at=time.perf_counter()))


def _served(server_pkg, gate=None, maxsize=16):
    fleet, gw, qmod, _ = PKG[server_pkg]
    rep = gw.Replica(FakeEngine(qmod, gate=gate), replica_id="srv", maxsize=maxsize).start()
    return rep, fleet.ReplicaServer(rep).start()


def _events(stream):
    out = []
    for ev in stream.events(timeout=10):
        kind, payload = ev[-2], ev[-1]
        idx = ev[0] if len(ev) == 3 else None
        if kind == "done":
            payload = ("done", payload.tokens, payload.request_id)
        elif isinstance(payload, dict):
            payload = {k: v for k, v in payload.items() if k != "detail"}
        out.append((idx, kind, payload))
    return out


HEALTH_KEYS = ("replica_id", "healthy", "draining", "queue_depth", "inflight", "slots",
               "image_seq_len", "image_fmap_size", "kv", "wedged", "error", "ok",
               "shed_total", "aot_loaded", "remote", "missed_heartbeats")


def _exchange(client_pkg, server_pkg):
    """One scripted conversation between a client package's RemoteReplica
    and a server package's ReplicaServer, normalised for comparison."""
    cfleet = PKG[client_pkg][0]
    out = {}
    rep, srv = _served(server_pkg)
    rem = cfleet.RemoteReplica(srv.addr, heartbeat_s=0.05)
    try:
        out["submit"] = _events(rem.submit(TEXT, 7))
        out["max_tokens"] = _events(rem.submit(TEXT, 8, max_tokens=5))
        out["group"] = _events(rem.submit_group(TEXT, [3, 4]))
        time.sleep(0.2)                               # a fresh heartbeat
        h = rem.health()
        out["health_keys"] = sorted(set(h) - {"progress"})
        out["health"] = {k: h.get(k) for k in HEALTH_KEYS}
        rep.fail_after_rows(1)
        out["death"] = _events(rem.submit(TEXT, 9))
    finally:
        rem.close()
        srv.shutdown()
    # queue full, then migrate, then drain on a gated engine
    gate = threading.Semaphore(0)
    rep, srv = _served(server_pkg, gate=gate, maxsize=1)
    rem = cfleet.RemoteReplica(srv.addr, heartbeat_s=0.05)
    try:
        held = rem.submit(TEXT, 1)                    # the engine takes it, gated
        deadline = time.time() + 5
        while rep.queue.qsize() or rep.inflight != 1:
            assert time.time() < deadline
            time.sleep(0.01)
        queued = rem.submit(TEXT, 2)                  # waits in the queue
        try:
            rem.submit(TEXT, 3)
            out["full"] = None
        except Exception as exc:  # noqa: BLE001 - the type is the result
            out["full"] = type(exc).__name__
        out["migrated"] = rem.migrate(reason="health_page")
        out["held"] = _events(held)
        out["queued"] = _events(queued)
        out["draining"] = rem.draining and not rem.healthy
        for _ in range(8):
            gate.release()
        rem.drain(timeout=5)
    finally:
        rem.close()
        srv.shutdown()
    return out


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_remote_replica_interop_matches_jax_pair(tracers, client, server):
    want = _exchange("jax", "jax")
    got = _exchange(client, server)
    assert got == want
    assert [p for _, k, p in got["submit"] if k == "row"] == [
        (0, FakeEngine.tokens_for(7)[:4]), (1, FakeEngine.tokens_for(7)[4:])]
    assert got["submit"][-1][2][1] == FakeEngine.tokens_for(7)
    assert got["death"][-1][2]["reason"] == "worker_death"
    assert got["full"] == "QueueFull" and got["migrated"] == 2
    assert got["held"][-1][2]["reason"] == "health_page"


def test_unknown_verb_and_ack_errors(tracers):
    rep, srv = _served("port")
    try:
        reply = ttransport.call(srv.addr, {"verb": "nope"})
        assert reply == {"error": "unknown_verb", "detail": "nope"}
        reply = jfleet.transport.call(srv.addr, {"verb": "nope"})
        assert reply == {"error": "unknown_verb", "detail": "nope"}
        rem = tfleet.RemoteReplica(srv.addr, heartbeat_s=0.05)
        rep.drain(timeout=5)                          # the replica stops serving
        time.sleep(0.2)
        with pytest.raises(tgw.ReplicaFailure):
            rem.submit(TEXT, 1)
        rem.close()
    finally:
        srv.shutdown()


def test_wiretap_conformance_and_jax_shapes(tracers):
    """Both taps on, one conversation in each direction: the port's
    observed frame shapes meet contracts/wire.json and equal the JAX
    tap's (a shape ignores direction, so the two ends see one set)."""
    wiretap.install()
    jwiretap.install()
    try:
        wiretap.reset()
        jwiretap.reset()
        for client, server in (("jax", "port"), ("port", "jax")):
            rep, srv = _served(server)
            rem = PKG[client][0].RemoteReplica(srv.addr, heartbeat_s=0.05)
            _events(rem.submit(TEXT, 7))
            _events(rem.submit_group(TEXT, [1, 2]))
            rem.fetch_telemetry(0)
            rem.migrate("drain")
            rem.drain(timeout=5)
            rem.close()
            srv.shutdown()
        got, want = wiretap.observed(), jwiretap.observed()
        assert got and set(got) == set(want)
        assert wiretap.conformance(wiretap.golden()) == []
        assert {s[0] for s in got if s[1] == "request"} == {
            "health", "submit", "submit_group", "telemetry", "drain"}
        wiretap.reset()
        a, b = socket.socketpair()
        ttransport.send_frame(a, {"verb": "bogus", "x": 1})
        a.close()
        b.close()
        assert [str(v) for v in wiretap.conformance(wiretap.golden())] == [
            "bogus.request {verb, x}: verb not in the golden contract"]
    finally:
        wiretap.uninstall()
        jwiretap.uninstall()
    assert ttransport._frame_tap is None and not wiretap.installed()


# ---------------------------------------------------------------------------
# the controller on the JAX tests' scripted cases
# ---------------------------------------------------------------------------

class FakeRemote:
    def __init__(self, rid):
        self.replica_id = rid
        self.healthy = True
        self.load = 0
        self.missed_heartbeats = 0
        self.max_missed = 3
        self.health_doc = {"decode": {}}
        self.migrations = []

    def health(self):
        return self.health_doc

    def migrate(self, reason):
        self.migrations.append(reason)
        return 1

    def drain(self, timeout=None):
        pass

    def close(self):
        pass


class FakeProc:
    def __init__(self, seq):
        seq[0] += 1
        self.remote = FakeRemote(f"fake-{seq[0]}")
        self.alive = True
        self.handshake = {"aot_loaded": False, "backend_compiles": 0}
        self.pid = 10000 + seq[0]

    @property
    def replica_id(self):
        return self.remote.replica_id

    def kill(self, sig=None):
        self.alive = False


class FakeManager:
    def __init__(self, spawn_error, seq):
        self.spawn_error, self.seq = spawn_error, seq
        self.killed, self.stopped, self.fail_next = [], [], 0

    @property
    def warm_available(self):
        return 1

    def acquire(self):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise self.spawn_error("injected spawn failure")
        return FakeProc(self.seq)

    def kill(self, rp, sig=None):
        rp.kill()
        self.killed.append(rp.replica_id)

    def stop(self, rp, drain_timeout_s=None):
        rp.kill()
        self.stopped.append(rp.replica_id)


def _burn_then(ctl, procs, mgr, burn):
    burn["v"] = True
    for _ in range(6):
        yield
    burn["v"] = False
    procs[0].remote.missed_heartbeats = 3
    for _ in range(8):
        yield


def _ticks(n):
    def script(ctl, procs, mgr, burn):
        for _ in range(n):
            yield
    return script


def _burning(n):
    def script(ctl, procs, mgr, burn):
        burn["v"] = True
        for _ in range(n):
            yield
    return script


def _oscillate(ctl, procs, mgr, burn):
    for i in range(12):
        burn["v"] = i % 2 == 0
        yield


def _set(attr_path, value, ticks=2, proc=0):
    def script(ctl, procs, mgr, burn):
        obj = procs[proc]
        *head, last = attr_path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
        for _ in range(ticks):
            yield
    return script


def _degrading(ctl, procs, mgr, burn):
    procs[0].remote.health_doc = {"decode": {"repeat_ratio": 0.9}}
    for _ in range(4):
        yield
    procs[1].remote.health_doc = {"decode": {"repeat_ratio": 0.9}}
    yield
    procs[1].remote.health_doc = {"decode": {"entropy": 0.05, "repeat_ratio": 0.0}}
    for _ in range(6):
        yield


def _request_drain(ctl, procs, mgr, burn):
    ctl.request_drain(procs[0].replica_id, reason="health_page")
    yield
    yield


def _spawn_failures(n_fail, alive=True, burn_on=False):
    def script(ctl, procs, mgr, burn):
        mgr.fail_next = n_fail
        procs[0].alive = alive
        burn["v"] = burn_on
        for _ in range(4):
            yield
    return script


def _draining_zombie(ctl, procs, mgr, burn):
    procs[0].remote.healthy = False
    procs[0].remote.draining = True
    yield
    procs[1].remote.healthy = False
    yield


CONTROLLER_CASES = {
    "scale_up_sustain_cooldown_max": (1, {}, _burning(12)),
    "scale_down_idle_bounded_by_min": (2, {}, _ticks(14)),
    "oscillating_never_flaps": (1, {"down_sustain": 4}, _oscillate),
    "replace_missed_heartbeats": (2, {}, _set("remote.missed_heartbeats", 3)),
    "min_bound_reconciles": (1, {}, _spawn_failures(3, alive=False)),
    "replace_process_exit": (1, {}, _set("alive", False)),
    "draining_then_zombie": (2, {}, _draining_zombie),
    "scale_up_spawn_failure_retries": (1, {}, _spawn_failures(1, burn_on=True)),
    "decode_degradation_drain": (2, {"drain_repeat_ratio": 0.5, "drain_entropy_floor": 0.1,
                                     "health_sustain": 3}, _degrading),
    "request_drain_below_min": (1, {}, _request_drain),
    "bounds_and_counters": (2, {"down_sustain": 2}, _burn_then),
    "wedged_self_report": (2, {}, _set("remote.health_doc", {"decode": {}, "wedged": True,
                                                              "wedge_detail": "frozen"})),
    "progress_stall": (2, {}, _set("remote.progress_stalled", True, proc=1)),
}


def _run_controller(pkg, n, kw, script):
    fleet, gw, _, obs = PKG[pkg]
    obs.disable()
    obs.configure()
    seq = [0]
    procs = [FakeProc(seq) for _ in range(n)]
    router = gw.ReplicaRouter([rp.remote for rp in procs])
    mgr = FakeManager(fleet.SpawnError, seq)
    burn = {"v": False}
    sentry = types.SimpleNamespace(evaluate=lambda: {"burning": burn["v"]})
    kw = {"min_replicas": 1, "max_replicas": 3, "up_sustain": 2, "down_sustain": 3,
          "cooldown_ticks": 3, "retire_grace_ticks": 0, **kw}
    ctl = fleet.FleetController(router, mgr, sentry=sentry, **kw)
    for rp in procs:
        ctl.adopt(rp)
    per_tick = []
    for _ in script(ctl, procs, mgr, burn):
        per_tick.append([{k: v for k, v in d.items() if k != "t"} for d in ctl.tick()])
    try:
        return {"ticks": per_tick, "fleet": [r.replica_id for r in router.replicas],
                "killed": mgr.killed, "stopped": mgr.stopped,
                "migrations": [rp.remote.migrations for rp in procs],
                "metrics": _fleet_only(obs.metrics_snapshot())}
    finally:
        obs.disable()


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_fleet_controller_matches_jax(case):
    n, kw, script = CONTROLLER_CASES[case]
    want = _run_controller("jax", n, kw, script)
    got = _run_controller("port", n, kw, script)
    assert got == want
    assert any(got["ticks"]) or case == "oscillating_never_flaps"


# ---------------------------------------------------------------------------
# degrade: frozen progress, stragglers, the wedge watchdog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [None, 0, 7])
def test_frozen_progress_matches_jax(step):
    for st in (None, 0.0, 5.0):
        for now in (4.0, 5.5, 20.0):
            for timeout in (0.5, 10.0):
                assert tdet.frozen_progress(step, st, now, timeout) == \
                    jdet.frozen_progress(step, st, now, timeout)


def _lockstep(n_steps, interval, blocked_by_worker, start=1, jitter=0.0):
    rounds, t = [], 0.0
    for i in range(n_steps):
        t += interval + (jitter if i % 5 == 3 else 0.0)
        rounds.append((start + i, t, dict(blocked_by_worker(i))))
    return rounds


STRAGGLER_CASES = {
    "victim_n2": ((0, 1), {}, _lockstep(12, 1.0, lambda i: {0: 0.8, 1: 0.02})),
    "healthy": ((0, 1, 2), {}, _lockstep(12, 1.0, lambda i: {0: 0.1, 1: 0.12, 2: 0.09})),
    "single_spike": ((0, 1), {}, _lockstep(12, 1.0, lambda i: (
        {0: 0.9, 1: 0.0} if i == 6 else {0: 0.05, 1: 0.05}))),
    "recovery": ((0, 1), {"sustain": 2}, _lockstep(30, 1.0, lambda i: (
        {0: 0.8, 1: 0.02} if i < 12 else {0: 0.05, 1: 0.05}), jitter=0.3)),
    "no_blocked_signal": ((0, 1), {}, _lockstep(10, 1.0, lambda i: {0: None, 1: None})),
    "three_workers": ((0, 1, 2), {"factor": 0.3}, _lockstep(15, 0.5, lambda i: {
        0: 0.4, 1: 0.41, 2: 0.01})),
}


def _verdict(v):
    return (v.worker_id, v.step, v.deficit_s, v.interval_s, v.ratio)


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_detector_matches_jax(case):
    members, kw, rounds = STRAGGLER_CASES[case]
    jd, td = jdet.StragglerDetector(**kw), tdet.StragglerDetector(**kw)
    seen = []
    for step, t, blocked in rounds:
        beats = {w: {"step": step, "step_time": t, "blocked_s": b} for w, b in blocked.items()}
        want = [_verdict(v) for v in jd.observe(beats, list(members))]
        got = [_verdict(v) for v in td.observe(beats, list(members))]
        assert got == want
        seen.extend(got)
        assert (td.processed, td.interval_ewma) == (jd.processed, jd.interval_ewma)
        for w in members:
            assert (td.deficit_of(w), td.is_flagged(w)) == (jd.deficit_of(w), jd.is_flagged(w))
    assert bool(seen) == (case in ("victim_n2", "recovery", "three_workers"))
    td.reset()
    jd.reset()
    assert td.observe({0: {"step": 1, "step_time": 1.0}}, [0]) == []


# (progress, busy, now) polls: a cold first dispatch, idle forever, long
# prefills under the timeout, the first look already frozen, two episodes
WEDGE_CASES = {
    "first_compile": [(0, True, float(t)) for t in range(0, 300, 10)],
    "idle": [(5, False, 0.0), (5, False, 1.0), (6, False, 2.0)]
    + [(6, False, float(t)) for t in range(3, 1000, 50)],
    "long_prefill": [(1, True, 0.0), (2, True, 0.1)]
    + [(3 + i, True, 0.1 + 0.9 * (i + 1)) for i in range(20)],
    "frozen_at_first_look": [(11, True, 0.0), (11, True, 1.5), (11, True, 3.0)],
    "two_episodes": [(1, True, 0.0), (2, True, 0.1), (2, True, 0.5), (2, True, 1.5),
                     (2, True, 2.5), (3, True, 3.0), (3, True, 4.5), (3, False, 9.0)],
}


@pytest.mark.parametrize("case", sorted(WEDGE_CASES))
def test_wedge_watchdog_matches_jax(case):
    state = {"p": 0, "b": False}
    probe = lambda: (state["p"], state["b"])    # noqa: E731
    trips = {"j": [], "t": []}
    jw = jwedge.WedgeWatchdog(probe, 1.0, on_wedge=trips["j"].append)
    tw = twedge.WedgeWatchdog(probe, 1.0, on_wedge=trips["t"].append)
    for progress, busy, now in WEDGE_CASES[case]:
        state.update(p=progress, b=busy)
        assert tw.check(now=now) == jw.check(now=now)
        assert (tw.wedged, tw.trips) == (jw.wedged, jw.trips)
    assert trips["t"] == trips["j"]


def test_wedge_watchdog_thread_and_failing_sinks():
    logs = []

    def bad_probe():
        raise RuntimeError("engine is gone")
    assert twedge.WedgeWatchdog(bad_probe, 1.0, log=logs.append).check(now=0.0) is False
    assert "probe failed" in logs[-1]
    state = {"p": 3}

    def bad_sink(detail):
        raise RuntimeError("pager down")
    wd = twedge.WedgeWatchdog(lambda: (state["p"], True), 0.05, on_wedge=bad_sink,
                              poll_s=0.01, log=logs.append).start()
    deadline = time.time() + 5
    while not wd.wedged:
        assert time.time() < deadline
        time.sleep(0.01)
    wd.stop()
    assert wd.trips == 1 and "on_wedge failed" in logs[-1]


# ---------------------------------------------------------------------------
# lockorder
# ---------------------------------------------------------------------------

def test_lockorder_finds_a_cycle_and_uninstall_restores():
    real_lock, real_rlock = threading.Lock, threading.RLock
    lockorder.install()
    try:
        quotas = tgw.TenantQuotas(1.0, 1.0)          # two locks created in
        bucket = tgw.TokenBucket(1.0, 1.0)          # dalle_tpu_torch code
        assert isinstance(quotas._lock, lockorder._TrackedLock)
        assert quotas._lock.site[0] == bucket._lock.site[0] == \
            "dalle_tpu_torch/gateway/admission.py"
        assert not isinstance(threading.Lock(), lockorder._TrackedLock)   # test code
        with quotas._lock:
            with bucket._lock:
                pass
        assert lockorder.cycles() == []

        def reverse():
            with bucket._lock:
                with quotas._lock:
                    pass
        t = threading.Thread(target=reverse, name="reverse")
        t.start()
        t.join()
        cyc = lockorder.cycles()
        assert len(cyc) == 1 and {e.src for e in cyc[0]} == {quotas._lock.site,
                                                            bucket._lock.site}
        assert "reverse" in lockorder.format_edge(cyc[0][1]) + lockorder.format_edge(cyc[0][0])
        assert set(lockorder.observed_sites().values()) == {"Lock"}
    finally:
        lockorder.uninstall()
    assert threading.Lock is real_lock and threading.RLock is real_rlock
    assert not lockorder.installed() and lockorder.cycles() == []
    assert not isinstance(tgw.TokenBucket(1.0, 1.0)._lock, lockorder._TrackedLock)


# ---------------------------------------------------------------------------
# one replica process: spawn, chaos SIGKILL mid-stream, bitwise failover
# ---------------------------------------------------------------------------

def test_spawned_replica_killed_midstream_fails_over_bitwise(tmp_path, tracers):
    from dalle_tpu_torch import chaos
    from dalle_tpu_torch.cli.serve_gateway import TINY_CFG
    from dalle_tpu_torch import DalleConfig, DalleWithVae, init_dalle
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    mgr = tfleet.FleetManager(
        [sys.executable, "-m", "dalle_tpu_torch.cli.serve_replica", "--untrained",
         "--device", "cpu", "--slots", "2", "--flight_dir", "off"],
        heartbeat_s=0.1, spawn_timeout_s=120, env=env)
    local = tgw.Replica(DalleWithVae(init_dalle(DalleConfig(**TINY_CFG), seed=0,
                                                device="cpu"), None).serve_engine(
        slots=2, steps_per_sync=4), replica_id="local").start()
    try:
        unfailed = [e for e in local.submit(TEXT, 5).events(timeout=60) if e[0] == "done"]
        t0 = time.perf_counter()
        plan = chaos.FaultPlan([chaos.Fault(kind="kill", step=3)])
        rp = mgr.spawn(extra_env=plan.env())
        spawn_s = time.perf_counter() - t0
        assert rp.handshake["fleet_replica"] == 1 and rp.remote.healthy
        assert rp.handshake["aot_loaded"] is False and spawn_s < 120
        router = tgw.ReplicaRouter([rp.remote, local])
        routed = router.submit(TEXT, 5)
        assert routed.replica_id == rp.replica_id
        rows, done = [], None
        for kind, payload in routed.events(timeout=60):
            if kind == "row":
                rows.append(payload["row"])
            elif kind == "done":
                done = payload
        assert rows == [0, 1, 2, 3] and done["failovers"] == 1
        assert done["replica"] == "local"
        assert done["tokens"] == unfailed[0][1].tokens.tolist()
        assert tobs.metrics_snapshot()['gateway.failover_total{reason="conn_reset"}'] == 1.0
        rp.proc.wait(timeout=30)
        assert not rp.alive
        deadline = time.time() + 10
        while rp.remote.missed_heartbeats < rp.remote.max_missed:
            assert time.time() < deadline
            time.sleep(0.05)
        assert not rp.remote.healthy
    finally:
        mgr.shutdown()
        local.drain(timeout=30)
