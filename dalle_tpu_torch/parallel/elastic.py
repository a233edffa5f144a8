"""Elastic pod runtime: membership epochs, heartbeats, liveness, and the
supervising agent that reshapes a pod around lost workers.

Port of ``dalle_tpu/parallel/elastic.py`` (pure stdlib plus the port's
``chaos``, ``obs``, ``degrade`` and ``utils/retry``; it imports no torch, so
the agent starts cheaply and workers use it before their process group
exists). Worker-set membership is a versioned fact:

  * **Membership epoch** (:class:`Epoch`, :class:`EpochFile`): an atomic
    JSON record in the shared run directory: epoch number, the stable
    worker ids that are members, each member's ``process_id`` (its rank in
    ``torch.distributed``) and the epoch's coordinator port. Every
    reconfiguration bumps the epoch.
  * **Heartbeats** (:class:`Heartbeat`, :func:`read_heartbeats`,
    :func:`stale_workers`, :func:`hung_workers`): each worker atomically
    rewrites ``hb_<worker_id>.json`` (pid/step/epoch/wall clock) from the
    training loop's ``on_step`` hook and a beater thread, through the retry
    layer and the chaos ``heartbeat`` injection site.
  * **Worker side** (:class:`ElasticWorker`): beats on every step and,
    with ``peer_timeout_s``, watches its peers' heartbeats from a daemon
    thread. A worker parked in a collective whose peer is gone cannot be
    interrupted from Python (gloo and NCCL both block the calling thread
    until their timeout), so the watcher ends the process with
    :data:`EXIT_RECONFIGURE` and hands recovery to the agent: the
    torchelastic teardown model. ``destroy_process_group`` from another
    thread cannot rescue a thread parked in a dead collective.
  * **Agent side** (:class:`ElasticAgent`): spawns one process per member,
    watches child exits and heartbeat staleness, and on a failure tears the
    epoch down (SIGTERM so survivors take their graceful-preemption save,
    then SIGKILL stragglers), writes epoch N+1 (the same membership under
    ``policy="respawn"``, the survivors only under ``"shrink"``) and
    relaunches. Respawned workers join the new world
    (``parallel/backend.TorchBackend``, retried: the gang dials in at
    once), restore the last durable step (a checkpoint holds the gathered
    state, so it restores at any world size: ``train/base_trainer.py``) and
    resume.

Recovery invariant (``cli/chaos_smoke.py``, over two real gloo processes):
the state after recovery is bit for bit that of an uninterrupted run at
the same step; every batch and every draw is keyed off the host step, so
re-running [last durable step, crash step] reproduces the same bits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from ..chaos import io_hook
from ..degrade import DegradeMonitor
from ..degrade.detector import frozen_progress
from ..obs import counter_add, record_event
from ..utils.retry import retry

# worker exit code meaning "membership changed under me — respawn me into
# the next epoch" (distinct from 0 = done and from crash codes)
EXIT_RECONFIGURE = 77

EPOCH_FILE = "epoch.json"

# env handoff: agent -> worker
DIR_ENV = "DALLE_ELASTIC_DIR"
WORKER_ENV = "DALLE_ELASTIC_WORKER"


# ---------------------------------------------------------------------------
# membership epochs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Epoch:
    """One generation of pod membership. ``members`` are stable WORKER ids
    (a worker keeps its id across epochs; a shrink removes ids, a respawn
    reuses them); a member's ``process_id`` (its torch.distributed rank) is its
    index in the list."""

    epoch: int
    members: List[int]
    port: int
    coordinator: str = "127.0.0.1"

    @property
    def nproc(self) -> int:
        return len(self.members)

    @property
    def coordinator_address(self) -> str:
        return f"{self.coordinator}:{self.port}"

    def process_id(self, worker_id: int) -> Optional[int]:
        try:
            return self.members.index(worker_id)
        except ValueError:
            return None


class EpochFile:
    """Atomic read/write of the epoch record in the shared run dir."""

    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, EPOCH_FILE)

    def read(self) -> Optional[Epoch]:
        try:
            with open(self.path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        return Epoch(epoch=int(doc["epoch"]),
                     members=[int(m) for m in doc["members"]],
                     port=int(doc["port"]),
                     coordinator=doc.get("coordinator", "127.0.0.1"))

    @retry("epoch_write", attempts=4, base_delay_s=0.02)
    def write(self, ep: Epoch) -> Epoch:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(dataclasses.asdict(ep), fh)
        os.replace(tmp, self.path)
        return ep


# ---------------------------------------------------------------------------
# heartbeats + liveness
# ---------------------------------------------------------------------------

def _hb_path(run_dir: str, worker_id: int) -> str:
    return os.path.join(run_dir, f"hb_{worker_id}.json")


class Heartbeat:
    """Worker-side liveness beacon: atomic rewrite of one small JSON file,
    throttled to ``interval_s``, written through the retry layer (a full
    disk or NFS blip must not kill the step loop) and the chaos
    ``heartbeat`` injection site.

    Each beat carries PROGRESS, not just presence: ``step`` (last
    completed host step) and ``step_time`` (wall clock of the last time
    the step ADVANCED). Liveness readers distinguish three states: file
    fresh + step advancing (healthy), file fresh + step frozen past a
    progress timeout (hung main thread — the beater below keeps the file
    fresh through a hang), file present but old (frozen/killed process)."""

    def __init__(self, run_dir: str, worker_id: int, *,
                 interval_s: float = 0.5):
        self.path = _hb_path(run_dir, worker_id)
        self.worker_id = int(worker_id)
        self.interval_s = float(interval_s)
        self._last = 0.0
        self._step: Optional[int] = None
        self._step_time: Optional[float] = None
        # graftward straggler signal: the worker's self-measured device/
        # collective wait for its last step (grafttrace t_dispatch+t_sync).
        # In lockstep SPMD every worker's step WALL time is the same; the
        # one that never waits is the straggler (degrade/detector.py).
        self._blocked_s: Optional[float] = None
        # graftward health page: a sentry breach on THIS worker, carried
        # in every subsequent beat so the agent's DegradeMonitor sees a
        # fleet-visible page instead of a process-local log line
        self._page: Optional[str] = None
        # the beater thread and the fit thread's on_step both write; the
        # shared tmp path must never be truncated/renamed mid-write
        self._write_lock = threading.Lock()

    def page(self, reason: str, epoch: Optional[int] = None) -> None:
        """Latch a health page into the beacon and publish it NOW (the
        agent must not wait out the write throttle to learn a worker is
        sick). Sticky for the life of this process — the drain decision is
        the agent's; a page that cleared locally still warranted it."""
        self._page = str(reason)
        self._write(epoch, time.time())
        self._last = time.time()

    def beat(self, step: Optional[int] = None,
             epoch: Optional[int] = None, *,
             blocked_s: Optional[float] = None,
             force: bool = False) -> bool:
        now = time.time()
        if step is not None and step != self._step:
            self._step = step
            self._step_time = now
            if blocked_s is not None:
                self._blocked_s = float(blocked_s)
        if not force and now - self._last < self.interval_s:
            return False
        self._write(epoch, now)
        self._last = now
        return True

    @retry("heartbeat", attempts=3, base_delay_s=0.02, max_delay_s=0.2)
    def _write(self, epoch, now) -> None:
        io_hook("heartbeat")             # chaos injection point
        with self._write_lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"worker_id": self.worker_id, "pid": os.getpid(),
                           "time": now, "step": self._step,
                           "step_time": self._step_time,
                           "blocked_s": self._blocked_s, "epoch": epoch,
                           "page": self._page}, fh)
            os.replace(tmp, self.path)


def read_heartbeats(run_dir: str) -> Dict[int, dict]:
    """Every parseable heartbeat in the run dir (a torn write — impossible
    with the atomic replace, but cheap to tolerate — reads as absent)."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("hb_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(run_dir, name), encoding="utf-8") as fh:
                doc = json.load(fh)
            out[int(doc["worker_id"])] = doc
        except (OSError, ValueError, KeyError):
            continue
    return out


def stale_workers(run_dir: str, members: List[int], timeout_s: float,
                  now: Optional[float] = None) -> List[int]:
    """Members whose heartbeat is older than ``timeout_s`` (or missing).
    The caller supplies the membership — a departed worker's leftover file
    must not read as a zombie."""
    now = time.time() if now is None else now
    beats = read_heartbeats(run_dir)
    out = []
    for wid in members:
        doc = beats.get(wid)
        if doc is None or now - float(doc.get("time", 0.0)) > timeout_s:
            out.append(wid)
    return out


def hung_workers(run_dir: str, members: List[int], timeout_s: float,
                 now: Optional[float] = None) -> List[int]:
    """Members that are provably WEDGED — never a worker that simply
    hasn't come up yet (a missing heartbeat means "still starting"; the
    agent's child-exit detection and run deadline own that case). Two
    shapes count:

      * file present but older than ``timeout_s`` — the whole process is
        frozen or gone (the beater thread would otherwise keep it fresh);
      * file fresh but the STEP hasn't advanced for ``timeout_s`` after
        having completed at least one step — a hung main thread behind a
        live beater. The ≥1-step arm gate keeps the long first-step
        step (and its kernel builds) from reading as a hang."""
    now = time.time() if now is None else now
    beats = read_heartbeats(run_dir)
    out = []
    for wid in members:
        doc = beats.get(wid)
        if doc is None:
            continue
        if now - float(doc.get("time", 0.0)) > timeout_s:
            out.append(wid)
            continue
        # fresh file, frozen step: the shared graftward core — the same
        # predicate the fleet transport runs against a replica's engine
        # iteration counter (degrade/detector.py)
        if frozen_progress(doc.get("step"), doc.get("step_time"), now,
                           timeout_s):
            out.append(wid)
    return out


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class ElasticWorker:
    """What a training process runs: beat from ``fit(on_step=...)``, watch
    peers, exit for respawn when the pod must reshape.

    ``peer_timeout_s > 0`` starts a daemon watcher: when any OTHER member's
    heartbeat goes stale past the timeout, the watcher records the event
    and calls ``on_peer_dead`` (default: ``os._exit(EXIT_RECONFIGURE)``).
    The hard exit is deliberate — see the module docstring: the main thread
    is typically parked inside a gloo collective that will never complete
    once the peer is gone, so only a process-level teardown can hand
    control back to the agent. The agent notices the exit (and the hung
    peer's stale heartbeat) and rebuilds the epoch."""

    def __init__(self, run_dir: str, worker_id: int, epoch: Epoch, *,
                 hb_interval_s: float = 0.5, peer_timeout_s: float = 0.0,
                 poll_s: float = 0.5,
                 on_peer_dead: Optional[Callable[[int], None]] = None,
                 log=print):
        self.run_dir = run_dir
        self.worker_id = int(worker_id)
        self.epoch = epoch
        self.heartbeat = Heartbeat(run_dir, worker_id,
                                   interval_s=hb_interval_s)
        self.peer_timeout_s = float(peer_timeout_s)
        self.poll_s = float(poll_s)
        self.on_peer_dead = on_peer_dead
        self.log = log
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._beater: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ElasticWorker":
        """Start the beater (and peer watcher) threads. Call EARLY — the
        beater keeps the heartbeat fresh through the long no-step phases
        (backend dial-in, restore, the first step's kernel builds) that the step hook
        cannot cover; progress-based liveness (``hung_workers``) is what
        distinguishes those from a real hang."""
        self.heartbeat.beat(step=None, epoch=self.epoch.epoch, force=True)
        self._beater = threading.Thread(
            target=self._beat_loop, name="elastic-heartbeat", daemon=True)
        self._beater.start()
        if self.peer_timeout_s > 0 and self.epoch.nproc > 1:
            self._watcher = threading.Thread(
                target=self._watch_peers, name="elastic-peer-watch",
                daemon=True)
            self._watcher.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def on_step(self, step: int,
                blocked_s: Optional[float] = None) -> None:
        """The ``BaseTrainer.fit(on_step=...)`` hook: records progress (the
        beater publishes it even while a later step wedges).
        ``blocked_s`` — the worker's device/collective wait for its last
        step — feeds the agent's straggler detector; callers with a
        grafttrace breakdown forward ``t_dispatch_s + t_sync_s`` (one step
        stale is fine, the detector smooths)."""
        try:
            self.heartbeat.beat(step=step, epoch=self.epoch.epoch,
                                blocked_s=blocked_s)
        except Exception as exc:  # noqa: BLE001 - a heartbeat outage past
            # the retry budget must not kill the training loop it reports
            # on; a quiet/stale file IS the failure signal
            self.log(f"[elastic] heartbeat beat failed: {exc!r}")

    def page(self, reason: str) -> None:
        """Publish a health page (graftward): latch ``reason`` into the
        heartbeat file so the agent's DegradeMonitor treats this worker
        like a straggler verdict — clean save, reshape around it,
        quarantine-respawn. Wire a graftpulse sentry to this via
        ``degrade.install_breach_pager(worker, sentry)``. Best-effort:
        a page lost to a heartbeat outage is re-published by every later
        beat (the marker is sticky)."""
        counter_add("degrade.pages_total", 1.0,
                    labels={"reason": "health_page"})
        record_event("worker_paged", worker_id=self.worker_id,
                     epoch=self.epoch.epoch, reason=reason)
        try:
            self.heartbeat.page(reason, epoch=self.epoch.epoch)
        except Exception as exc:  # noqa: BLE001 - same contract as
            # on_step: a beacon outage must not kill the loop it reports on
            self.log(f"[elastic] health page publish failed: {exc!r}")

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat.interval_s):
            try:
                self.heartbeat.beat(epoch=self.epoch.epoch, force=True)
            except Exception as exc:  # noqa: BLE001 - a dying beater must
                # not take the process with it; a quiet file IS the signal
                self.log(f"[elastic] heartbeat write failed: {exc!r}")

    # -- peer liveness -----------------------------------------------------
    def _watch_peers(self) -> None:
        peers = [m for m in self.epoch.members if m != self.worker_id]
        while not self._stop.wait(self.poll_s):
            dead = hung_workers(self.run_dir, peers, self.peer_timeout_s)
            if not dead:
                continue
            wid = dead[0]
            self.log(f"[elastic] worker {self.worker_id}: peer {wid} "
                     f"wedged (no progress/beat > {self.peer_timeout_s}s) "
                     "— requesting reconfiguration")
            counter_add("elastic.peer_dead_total", 1.0)
            record_event("elastic_peer_dead", worker_id=self.worker_id,
                         peer=wid, epoch=self.epoch.epoch)
            if self.on_peer_dead is not None:
                self.on_peer_dead(wid)
            else:
                os._exit(EXIT_RECONFIGURE)
            return

    # -- worker-side env plumbing -----------------------------------------
    @classmethod
    def from_env(cls, environ=os.environ, **kw) -> "ElasticWorker":
        """Build from the agent's env handoff: run dir + stable worker id
        from the env, topology from the epoch file."""
        run_dir = environ[DIR_ENV]
        worker_id = int(environ[WORKER_ENV])
        ep = EpochFile(run_dir).read()
        if ep is None:
            raise FileNotFoundError(f"no epoch file in {run_dir}")
        return cls(run_dir, worker_id, ep, **kw)


# ---------------------------------------------------------------------------
# agent side
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def python_worker_env(repo_root: str = "", card: Optional[int] = None,
                      extra: Optional[dict] = None) -> dict:
    """Env for a spawned torch worker process: the repo on PYTHONPATH and,
    on a host with several cards, the worker's own card
    (``CUDA_VISIBLE_DEVICES``; None leaves the parent's view, as for ranks
    that share one card). The rank, world and coordinator come from the
    epoch file, not from the environment."""
    env = dict(os.environ)
    if repo_root:
        env["PYTHONPATH"] = repo_root
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    env.update(extra or {})
    return env


class ElasticAgent:
    """The gang supervisor (torchelastic-style): spawn, watch, reshape.

    ``spawn(worker_id, epoch) -> subprocess.Popen`` is supplied by the
    caller (chaos_smoke builds python children; a launcher would exec the
    training CLI). The agent owns the epoch file: it writes epoch N before
    spawning its members, so a worker's view of topology is always a read
    of one atomic file.

    ``run()`` supervises until every member of the current epoch exits 0
    (returns the event log) or ``deadline_s`` passes (raises). Failure
    events — a child exiting nonzero (crash or EXIT_RECONFIGURE) or a
    running child whose heartbeat goes stale (hang; the agent SIGKILLs it)
    — trigger ``_reconfigure``: SIGTERM the survivors (their graceful-
    preemption handler saves + exits 0), escalate to SIGKILL after
    ``term_grace_s`` (a survivor blocked in a dead collective never
    reaches its step boundary), then write epoch N+1 per ``policy`` and
    respawn. ``max_reconfigures`` bounds crash loops."""

    def __init__(self, run_dir: str,
                 spawn: Callable[[int, Epoch], subprocess.Popen],
                 members: List[int], *, policy: str = "respawn",
                 hb_timeout_s: float = 0.0, poll_s: float = 0.2,
                 term_grace_s: float = 10.0, max_reconfigures: int = 4,
                 degrade: Optional[DegradeMonitor] = None,
                 log=print):
        assert policy in ("respawn", "shrink"), policy
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.spawn = spawn
        self.all_members = list(members)
        self.policy = policy
        # graftward (docs/RESILIENCE.md "Degradation ladder"): when set,
        # every poll also feeds the fleet's heartbeats to the degradation
        # monitor — straggler verdicts page then drain (reshape WITHOUT
        # the slow worker), health-page markers drain straight away
        # (quarantine-respawn: fresh process, same slot). None = dead/hung
        # detection only.
        self.degrade = degrade
        self.hb_timeout_s = float(hb_timeout_s)
        self.poll_s = float(poll_s)
        self.term_grace_s = float(term_grace_s)
        self.max_reconfigures = int(max_reconfigures)
        self.log = log
        self.epoch_file = EpochFile(run_dir)
        self.epoch: Optional[Epoch] = None
        self.procs: Dict[int, subprocess.Popen] = {}
        self.done: Dict[int, int] = {}          # worker_id -> exit code 0
        self.events: List[dict] = []            # the smoke's verdict input
        self.reconfigures = 0

    # -- bookkeeping -------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "time": time.time(),
              "epoch": self.epoch.epoch if self.epoch else -1, **fields}
        self.events.append(ev)
        record_event(f"elastic_{kind}", **{k: v for k, v in ev.items()
                                           if k != "kind"})
        self.log(f"[elastic-agent] {kind}: "
                 + " ".join(f"{k}={v}" for k, v in fields.items()))

    # -- epoch lifecycle ---------------------------------------------------
    def start_epoch(self, members: Optional[List[int]] = None) -> Epoch:
        n = (self.epoch.epoch + 1) if self.epoch is not None else 0
        members = list(self.all_members if members is None
                       else members)
        self.epoch = self.epoch_file.write(
            Epoch(epoch=n, members=members, port=free_port()))
        # stale beats from the previous epoch must not mask a worker that
        # never comes up in this one
        for wid in members:
            try:
                os.remove(_hb_path(self.run_dir, wid))
            except OSError:
                pass
        self._event("epoch_start", members=members,
                    port=self.epoch.port, policy=self.policy)
        if self.degrade is not None:
            # verdict state must not outlive the membership it was
            # computed over (EWMAs, page markers, escalation rungs)
            self.degrade.reset()
        # completion is PER EPOCH: a reconfiguration respawns every member
        # (done ones included) so the gang resumes in lockstep from one
        # shared durable step — a "done" worker sitting out would leave the
        # others' collectives one participant short
        self.done = {}
        self.procs = {}
        for wid in members:
            self.procs[wid] = self.spawn(wid, self.epoch)
        counter_add("elastic.epochs_total", 1.0)
        return self.epoch

    def _kill_epoch(self) -> None:
        """Tear down every still-running member: SIGTERM (graceful save),
        grace wait, SIGKILL stragglers."""
        live = {w: p for w, p in self.procs.items() if p.poll() is None}
        for wid, p in live.items():
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + self.term_grace_s
        for wid, p in live.items():
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
                self._event("survivor_drained", worker=wid,
                            returncode=p.returncode)
            except subprocess.TimeoutExpired:
                self._event("survivor_killed", worker=wid)
                p.kill()
                p.wait()

    def _reconfigure(self, *, lost: List[int], reason: str,
                     members: Optional[List[int]] = None) -> None:
        """Tear the epoch down and start the next one. ``members`` pins the
        new membership explicitly (the graftward drain rungs choose it —
        a straggler loses its slot regardless of policy, a health-paged
        worker keeps it for a fresh quarantine-respawn); None falls back
        to the death policy (respawn keeps every slot, shrink drops the
        lost)."""
        self.reconfigures += 1
        counter_add("elastic.reconfigures_total", 1.0)
        self._event("reconfigure", lost=lost, reason=reason,
                    n=self.reconfigures)
        if self.reconfigures > self.max_reconfigures:
            # tear the gang down BEFORE giving up: survivors are typically
            # wedged in dead collectives and would otherwise outlive the
            # agent as orphans
            self._kill_epoch()
            raise RuntimeError(
                f"elastic agent: {self.reconfigures} reconfigurations "
                f"(max {self.max_reconfigures}) — crash loop, giving up")
        self._kill_epoch()
        if members is None:
            if self.policy == "shrink":
                members = [m for m in self.epoch.members if m not in lost]
            else:
                members = list(self.epoch.members)
        if not members:
            raise RuntimeError("elastic agent: no survivors to shrink to")
        self.start_epoch(members)

    def _degrade_drain(self, action) -> None:
        """One ladder drain (graftward): SIGTERM the whole gang so every
        member — the sick one included — takes its graceful-preemption
        save at the next checkpoint boundary (``_kill_epoch``'s TERM →
        grace → KILL escalation is exactly the proactive-drain contract),
        then reshape: a STRAGGLER is excluded from the next epoch (a slow
        host is hardware-suspect — the shrink path); a HEALTH-PAGED worker
        keeps its slot and is quarantine-respawned as a fresh process
        (sick software state, healthy host), with ``max_reconfigures``
        bounding the crash loop if the respawn pages again."""
        wid, reason = action.worker_id, action.reason
        counter_add("degrade.actions_total", 1.0, labels={"reason": reason})
        self._event("degrade_drain", worker=wid, reason=reason,
                    detail=action.detail)
        if reason == "straggler":
            members = [m for m in self.epoch.members if m != wid]
        else:
            members = list(self.epoch.members)
        self._reconfigure(lost=[wid], reason=f"degrade_{reason}",
                          members=members)

    # -- the supervision loop ----------------------------------------------
    def run(self, deadline_s: float = 600.0) -> List[dict]:
        if self.epoch is None:
            self.start_epoch()
        t0 = time.time()
        while True:
            if time.time() - t0 > deadline_s:
                self._kill_epoch()
                raise TimeoutError(
                    f"elastic agent: run exceeded {deadline_s}s "
                    f"(events: {[e['kind'] for e in self.events]})")
            time.sleep(self.poll_s)
            # 1. child exits
            exited = {w: p.returncode for w, p in self.procs.items()
                      if p.poll() is not None and w not in self.done}
            lost = []
            for wid, rc in exited.items():
                if rc == 0:
                    self.done[wid] = 0
                    self._event("worker_done", worker=wid)
                else:
                    lost.append(wid)
                    self._event("worker_lost", worker=wid, returncode=rc,
                                reconfigure_request=(rc == EXIT_RECONFIGURE))
            if lost:
                # a worker that ASKED for reconfiguration (exit 77) is not
                # dead — it rejoins the next epoch even under shrink; a
                # crashed/killed one is only respawned under "respawn".
                # Fold in concurrently-HUNG members (running but heartbeat
                # stale — the usual reason a peer exited 77) so a shrink
                # drops them too instead of respawning a zombie slot.
                crashed = [w for w in lost
                           if exited[w] != EXIT_RECONFIGURE]
                if self.hb_timeout_s > 0:
                    running = [w for w, p in self.procs.items()
                               if p.poll() is None]
                    crashed += [w for w in
                                hung_workers(self.run_dir, running,
                                             self.hb_timeout_s)
                                if w not in crashed]
                self._reconfigure(lost=crashed, reason="worker_exit")
                continue
            # 2. hangs: a RUNNING child that is provably wedged — beating
            # without step progress (hung main thread) or present-but-
            # silent (frozen process). A child that hasn't beaten at all
            # is still starting; the run deadline backstops it.
            if self.hb_timeout_s > 0:
                running = [w for w, p in self.procs.items()
                           if p.poll() is None]
                hung = hung_workers(self.run_dir, running, self.hb_timeout_s)
                if hung:
                    for wid in hung:
                        self._event("worker_hung", worker=wid)
                        self.procs[wid].kill()
                        self.procs[wid].wait()
                    self._reconfigure(lost=hung, reason="heartbeat_stale")
                    continue
            # 3. degradation ladder (graftward): stragglers and health
            # pages among RUNNING members — sick-but-alive is this rung's
            # whole domain; dead/hung workers were handled above
            if self.degrade is not None:
                running = [w for w, p in self.procs.items()
                           if p.poll() is None and w not in self.done]
                actions = self.degrade.observe(
                    read_heartbeats(self.run_dir), running)
                drained = False
                for act in actions:
                    if act.kind == "page":
                        counter_add("degrade.pages_total", 1.0,
                                    labels={"reason": act.reason})
                        self._event("worker_paged", worker=act.worker_id,
                                    reason=act.reason, detail=act.detail)
                    elif not drained:
                        # one drain per poll: the reshape replaces the
                        # whole epoch, so a second same-poll verdict is
                        # stale by construction
                        drained = True
                        self._degrade_drain(act)
                if drained:
                    continue
            # 4. done?
            if all(w in self.done for w in self.epoch.members):
                self._event("pod_done", members=self.epoch.members)
                return self.events
