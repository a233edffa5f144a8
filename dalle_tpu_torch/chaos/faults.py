"""Deterministic fault injection: the FaultPlan and its hook points.

A copy of ``dalle_tpu/chaos/faults.py`` (it imports no JAX), with the same
environment names and plan JSON, so a plan written for the JAX package
drives the port. A :class:`FaultPlan` is a scripted list of :class:`Fault`
entries (what breaks, where, when, for which rank) installed process-wide
(:func:`install`) or handed to a subprocess through ``DALLE_CHAOS_PLAN``
(:func:`install_from_env`). Two hook shapes:

  * :func:`step_hook`: called once per loop iteration with the step, by
    ``BaseTrainer.fit`` and by the serve engine's decode loop. Fires
    ``kill`` (a signal to this process), ``hang`` / ``wedge`` (block the
    loop), ``slow`` (a delay on each of a range of steps) and
    ``corrupt_ckpt`` (damage the newest checkpoint on disk).
  * :func:`io_hook`: called at guarded I/O sites (``coordinator_connect``,
    ``ckpt_save``, ``ckpt_restore``, ``heartbeat``) inside their retry
    wrappers; fires ``fail_io``: raises :class:`InjectedFault` (an
    ``OSError``) ``times`` times, then heals. The port has no caller of it
    yet: its checkpoint I/O has no retry policy.

Every fired fault is recorded (a ``chaos_fault`` flight-recorder event and
the ``chaos.faults_injected_total{kind=}`` counter). Both hooks are one
module-global ``None`` check when no plan is installed. The same seed of
:meth:`FaultPlan.sample` gives the same faults as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal as _signal
import time
from typing import List, Optional

from ..obs import counter_add, record_event

PLAN_ENV = "DALLE_CHAOS_PLAN"
RANK_ENV = "DALLE_CHAOS_RANK"
EPOCH_ENV = "DALLE_CHAOS_EPOCH"

IO_SITES = ("coordinator_connect", "ckpt_save", "ckpt_restore", "heartbeat")
STEP_KINDS = ("kill", "hang", "slow", "wedge", "corrupt_ckpt")
KINDS = STEP_KINDS + ("fail_io",)


class InjectedFault(OSError):
    """A fault the harness injected. Subclasses ``OSError`` on purpose:
    the retry layer's TRANSIENT policy must absorb injected I/O faults
    through the exact path a real filesystem/connect blip would take."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted failure. ``kind`` selects the trigger surface:

    step-scoped (fired by :func:`step_hook` at ``step``):
      * ``kill`` — ``os.kill(self, signal)``; ``signal`` "SIGKILL" (hard
        preemption) or "SIGTERM" (graceful-preemption contract).
      * ``hang`` — block the training loop for ``duration_s`` (liveness
        detectors must notice via stale heartbeats).
      * ``slow`` — sleep ``duration_s`` on each of ``span_steps``
        consecutive steps starting at ``step`` (a straggler). Fires at both
        step-hook sites: the fit loop and the serve engine's decode loop.
      * ``wedge`` — ``hang``, named for the serving plane: block inside
        the engine loop for ``duration_s``.
      * ``corrupt_ckpt`` — damage the newest finalized step under
        ``path`` (:func:`corrupt_checkpoint`): ``mode`` "truncate",
        "garbage" or "tmp_litter" (a stale tmp directory aged ``age_s``
        seconds, the sweep's target).

    io-scoped (fired by :func:`io_hook` at ``site``):
      * ``fail_io`` — raise :class:`InjectedFault` at ``site`` for the
        first ``times`` calls, then heal.

    ``rank`` scopes the fault to one worker (-1 = every rank); ``epoch``
    scopes it to one membership epoch (default 0 — the original gang), so
    a RESPAWNED worker re-crossing the trigger step does not re-fire the
    fault and crash-loop the recovery it is supposed to exercise."""

    kind: str
    step: int = -1
    site: str = ""
    rank: int = 0
    epoch: int = 0
    times: int = 1
    signal: str = "SIGKILL"
    duration_s: float = 3600.0
    span_steps: int = 1
    path: str = ""
    mode: str = "truncate"
    age_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.kind == "fail_io" and self.site not in IO_SITES:
            raise ValueError(
                f"fail_io needs site in {IO_SITES}, got {self.site!r}")
        if self.kind in STEP_KINDS and self.step < 0:
            raise ValueError(f"{self.kind} fault needs a step >= 0")


class FaultPlan:
    """The installed scenario: faults + this process's rank + bookkeeping
    of what already fired (each fault fires at most once; ``fail_io``
    decrements ``times``)."""

    def __init__(self, faults: List[Fault], *, rank: int = 0, seed: int = 0,
                 epoch: int = 0):
        self.faults = list(faults)
        self.rank = int(rank)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self._fired = [False] * len(self.faults)
        self._io_remaining = [f.times if f.kind == "fail_io" else 0
                              for f in self.faults]
        self._slow_until = {}   # fault index -> last slowed step

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults]})

    @classmethod
    def from_json(cls, text: str, *, rank: int = 0,
                  epoch: int = 0) -> "FaultPlan":
        doc = json.loads(text)
        return cls([Fault(**f) for f in doc.get("faults", [])],
                   rank=rank, seed=int(doc.get("seed", 0)), epoch=epoch)

    def env(self) -> dict:
        """Env-var handoff for a spawned worker (the worker sets its own
        rank via :data:`RANK_ENV`)."""
        return {PLAN_ENV: self.to_json()}

    # -- scenario generator ------------------------------------------------
    @classmethod
    def sample(cls, seed: int, *, nproc: int = 2, max_step: int = 8,
               kinds: tuple = ("kill", "fail_io"), rank: int = 0,
               ckpt_dir: str = "") -> "FaultPlan":
        """A seeded random scenario: same seed → same faults, same steps,
        same victims — a failing randomized chaos run reproduces exactly."""
        rng = random.Random(seed)
        faults: List[Fault] = []
        for kind in kinds:
            victim = rng.randrange(nproc)
            at = rng.randrange(1, max(max_step, 2))
            if kind == "fail_io":
                faults.append(Fault(
                    kind="fail_io", site=rng.choice(IO_SITES), rank=victim,
                    times=rng.randint(1, 3)))
            elif kind == "kill":
                faults.append(Fault(
                    kind="kill", step=at, rank=victim,
                    signal=rng.choice(("SIGKILL", "SIGTERM"))))
            elif kind == "slow":
                faults.append(Fault(kind="slow", step=at, rank=victim,
                                    duration_s=0.2,
                                    span_steps=rng.randint(1, 3)))
            elif kind in ("hang", "wedge"):
                faults.append(Fault(kind=kind, step=at, rank=victim))
            elif kind == "corrupt_ckpt":
                faults.append(Fault(kind="corrupt_ckpt", step=at,
                                    rank=victim, path=ckpt_dir))
        return cls(faults, rank=rank, seed=seed)

    # -- firing ------------------------------------------------------------
    def _record(self, fault: Fault, **extra) -> None:
        counter_add("chaos.faults_injected_total", 1.0,
                    labels={"kind": fault.kind})
        record_event("chaos_fault", fault_kind=fault.kind, rank=self.rank,
                     **{k: v for k, v in dataclasses.asdict(fault).items()
                        if k in ("step", "site", "signal", "mode")}, **extra)

    def on_step(self, step: int) -> None:
        for i, f in enumerate(self.faults):
            if f.kind not in STEP_KINDS or self._fired[i]:
                continue
            if f.rank not in (-1, self.rank) or f.epoch != self.epoch:
                continue
            if f.kind == "slow":
                # fires once per step across its span, then retires
                if f.step <= step < f.step + f.span_steps:
                    last = self._slow_until.get(i, -1)
                    if step > last:
                        self._slow_until[i] = step
                        self._record(f, at_step=step)
                        time.sleep(f.duration_s)
                    if step == f.step + f.span_steps - 1:
                        self._fired[i] = True
                continue
            if step < f.step:
                continue
            self._fired[i] = True
            self._record(f, at_step=step)
            if f.kind == "kill":
                # record first (the flight ring is in-memory and dies with
                # the process — the counter at least reaches any textfile);
                # SIGKILL is the hard-preemption model, SIGTERM exercises
                # the graceful path end to end
                os.kill(os.getpid(), getattr(_signal, f.signal))
                if f.signal == "SIGKILL":      # pragma: no cover - we died
                    time.sleep(60)
            elif f.kind in ("hang", "wedge"):
                time.sleep(f.duration_s)
            elif f.kind == "corrupt_ckpt":
                corrupt_checkpoint(f.path, mode=f.mode, age_s=f.age_s)

    def on_io(self, site: str) -> None:
        for i, f in enumerate(self.faults):
            if f.kind != "fail_io" or f.site != site:
                continue
            if (f.rank not in (-1, self.rank) or f.epoch != self.epoch
                    or self._io_remaining[i] <= 0):
                continue
            self._io_remaining[i] -= 1
            self._record(f, remaining=self._io_remaining[i])
            raise InjectedFault(
                f"chaos: injected {site} failure "
                f"({f.times - self._io_remaining[i]}/{f.times})")


# ---------------------------------------------------------------------------
# checkpoint corruption (shared with tests): damage what's on disk the way
# a real partial write / bitrot would
# ---------------------------------------------------------------------------

def _newest_step_dir(ckpt_dir: str) -> Optional[str]:
    steps = [d for d in (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir)
                         else []) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=int))


def corrupt_checkpoint(ckpt_dir: str, *, mode: str = "truncate",
                       age_s: float = 0.0) -> List[str]:
    """Damage the newest finalized step of a ``CheckpointManager``
    directory (``<ckpt_dir>/<step>/``): ``mode`` "truncate" empties its
    files, "garbage" overwrites them; ``mode="tmp_litter"`` instead plants
    a torn write under the manager's tmp name (``<step>.tmp-<pid>-<n>``),
    aged ``age_s`` seconds, for ``gc_stale_tmp`` to reclaim. Returns the
    touched paths."""
    touched: List[str] = []
    if mode == "tmp_litter":
        target = os.path.join(ckpt_dir, "9999.tmp-0-0")
        os.makedirs(target, exist_ok=True)
        junk = os.path.join(target, "junk")
        with open(junk, "w") as fh:
            fh.write("torn write\n")
        if age_s > 0:
            # age the whole tree: the GC's liveness signal is the NEWEST
            # mtime anywhere under the tmp dir (a live save streams into
            # nested files), so a genuinely stale leftover is old
            # throughout
            old = time.time() - age_s
            os.utime(junk, (old, old))
            os.utime(target, (old, old))
        return [target]
    step_dir = _newest_step_dir(ckpt_dir)
    if step_dir is None:
        return touched
    for dirpath, _dirs, files in os.walk(step_dir):
        for fn in files:
            p = os.path.join(dirpath, fn)
            touched.append(p)
            if mode == "truncate":
                open(p, "wb").close()
            elif mode == "garbage":
                with open(p, "wb") as fh:
                    fh.write(b"\xde\xad\xbe\xef" * 16)
            else:
                raise ValueError(f"unknown corrupt mode {mode!r}")
    return touched


# ---------------------------------------------------------------------------
# process-global installation + the hook points
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process's active scenario (replacing any)."""
    global _active
    _active = plan
    return plan


def uninstall() -> None:
    global _active
    _active = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def install_from_env(environ=os.environ) -> Optional[FaultPlan]:
    """Install the plan a parent handed down via :data:`PLAN_ENV` (rank
    from :data:`RANK_ENV`, membership epoch from :data:`EPOCH_ENV`,
    defaults 0). No-op without the env var — safe to call unconditionally
    from worker entry points."""
    text = environ.get(PLAN_ENV)
    if not text:
        return None
    rank = int(environ.get(RANK_ENV, "0"))
    epoch = int(environ.get(EPOCH_ENV, "0"))
    return install(FaultPlan.from_json(text, rank=rank, epoch=epoch))


def step_hook(step: int) -> None:
    """Hook point: ``BaseTrainer.fit`` and ``DecodeEngine.run`` call this
    once per loop iteration. One global ``None`` check when chaos is off."""
    if _active is not None:
        _active.on_step(step)


def io_hook(site: str) -> None:
    """Hook point: guarded distributed-I/O sites call this inside their
    retry wrappers. One global ``None`` check when chaos is off."""
    if _active is not None:
        _active.on_io(site)
