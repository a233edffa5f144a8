"""The port's elastic runtime and degradation ladder against the JAX
package's, and one real recovery.

* The epoch file, heartbeats, ``hung_workers`` and the worker's beater, as
  ``tests/test_chaos.py`` holds the JAX ones; the agent's respawn, shrink,
  exit-77 rejoin, hang and crash-loop cases over stub children.
* ``DegradeMonitor`` against the JAX ``DegradeMonitor`` on the same
  heartbeat streams (``tests/test_degrade.py``'s lockstep fleet): the same
  actions, round by round; ``install_breach_pager`` chains a sentry's
  breach into the worker's heartbeat page.
* ``cli.chaos_smoke``'s ``kill_respawn`` over two real gloo processes
  training the small dVAE: SIGKILL worker 1 mid-step, the agent respawns
  the gang, and the recovered state is bit for bit the uninterrupted
  run's.
"""

import copy
import json
import os
import subprocess
import sys
import time

import pytest

from dalle_tpu.degrade import DegradeMonitor as JDegradeMonitor
from dalle_tpu.degrade import StragglerDetector as JStragglerDetector
from dalle_tpu_torch import chaos, obs
from dalle_tpu_torch.chaos import Fault, FaultPlan
from dalle_tpu_torch.degrade import (DegradeMonitor, StragglerDetector,
                                     install_breach_pager)
from dalle_tpu_torch.parallel import elastic


@pytest.fixture(autouse=True)
def _clean():
    obs.configure()
    yield
    chaos.uninstall()
    obs.disable()
    obs.disable_recorder()      # chaos_smoke's agent turns the flight recorder on


def test_epoch_file_roundtrip_and_process_ids(tmp_path):
    ef = elastic.EpochFile(str(tmp_path))
    assert ef.read() is None
    ep = ef.write(elastic.Epoch(epoch=3, members=[0, 2], port=12345))
    got = ef.read()
    assert got == ep
    assert got.nproc == 2 and got.coordinator_address == "127.0.0.1:12345"
    assert got.process_id(2) == 1 and got.process_id(1) is None


def test_heartbeat_write_read_stale_and_throttle(tmp_path):
    d = str(tmp_path)
    hb = elastic.Heartbeat(d, 0, interval_s=30.0)
    assert hb.beat(step=5, epoch=1)
    assert not hb.beat(step=6)                  # throttled
    assert hb.beat(step=6, force=True)
    beats = elastic.read_heartbeats(d)
    assert beats[0]["step"] == 6 and beats[0]["pid"] == os.getpid()
    now = time.time()
    assert elastic.stale_workers(d, [0, 1], 5.0, now=now) == [1]
    assert elastic.stale_workers(d, [0], 5.0, now=now + 60) == [0]


def test_hung_workers_progress_and_age_semantics(tmp_path):
    d = str(tmp_path)
    now = 1000.0

    def write(wid, t, step, step_time):
        with open(os.path.join(d, f"hb_{wid}.json"), "w") as fh:
            json.dump({"worker_id": wid, "pid": 1, "time": t, "step": step,
                       "step_time": step_time}, fh)

    write(0, now - 0.1, 7, now - 0.2)        # healthy
    write(1, now - 0.1, 5, now - 10.0)       # hung main thread behind a live beater
    write(2, now - 10.0, 3, now - 10.0)      # frozen process
    write(3, now - 0.1, None, None)          # still starting
    assert elastic.hung_workers(d, [0, 1, 2, 3, 4], 2.0, now=now) == [1, 2]
    assert 4 in elastic.stale_workers(d, [0, 4], 2.0, now=now)


def test_worker_beater_keeps_the_file_fresh_and_pages(tmp_path):
    ep = elastic.Epoch(epoch=0, members=[0], port=1)
    w = elastic.ElasticWorker(str(tmp_path), 0, ep, hb_interval_s=0.05)
    w.start()
    try:
        w.on_step(1)
        t = elastic.read_heartbeats(str(tmp_path))[0]["time"]
        time.sleep(0.3)
        doc = elastic.read_heartbeats(str(tmp_path))[0]
        assert doc["time"] > t and doc["step"] == 1
        w.page("nan-precursor:transformer")
        assert elastic.read_heartbeats(str(tmp_path))[0]["page"] == \
            "nan-precursor:transformer"
    finally:
        w.stop()


def test_heartbeat_faults_absorbed_and_outage_survived(tmp_path):
    chaos.install(FaultPlan([Fault(kind="fail_io", site="heartbeat", times=1)]))
    hb = elastic.Heartbeat(str(tmp_path), 1, interval_s=0.0)
    assert hb.beat(step=1, force=True)
    assert obs.metrics_snapshot()['retry.attempts_total{op="heartbeat"}'] == 1
    logs = []
    w = elastic.ElasticWorker(str(tmp_path), 0, elastic.Epoch(0, [0], 1), log=logs.append)
    chaos.install(FaultPlan([Fault(kind="fail_io", site="heartbeat", times=99)]))
    w.on_step(3)                                # must not raise
    assert any("heartbeat beat failed" in entry for entry in logs)


def test_python_worker_env_sets_path_and_card():
    env = elastic.python_worker_env(repo_root="/r", card=1, extra={"A": "b"})
    assert env["PYTHONPATH"] == "/r" and env["CUDA_VISIBLE_DEVICES"] == "1"
    assert env["A"] == "b" and "XLA_FLAGS" not in set(env) - set(os.environ)


CHILD = """
import json, os, sys, time
run_dir, wid, mode = sys.argv[1], sys.argv[2], sys.argv[3]
marker = os.path.join(run_dir, f"crashed_{wid}")
def beat():
    p = os.path.join(run_dir, f"hb_{wid}.json")
    json.dump({"worker_id": int(wid), "pid": os.getpid(), "time": time.time()},
              open(p + ".tmp", "w"))
    os.replace(p + ".tmp", p)
beat()
if mode == "crash_once" and wid == "1" and not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(1)
if mode == "crash_always" and wid == "1":
    sys.exit(1)
if mode == "reconfigure_once" and wid == "1" and not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(77)
if mode == "hang" and wid == "1" and not os.path.exists(marker):
    open(marker, "w").close()
    time.sleep(600)
for _ in range(3):
    beat(); time.sleep(0.05)
sys.exit(0)
"""


def _agent(tmp_path, mode, **kw):
    run_dir = str(tmp_path / "pod")
    os.makedirs(run_dir, exist_ok=True)
    script = tmp_path / "child.py"
    script.write_text(CHILD)

    def spawn(worker_id, epoch):
        return subprocess.Popen([sys.executable, str(script), run_dir, str(worker_id), mode])

    return elastic.ElasticAgent(run_dir, spawn, members=[0, 1], poll_s=0.05,
                                term_grace_s=2.0, log=lambda *a: None, **kw)


@pytest.mark.parametrize("mode,policy,members,lost", [
    ("crash_once", "respawn", [0, 1], "worker_lost"),
    ("crash_always", "shrink", [0], "worker_lost"),
    ("reconfigure_once", "shrink", [0, 1], "worker_lost"),   # 77 rejoins
    ("hang", "respawn", [0, 1], "worker_hung"),
])
def test_agent_recovers(tmp_path, mode, policy, members, lost):
    agent = _agent(tmp_path, mode, policy=policy, max_reconfigures=2,
                   hb_timeout_s=1.0 if mode == "hang" else 0.0)
    events = agent.run(deadline_s=60)
    assert any(e["kind"] == lost and e["worker"] == 1 for e in events)
    assert agent.epoch.members == members and agent.reconfigures == 1
    assert events[-1]["kind"] == "pod_done"


def test_agent_gives_up_on_a_crash_loop(tmp_path):
    agent = _agent(tmp_path, "crash_always", policy="respawn", max_reconfigures=2)
    with pytest.raises(RuntimeError, match="crash loop"):
        agent.run(deadline_s=60)


# -- the ladder against the JAX one ---------------------------------------------

def _beats(step, t, blocked, page=None):
    out = {w: {"step": step, "step_time": t, "blocked_s": b} for w, b in blocked.items()}
    if page:
        out[1]["page"] = page
    return out


def _rounds():
    """A lockstep fleet (tests/test_degrade.py's): a straggler that pages,
    escalates and drains; a recovery between the rungs; a health page."""
    out, t = [], 0.0
    for i in range(12):
        t += 1.0
        out.append(_beats(1 + i, t, {0: 0.9, 1: 0.02}))
    for i in range(8):
        t += 0.5
        out.append(_beats(13 + i, t, {0: 0.4, 1: 0.4}))
    t += 1.0
    out.append(_beats(21, t, {0: 0.1, 1: 0.1}, page="nan-precursor:transformer"))
    out.append(_beats(22, t + 1.0, {0: 0.1, 1: 0.1}, page="nan-precursor:transformer"))
    return out


@pytest.mark.parametrize("escalate,alpha", [(2, None), (4, 1.0)])
def test_ladder_matches_jax(escalate, alpha):
    kw = dict(factor=0.4, sustain=2, warmup_steps=2)
    if alpha is not None:
        kw["alpha"] = alpha
    mons = [DegradeMonitor(StragglerDetector(**kw), straggler_escalate=escalate),
            JDegradeMonitor(JStragglerDetector(**kw), straggler_escalate=escalate)]
    seen = []
    for i, beats in enumerate(_rounds()):
        if i == 14:
            for m in mons:
                m.reset()
        got, want = (m.observe(copy.deepcopy(beats), [0, 1]) for m in mons)
        assert [tuple(vars(a).values()) for a in got] == \
            [tuple(vars(a).values()) for a in want], f"round {i}"
        seen += [(a.kind, a.reason) for a in got]
    assert ("page", "straggler") in seen and ("drain", "health_page") in seen
    if escalate == 2:
        assert ("drain", "straggler") in seen


def test_breach_pager_chains_the_sentry(tmp_path):
    class Sentry:
        on_breach = None

    class Breach:
        detector, group = "nan-precursor", "transformer"

    fired = []
    sentry = Sentry()
    sentry.on_breach = fired.append
    w = elastic.ElasticWorker(str(tmp_path), 0, elastic.Epoch(0, [0], 1))
    install_breach_pager(w, sentry)
    sentry.on_breach(Breach())
    assert len(fired) == 1
    assert elastic.read_heartbeats(str(tmp_path))[0]["page"] == "nan-precursor:transformer"


# -- one real recovery ----------------------------------------------------------------

def test_chaos_smoke_kill_respawn_bitwise(tmp_path):
    """The acceptance scenario over two gloo processes (the small dVAE, 4
    steps, a save every 2, worker 1 SIGKILLed at step 3)."""
    from dalle_tpu_torch.cli import chaos_smoke
    rc = chaos_smoke.main(["--outdir", str(tmp_path), "--scenarios", "kill_respawn",
                           "--target_steps", "4", "--kill_step", "3", "--deadline_s", "60",
                           "--worker_args", "--device cpu"])
    with open(tmp_path / "summary.json") as fh:
        summary = json.load(fh)
    assert rc == 0, summary["failures"]
    assert summary["scenarios"] == {"reference2": True, "kill_respawn": True}
