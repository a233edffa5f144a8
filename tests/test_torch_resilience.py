"""The port's training resilience against the JAX package's, on the CPU.

* ``utils/retry.py``: ``backoff_delays`` equals the JAX schedule for one
  seed; ``retry`` sleeps the same schedule, absorbs transient errors and
  counts them, raises ``RetryBudgetExceeded`` when the budget runs out and
  lets a non-transient error through at once.
* ``CheckpointManager(async_save=True)``: a save blocks only for a host
  snapshot, which later in-place updates do not reach; the checkpoint
  loads bit for bit equal to a synchronous save's; a save issued during a
  write waits for it; a failed write is raised at the next ``save``,
  ``wait_until_finished`` or ``close``; an injected ``fail_io`` is absorbed
  and counted, an exhausted budget raises.
* The signal latches in ``fit``: SIGTERM and SIGUSR1 (real signals) stop
  and save at the same steps as the JAX trainer's ``fit`` on the same
  schedule, a NaN at the SIGTERM boundary included; a second SIGTERM
  changes nothing; ``fit`` drains on exit, by return or by raise.
* ``TrainConfig``'s new fields round-trip through the JAX ``TrainConfig``;
  ``log_artifacts`` is refused.
* ``train_dalle`` in a subprocess: SIGTERM after its first step exits 0
  with a finalized checkpoint at the step it reached, and ``--resume``
  continues from that step.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.train.base_trainer import BaseTrainer as JBaseTrainer
from dalle_tpu.train.metrics import ThroughputMeter as JThroughputMeter
from dalle_tpu.utils import retry as jretry
from dalle_tpu_torch import chaos, obs
from dalle_tpu_torch.config import DVAEConfig, PrecisionConfig, TrainConfig
from dalle_tpu_torch.train import checkpoints as ck
from dalle_tpu_torch.train.base_trainer import BaseTrainer
from dalle_tpu_torch.utils import retry as tretry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SLEEP = {"attempts": 4, "base_delay_s": 0.05, "max_delay_s": 1.0, "sleep": lambda s: None}


@pytest.fixture
def handlers():
    """Put back the process's SIGTERM and SIGUSR1 handlers after a test."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.fixture
def traced():
    obs.configure()
    try:
        yield
    finally:
        obs.disable()
        chaos.uninstall()


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(attempts=5, seed=0), dict(attempts=7, seed=3, jitter=0.2),
                                dict(attempts=4, seed=11, base_delay_s=0.5, max_delay_s=0.7),
                                dict(attempts=1, seed=1)])
def test_backoff_schedule_equals_jax(kw):
    assert tretry.backoff_delays(**kw) == jretry.backoff_delays(**kw)


def test_retry_absorbs_counts_and_exhausts_as_jax_does(traced):
    def flaky(fails):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise TimeoutError("blip")
            return len(calls)
        return fn

    for fails in (0, 2, 9):
        slept = {"t": [], "j": []}
        outs = {}
        for side, mod in (("t", tretry), ("j", jretry)):
            kw = dict(attempts=4, seed=5, sleep=slept[side].append)
            try:
                outs[side] = mod.with_retry("op", flaky(fails), retry_kw=kw)
            except mod.RetryBudgetExceeded as exc:
                assert isinstance(exc.__cause__, TimeoutError) and exc.attempts == 4
                outs[side] = "exhausted"
        assert outs["t"] == outs["j"] and slept["t"] == slept["j"]
    snap = obs.metrics_snapshot()
    assert snap['retry.attempts_total{op="op"}'] == 2 + 4
    assert snap['retry.recovered_total{op="op"}'] == 1
    assert snap['retry.exhausted_total{op="op"}'] == 1
    def corrupt():
        raise ValueError("corrupt")
    with pytest.raises(ValueError):          # not transient: no second try
        tretry.with_retry("op", corrupt, retry_kw=NO_SLEEP)
    assert obs.metrics_snapshot()['retry.attempts_total{op="op"}'] == 6


# ---------------------------------------------------------------------------
# asynchronous checkpoints
# ---------------------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(64, 32, generator=g)
    return {"model": {"w": w, "tied": w, "b": torch.randn(32, generator=g)},
            "optimizer": {"count": 3, "m": [torch.randn(5, generator=g), torch.zeros(2)]},
            "step": seed, "generator": g.get_state()}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_async_save_equals_sync_save_and_snapshots_the_state(tmp_path):
    live = _state(1)
    want = ck._Snapshot().take(live)
    sync = ck.CheckpointManager(str(tmp_path / "sync"))
    sync.save(5, live, {"m": 1})
    mgr = ck.CheckpointManager(str(tmp_path / "async"), async_save=True)
    mgr.save(5, live, {"m": 1})
    assert mgr.latest_step() == 5            # in flight, counted
    live["model"]["w"].add_(1.0)             # the next step's in-place update
    live["optimizer"]["m"][0].zero_()
    mgr.wait_until_finished()
    assert mgr.in_flight_step is None and mgr.all_steps() == [5]
    got, meta = mgr.restore(map_location="cpu")
    ref, ref_meta = sync.restore(map_location="cpu")
    assert meta == ref_meta == {"m": 1}
    assert _same(got, ref) and _same(got, want)
    assert got["model"]["tied"] is got["model"]["w"]       # a view stays a view
    with pytest.raises(FileExistsError):
        mgr.save(5, live)
    mgr.close()


def test_a_save_during_a_write_waits_for_it(tmp_path, monkeypatch):
    release, started = threading.Event(), threading.Event()
    real = torch.save

    def slow_save(obj, f, *a, **k):
        if obj.get("step") == 1:
            started.set()
            assert release.wait(10)
        return real(obj, f, *a, **k)
    monkeypatch.setattr(ck.torch, "save", slow_save)
    mgr = ck.CheckpointManager(str(tmp_path), async_save=True, keep_n=1)
    mgr.save(1, _state(1))
    assert started.wait(10)
    done = threading.Event()
    second = threading.Thread(target=lambda: (mgr.save(2, _state(2)), done.set()))
    second.start()
    assert not done.wait(0.3)                # blocked behind step 1's write
    assert mgr.all_steps() == []
    release.set()
    second.join(10)
    assert done.is_set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]            # 1 finalized first, then rotated away


def test_a_failed_write_is_raised_later_not_lost(tmp_path, monkeypatch):
    def broken(self, step, state, metadata):
        raise ValueError(f"disk says no to {step}")
    mgr = ck.CheckpointManager(str(tmp_path), async_save=True)
    with monkeypatch.context() as m:
        m.setattr(ck.CheckpointManager, "_write", broken)
        mgr.save(1, _state(1))
        with pytest.raises(ValueError, match="no to 1"):
            mgr.wait_until_finished()
        mgr.save(2, _state(2))
        with pytest.raises(ValueError, match="no to 2"):
            mgr.save(3, _state(3))           # the next save raises the last one's
        assert mgr.in_flight_step is None    # ... before it starts its own
        mgr.save(3, _state(3))
        with pytest.raises(ValueError, match="no to 3"):
            mgr.close()
    assert mgr.all_steps() == [] and not os.listdir(tmp_path)


@pytest.mark.parametrize("async_save", [True, False])
def test_injected_io_faults_are_absorbed_and_counted(tmp_path, traced, async_save):
    chaos.install(chaos.FaultPlan([chaos.Fault("fail_io", site="ckpt_save", times=2),
                                   chaos.Fault("fail_io", site="ckpt_restore", times=1)]))
    mgr = ck.CheckpointManager(str(tmp_path / "a"), async_save=async_save)
    mgr.retry_kw = NO_SLEEP
    mgr.save(1, _state(1), {"k": 1})
    got, meta = mgr.restore(map_location="cpu")
    assert _same(got, _state(1)) and meta == {"k": 1}
    snap = obs.metrics_snapshot()
    assert snap['retry.attempts_total{op="ckpt_save"}'] == 2
    assert snap['retry.recovered_total{op="ckpt_save"}'] == 1
    assert snap['retry.attempts_total{op="ckpt_restore"}'] == 1
    chaos.install(chaos.FaultPlan([chaos.Fault("fail_io", site="ckpt_save", times=10)]))
    with pytest.raises(tretry.RetryBudgetExceeded) as exc:
        mgr.save(2, _state(2))               # an async write raises at the drain
        mgr.wait_until_finished()
    assert isinstance(exc.value.__cause__, chaos.InjectedFault)
    assert obs.metrics_snapshot()['retry.exhausted_total{op="ckpt_save"}'] == 1
    assert mgr.all_steps() == [1]


# ---------------------------------------------------------------------------
# the signal latches in fit, against the JAX trainer's
# ---------------------------------------------------------------------------

class _Ckpt:
    def __init__(self):
        self.saves, self.drains = [], 0

    def preflight(self, *a, **k):
        pass

    def save(self, step, state, meta=None):
        self.saves.append(step)

    def latest_step(self):
        return self.saves[-1] if self.saves else None

    def wait_until_finished(self):
        self.drains += 1


class JFake(JBaseTrainer):
    """The JAX shell's fit with no device work: the losses come from a table."""
    model_class = "Fake"

    def __init__(self, tc, losses):
        self.train_cfg, self.model_cfg, self.losses = tc, JDVAEConfig(), losses
        self.ckpt = _Ckpt()
        self.meter = JThroughputMeter(tc.batch_size, tc.log_every)
        self.extra_meta, self.state, self._host_step = {}, None, 0
        self._obs_dispatch_t0 = self._obs_window_t0 = None
        self._obs_last_wait = self._obs_wait_accum = 0.0
        self.rollbacks = []

    def train_step(self, x):
        return self._finish_step({"loss": np.float32(self.losses.get(self._host_step + 1, 0.5))})

    def _snapshot_good(self):
        pass

    def _rollback(self):
        self._pending_metrics = self._deferred_metrics = None
        self.rollbacks.append(self._host_step)


class TFake(BaseTrainer):
    """The port's shell with a two-weight model: the losses from a table."""
    model_class = "Fake"

    def __init__(self, tc, losses):
        super().__init__(tc, device="cpu")
        self.model_cfg, self.losses = DVAEConfig(), losses
        self.model = torch.nn.Linear(2, 1)
        self._setup_training(lambda m, x: (m(x).sum(), {}))
        self.rollbacks = []

    def train_step(self, x):
        self.step += 1
        return self._finish_step({"loss": torch.tensor(self.losses.get(self.step, 0.5))})

    def _rollback(self):
        self.rollbacks.append(self.step)
        return super()._rollback()


SCHEDULES = {  # batch index → signals sent while fit pulls that batch; NaN steps
    "sigterm": ({3: ["SIGTERM"]}, {}),
    "sigusr1_then_sigterm": ({1: ["SIGUSR1"], 5: ["SIGTERM", "SIGTERM"]}, {}),
    "nan_at_the_sigterm_boundary": ({3: ["SIGTERM"]}, {4: float("nan")}),
    "sigusr1_only": ({2: ["SIGUSR1"]}, {}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_signals_stop_fit_where_jax_stops(tmp_path, handlers, name):
    sends, losses = SCHEDULES[name]
    out = {}
    for side in ("j", "t"):
        kw = dict(batch_size=2, log_every=100, save_every_steps=100, preflight_checkpoint=False,
                  device_prefetch=0)
        if side == "j":
            tr = JFake(JTrainConfig(checkpoint_dir=str(tmp_path / side), **kw), losses)
        else:
            tr = TFake(TrainConfig(checkpoint_dir=str(tmp_path / side),
                                   precision=PrecisionConfig(compute="float32"), **kw), losses)
        tr.install_signal_checkpoint(log=lambda *a: None)
        tr.install_preemption_handler(log=lambda *a: None)
        consumed = []

        def batches():
            for i in range(10):
                for sig in sends.get(i, []):
                    os.kill(os.getpid(), getattr(signal, sig))
                consumed.append(i)
                yield (np.zeros((2, 2), np.float32),)

        tr.fit(batches(), steps=10, log=lambda *a: None)
        step = tr._host_step if side == "j" else tr.step
        if side == "j" and tr.ckpt.latest_step() != step:
            tr.ckpt.save(step, None)         # the JAX scripts' final save, in the port's fit
        saves = tr.ckpt.saves if side == "j" else tr.ckpt.all_steps()
        out[side] = (tr.preempted, step, consumed, saves, tr.rollbacks)
    assert out["t"] == out["j"], out
    if "sigterm" in name:
        assert out["t"][0] is True


def test_fit_drains_on_return_and_on_raise(tmp_path):
    tc = TrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), save_every_steps=1,
                     preflight_checkpoint=False, device_prefetch=0,
                     precision=PrecisionConfig(compute="float32"))
    tr = TFake(tc, {})
    assert tr.ckpt.async_save
    tr.fit(iter([(np.zeros((2, 2), np.float32),)] * 3), log=lambda *a: None)
    assert tr.ckpt.in_flight_step is None and tr.ckpt.all_steps() == [1, 2, 3]

    def failing():
        yield (np.zeros((2, 2), np.float32),)
        raise KeyError("the loader broke")
    with pytest.raises(KeyError):
        tr.fit(failing(), log=lambda *a: None)
    assert tr.ckpt.in_flight_step is None and tr.ckpt.all_steps() == [1, 2, 3, 4]


def test_train_config_fields_round_trip_with_jax(tmp_path):
    kw = dict(epochs=3, resume=True, async_checkpointing=False, log_artifacts=False,
              checkpoint_dir=str(tmp_path))
    ours, theirs = TrainConfig.from_dict(kw).to_dict(), JTrainConfig.from_dict(kw).to_dict()
    assert ours == {k: theirs[k] for k in ours}
    assert {"epochs", "resume", "async_checkpointing", "log_artifacts"} <= set(ours)
    assert TrainConfig.from_dict(theirs) == TrainConfig.from_dict(kw)
    d = TrainConfig().to_dict()
    assert (d["epochs"], d["resume"], d["async_checkpointing"], d["log_artifacts"]) == (
        20, False, True, False)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        TFake(TrainConfig(log_artifacts=True), {})


# ---------------------------------------------------------------------------
# the entry point in a subprocess
# ---------------------------------------------------------------------------

def test_train_dalle_exits_zero_on_sigterm_and_resumes(tmp_path, handlers, capsys):
    out = str(tmp_path / "ck")
    argv = [sys.executable, "-m", "dalle_tpu_torch.cli.train_dalle", "--synthetic",
            "--untrained_vae", "--untrained_vae_tokens", "48", "--image_size", "16",
            "--dim", "16", "--depth", "1", "--heads", "2", "--dim_head", "8",
            "--text_seq_len", "8", "--batch_size", "2", "--output_dir", out,
            "--device", "cpu", "--device_prefetch", "0", "--no_preflight"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv + ["--steps", "100000"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    metrics = os.path.join(out, "metrics.jsonl")
    deadline = time.time() + 120
    while not (os.path.exists(metrics) and os.path.getsize(metrics) > 0):
        assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    text, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, text
    mgr = ck.CheckpointManager(out)
    step = mgr.latest_step()
    assert step is not None and step >= 1 and f"preempted at step {step}" in text, text
    assert not [n for n in os.listdir(out) if ".tmp-" in n]
    # the resume in this process: its imports are paid already
    from dalle_tpu_torch.cli import train_dalle
    capsys.readouterr()
    assert train_dalle.main(argv[3:] + ["--steps", str(step + 2), "--resume"]) == 0
    text = capsys.readouterr().out
    assert f"resumed at step {step}" in text and f"done at step {step + 2}" in text
    assert mgr.latest_step() == step + 2
