"""The training loop's telemetry in the port ≡ the JAX package's, on the CPU
(a traced ``fit`` against the JAX fit is in ``test_torch_health.py``, on its
trainers).

* The stall watchdog fires on a stall, names the open span, and re-arms
  after a beat; ``profile_step`` writes its ``torch.profiler`` trace
  directory for the step that holds it; ``MetricsLogger`` rows;
  ``DeviceTelemetry``'s keys against JAX's on the CPU.
* ``summarize_run`` of the port's files equals the JAX report on them, with
  the MODEL-HEALTH verdict of a health run; ``cli.obs_report`` prints it.
* The breach rung: an inf written into one group's gradient fires the
  NaN precursor, the preemptive snapshot, and the next NaN rolls back to it.
* The SIGUSR2 capture takes one bounded capture at a time and re-arms.

A host-only ``FakeTrainer`` (no model) drives the loop-level cases.
"""

import json
import os
import signal
import time
import types

import numpy as np
import pytest
import torch

from dalle_tpu import obs as jobs
from dalle_tpu.obs import DeviceTelemetry as JDeviceTelemetry
from dalle_tpu.obs.report import summarize_run as jsummarize_run
from dalle_tpu_torch import obs
from dalle_tpu_torch.cli import _common
from dalle_tpu_torch.cli import obs_report
from dalle_tpu_torch.config import (DalleConfig, DVAEConfig, ObsConfig, OptimConfig,
                                    PrecisionConfig, TrainConfig)
from dalle_tpu_torch.obs.report import summarize_run
from dalle_tpu_torch.train.actions import BreachActions
from dalle_tpu_torch.train.base_trainer import BaseTrainer
from dalle_tpu_torch.train.metrics import MetricsLogger
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer
from dalle_tpu_torch.train.trainer_vae import VAETrainer

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)


@pytest.fixture(autouse=True)
def _obs_off():
    """fit(obs.trace=True) turns the global tracer on, in each package."""
    yield
    obs.disable()
    obs.disable_recorder()
    jobs.disable()


class Writer:
    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append((step, dict(metrics)))


class FakeTrainer(BaseTrainer):
    """The fit shell over a fake step: no model, no device program."""

    model_class = "Fake"

    def __init__(self, tc, step_sleep=0.0):
        super().__init__(tc, device="cpu")
        self.model_cfg = DVAEConfig()
        self.step_sleep = step_sleep
        self.scan_calls = []

    def train_step(self, x):
        time.sleep(self.step_sleep)
        self.step += 1
        return self._finish_step({"loss": torch.tensor(0.25)})

    def train_steps(self, xs):
        self.scan_calls.append(len(xs))
        self.step += len(xs)
        return self._finish_step({"loss": torch.tensor(0.25)})

    def state_dict(self):
        return {"step": self.step}

    def _rollback_state(self):
        return {}

    def _load_rollback_state(self, good):
        pass


def _tc(tmp_path, **kw):
    kw.setdefault("preflight_checkpoint", False)
    kw.setdefault("batch_size", 4)
    kw.setdefault("log_every", 1)
    return TrainConfig(checkpoint_dir=str(tmp_path), **kw)


def _batches(n):
    return iter([(np.zeros((4, 8), np.float32),) for _ in range(n)])


def _dalle_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 60, (2, 6)).astype(np.int32),
             rng.randint(0, 48, (2, 16)).astype(np.int32)) for _ in range(n)]


def test_trace_needs_a_directory():
    tr = FakeTrainer(TrainConfig(obs=ObsConfig(trace=True)))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.fit(_batches(1), log=lambda *a: None)


# ---------------------------------------------------------------------------
# the watchdog, profile_step, the logger, the device gauges
# ---------------------------------------------------------------------------

def test_watchdog_fires_on_a_stall_and_rearms_after_a_beat():
    logs = []
    wd = obs.StallWatchdog(0.08, log=logs.append, dump_stacks=False, poll_s=0.02).start()
    try:
        time.sleep(0.3)
        assert wd.stall_count == 1          # one report per episode
        wd.beat(7)
        time.sleep(0.3)
        assert wd.stall_count == 2 and wd.last_report.step == 7
    finally:
        wd.stop()
    assert "STALL" in logs[0]
    with pytest.raises(ValueError):
        obs.StallWatchdog(0)


def test_fit_watchdog_names_the_open_dispatch_span(tmp_path):
    logs = []
    tr = FakeTrainer(_tc(tmp_path, obs=ObsConfig(trace=True, watchdog_deadline_s=0.08)),
                     step_sleep=0.4)
    tr.fit(_batches(2), log=logs.append)
    wd = tr.last_watchdog
    assert wd.stall_count >= 1
    assert any("fit/dispatch" in " > ".join(v) for v in wd.last_report.open_spans.values())
    assert any("STALL" in line for line in logs)
    quiet = FakeTrainer(_tc(tmp_path / "q", obs=ObsConfig(watchdog_deadline_s=30.0)))
    quiet.fit(_batches(3), log=lambda *a: None)
    assert quiet.last_watchdog.stall_count == 0


@pytest.mark.parametrize("profile_step,want", [(3, True), (100, False)])
def test_profile_step_writes_its_trace_for_the_step_that_holds_it(tmp_path, profile_step,
                                                                  want):
    """scan_steps 2: step 3 lies in the second group, which is profiled;
    nothing is profiled past the window."""
    tr = FakeTrainer(_tc(tmp_path, scan_steps=2, profile_step=profile_step))
    logs = []
    tr.fit(_batches(4), log=logs.append)
    assert tr.scan_calls == [2, 2] and tr.step == 4
    path = tmp_path / f"profile_step{profile_step}"
    assert path.is_dir() == want
    assert (path / "trace.json").is_file() == want
    assert sum(line.startswith("[profile]") for line in logs) == int(want)


def test_metrics_logger_rows(tmp_path):
    path = tmp_path / "m.jsonl"
    obs.configure()
    obs.counter_add("my.counter", 2.0)
    w = MetricsLogger(str(path))
    w.log(3, {"a": torch.tensor(1.5), "b": np.float32(2.5), "c": 4, "d": "x",
              "e": torch.ones(2), "f": True})
    w.close()
    (rec,) = [json.loads(line) for line in open(path)]
    assert rec["step"] == 3 and rec["a"] == 1.5 and rec["b"] == 2.5 and rec["c"] == 4
    assert rec["d"] == "x" and rec["f"] is True and "e" not in rec
    assert rec["my.counter"] == 2.0 and "time" in rec
    with pytest.raises(ImportError, match="wandb"):
        MetricsLogger(str(path), use_wandb=True)


def test_device_telemetry_keys_match_jax_on_the_cpu():
    jt, pt = JDeviceTelemetry(), obs.DeviceTelemetry("cpu")
    for step in (1, 5):
        assert set(pt.poll(step)) == set(jt.poll(step))
    stats = obs.device_memory_stats("cpu")
    assert stats["hbm_bytes_in_use"] > 0 and obs.device_memory_headroom("cpu") is None


# ---------------------------------------------------------------------------
# the report, and health through fit
# ---------------------------------------------------------------------------

def test_report_of_a_health_run_matches_jax_and_the_cli_prints_it(tmp_path, capsys):
    """The impossible collapse floor (1e6) trips codebook-collapse once:
    edge-triggered, though every later step is collapsed too."""
    cfg = DVAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
                     hidden_dim=8, num_resnet_blocks=0)
    tc = TrainConfig(batch_size=4, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                     log_every=1, save_every_steps=0,
                     precision=PrecisionConfig(compute="float32"),
                     obs=ObsConfig(trace=True, health=True, health_perplexity_floor=1e6,
                                   health_min_samples=2))
    tr = VAETrainer(cfg, tc, device="cpu")
    mpath = str(tmp_path / "obs" / "metrics.jsonl")
    os.makedirs(tmp_path / "obs")
    w = MetricsLogger(mpath)
    rng = np.random.RandomState(0)
    tr.fit(iter([(rng.rand(4, 16, 16, 3).astype(np.float32),) for _ in range(5)]), steps=5,
           metrics_writer=w, log=lambda *a: None)
    w.close()
    recs = [json.loads(line) for line in open(mpath)]
    assert sum(int(r.get("health/breach", 0)) for r in recs) == 1
    run = str(tmp_path / "obs")
    rep = summarize_run(run)
    assert rep == jsummarize_run(run)
    assert "MODEL-HEALTH: DEGRADED (codebook-collapse in codebook" in rep
    assert "== model health (graftpulse)" in rep and "fit/step" in rep
    assert obs_report.main([run, "--top", "5"]) == 0
    assert "MODEL-HEALTH" in capsys.readouterr().out
    assert obs_report.main([str(tmp_path / "missing")]) == 2


def test_breach_rung_snapshots_at_the_precursor_and_rolls_back_to_it(tmp_path):
    tc = TrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                     log_every=1, save_every_steps=0, runtime_lr_scale=True,
                     precision=PrecisionConfig(compute="float32"),
                     optim=OptimConfig(learning_rate=1e-3),
                     obs=ObsConfig(trace=True, health=True, health_min_samples=2))
    tr = DalleTrainer(DalleConfig(**TINY), tc, device="cpu")
    # the nan-precursor's action alone (the same inf also trips the
    # grad-explosion detector, whose action would roll back at once), once
    # an episode (the NaN then spreads to every group)
    actions = BreachActions(tr, policy={"nan-precursor": "preemptive_snapshot"},
                            cooldown_steps=10, log=lambda *a: None).attach()

    def poison(trainer):
        if trainer.step == 2:
            trainer.model.transformer.attn_0.to_out.weight.grad[0, 0] = float("inf")
    tr.grad_hook = poison
    logs = []
    tr.fit(iter(_dalle_batches(6, seed=3)), steps=5, log=logs.append)
    assert [a[1:] for a in actions.fired] == [("preemptive_snapshot", "nan-precursor",
                                               "transformer")]
    assert tr.last_preemptive["mode"] == "host" and tr.last_preemptive["bytes"] > 0
    # step 3 applied the inf (clipped to NaN): its state is poisoned too, so
    # step 4's NaN rolls back to the rung, step 5's to fit's start
    rolled = [line for line in logs if "rolled back" in line]
    assert [line.split("step ")[-1] for line in rolled] == ["3", "0"], logs
    names = {s[0] for s in obs.get_tracer().snapshot_spans()}
    assert {"ckpt/preemptive_snapshot", "ckpt/rollback"} <= names
    assert tr._preemptive is None               # the rung is one-shot


# ---------------------------------------------------------------------------
# SIGUSR2: one bounded capture at a time
# ---------------------------------------------------------------------------

class _FakeProfile:
    calls = {"start": 0, "stop": 0}

    def __init__(self, activities=None):
        pass

    def start(self):
        _FakeProfile.calls["start"] += 1

    def stop(self):
        _FakeProfile.calls["stop"] += 1

    def export_chrome_trace(self, path):
        open(path, "w").write("{}")


@pytest.mark.parametrize("rearm", [False, True], ids=["single", "rearm"])
def test_sigusr2_capture_is_bounded_and_one_at_a_time(monkeypatch, tmp_path, rearm):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.calls = {"start": 0, "stop": 0}
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        args = types.SimpleNamespace(profiler_dir=None, profiler_capture_s=0.1)
        assert _common.install_sigusr2_profiler(str(tmp_path), args, log=lambda *a: None)
        handler = signal.getsignal(signal.SIGUSR2)
        handler(signal.SIGUSR2, None)
        handler(signal.SIGUSR2, None)            # mid-capture: ignored
        assert _FakeProfile.calls["start"] == 1
        deadline = time.time() + 5.0
        while _FakeProfile.calls["stop"] == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert _FakeProfile.calls == {"start": 1, "stop": 1}
        (sub,) = os.listdir(tmp_path)
        assert sub.startswith("profile_") and os.path.isfile(tmp_path / sub / "trace.json")
        if rearm:
            handler(signal.SIGUSR2, None)        # a new capture after the stop
            assert _FakeProfile.calls["start"] == 2
            while _FakeProfile.calls["stop"] == 1 and time.time() < deadline:
                time.sleep(0.01)
            assert _FakeProfile.calls["stop"] == 2
    finally:
        signal.signal(signal.SIGUSR2, prev)
    off = types.SimpleNamespace(profiler_dir="off", profiler_capture_s=1.0)
    assert _common.install_sigusr2_profiler(str(tmp_path), off) is False
