"""The port's fault injection ≡ the JAX package's (CPU).

``FaultPlan`` JSON goes from either package to the other and back
unchanged; ``FaultPlan.sample(seed)`` gives the JAX package's faults for
the same seed; ``slow`` and ``hang`` faults sleep their (millisecond)
durations at their steps and are recorded; ``fail_io`` raises
``InjectedFault`` (an ``OSError``) its count of times and heals;
``install_from_env`` reads the same environment names; ``corrupt_checkpoint``
damages a directory the port's ``CheckpointManager`` wrote so that
``restore`` falls back, and its tmp litter is what ``gc_stale_tmp``
reclaims; ``BaseTrainer.fit`` calls the step hook before each dispatch.
"""

import json
import time

import numpy as np
import pytest
import torch

from dalle_tpu import chaos as jchaos
from dalle_tpu_torch import chaos as tchaos
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.config import DalleConfig, OptimConfig, PrecisionConfig, TrainConfig
from dalle_tpu_torch.train.checkpoints import CheckpointManager
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

KINDS = ("kill", "fail_io", "slow", "hang", "wedge", "corrupt_ckpt")


@pytest.fixture
def traced(tmp_path):
    tobs.disable()
    tobs.configure()
    tobs.configure_recorder(str(tmp_path / "rec"))
    yield
    tchaos.uninstall()
    tobs.disable()
    tobs.disable_recorder()


def _plan_doc(plan):
    return json.loads(plan.to_json())


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_sample_and_json_round_trip_match_jax(seed):
    kw = dict(nproc=3, max_step=9, kinds=KINDS, rank=1, ckpt_dir="/ck")
    jp = jchaos.FaultPlan.sample(seed, **kw)
    tp = tchaos.FaultPlan.sample(seed, **kw)
    assert _plan_doc(tp) == _plan_doc(jp)
    # across the packages and back
    assert tchaos.FaultPlan.from_json(jp.to_json(), rank=2).to_json() == jp.to_json()
    assert jchaos.FaultPlan.from_json(tp.to_json(), rank=2).to_json() == tp.to_json()
    assert tp.env() == jp.env() and list(tp.env()) == ["DALLE_CHAOS_PLAN"]


def test_fault_validation_matches_jax():
    for kw in (dict(kind="explode"), dict(kind="fail_io", site="disk"), dict(kind="slow")):
        with pytest.raises(ValueError):
            jchaos.Fault(**kw)
        with pytest.raises(ValueError):
            tchaos.Fault(**kw)


def test_slow_and_hang_fire_at_their_steps(traced):
    plan = tchaos.install(tchaos.FaultPlan([
        tchaos.Fault(kind="slow", step=2, duration_s=0.03, span_steps=2),
        tchaos.Fault(kind="hang", step=5, duration_s=0.05),
        tchaos.Fault(kind="slow", step=1, duration_s=1.0, rank=3)]))   # another rank's
    assert tchaos.active_plan() is plan
    took = []
    for step in range(8):
        t0 = time.perf_counter()
        tchaos.step_hook(step)
        took.append(time.perf_counter() - t0)
    assert took[2] >= 0.03 and took[3] >= 0.03 and took[5] >= 0.05
    assert max(took[i] for i in (0, 1, 4, 6, 7)) < 0.02
    ev = [e for e in tobs.get_recorder().snapshot_events() if e["kind"] == "chaos_fault"]
    assert [(e["fault_kind"], e["at_step"]) for e in ev] == [("slow", 2), ("slow", 3),
                                                             ("hang", 5)]
    snap = tobs.metrics_snapshot()
    assert snap['chaos.faults_injected_total{kind="slow"}'] == 2.0
    assert snap['chaos.faults_injected_total{kind="hang"}'] == 1.0
    tchaos.uninstall()
    t0 = time.perf_counter()
    tchaos.step_hook(2)
    assert tchaos.active_plan() is None and time.perf_counter() - t0 < 0.02


def test_fail_io_counts_then_heals(traced):
    tchaos.install(tchaos.FaultPlan([tchaos.Fault(kind="fail_io", site="ckpt_save",
                                                  times=2)]))
    for i in range(2):
        with pytest.raises(tchaos.InjectedFault, match=f"ckpt_save failure \\({i + 1}/2\\)"):
            tchaos.io_hook("ckpt_save")
    tchaos.io_hook("ckpt_save")                 # healed
    tchaos.io_hook("heartbeat")                 # another site never fails
    assert issubclass(tchaos.InjectedFault, OSError)
    ev = [e for e in tobs.get_recorder().snapshot_events() if e["kind"] == "chaos_fault"]
    assert [e["remaining"] for e in ev] == [1, 0] and ev[0]["site"] == "ckpt_save"


def test_install_from_env_reads_the_jax_names(traced):
    jplan = jchaos.FaultPlan([jchaos.Fault(kind="slow", step=1, rank=2, epoch=1,
                                           duration_s=0.001)], seed=5)
    env = {**jplan.env(), "DALLE_CHAOS_RANK": "2", "DALLE_CHAOS_EPOCH": "1"}
    assert (tchaos.PLAN_ENV, tchaos.RANK_ENV, tchaos.EPOCH_ENV) == (
        jchaos.PLAN_ENV, jchaos.RANK_ENV, jchaos.EPOCH_ENV)
    plan = tchaos.install_from_env(env)
    assert (plan.rank, plan.epoch, plan.seed) == (2, 1, 5)
    assert tchaos.active_plan() is plan
    tchaos.step_hook(1)
    assert [e["at_step"] for e in tobs.get_recorder().snapshot_events()] == [1]
    tchaos.uninstall()
    assert tchaos.install_from_env({}) is None and tchaos.active_plan() is None


def _manager_with_steps(path):
    mgr = CheckpointManager(str(path))
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((3,), float(step))}, {"step": step})
    return mgr


@pytest.mark.parametrize("mode", ["truncate", "garbage"])
def test_corrupt_checkpoint_forces_the_fallback(tmp_path, mode):
    mgr = _manager_with_steps(tmp_path / "ck")
    touched = tchaos.corrupt_checkpoint(str(tmp_path / "ck"), mode=mode)
    assert sorted(p.rsplit("/", 1)[1] for p in touched) == ["metadata.json", "state.pt"]
    assert all("/2/" in p for p in touched)
    state, meta = mgr.restore(log=lambda *a: None)
    assert meta["step"] == 1 and torch.equal(state["w"], torch.full((3,), 1.0))
    assert mgr.all_steps() == [1]                    # step 2 quarantined


def test_corrupt_checkpoint_tmp_litter_is_swept(tmp_path):
    mgr = _manager_with_steps(tmp_path / "ck")
    (target,) = tchaos.corrupt_checkpoint(str(tmp_path / "ck"), mode="tmp_litter",
                                          age_s=3600.0)
    assert mgr.all_steps() == [1, 2]
    assert mgr.gc_stale_tmp(log=lambda *a: None) == [target]
    assert tchaos.corrupt_checkpoint(str(tmp_path / "empty")) == []
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        tchaos.corrupt_checkpoint(str(tmp_path / "ck"), mode="shred")


def test_fit_calls_the_step_hook_before_each_dispatch(traced):
    cfg = DalleConfig(num_text_tokens=60, text_seq_len=6, dim=32, depth=1, heads=2,
                      dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
    tc = TrainConfig(batch_size=2, precision=PrecisionConfig(compute="float32"),
                     optim=OptimConfig(learning_rate=1e-2))
    trainer = DalleTrainer(cfg, tc, device="cpu")
    seen = []
    plan = tchaos.FaultPlan([tchaos.Fault(kind="slow", step=1, duration_s=0.001)])
    plan.on_step = lambda step: seen.append((step, trainer.step))
    tchaos.install(plan)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(1, 60, (2, 6)), rng.randint(0, 24, (2, 16))) for _ in range(3)]
    trainer.fit(iter(batches), log=lambda *a: None)
    assert seen == [(0, 0), (1, 1), (2, 2)] and trainer.step == 3
