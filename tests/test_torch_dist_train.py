"""Training across processes ≡ one process, on the CPU.

One ``torch.multiprocessing.spawn`` of two gloo ranks (a ``file://`` store,
a 20 s timeout on every collective, a whole-run limit) trains, in turn, a
small DALL·E (dim 128, so Adafactor factors the projections and the
vocabulary tables and fsdp splits both of their factored axes):

* dp = 2: two Adam steps (clipped) on global batches of 4, each rank its 2
  rows;
* fsdp = 2: two Adafactor steps (the recipe's optimizer, clipped), each
  rank holding half of every master and moment, then a checkpoint written
  at world 2;
* sp = 2: two Adam steps with each rank holding its zigzag slice of the
  sequence, every layer's attention a ``GroupRing``;
* dp = 2 for the dVAE: two Adam steps with its gumbel draws taken for the
  global batch;
* dp = 2 through ``fit`` with device prefetch: each batch placed once, by
  the prefetcher, and stepped as ``train_step`` steps it.

A second spawn of four ranks trains dp = 2 × fsdp = 2 (Adam): each slice's
gradient reduce-scattered over its fsdp pair, then summed over the pair of
ranks that hold the same slice.

The parent holds each against the port's one-process trainer on the same
global batches (the gathered masters, the optimizer's state, the losses),
dp also against the JAX ``DalleTrainer`` on ``MeshConfig(dp=2)``, sp
against the ``LocalRing`` trainer, and restores the world-2 checkpoint at
world 1. f32 throughout: the ranks' sums differ from one process's only in
order. Tolerances: Adam's masters 2e-5 absolute + 1e-4 relative (the
port's own bound against the JAX trainer, tighter than the JAX dry run's
rtol 2e-4: Adam's normalised update turns an ulp of a near-zero gradient
into a few 1e-6 of its element); fsdp's Adafactor masters, the losses and
the optimizer moments 1e-6 + 1e-5.

This file imports no JAX at its top: the spawned children import it again.
"""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dalle_tpu_torch.config import (DalleConfig, DVAEConfig, MeshConfig, OptimConfig,
                                    PrecisionConfig, TrainConfig)
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer
from dalle_tpu_torch.train.trainer_vae import VAETrainer

WORLD, B, STEPS = 2, 4, 2
LIMIT_S = 120.0
CFG = dict(num_text_tokens=200, text_seq_len=8, dim=128, depth=1, heads=2, dim_head=64,
           image_size=16, image_vocab_size=64, image_fmap_size=4)
VAE = dict(image_size=16, num_layers=2, num_tokens=32, codebook_dim=16, hidden_dim=8,
           num_resnet_blocks=0)
ADAM = dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5)
ADAFACTOR = dict(optimizer="adafactor", learning_rate=1e-2, grad_clip_norm=0.5)
F32 = PrecisionConfig(compute="float32")
TIGHT = dict(atol=1e-6, rtol=1e-5)
MASTERS = dict(atol=2e-5, rtol=1e-4)


def _batch(step):
    rng = np.random.RandomState(100 + step)
    text = rng.randint(1, CFG["num_text_tokens"], (B, CFG["text_seq_len"]))
    text[:, -2:] = 0                                        # pads
    img = rng.randint(0, CFG["image_vocab_size"], (B, CFG["image_fmap_size"] ** 2))
    return text.astype(np.int64), img.astype(np.int64)


def _images(step):
    return (np.random.RandomState(200 + step)
            .rand(B, VAE["image_size"], VAE["image_size"], 3).astype(np.float32))


def _dalle(mesh, optim, params, **kw):
    tc = TrainConfig(**{"batch_size": B, "optim": OptimConfig(**optim), "mesh": mesh,
                        "precision": F32, "device_prefetch": 0, **kw})
    tr = DalleTrainer(DalleConfig(**CFG), tc, device="cpu")
    tr.load_jax_state(params)
    return tr


def _run(tr, batches):
    losses = [tr.train_step(*b)["loss"] for b in batches]
    state = tr.state_dict()          # collective under fsdp: the gathered state
    return losses, state


def _worker(rank, init_file, out_dir, params):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=20))
    try:
        batches = [_batch(s) for s in range(STEPS)]
        res = {"dp": _run(_dalle(MeshConfig(dp=2), ADAM, params), batches)}
        tr = _dalle(MeshConfig(fsdp=2), ADAFACTOR, params,
                    checkpoint_dir=f"{out_dir}/ckpt", preflight_checkpoint=False)
        res["fsdp_shapes"] = {n: tuple(p.shape) for n, p in tr.model.named_parameters()}
        res["fsdp"] = _run(tr, batches)
        tr.save()
        res["sp"] = _run(_dalle(MeshConfig(sp=2), ADAM, params), batches)
        vae = VAETrainer(DVAEConfig(**VAE), TrainConfig(batch_size=B, optim=OptimConfig(**ADAM),
                                                        precision=F32, device_prefetch=0),
                         device="cpu")
        res["vae"] = _run(vae, [(_images(s),) for s in range(STEPS)])
        tr = _dalle(MeshConfig(dp=2), ADAM, params, device_prefetch=2)
        tr.fit(iter(batches), steps=STEPS, log=lambda *a: None)
        res["dp_fit"] = tr.state_dict()
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _worker4(rank, init_file, out_dir, params):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=20))
    try:
        tr = _dalle(MeshConfig(dp=2, fsdp=2), ADAM, params)
        torch.save(_run(tr, [_batch(s) for s in range(STEPS)]), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(worker, nprocs, tmp, params):
    return mp.spawn(worker, args=(str(tmp / "store"), str(tmp), params), nprocs=nprocs,
                    join=False)


def _join(ctx, nprocs, tmp):
    deadline = time.monotonic() + LIMIT_S
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish within {LIMIT_S} s")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(nprocs)]


def _close(got, want, what, tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}.{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", tol)
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, msg=lambda m: f"{what}: {m}", **tol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=tol["rtol"], abs=tol["atol"]), what
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the JAX dp=2 trainer's masters after the steps, its losses, the
    initial flax params, the ranks' results, the run directory)."""
    import jax
    from dalle_tpu.config import DalleConfig as JDalleConfig
    from dalle_tpu.config import MeshConfig as JMeshConfig
    from dalle_tpu.config import OptimConfig as JOptimConfig
    from dalle_tpu.config import PrecisionConfig as JPrecisionConfig
    from dalle_tpu.config import TrainConfig as JTrainConfig
    from dalle_tpu.parallel import build_mesh
    from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
    from dalle_tpu_torch.convert import flax_to_state_dict

    tmp = tmp_path_factory.mktemp("dist")
    tc = JTrainConfig(batch_size=B, checkpoint_dir=str(tmp / "jax"), preflight_checkpoint=False,
                      mesh=JMeshConfig(dp=2), precision=JPrecisionConfig(compute="float32"),
                      optim=JOptimConfig(**ADAM), device_prefetch=0)
    jtr = JDalleTrainer(JDalleConfig(**CFG), tc,
                        mesh=build_mesh(JMeshConfig(dp=2), devices=jax.devices()[:2]))
    params = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
    ctx = _spawn(_worker, WORLD, tmp, params)
    # the JAX steps run while the ranks do
    jlosses = [float(jtr.train_step(*_batch(s))["loss"]) for s in range(STEPS)]
    jmasters = flax_to_state_dict(jax.device_get(jtr.state.params))
    return jmasters, jlosses, params, _join(ctx, WORLD, tmp), tmp


@pytest.fixture(scope="module")
def spawned4(spawned, tmp_path_factory):
    """The four ranks' (losses, gathered state) at dp = 2 × fsdp = 2."""
    tmp = tmp_path_factory.mktemp("dist4")
    return _join(_spawn(_worker4, 4, tmp, spawned[2]), 4, tmp)


def _one_process(mesh, optim, params):
    return _run(_dalle(mesh, optim, params), [_batch(s) for s in range(STEPS)])


def test_dp_matches_one_process_and_jax(spawned):
    jmasters, jlosses, params, ranks, _ = spawned
    losses, state = _one_process(MeshConfig(), ADAM, params)
    for r in ranks:
        got_losses, got = r["dp"]
        _close(got_losses, losses, "dp loss", TIGHT)
        _close(got["model"], state["model"], "dp masters", MASTERS)
        _close(got["optimizer"]["core"], state["optimizer"]["core"], "dp moments", TIGHT)
        _close(got_losses, jlosses, "dp loss vs JAX", MASTERS)
        for name, want in jmasters.items():
            _close(got["model"][name], want, f"dp vs JAX {name}", MASTERS)


def test_fsdp_adafactor_matches_one_process(spawned):
    _, _, params, ranks, _ = spawned
    losses, state = _one_process(MeshConfig(), ADAFACTOR, params)
    full = {n: tuple(v.shape) for n, v in state["model"].items()}
    halves = {n for n, s in ranks[0]["fsdp_shapes"].items() if s != full[n]}
    # every projection, both vocabulary tables and the head are split
    assert {"text_emb.weight", "image_emb.weight", "to_logits.weight"} <= halves
    assert sum(".weight" in n and "norm" not in n for n in halves) >= 7
    for r in ranks:
        got_losses, got = r["fsdp"]
        _close(got_losses, losses, "fsdp loss", TIGHT)
        _close(got["model"], state["model"], "fsdp masters", TIGHT)
        _close(got["optimizer"]["core"], state["optimizer"]["core"], "fsdp v_row/v_col/v",
               TIGHT)


def test_fsdp_checkpoint_restores_at_world_one(spawned):
    _, _, params, ranks, tmp = spawned
    tr = _dalle(MeshConfig(), ADAFACTOR, params, checkpoint_dir=str(tmp / "ckpt"))
    tr.restore()
    assert tr.step == STEPS
    _, state = ranks[0]["fsdp"]
    _close(tr.state_dict()["model"], state["model"], "restored masters", dict(atol=0, rtol=0))
    # and trains on from there as the one-process run would
    ref = _dalle(MeshConfig(), ADAFACTOR, params)
    for s in range(STEPS):
        ref.train_step(*_batch(s))
    _close(tr.train_step(*_batch(9))["loss"], ref.train_step(*_batch(9))["loss"],
           "loss after restore", TIGHT)


def test_sp_group_ring_matches_local_ring(spawned):
    _, _, params, ranks, _ = spawned
    losses, state = _one_process(MeshConfig(sp=2), ADAM, params)
    for r in ranks:
        got_losses, got = r["sp"]
        _close(got_losses, losses, "sp loss", TIGHT)
        _close(got["model"], state["model"], "sp masters", MASTERS)


def test_vae_dp_matches_one_process(spawned):
    _, _, _, ranks, _ = spawned
    vae = VAETrainer(DVAEConfig(**VAE), TrainConfig(batch_size=B, optim=OptimConfig(**ADAM),
                                                    precision=F32, device_prefetch=0), device="cpu")
    losses, state = _run(vae, [(_images(s),) for s in range(STEPS)])
    for r in ranks:
        got_losses, got = r["vae"]
        _close(got_losses, losses, "vae loss", TIGHT)
        _close(got["model"], state["model"], "vae masters", MASTERS)


def test_dp_fit_places_each_batch_once(spawned):
    """fit with device prefetch: the prefetcher places each global batch
    (this rank's rows) once and the step takes it as placed, so the masters
    are train_step's bit for bit."""
    for r in spawned[3]:
        _close(r["dp_fit"]["model"], r["dp"][1]["model"], "fit masters", dict(atol=0, rtol=0))


def test_dp_by_fsdp_matches_one_process(spawned, spawned4):
    losses, state = _one_process(MeshConfig(), ADAM, spawned[2])
    for got_losses, got in spawned4:
        _close(got_losses, losses, "dp×fsdp loss", TIGHT)
        _close(got["model"], state["model"], "dp×fsdp masters", MASTERS)
        _close(got["optimizer"]["core"], state["optimizer"]["core"], "dp×fsdp moments", TIGHT)


def test_one_process_refuses_dp_fsdp_tp():
    for mesh, match in ((MeshConfig(dp=2), "across processes"),
                        (MeshConfig(fsdp=2), "across processes"),
                        (MeshConfig(tp=2), "item 11c")):
        with pytest.raises(NotImplementedError, match=match):
            DalleTrainer(DalleConfig(**CFG), TrainConfig(batch_size=B, mesh=mesh), device="cpu")
