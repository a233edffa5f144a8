"""The rest of the training loop ≡ the JAX package's, on the CPU.

* ``DalleTrainer.train_step`` with Adafactor (weight decay, the plateau
  schedule) and with Adam under gradient accumulation, three steps against the
  JAX ``DalleTrainer`` (f32; ``tests/test_torch_train.py``'s ``STEP_CASES``
  tolerances), then each JAX run continued in the port from its optax state
  (Adafactor's statistics, the accumulator mid-group, the plateau's state).
  The model is wide enough for Adafactor to factor (dim 128, 2 heads of 64,
  one layer, which keeps the JAX compile short): ``to_qkv`` and the
  feed-forward weights factor, ``to_out`` is square, the embeddings and the
  head do not factor.
* ``train_steps`` ≡ k ``train_step`` calls bit for bit, for the three
  trainers (CFG nulls and dropout masks drawn from the generator; the dVAE
  with its temperature stream and injected noise).
* ``fit`` with scanned groups and a ragged tail, the metrics cadence, the
  deferred read, and NaN rollback with a save inside a group.
* The device prefetcher's order, exhaustion and errors.
* Dropout: p = 0 draws nothing; injected masks give the JAX forward and
  gradients (its ``nn.Dropout`` patched here to read the same masks);
  remat on and off give the same gradients; prefill and decode ignore it.
* The entry points' flags.
"""

import math

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import MeshConfig as JMeshConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.config import PrecisionConfig as JPrecisionConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.parallel.mesh import build_mesh
from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
from dalle_tpu_torch.cli import train_clip, train_dalle, train_vae
from dalle_tpu_torch.config import (AnnealConfig, ClipConfig, DalleConfig, DVAEConfig, OptimConfig,
                                    PrecisionConfig, TrainConfig)
from dalle_tpu_torch.convert import (dalle_state_dict, flax_to_state_dict,
                                     optimizer_state_from_optax)
from dalle_tpu_torch.data.device_prefetch import DevicePrefetcher
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.train.checkpoints import CheckpointManager
from dalle_tpu_torch.train.trainer_clip import CLIPTrainer
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer
from dalle_tpu_torch.train.trainer_vae import VAETrainer

WIDE = dict(num_text_tokens=60, text_seq_len=6, dim=128, depth=1, heads=2, dim_head=64,
            image_size=16, image_vocab_size=48, image_fmap_size=4)
SMALL = dict(WIDE, dim=32, depth=2, heads=2, dim_head=16)
F32 = PrecisionConfig(compute="float32")


def _batch(seed, b=2, cfg=WIDE):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg["num_text_tokens"], (b, cfg["text_seq_len"]))
    text[:, -2:] = 0
    img = rng.randint(0, cfg["image_vocab_size"], (b, cfg["image_fmap_size"] ** 2))
    return text.astype(np.int32), img.astype(np.int32)


def _jax_trainer(tmp_path, optim):
    tc = JTrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                      mesh=JMeshConfig(), precision=JPrecisionConfig(compute="float32"),
                      optim=JOptimConfig(**optim), device_prefetch=0)
    return JDalleTrainer(JDalleConfig(**WIDE), tc,
                         mesh=build_mesh(JMeshConfig(), devices=jax.devices()[:1]))


def _port_trainer(optim, **kw):
    tc = TrainConfig(batch_size=2, optim=OptimConfig(**optim), precision=F32, **kw)
    return DalleTrainer(DalleConfig(**WIDE), tc, device="cpu")


def _params(jtr):
    return flax_to_state_dict(jax.device_get(jtr.state.params))


# (optim config, parameter atol, parameter rtol): test_torch_train.py's f32 step
# tolerances (summation order in one step's gradient, carried through updates)
STEP_CASES = {
    # patience 0: every step that improves on the best halves the scale
    "adafactor_decay_plateau": (dict(optimizer="adafactor", learning_rate=1e-3,
                                     weight_decay=0.1, grad_clip_norm=0.5,
                                     lr_scheduler="plateau", plateau_patience=0,
                                     plateau_cooldown=0), 2e-5, 1e-4),
    "adam_accumulate_2": (dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5,
                               grad_accum_steps=2), 2e-5, 1e-4),
}


def _assert_params(tr, jtr, atol, rtol, what):
    want = _params(jtr)
    for name, p in tr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax_trainer_and_resume_its_state(case, tmp_path):
    optim, p_atol, p_rtol = STEP_CASES[case]
    jtr = _jax_trainer(tmp_path, optim)
    tr = _port_trainer(optim)
    tr.load_jax_state(jax.device_get(jtr.state.params))
    for step in range(3):
        text, img = _batch(10 + step)
        ref, got = jtr.train_step(text, img), tr.train_step(text, img)
        assert got["step"] == step + 1
        for key in ("loss", "loss_text", "loss_img", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")
        _assert_params(tr, jtr, p_atol, p_rtol, f"step {step}")
    params = jax.device_get(jtr.state.params)
    opt_state = jax.device_get(jtr.state.opt_state)
    if optim.get("lr_scheduler") == "plateau":
        want = optimizer_state_from_optax(opt_state, params, tr.names, optim["optimizer"])
        assert float(tr.optimizer.plateau.scale) == float(want["plateau"]["scale"]) < 1.0
    resumed = _port_trainer(optim)
    resumed.load_jax_state(params, opt_state)
    opt = resumed.optimizer
    assert resumed.step == 3 and (opt.count, opt.mini_step) == (
        (1, 1) if case == "adam_accumulate_2" else (3, 0))
    if case.startswith("adafactor"):
        # the square to_out (128 × 128): the port's v_row is flax's v_col,
        # and equals the port's own after the same steps (means of g², the
        # gradients' f32 summation order apart)
        sq = resumed.names.index("transformer.attn_0.to_out.weight")
        for k in ("v_row", "v_col"):
            np.testing.assert_allclose(getattr(opt.core, k)[sq].numpy(),
                                       getattr(tr.optimizer.core, k)[sq].numpy(), rtol=1e-3)
    for step in (3, 4):
        jtr.train_step(*_batch(10 + step))
        resumed.train_step(*_batch(10 + step))
        _assert_params(resumed, jtr, p_atol, p_rtol, f"resumed step {step}")


# ---------------------------------------------------------------------------
# train_steps ≡ train_step, bit for bit
# ---------------------------------------------------------------------------

def _same_state(a, b):
    for (name, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), name

    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        else:
            assert x == y, path
    walk(a.optimizer.state_dict(), b.optimizer.state_dict(), "optimizer")
    assert a.step == b.step


def test_dalle_train_steps_are_train_step_bit_for_bit():
    cfg = DalleConfig(**dict(WIDE, attn_dropout=0.1, ff_dropout=0.2))
    optim = OptimConfig(optimizer="adafactor", learning_rate=1e-2, grad_accum_steps=2,
                        lr_scheduler="plateau")
    pair = [DalleTrainer(cfg, TrainConfig(batch_size=2, optim=optim, precision=F32,
                                          runtime_lr_scale=True),
                         device="cpu", null_cond_prob=0.5) for _ in range(2)]
    for tr in pair:
        tr.set_lr_scale(0.5)
    batches = [_batch(30 + i) for i in range(3)]
    m = pair[0].train_steps(np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]))
    singles = [pair[1].train_step(*b) for b in batches]
    assert m["step"] == singles[-1]["step"] == 3
    assert m["loss"] == singles[-1]["loss"] and m["grad_norm"] == singles[-1]["grad_norm"]
    assert math.isclose(m["loss_mean"], np.mean([s["loss"] for s in singles]), rel_tol=1e-6)
    # accumulation: the first mini-step moved no master
    _same_state(*pair)


def _vae_pair():
    tc = TrainConfig(batch_size=2, precision=F32, optim=OptimConfig(learning_rate=1e-2))
    cfg = DVAEConfig(image_size=16, num_layers=2, num_tokens=32, codebook_dim=16,
                     hidden_dim=16)
    return [VAETrainer(cfg, tc, device="cpu") for _ in range(2)]


def test_vae_train_steps_are_train_step_bit_for_bit():
    """The temperature is read at each step, the gumbel draws come from the
    generator in order, or from the injected noise."""
    rng = np.random.RandomState(0)
    images = rng.rand(3, 2, 16, 16, 3).astype(np.float32)
    for noise in (None, torch.from_numpy(rng.gumbel(size=(3, 2, 4, 4, 32)).astype(np.float32))):
        a, b = _vae_pair()
        for tr in (a, b):
            tr.anneal_cfg = AnnealConfig(starting_temp=1.0, temp_min=0.1, anneal_rate=0.5)
        m = a.train_steps(images, noise)
        for i in range(3):
            last = b.train_step(images[i], None if noise is None else noise[i])
        assert m["temperature"] == last["temperature"] == math.exp(-1.0)
        assert m["loss"] == last["loss"]
        _same_state(a, b)


def test_clip_train_steps_are_train_step_bit_for_bit():
    cfg = ClipConfig(dim_text=32, dim_image=32, dim_latent=32, num_text_tokens=100,
                     text_enc_depth=1, text_seq_len=8, text_heads=2, visual_enc_depth=1,
                     visual_heads=2, visual_image_size=16, visual_patch_size=8)
    tc = TrainConfig(batch_size=2, precision=F32, optim=OptimConfig(learning_rate=1e-2))
    a, b = (CLIPTrainer(cfg, tc, device="cpu") for _ in range(2))
    rng = np.random.RandomState(1)
    texts = rng.randint(1, 100, (3, 2, 8))
    images = rng.rand(3, 2, 16, 16, 3).astype(np.float32)
    m = a.train_steps(texts, images)
    for i in range(3):
        last = b.train_step(texts[i], images[i])
    assert m["loss"] == last["loss"]
    _same_state(a, b)


# ---------------------------------------------------------------------------
# fit: scanned groups, the metrics cadence, deferred reads, late NaN
# ---------------------------------------------------------------------------

def _small(tmp_path=None, **kw):
    tc = TrainConfig(**{"batch_size": 2, "precision": F32, "log_every": 1,
                        "device_prefetch": 1, "optim": OptimConfig(learning_rate=1e-2),
                        "checkpoint_dir": str(tmp_path) if tmp_path else None, **kw})
    return DalleTrainer(DalleConfig(**SMALL), tc, device="cpu")


def _stream(n):
    for i in range(n):
        yield _batch(40 + i, cfg=SMALL)


def test_fit_scans_groups_and_drains_a_ragged_tail():
    lines = []
    scanned = _small(scan_steps=2)
    calls = []
    # the prefetched batches are stepped as placed (train_step(s) place, then
    # step through the same two methods)
    scanned._steps_placed = lambda b, f=scanned._steps_placed: calls.append(2) or f(b)
    scanned._step_placed = lambda b, f=scanned._step_placed: calls.append(1) or f(b)
    m = scanned.fit(_stream(5), log=lines.append)
    assert calls == [2, 2, 1] and scanned.step == 5 and m["step"] == 5
    single = _small(device_prefetch=0)
    single.fit(_stream(5), log=lambda *a: None)
    _same_state(scanned, single)
    # the loop logs once a group: steps 2, 4, then the drained 5th
    assert [ln.split("]")[0] for ln in lines] == ["[step 2", "[step 4", "[step 5"]
    ragged = list(_stream(3))
    ragged[1] = (ragged[1][0][:1], ragged[1][1][:1])
    with pytest.warns(UserWarning, match="mismatched shapes"):
        assert _small(scan_steps=2).fit(ragged, log=lambda *a: None)["step"] == 3


def test_metrics_every_and_defer_metrics():
    tr = _small(metrics_every=2)
    got = [tr.train_step(*b) for b in _stream(4)]
    assert [bool(m) for m in got] == [False, True, False, True]
    assert got[1]["step"] == 2 and "metrics_step" not in got[1]
    tr = _small(metrics_every=2, defer_metrics=True)
    got = [tr.train_step(*b) for b in _stream(6)]
    assert [bool(m) for m in got] == [False, False, False, True, False, True]
    assert (got[3]["step"], got[3]["metrics_step"]) == (4, 2)
    assert (got[5]["step"], got[5]["metrics_step"]) == (6, 4)
    # fit flushes the parked boundary and reads the last step at its end
    lines = []
    tr = _small(metrics_every=2, defer_metrics=True)
    m = tr.fit(_stream(5), log=lines.append)
    assert m["step"] == 5 and "metrics_step" not in m
    assert [ln.split("]")[0] for ln in lines] == ["[step 2", "[step 4"]


def test_late_nan_rolls_back_the_group_before_a_save(tmp_path):
    """metrics_every 4 hides the NaN of step 3 until the save at step 4 (in
    the group 3–4) reads it: the group rolls back to step 2's snapshot and
    nothing is written for it."""
    tr = _small(tmp_path, metrics_every=4, scan_steps=2, save_every_steps=2,
                device_prefetch=0)
    lines = []

    def poisoned():
        for i, b in enumerate(_stream(6)):
            if i == 2:
                with torch.no_grad():
                    tr.model.transformer.layer_ff_0.scale.fill_(float("nan"))
            yield b
    tr.fit(poisoned(), log=lines.append)
    assert tr.step == 6
    assert any(ln.startswith("[step 4] non-finite loss") for ln in lines)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 2, 6]
    saved = CheckpointManager(str(tmp_path)).restore(step=2)[0]
    assert saved["optimizer"]["count"] == 2
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


# ---------------------------------------------------------------------------
# the device prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_order_exhaustion_and_errors():
    seen = []

    def put(x):
        seen.append(x)
        if x == "bad":
            raise ValueError("put failed")
        return x * 2

    pf = DevicePrefetcher(iter([1, 2, 3]), put, depth=2)
    assert next(pf) == 2 and seen == [1, 2]          # two ahead after the first pull
    assert list(pf) == [4, 6]
    with pytest.raises(StopIteration):
        next(pf)

    def source():
        yield 1
        yield 2
        raise RuntimeError("source failed")
    pf = DevicePrefetcher(source(), lambda x: x, depth=4)
    assert next(pf) == 1 and next(pf) == 2           # the good batches first
    with pytest.raises(RuntimeError, match="source failed"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf = DevicePrefetcher(iter([1, "bad", 3]), put, depth=3)
    assert next(pf) == 2
    with pytest.raises(ValueError, match="put failed"):
        next(pf)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

# WIDE's shapes: the JAX init's eager ops are already compiled there
DROP = dict(WIDE, attn_dropout=0.25, ff_dropout=0.5, use_remat=False)


def _jax_pair(cfg):
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0))
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm


def test_injected_masks_give_the_jax_dropout_forward_and_gradients(monkeypatch):
    jm, jp, tm = _jax_pair(DROP)
    text, img = _batch(50, cfg=DROP)
    n = DROP["text_seq_len"] + DROP["image_fmap_size"] ** 2
    rng = np.random.RandomState(3)
    masks = {}
    for i in range(DROP["depth"]):
        masks[f"attn_{i}"] = rng.rand(2, n, DROP["dim"]) > DROP["attn_dropout"]
        masks[f"ff_{i}"] = rng.rand(2, n, 4 * DROP["dim"]) > DROP["ff_dropout"]

    def injected(self, inputs, deterministic=None, rng=None):
        if deterministic or self.rate == 0:
            return inputs
        keep = jnp.asarray(masks[self.parent.name])
        return jnp.where(keep, inputs / (1.0 - self.rate), 0)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", injected)

    def jloss(p):
        return jm.apply(p, jnp.asarray(text), jnp.asarray(img), return_loss=True,
                        deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})[0]
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    drop = [(torch.from_numpy(masks[f"attn_{i}"]), torch.from_numpy(masks[f"ff_{i}"]))
            for i in range(DROP["depth"])]
    text, img = torch.from_numpy(text).long(), torch.from_numpy(img).long()
    with torch.no_grad():
        plain = tm(text, img, True)[0].item()
    loss, _ = tm(text, img, True, dropout_masks=drop)
    loss.backward()
    assert abs(loss.item() - plain) > 1e-3           # the masks matter
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        # f32 gradients: summation order, 1e-5 plus a relative share
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _drop_loss(cfg, remat, seed=7, **kw):
    torch.manual_seed(0)
    tm = DALLE(DalleConfig(**dict(cfg, use_remat=remat)))
    tm.reset_parameters(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(seed)
    text, img = _batch(51, cfg=cfg)
    loss, _ = tm(torch.from_numpy(text).long(), torch.from_numpy(img).long(), True,
                 generator=gen, **kw)
    loss.backward()
    return loss, {n: p.grad for n, p in tm.named_parameters()}, gen


def test_dropout_masks_survive_remat_and_p0_draws_nothing():
    loss_r, grads_r, _ = _drop_loss(DROP, True, dropout=True)
    loss_n, grads_n, _ = _drop_loss(DROP, False, dropout=True)
    assert torch.equal(loss_r, loss_n)
    for name, g in grads_n.items():
        assert torch.equal(grads_r[name], g), name
    plain, _, _ = _drop_loss(DROP, False)
    assert not torch.equal(plain, loss_n)
    zero = dict(DROP, attn_dropout=0.0, ff_dropout=0.0)
    on, _, gen_on = _drop_loss(zero, False, dropout=True)
    off, _, gen_off = _drop_loss(zero, False)
    assert torch.equal(on, off) and torch.equal(gen_on.get_state(), gen_off.get_state())


def test_prefill_and_decode_ignore_dropout():
    drop, plain = (DALLE(DalleConfig(**dict(DROP, **kw))).train()
                   for kw in ({}, dict(attn_dropout=0.0, ff_dropout=0.0)))
    plain.load_state_dict(drop.state_dict())
    text = torch.from_numpy(_batch(52, cfg=DROP)[0]).long()
    outs = []
    for model in (drop, plain):
        g = torch.Generator().manual_seed(0)
        outs.append(model.generate_images_tokens(text, generator=g))
        assert torch.equal(model(text, outs[0]), plain(text, outs[0]))
    assert torch.equal(*outs)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_train_dalle_cli_with_the_loop_flags(tmp_path):
    ckpt = str(tmp_path / "ck")
    argv = ["--synthetic", "--untrained_vae", "--image_size", "16", "--untrained_vae_tokens",
            "48", "--dim", "32", "--depth", "1", "--heads", "2", "--dim_head", "16",
            "--text_seq_len", "8", "--batch_size", "2", "--output_dir", ckpt,
            "--device", "cpu", "--save_every_n_steps", "4", "--scan_steps", "2",
            "--ga_steps", "2", "--lr_scheduler", "plateau", "--device_prefetch", "2",
            "--defer_metrics", "--attn_dropout", "0.1", "--ff_dropout", "0.1"]
    assert train_dalle.main(argv + ["--steps", "4"]) == 0
    mgr = CheckpointManager(ckpt)
    state, meta = mgr.restore()
    assert mgr.all_steps() == [0, 4] and state["step"] == 4
    assert meta["train"]["scan_steps"] == 2 and meta["train"]["defer_metrics"]
    assert meta["hparams"]["attn_dropout"] == 0.1
    opt = state["optimizer"]
    assert (opt["count"], opt["mini_step"]) == (2, 0) and opt["plateau"] is not None
    assert train_dalle.main(argv + ["--steps", "6", "--resume"]) == 0
    assert mgr.restore()[0]["optimizer"]["count"] == 3


@pytest.mark.parametrize("entry", ["train_vae", "train_clip"])
def test_vae_and_clip_entry_points_scan_steps(tmp_path, entry):
    common = ["--synthetic", "--device", "cpu", "--output_dir", str(tmp_path),
              "--batch_size", "2", "--steps", "4", "--scan_steps", "2",
              "--device_prefetch", "1", "--defer_metrics"]
    if entry == "train_vae":
        assert train_vae.main(common + ["--image_size", "16", "--num_layers", "2",
                                        "--hidden_dim", "8", "--num_tokens", "16",
                                        "--codebook_dim", "8"]) == 0
    else:
        assert train_clip.main(common + ["--image_size", "16", "--patch_size", "8",
                                         "--dim", "16", "--depth", "1", "--heads", "2",
                                         "--text_seq_len", "8"]) == 0
    state, meta = CheckpointManager(str(tmp_path)).restore()
    assert state["step"] == 4 and meta["train"]["scan_steps"] == 2
