"""The port's dVAE training ≡ the JAX package's, on the CPU at a tiny size
(32 px, 2 layers, 64 codes): the gumbel-softmax and the KL term, the
training forward's loss, reconstruction and gradients, the temperature's
anneal, ``VAETrainer`` steps against optax; the trainers' shell (NaN
rollback, the two counters, the checkpoint format before the shell); and
``cli.train_vae`` → ``cli.train_dalle --vae_path``.

Flax draws the gumbel noise inside the module, so the reference of the
gumbel path is composed from the JAX package's own pieces (``encode_logits``,
``ops.quantize.gumbel_softmax`` on a known key, the codebook product, the
decoder) and the port is fed that key's ``jax.random.gumbel`` draw.
Tolerances, with their reasons at the asserts: f32 values 1e-5 (summation
order only), gradients 1e-5 plus 1e-4 relative.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import AnnealConfig as JAnnealConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.ops import quantize as jq
from dalle_tpu.train import train_state as jts
from dalle_tpu.train.trainer_vae import anneal_temperature as janneal
from dalle_tpu_torch import (AnnealConfig, DiscreteVAE, DVAEConfig, OptimConfig,
                             PrecisionConfig, TrainConfig, VAETrainer, dvae_state_dict)
from dalle_tpu_torch import obs
from dalle_tpu_torch.cli import train_dalle, train_vae
from dalle_tpu_torch.config import SNAPSHOT_MODES
from dalle_tpu_torch.ops.quantize import gumbel_softmax, kl_to_uniform
from dalle_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager
from dalle_tpu_torch.train.trainer_vae import anneal_temperature

VAE = dict(image_size=32, num_layers=2, num_tokens=64, codebook_dim=16, hidden_dim=16)
GRID = (8, 8)          # 32 px / 2**2
F32 = PrecisionConfig(compute="float32")


_SHAPES = {}


def _random_params(cfg, seed):
    """numpy weights on the flax tree's shapes (traced once per config, no
    flax init to compile): kernels N(0, 1/fan-in), the codebook N(0, 1),
    biases N(0, 0.1²)."""
    model = JDiscreteVAE(cfg)
    # the loss options leave the tree as it is: one trace for every config here
    if not _SHAPES:
        key = jax.random.PRNGKey(0)
        _SHAPES["vae"] = jax.eval_shape(lambda: model.init(
            {"params": key, "gumbel": key}, jnp.zeros((1, 32, 32, 3)), return_loss=True))
    shapes = _SHAPES["vae"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return x * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        return x if name == "embedding" else x * np.float32(0.1)
    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _images(b=3, seed=0):
    return np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32)


def _port(cfg_kw, jp):
    tv = DiscreteVAE(DVAEConfig(**cfg_kw))
    tv.load_state_dict(dvae_state_dict(jp))
    return tv


def _jax_loss(model, straight_through):
    """The gumbel path of ``DiscreteVAE.__call__`` composed from the JAX
    package's pieces, its draw from ``PRNGKey(seed)``; the draw itself is
    returned beside the reconstruction, for the port."""
    c = model.cfg

    def loss(params, img, seed, temp):
        key = jax.random.PRNGKey(seed)
        logits = model.apply(params, img, method=JDiscreteVAE.encode_logits)
        one_hot = jq.gumbel_softmax(key, logits, tau=temp, hard=straight_through)
        sampled = jnp.einsum("bhwn,nd->bhwd", one_hot,
                             params["params"]["codebook"]["embedding"])
        out = model.apply(params, sampled, method=lambda m, z: m.decoder(z))
        diff = model.apply(params, img, method=JDiscreteVAE.norm) - out
        if c.smooth_l1_loss:
            a = jnp.abs(diff)
            recon = jnp.mean(jnp.where(a < 1.0, 0.5 * diff ** 2, a - 0.5))
        else:
            recon = jnp.mean(diff ** 2)
        b, h, w, n = logits.shape
        kl = jq.kl_to_uniform(logits.reshape(b, h * w, n))
        return recon + kl * c.kl_div_loss_weight, (out, jax.random.gumbel(key, logits.shape))
    return loss


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

LOGITS = np.random.RandomState(1).randn(4, 5, 64).astype(np.float32) * 2
WEIGHTS = np.random.RandomState(2).randn(4, 5, 64).astype(np.float32)
KL_LOGITS = np.random.RandomState(4).randn(3, 16, 64).astype(np.float32) * 3


@pytest.fixture(scope="module")
def quantize_jax():
    """In one jitted call: JAX's soft and hard samples of LOGITS under key
    3 and the gradients of their WEIGHTS-weighted sums, that key's draw, and
    ``kl_to_uniform(KL_LOGITS)``."""
    @jax.jit
    def ref(x, kl_logits):
        key = jax.random.PRNGKey(3)
        out = {}
        for hard in (False, True):
            def f(x):
                y = jq.gumbel_softmax(key, x, tau=0.7, hard=hard)
                return jnp.sum(y * WEIGHTS), y
            (_, y), g = jax.value_and_grad(f, has_aux=True)(x)
            out[hard] = (y, g)
        return out, jax.random.gumbel(key, x.shape), jq.kl_to_uniform(kl_logits)
    samples, noise, kl = jax.tree_util.tree_map(np.asarray, ref(LOGITS, KL_LOGITS))
    return samples, torch.tensor(noise), float(kl)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_gumbel_softmax_matches_jax(quantize_jax, hard):
    """Forward within 1e-6 (f32, exp and sum order); the straight-through
    gradient is the soft one, and both are JAX's within 1e-6."""
    ref, noise, _ = quantize_jax
    want, jgrad = ref[hard]

    def port(hard):
        x = torch.from_numpy(LOGITS).requires_grad_()
        y = gumbel_softmax(x, 0.7, hard=hard, noise=noise)
        (g,) = torch.autograd.grad((y * torch.from_numpy(WEIGHTS)).sum(), x)
        return y.detach().numpy(), g.numpy()
    got, grad = port(hard)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if hard:
        assert set(np.unique(got)) <= {0.0, 1.0} and np.all(got.sum(-1) == 1)
        np.testing.assert_array_equal(grad, port(False)[1])
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=1e-6)
    bf = gumbel_softmax(torch.from_numpy(LOGITS).bfloat16(), 0.7, hard=hard, noise=noise)
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        gumbel_softmax(torch.from_numpy(LOGITS), 0.7, noise=noise[:2])


def test_kl_to_uniform_matches_jax(quantize_jax):
    want = quantize_jax[2]
    got = kl_to_uniform(torch.from_numpy(KL_LOGITS)).item()
    assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-5)   # f32 sum order


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

HARD_CFGS = {smooth_l1: dict(VAE, smooth_l1_loss=smooth_l1, kl_div_loss_weight=0.3)
             for smooth_l1 in (False, True)}


@pytest.fixture(scope="module")
def hard_recons_jax():
    """Per loss: the JAX params, and ``__call__(…, hard_recons=True,
    return_loss=True, return_recons=True)`` on ``_images(seed=6)``, both
    losses in one jitted call."""
    models = {k: _random_params(JDVAEConfig(**cfg), 5) for k, cfg in HARD_CFGS.items()}
    img = _images(seed=6)
    ref = jax.jit(lambda ps: {k: models[k][0].apply(ps[k], img, hard_recons=True,
                                                    return_loss=True, return_recons=True)
                              for k in models})({k: m[1] for k, m in models.items()})
    return {k: (models[k][1], ref[k]) for k in models}, img


@pytest.mark.parametrize("smooth_l1", [False, True], ids=["mse", "smooth_l1"])
def test_hard_recons_loss_matches_jax(hard_recons_jax, smooth_l1):
    """``hard_recons`` draws nothing: loss and reconstruction against
    ``__call__(…, hard_recons=True)`` within 1e-5 (f32 sum order)."""
    refs, img = hard_recons_jax
    jp, (want_loss, want_out) = refs[smooth_l1]
    tv = _port(HARD_CFGS[smooth_l1], jp)
    loss, out = tv(torch.from_numpy(img), hard_recons=True, return_loss=True,
                   return_recons=True)
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    assert math.isclose(loss.item(), float(want_loss), rel_tol=1e-5, abs_tol=1e-5)
    recons = tv(torch.from_numpy(img), hard_recons=True)
    assert torch.equal(recons, out)
    # the health taps (ported since): the same reconstruction, then the taps
    recons, taps = tv(torch.from_numpy(img), hard_recons=True, return_health=True)
    assert torch.equal(recons, out)
    assert taps["health/st_sharpness"].item() == 1.0       # the argmax's one-hot
    assert {"health/codebook_perplexity", "health/gumbel_temp",
            "health/encoder_confidence"} <= set(taps)


GUMBEL = dict(VAE, kl_div_loss_weight=0.5)


@pytest.fixture(scope="module")
def gumbel_ref():
    """The composed JAX loss and its gradient, jitted once for the module."""
    jv = JDiscreteVAE(JDVAEConfig(**GUMBEL))
    return jv, jax.jit(jax.value_and_grad(_jax_loss(jv, False), has_aux=True))


def test_gumbel_path_loss_and_gradients_match_jax(gumbel_ref):
    """The loss within 1e-5 and every parameter's gradient within 1e-5 + 1e-4
    relative of ``jax.grad`` (f32: summation order in the convolutions'
    backward)."""
    _, grad_fn = gumbel_ref
    _, jp = _random_params(JDVAEConfig(**GUMBEL), 7)
    img = _images(seed=8)
    (want, (_, noise)), jgrads = grad_fn(jp, img, 9, 0.8)
    tv = _port(GUMBEL, jp)
    loss = tv(torch.from_numpy(img), temp=0.8, return_loss=True,
              noise=torch.tensor(np.asarray(noise)))
    loss.backward()
    assert math.isclose(loss.item(), float(want), rel_tol=1e-5, abs_tol=1e-5)
    want_grads = dvae_state_dict(jgrads)
    for name, p in tv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_anneal_matches_jax_and_reanneal_survives_restore(tmp_path):
    kw = dict(starting_temp=1.0, temp_min=0.5, anneal_rate=0.01)
    for step in (0, 1, 17, 69, 70, 500):
        assert anneal_temperature(AnnealConfig(**kw), step) == janneal(JAnnealConfig(**kw), step)
    tc = TrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), precision=F32)
    tr = VAETrainer(DVAEConfig(**VAE), tc, AnnealConfig(**kw), device="cpu")
    tr.step = 100
    assert tr.reanneal_gumbel(80) == 1.0                 # the anneal restarts at 80
    assert tr._temp_at(100) == anneal_temperature(AnnealConfig(**kw), 20)
    tr.save()
    again = VAETrainer(DVAEConfig(**VAE), tc, AnnealConfig(**kw), device="cpu")
    meta = again.restore()
    assert meta["anneal_step0"] == 80 and again.step == 100
    assert again._temp_at(100) == tr._temp_at(100)


def test_vae_trainer_steps_match_optax(gumbel_ref):
    """Two steps with the draws injected against optax Adam under the
    exponential schedule (the JAX package's ``make_optimizer``) on the
    composed JAX loss, the temperature annealed between them: parameters
    within 2e-5 + 1e-4 relative (f32 gradients' summation order)."""
    jv, grad_fn = gumbel_ref
    optim = dict(learning_rate=1e-3, lr_scheduler="exponential", lr_decay_rate=0.5,
                 lr_transition_steps=1, grad_clip_norm=0.5)
    anneal = dict(starting_temp=1.0, temp_min=0.5, anneal_rate=0.2)
    _, jp = _random_params(JDVAEConfig(**GUMBEL), 10)
    tx = jts.make_optimizer(JOptimConfig(**optim))
    opt_state = jax.jit(tx.init)(jp)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state
    tr = VAETrainer(DVAEConfig(**GUMBEL), TrainConfig(batch_size=3, precision=F32,
                                                   optim=OptimConfig(**optim)),
                    AnnealConfig(**anneal), device="cpu")
    with torch.no_grad():
        tr.model.load_state_dict(dvae_state_dict(jp))
    for step in range(2):
        img = _images(seed=20 + step)
        temp = janneal(JAnnealConfig(**anneal), step)
        (want, (_, noise)), grads = grad_fn(jp, img, 30 + step, temp)
        jp, opt_state = update(grads, opt_state, jp)
        m = tr.train_step(img, torch.tensor(np.asarray(noise)))
        assert m["step"] == step + 1 and m["temperature"] == temp
        assert math.isclose(m["loss"], float(want), rel_tol=1e-5, abs_tol=1e-5)
        ref = dvae_state_dict(jp)
        for name, p in tr.model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=f"step {step} {name}")


def test_reconstruct_and_codebook_histogram():
    tr = VAETrainer(DVAEConfig(**VAE), TrainConfig(batch_size=2, precision=F32), device="cpu")
    img = _images(2, seed=11)
    rec = tr.reconstruct(img)
    assert rec.shape == (2, 32, 32, 3) and torch.isfinite(rec).all()
    assert torch.equal(rec, tr.reconstruct(img))
    assert torch.equal(tr.reconstruct(img, hard=False), tr.reconstruct(img, hard=False))
    hist = tr.codebook_histogram(img)
    ids = tr.model.get_codebook_indices(torch.from_numpy(img)).numpy()
    assert hist.shape == (64,) and hist.sum() == 2 * 64
    np.testing.assert_array_equal(hist, np.bincount(ids.ravel(), minlength=64))


# ---------------------------------------------------------------------------
# the trainers' shell: NaN rollback, the two counters, the old format
# ---------------------------------------------------------------------------

def _trainer(tmp_path=None, **kw):
    tc = TrainConfig(batch_size=2, precision=F32, save_every_steps=1, log_every=1,
                     checkpoint_dir=str(tmp_path) if tmp_path else None,
                     optim=OptimConfig(learning_rate=1e-2), **kw)
    return VAETrainer(DVAEConfig(**VAE), tc, device="cpu")


def _batch(i, nan=False):
    img = _images(2, seed=40 + i)
    if nan:
        img[0, 3, 5, 1] = np.nan
    return img, torch.from_numpy(np.random.RandomState(50 + i).gumbel(
        size=(2, *GRID, 64)).astype(np.float32))


def _tree_equal(live, saved, path):
    if isinstance(live, torch.Tensor):
        assert torch.equal(live, saved), path
    elif isinstance(live, dict):
        assert live.keys() == saved.keys(), path
        for k in live:
            _tree_equal(live[k], saved[k], f"{path}.{k}")
    elif isinstance(live, list):
        assert len(live) == len(saved), path
        for i, (a, b) in enumerate(zip(live, saved)):
            _tree_equal(a, b, f"{path}[{i}]")
    else:
        assert live == saved, path


def _state_equal(tr, saved):
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    # the optimizer's whole state: Adam's moments and the count
    _tree_equal(tr.optimizer.state_dict(), saved["optimizer"], "optimizer")


def test_nan_step_rolls_back_bit_for_bit_and_the_step_advances(tmp_path):
    # device_prefetch=0: the stream checks the state between its batches,
    # which a prefetcher would pull ahead of the steps
    tr = _trainer(tmp_path, device_prefetch=0)
    lines, seen = [], {}

    def batches():
        yield _batch(0)
        yield _batch(1, nan=True)
        # the NaN step is over: its rollback is what the third step starts from
        saved = CheckpointManager(str(tmp_path)).restore(step=1)[0]
        _state_equal(tr, saved)
        seen.update(step=tr.step, count=tr.optimizer.count)
        yield _batch(2)
    m = tr.fit(batches(), log=lines.append)
    assert seen == {"step": 2, "count": 1}
    assert tr.step == 3 and tr.optimizer.count == 2 and m["step"] == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 1, 3]
    assert [ln.split()[0:2] for ln in lines if "loss=" in ln] == [["[step", "1]"],
                                                                   ["[step", "3]"]]
    assert any(ln.startswith("[step 2] non-finite loss") for ln in lines)
    assert tr.last_snapshot["mode"] == "host" and tr.last_snapshot["bytes"] > 0
    # the third step, taken again from step 1's checkpoint, gives the same bits
    replay = _trainer(tmp_path)
    replay.restore(step=1)
    replay.step = 2          # the NaN step counts: the temperature is read at step 2
    replay.train_step(*_batch(2))
    _state_equal(tr, replay.state_dict())


def test_all_nan_stream_ends_at_steps_with_the_first_state():
    tr = _trainer()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    nan = _batch(0, nan=True)
    tr.fit(iter(lambda: nan, None), steps=3, log=lambda *a: None)
    assert tr.step == 3 and tr.optimizer.count == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_without_rollback_the_nans_stay():
    tr = _trainer(nan_rollback=False)
    tr.fit([_batch(0, nan=True)], log=lambda *a: None)
    assert tr.step == 1 and tr.optimizer.count == 1 and tr._good is None
    assert torch.isnan(tr.model.codebook.weight).all()


def test_checkpoint_without_a_step_restores_its_count(tmp_path):
    """The format before the shell: no ``step``, the step is the count; and
    the optimizer a ``torch.optim.Adam`` state dict with the count beside it
    (the format before the port's own optimizer)."""
    tr = _trainer()
    tr.fit([_batch(0), _batch(1)], log=lambda *a: None)
    params = list(tr.model.parameters())
    legacy = torch.optim.Adam(params)
    for p, mu, nu in zip(params, tr.optimizer.core.mu, tr.optimizer.core.nu):
        legacy.state[p] = {"step": torch.tensor(2.0), "exp_avg": mu.clone(),
                           "exp_avg_sq": nu.clone()}
    state = {"model": tr.model.state_dict(), "optimizer": legacy.state_dict(), "count": 2,
             "generator": tr.generator.get_state()}
    CheckpointManager(str(tmp_path)).save(2, state, tr._meta())
    again = _trainer(tmp_path)
    again.restore()
    assert again.step == again.optimizer.count == 2
    _state_equal(again, tr.state_dict())


def test_snapshot_mode_policy():
    """On the CPU every mode keeps the snapshot in host memory; a mode that
    is none of them is refused when the config is built."""
    for mode in SNAPSHOT_MODES:
        assert _trainer(rollback_snapshot=mode)._snapshot_mode(1 << 40) == "host"
    with pytest.raises(ValueError, match="rollback_snapshot"):
        TrainConfig(rollback_snapshot="disk")


# ---------------------------------------------------------------------------
# the entry point, and its checkpoint read by train_dalle --vae_path
# ---------------------------------------------------------------------------

def test_train_vae_then_train_dalle_on_its_checkpoint(tmp_path):
    vae_dir, dalle_dir = str(tmp_path / "vae"), str(tmp_path / "dalle")
    samples = tmp_path / "samples"
    assert train_vae.main(["--synthetic", "--image_size", "32", "--num_layers", "2",
                           "--num_tokens", "64", "--codebook_dim", "16", "--hidden_dim",
                           "16", "--batch_size", "2", "--steps", "2", "--output_dir",
                           vae_dir, "--sample_every_steps", "2", "--sample_dir",
                           str(samples), "--rollback_snapshot", "host", "--device",
                           "cpu"]) == 0
    mgr = CheckpointManager(vae_dir)
    assert mgr.all_steps() == [0, 2] and sorted(os.listdir(samples)) == ["step2_recon.png"]
    meta = mgr.load_metadata()
    assert meta["model_class"] == "DiscreteVAE" and meta["hparams"]["num_tokens"] == 64
    assert meta["train"]["optim"]["lr_scheduler"] == "exponential"
    assert meta["train"]["rollback_snapshot"] == "host"
    assert train_dalle.main(["--synthetic", "--vae_path", vae_dir, "--image_size", "32",
                             "--dim", "32", "--depth", "1", "--heads", "2", "--dim_head",
                             "16", "--text_seq_len", "8", "--batch_size", "2", "--steps",
                             "1", "--output_dir", dalle_dir, "--rollback_snapshot", "device",
                             "--device", "cpu"]) == 0
    dmeta = CheckpointManager(dalle_dir).load_metadata()
    assert dmeta["vae_hparams"] == meta["hparams"] and dmeta["hparams"]["image_vocab_size"] == 64
    assert dmeta["train"]["rollback_snapshot"] == "device"
    sidecar = torch.load(os.path.join(dalle_dir, "vae", "0", STATE_FILE), weights_only=True)
    trained = mgr.restore()[0]["model"]
    assert sidecar["model"].keys() == trained.keys()
    for k, v in trained.items():
        assert torch.equal(sidecar["model"][k], v), k


VAE_UNPORTED = [["--image_folder", "x"], ["--wandb"], ["--health"],
                ["--breach_actions"], ["--trace"], ["--prometheus_path", "p"]]
# ported since these cases were written: the health and telemetry flags run,
# each leaving its file or its columns (a relative path under the test's
# directory), and --image_folder trains on a folder of images the test writes
VAE_TELEMETRY = {"--health": "metrics.jsonl", "--breach_actions": "metrics.jsonl",
                 "--trace": os.path.join("obs", "spans.jsonl"), "--prometheus_path": "p"}


@pytest.mark.parametrize("flags", VAE_UNPORTED, ids=lambda f: f[0])
def test_train_vae_unported_flags_raise(tmp_path, flags):
    argv = ["--synthetic", "--device", "cpu", "--output_dir", str(tmp_path)]
    tiny = ["--image_size", "16", "--num_layers", "2", "--num_tokens", "32",
            "--codebook_dim", "16", "--hidden_dim", "8", "--batch_size", "2",
            "--steps", "2"]
    if flags[0] == "--image_folder":
        from dalle_tpu_torch.data.image_codec import encode_bmp, write_png
        folder = tmp_path / "data"
        folder.mkdir()
        rng = np.random.RandomState(0)
        for i in range(3):
            img = rng.randint(0, 256, (20, 17 + i, 3)).astype(np.uint8)
            if i % 2:
                (folder / f"shape_{i}.bmp").write_bytes(encode_bmp(img))
            else:
                write_png(str(folder / f"shape_{i}.png"), img)
        assert train_vae.main(argv[1:] + tiny + [flags[0], str(folder)]) == 0
        assert CheckpointManager(str(tmp_path)).latest_step() == 2
        return
    if flags[0] in VAE_TELEMETRY:
        flags = [flags[0]] + [str(tmp_path / f) if f == "p" else f for f in flags[1:]]
        try:
            assert train_vae.main(argv + tiny + flags) == 0
        finally:
            obs.disable()
            obs.disable_recorder()
        assert os.path.isfile(tmp_path / VAE_TELEMETRY[flags[0]])
        if flags[0] == "--health":
            with open(tmp_path / "metrics.jsonl") as f:
                rec = json.loads(f.readline())
            assert "health/codebook_perplexity" in rec and "health/grad_norm/encoder" in rec
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        train_vae.main(argv + flags)
