"""The port's command-line flow ≡ the JAX package's, on the CPU at tiny sizes:
the dVAE encoder, the config dicts a checkpoint carries, the checkpoint
manager, the trainer's resume, priming from pixels, and the two entry
points (``python -m dalle_tpu_torch.cli.train_dalle`` / ``.generate``).

JAX parameters are drawn from numpy on the shapes ``jax.eval_shape`` gives
(no flax init to compile), converted to the port, and the JAX calls are
jitted once each. Generation is compared greedily: ``top_k_thres`` 0.999
keeps k = max(int(0.001·48), 1) = 1 image token, so neither framework's
draws matter and the tokens must be equal. Pixels agree within 1e-4 in
f32; the encoder's logits within 1e-5.
"""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.models.wrapper import DalleWithVae as JDalleWithVae
from dalle_tpu.models.wrapper import DiscreteVAEAdapter as JAdapter
from dalle_tpu_torch import (DALLE, DalleConfig, DalleTrainer, DalleWithVae, DiscreteVAE,
                             DiscreteVAEAdapter, DVAEConfig, OptimConfig, TrainConfig,
                             dalle_state_dict, dvae_state_dict)
from dalle_tpu_torch.cli import _common, generate, train_dalle
from dalle_tpu_torch.models.wrapper import dalle_config_for_vae
from dalle_tpu_torch.text.tokenizer import SimpleTokenizer
from dalle_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager

# the default tokenizer's vocabulary, so the CLI's vocab check passes
TINY = dict(num_text_tokens=49408, text_seq_len=8, dim=32, depth=1, heads=2, dim_head=16,
            image_size=16, image_vocab_size=48, image_fmap_size=4)
VAE = dict(image_size=16, num_tokens=48, codebook_dim=16, num_layers=2, hidden_dim=8)
GREEDY = 0.999
PROMPTS = ["a red circle", "blue square"]


def _random_params(model, args, seed, **kw):
    """numpy weights on the flax tree's shapes: kernels N(0, 1/fan-in),
    embeddings N(0, 0.5²), norm scales near 1, the rest N(0, 0.1²)."""
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: model.init(keys, *args, **kw))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        if name == "embedding":
            return x * np.float32(0.5)
        if name == "scale":
            return 1 + np.float32(0.1) * x
        return x * np.float32(0.1)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_models():
    jm = JDALLE(JDalleConfig(**TINY))
    jp = _random_params(jm, (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)), 0)
    jv = JDiscreteVAE(JDVAEConfig(**VAE))
    jvp = _random_params(jv, (jnp.zeros((1, 16, 16, 3)),), 1, return_loss=True)
    return jm, jp, jv, jvp


@pytest.fixture(scope="module")
def port_vae(jax_models):
    *_, jvp = jax_models
    tv = DiscreteVAE(DVAEConfig(**VAE))
    tv.load_state_dict(dvae_state_dict(jvp))
    return DiscreteVAEAdapter(tv.eval())


def _images(b=2, seed=0, size=16):
    return np.random.RandomState(seed).rand(b, size, size, 3).astype(np.float32)


def _text(prompts):
    return SimpleTokenizer().tokenize(prompts, TINY["text_seq_len"], truncate_text=True)


# ---------------------------------------------------------------------------
# dVAE encode
# ---------------------------------------------------------------------------

ENC_TOL = 1e-5


@pytest.mark.parametrize("resblocks", [0, 1])
def test_dvae_encoder_matches_jax(jax_models, resblocks):
    """encode_logits within 1e-5 of JAX in f32; get_codebook_indices equal
    wherever JAX's top-two logit gap exceeds 2e-5 (there two answers each
    within 1e-5 cannot swap the argmax); where the gap is smaller, either
    of the two tied tokens is accepted."""
    cfg = dict(VAE, num_resnet_blocks=resblocks)
    jv = JDiscreteVAE(JDVAEConfig(**cfg))
    jvp = _random_params(jv, (jnp.zeros((1, 16, 16, 3)),), 2 + resblocks, return_loss=True)
    tv = DiscreteVAE(DVAEConfig(**cfg))
    tv.load_state_dict(dvae_state_dict(jvp))
    img = _images(3, seed=resblocks)
    want = np.asarray(jv.apply(jvp, img, method=JDiscreteVAE.encode_logits))
    got = tv.encode_logits(torch.from_numpy(img)).detach().numpy()
    assert got.shape == want.shape == (3, 4, 4, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_TOL)
    ids = DiscreteVAEAdapter(tv).get_codebook_indices(img).numpy()
    jids = np.asarray(jv.apply(jvp, img, method=JDiscreteVAE.get_codebook_indices))
    top2 = np.sort(want, axis=-1)[..., -2:].reshape(3, -1, 2)
    clear = (top2[..., 1] - top2[..., 0]) > 2 * ENC_TOL
    assert clear.mean() > 0.9
    assert np.array_equal(ids[clear], jids[clear])
    flat = want.reshape(3, -1, 48)
    near = np.take_along_axis(flat, ids[..., None], -1)[..., 0]
    assert np.all(near >= flat.max(-1) - 2 * ENC_TOL)


def test_dvae_encoder_rejects_a_wrong_size(port_vae):
    with pytest.raises(ValueError, match="16px"):
        port_vae.get_codebook_indices(_images(1, size=32))


# ---------------------------------------------------------------------------
# config dicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["dalle", "dalle_variant", "dvae", "dvae_no_norm", "optim"])
def test_config_dict_equals_jax(which):
    kw = {"dalle": ({}, DalleConfig, JDalleConfig),
          "dalle_variant": (dict(attn_types=("full", "axial_row"), shared_attn_ids=(0, 0),
                                 depth=2, loss_chunk=64), DalleConfig, JDalleConfig),
          "dvae": ({}, DVAEConfig, JDVAEConfig),
          "dvae_no_norm": (dict(normalization=None, num_tokens=64), DVAEConfig, JDVAEConfig),
          "optim": (dict(optimizer="adamw", warmup_steps=3), OptimConfig, JOptimConfig)}
    fields, ours, theirs = kw[which]
    d = ours(**fields).to_dict()
    assert d == theirs(**fields).to_dict()
    assert ours.from_dict(json.loads(json.dumps(d))) == ours(**fields)
    assert theirs.from_dict(d) == theirs(**fields)


def test_train_config_dict_equals_jax_on_shared_fields(tmp_path):
    kw = dict(batch_size=4, seed=3, checkpoint_dir=str(tmp_path), keep_n_checkpoints=2,
              save_every_steps=7, preflight_checkpoint=False,
              optim=dict(learning_rate=1e-3))
    ours = TrainConfig.from_dict(kw).to_dict()
    theirs = JTrainConfig.from_dict(kw).to_dict()
    assert ours == {k: theirs[k] for k in ours}
    assert TrainConfig.from_dict(theirs) == TrainConfig.from_dict(kw)
    assert TrainConfig().checkpoint_dir is None


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def _state(v):
    return {"w": torch.full((3, 2), float(v)), "nested": {"n": v, "t": torch.arange(v + 1)}}


def test_checkpoint_round_trip_and_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_n=2)
    assert not (tmp_path / "ck").exists() and mgr.latest_step() is None
    for step in (1, 2, 3):
        mgr.save(step, _state(step), {"model_class": "X", "step": step})
    assert mgr.all_steps() == [2, 3]
    state, meta = mgr.restore()
    assert meta == {"model_class": "X", "step": 3}
    assert torch.equal(state["w"], _state(3)["w"]) and state["nested"]["n"] == 3
    state, meta = mgr.restore(step=2)
    assert meta["step"] == 2 and torch.equal(state["nested"]["t"], torch.arange(3))
    with pytest.raises(FileExistsError):
        mgr.save(3, _state(3))
    mgr.preflight(3, _state(9), {"step": 9})          # an existing step stays as it is
    assert mgr.all_steps() == [2, 3] and mgr.load_metadata()["step"] == 3
    assert not any(".tmp-" in n for n in os.listdir(mgr.directory))
    mgr.close()


def test_torn_newest_step_falls_back_and_is_quarantined_after(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2, 3):
        mgr.save(step, _state(step), {"step": step})
    path = os.path.join(mgr.step_dir(3), STATE_FILE)
    with open(path, "r+b") as f:                         # torn mid-write
        f.truncate(os.path.getsize(path) // 2)
    os.remove(os.path.join(mgr.step_dir(2), STATE_FILE))  # and a step with no data
    logs = []
    state, meta = mgr.restore(log=logs.append)
    assert meta == {"step": 1} and torch.equal(state["w"], _state(1)["w"])
    assert sorted(os.listdir(tmp_path)) == ["1", "2.corrupt", "3.corrupt"]
    assert len(logs) == 2
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=3)                              # a pinned step still raises


def test_nothing_is_quarantined_when_every_step_fails(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2):
        mgr.save(step, _state(step))
        with open(os.path.join(mgr.step_dir(step), STATE_FILE), "wb") as f:
            f.write(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="every checkpoint"):
        mgr.restore(log=lambda *a: None)
    assert mgr.all_steps() == [1, 2]


def test_stale_tmp_is_swept_and_a_live_one_kept(tmp_path):
    mgr = CheckpointManager(str(tmp_path), tmp_grace_s=60)
    mgr.save(1, _state(1))
    stale, live = tmp_path / "2.tmp-999-0", tmp_path / "3.tmp-999-1"
    for d in (stale, live):
        d.mkdir()
        (d / STATE_FILE).write_bytes(b"partial")
    old = time.time() - 3600
    for p in (stale, stale / STATE_FILE):
        os.utime(p, (old, old))
    assert mgr.all_steps() == [1]
    mgr.restore(log=lambda *a: None)
    assert not stale.exists() and live.exists()


def test_resume_is_bit_for_bit_four_steps(tmp_path):
    """2 steps + save + restore in a new trainer + 2 steps ≡ 4 steps, with
    CFG text dropout drawing from the trainer's generator."""
    cfg = DalleConfig(**dict(TINY, num_text_tokens=60))

    def trainer(ckpt=None):
        tc = TrainConfig(batch_size=2, checkpoint_dir=ckpt, save_every_steps=2,
                         optim=OptimConfig(learning_rate=1e-2))
        return DalleTrainer(cfg, tc, device="cpu", null_cond_prob=0.5)

    def batches(lo, hi):
        for i in range(lo, hi):
            rng = np.random.RandomState(i)
            yield rng.randint(1, 60, (2, 8)), rng.randint(0, 48, (2, 16))
    quiet = dict(log=lambda *a: None)
    whole = trainer()
    whole.fit(batches(0, 4), **quiet)
    first = trainer(str(tmp_path))
    first.fit(batches(0, 2), **quiet)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 2]
    second = trainer(str(tmp_path))
    meta = second.restore()
    assert meta["model_class"] == "DALLE" and meta["hparams"] == cfg.to_dict()
    assert meta["train"]["optim"]["learning_rate"] == 1e-2
    second.fit(batches(2, 4), **quiet)
    assert whole.step == second.step == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 2, 4]
    for (name, a), (_, b) in zip(whole.model.named_parameters(),
                                 second.model.named_parameters()):
        assert torch.equal(a, b), name
    for sa, sb in zip(whole.optimizer.core.nu, second.optimizer.core.nu):
        assert torch.equal(sa, sb)


# ---------------------------------------------------------------------------
# priming from pixels, and the flow from a checkpoint through the CLI
# ---------------------------------------------------------------------------

def _port_wrapper(jax_models, port_vae):
    _, jp, *_ = jax_models
    tm = DALLE(DalleConfig(**TINY))
    tm.load_state_dict(dalle_state_dict(jp))
    return DalleWithVae(tm.eval(), port_vae)


def test_priming_from_pixels_matches_jax(jax_models, port_vae):
    jm, jp, jv, jvp = jax_models
    jw = JDalleWithVae(jm, jp, JAdapter(jv, jvp))
    text, img = _text(PROMPTS), _images(2, seed=5)
    want = np.asarray(jax.jit(lambda t, k, im: jw.generate_images(
        t, k, filter_thres=GREEDY, img=im))(text.numpy().astype(np.int32),
                                            jax.random.PRNGKey(0), img))
    tw = _port_wrapper(jax_models, port_vae)
    got = tw.generate_images(text, generator=torch.Generator().manual_seed(1),
                             filter_thres=GREEDY, img=img).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    n_prime = int(0.4375 * 16)
    prime = np.asarray(jv.apply(jvp, img, method=JDiscreteVAE.get_codebook_indices))[:, :n_prime]
    assert np.array_equal(port_vae.get_codebook_indices(img)[:, :n_prime].numpy(), prime)
    with pytest.raises(ValueError):
        tw.generate_images(text, img=img, num_init_img_tokens=16)


def _write_checkpoint(ckpt, state_dict, cfg, vae=None):
    CheckpointManager(ckpt).save(0, {"model": state_dict},
                                 {"model_class": "DALLE", "hparams": cfg.to_dict(),
                                  "vae_class_name": "DiscreteVAEAdapter"})
    if vae is not None:
        _common.save_vae_sidecar(ckpt, vae)


def test_generate_cli_matches_jax_greedy(jax_models, port_vae, tmp_path):
    """A JAX model converted and written as a port checkpoint; the port's
    ``cli.generate`` on the CPU writes the pixels of JAX's
    ``DalleWithVae.generate_images`` (within 1e-4, so each PNG byte is JAX's
    or one level off where 255·pixel lies within 255e-4 of a step), and the
    checkpoint's model samples JAX's tokens."""
    jm, jp, jv, jvp = jax_models
    ckpt, out = str(tmp_path / "ck"), str(tmp_path / "out")
    _write_checkpoint(ckpt, dalle_state_dict(jp), DalleConfig(**TINY), port_vae)
    rc = generate.main(["--dalle_path", ckpt, "--text", "|".join(PROMPTS),
                        "--num_images", "2", "--batch_size", "2", "--top_k_thres", str(GREEDY),
                        "--device", "cpu", "--outputs_dir", out])
    assert rc == 0
    text = _text(PROMPTS).numpy().astype(np.int32)
    jw = JDalleWithVae(jm, jp, JAdapter(jv, jvp))
    pixels = np.asarray(jax.jit(lambda t, k: jw.generate_images(t, k, filter_thres=GREEDY))(
        text, jax.random.PRNGKey(0)))
    jtokens = np.asarray(jax.jit(lambda t, k: jm.apply(
        jp, t, k, filter_thres=GREEDY, method=JDALLE.generate_images_tokens))(
            text, jax.random.PRNGKey(0)))
    model, meta = generate.load_dalle(ckpt, "cpu")
    assert meta["model_class"] == "DALLE" and model.cfg == DalleConfig(**TINY)
    tokens = model.generate_images_tokens(torch.from_numpy(text).long(), filter_thres=GREEDY,
                                          generator=torch.Generator().manual_seed(5))
    assert np.array_equal(tokens.numpy(), jtokens)
    ours = DalleWithVae(model, _common.load_vae_sidecar(ckpt, "cpu")).generate_images(
        torch.from_numpy(text).long(), filter_thres=GREEDY).numpy()
    np.testing.assert_allclose(ours, pixels, rtol=0, atol=1e-4)
    want = _common.to_uint8(pixels)
    scaled = np.clip(pixels, 0, 1) * 255
    edge = np.abs(scaled - np.round(scaled)) < 255e-4
    for p, prompt in enumerate(PROMPTS):
        for i in range(2):
            png = np.asarray(Image.open(os.path.join(out, prompt.replace(" ", "_"),
                                                     f"img_0_{i}.png")))
            assert png.shape == (16, 16, 3)
            diff = np.abs(png.astype(int) - want[p].astype(int))
            assert np.all(diff[~edge[p]] == 0) and np.all(diff <= 1)
            assert np.array_equal(png, _common.to_uint8(ours)[p])


def test_train_resume_generate_cli_on_cpu(tmp_path):
    ckpt, out = str(tmp_path / "ck"), str(tmp_path / "out")
    argv = ["--synthetic", "--untrained_vae", "--image_size", "16", "--untrained_vae_tokens",
            "48", "--dim", "32", "--depth", "1", "--heads", "2", "--dim_head", "16",
            "--text_seq_len", "8", "--batch_size", "2", "--keep_n_checkpoints", "1",
            "--output_dir", ckpt, "--device", "cpu", "--save_every_n_steps", "2"]
    assert train_dalle.main(argv + ["--steps", "3"]) == 0
    mgr = CheckpointManager(ckpt)
    assert sorted(os.listdir(ckpt)) == ["3", "vae"]
    meta = mgr.load_metadata()
    assert meta["vae_class_name"] == "DiscreteVAEAdapter"
    assert meta["vae_hparams"]["num_tokens"] == 48 and meta["hparams"]["num_text_tokens"] == 49408
    saved = mgr.restore()[0]["model"]
    assert train_dalle.main(argv + ["--steps", "4", "--resume"]) == 0
    assert mgr.all_steps() == [4]
    tr = DalleTrainer(DalleConfig.from_dict(meta["hparams"]),
                      TrainConfig(checkpoint_dir=ckpt), device="cpu")
    tr.restore()
    assert tr.step == 4
    assert any(not torch.equal(v, tr.model.state_dict()[k]) for k, v in saved.items())
    assert generate.main(["--dalle_path", ckpt, "--text", "red", "--num_images", "1",
                          "--batch_size", "1", "--device", "cpu", "--outputs_dir", out]) == 0
    assert np.asarray(Image.open(os.path.join(out, "red", "img_0_0.png"))).shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# the entry points' own checks
# ---------------------------------------------------------------------------

def test_generate_rejects_a_vocab_mismatch(tmp_path, port_vae):
    cfg = DalleConfig(**dict(TINY, num_text_tokens=600))
    _write_checkpoint(str(tmp_path), DALLE(cfg).state_dict(), cfg, port_vae)
    assert generate.main(["--dalle_path", str(tmp_path), "--text", "x",
                          "--device", "cpu"]) == 2


def test_train_rejects_a_small_vocab_and_a_vae_of_another_size(tmp_path, port_vae):
    base = ["--synthetic", "--untrained_vae", "--image_size", "16", "--device", "cpu",
            "--output_dir", str(tmp_path / "ck")]
    assert train_dalle.main(base + ["--num_text_tokens", "300"]) == 2
    vae_dir = str(tmp_path / "vae")
    CheckpointManager(vae_dir).save(0, {"model": port_vae.model.state_dict()},
                                    {"model_class": "DiscreteVAE",
                                     "hparams": port_vae.model.cfg.to_dict()})
    assert _common.build_vae_from_args(
        train_dalle.build_parser().parse_args(["--vae_path", vae_dir]), "cpu").num_tokens == 48
    assert train_dalle.main(["--synthetic", "--vae_path", vae_dir, "--image_size", "32",
                             "--device", "cpu", "--output_dir", str(tmp_path / "ck")]) == 2


TRAIN_UNPORTED = [["--image_text_folder", "x"], ["--wds", "x"], ["--reversible"],
                  ["--shift_tokens"], ["--trace"], ["--watchdog_deadline_s", "5"],
                  ["--prometheus_path", "p"], ["--taming"], []]
# ported since these cases were written: each case now runs its flag end to end
TRAIN_PORTED = {"--shift_tokens"}
# --clip_path is ported: its case now gives it a path with a DALL·E checkpoint
# and no CLIP one, which is refused
GENERATE_UNPORTED = [["--int8w"], ["--speculative", "2"], ["--clip_path", "DALLE"], ["--gentxt"],
                     ["--fast_topk"], ["--trace", "d"]]
GENERATE_PORTED = {"--int8w", "--speculative", "--gentxt"}
TINY_TRAIN = ["--image_size", "16", "--untrained_vae_tokens", "48", "--dim", "32", "--depth",
              "1", "--heads", "2", "--dim_head", "16", "--text_seq_len", "8", "--batch_size",
              "2", "--steps", "1"]


@pytest.mark.parametrize("flags", TRAIN_UNPORTED, ids=lambda f: " ".join(f) or "openai_vae")
def test_train_unported_flags_raise(tmp_path, flags):
    argv = ["--synthetic", "--device", "cpu", "--output_dir", str(tmp_path)]
    if flags[:1] not in (["--taming"], []):
        argv.append("--untrained_vae")
    if flags[0:1] and flags[0] in TRAIN_PORTED:
        assert train_dalle.main(argv + TINY_TRAIN + flags) == 0
        meta = CheckpointManager(str(tmp_path)).load_metadata()
        assert meta["hparams"]["shift_tokens"] is True
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        train_dalle.main(argv + flags)


@pytest.fixture(scope="module")
def dalle_ckpt(tmp_path_factory, port_vae):
    ckpt = str(tmp_path_factory.mktemp("dalle_ckpt"))
    cfg = DalleConfig(**TINY)
    _write_checkpoint(ckpt, DALLE(cfg).state_dict(), cfg, port_vae)
    return ckpt


@pytest.mark.parametrize("flags", GENERATE_UNPORTED, ids=lambda f: f[0])
def test_generate_unported_flags_raise(dalle_ckpt, tmp_path, flags, capsys):
    flags = [dalle_ckpt if f == "DALLE" else f for f in flags]
    argv = ["--dalle_path", dalle_ckpt, "--text", "a red circle", "--device", "cpu",
            "--outputs_dir", str(tmp_path)] + flags
    if flags[0] in GENERATE_PORTED:
        # the flag runs end to end: two images written per prompt
        assert generate.main(argv + ["--num_images", "2", "--batch_size", "2"]) == 0
        out = capsys.readouterr().out
        if flags[0] == "--gentxt":
            assert "gentxt: 'a red circle' → " in out
        written = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs]
        assert len(written) == 2 and all(f.endswith(".png") for f in written)
        assert all(np.asarray(Image.open(f)).shape == (16, 16, 3) for f in written)
        return
    err, match = ((ValueError, "not a CLIP checkpoint") if flags[0] == "--clip_path"
                  else (NotImplementedError, "ROADMAP.md Queue 1 item"))
    with pytest.raises(err, match=match):
        generate.main(argv)


def test_png_writer_reads_back_in_pil(tmp_path):
    img = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32) * 1.2 - 0.1
    _common.save_image_grid(torch.from_numpy(img), str(tmp_path / "im_{}.png"))
    for i in range(2):
        path = str(tmp_path / f"im_{i}.png")
        assert np.array_equal(np.asarray(Image.open(path).convert("RGB")),
                              _common.to_uint8(img)[i])
        assert np.array_equal(_common.read_png(path), _common.to_uint8(img)[i])
    shutil.rmtree(tmp_path)


def test_dalle_config_for_vae(port_vae):
    cfg = dalle_config_for_vae(port_vae, num_text_tokens=100, dim=32)
    assert (cfg.image_size, cfg.image_vocab_size, cfg.image_fmap_size) == (16, 48, 4)
