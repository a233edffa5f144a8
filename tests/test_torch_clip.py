"""The port's CLIP ≡ the JAX package's, on the CPU at a tiny size (dim 32,
depth 1, 16 px with 8 px patches): the text and image embeddings with
padded text rows, the per-pair scores, ``score_images``, the loss and its
gradients, ``CLIPTrainer`` steps against optax, the towers' routing, and
the entry points: ``cli.train_clip``, and ``cli.generate --clip_path`` on a
JAX DALL·E, dVAE and CLIP converted to port checkpoints.

JAX parameters are drawn from numpy on the shapes ``jax.eval_shape`` gives
(no flax init to compile) and the JAX calls are jitted once each.
Generation against JAX is greedy (``top_k_thres`` 0.999 keeps one of 48
image tokens), so neither framework's draws matter; the CLI's order of
scores that differ is held, sampled, to the port's own in-process
generation on the same seed. Tolerances, with their reasons at the
asserts: f32 values 1e-5, gradients and parameters 1e-5 plus 1e-4 relative,
the reranked generation's scores 1e-4 (they sit on the generated pixels).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import AnnealConfig as JAnnealConfig
from dalle_tpu.config import ClipConfig as JClipConfig
from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.models.clip import CLIP as JCLIP
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.models.wrapper import DalleWithVae as JDalleWithVae
from dalle_tpu.models.wrapper import DiscreteVAEAdapter as JAdapter
from dalle_tpu.train import train_state as jts
from dalle_tpu_torch import (CLIP, AnnealConfig, CLIPTrainer, ClipConfig, DALLE, DalleConfig, DalleWithVae,
                             DiscreteVAE, DiscreteVAEAdapter, DVAEConfig, OptimConfig,
                             PrecisionConfig, TrainConfig, clip_state_dict, dalle_state_dict,
                             dvae_state_dict, init_clip, load_clip)
from dalle_tpu_torch import obs
from dalle_tpu_torch.cli import _common, generate, train_clip
from dalle_tpu_torch.data import image_codec
from dalle_tpu_torch.models.wrapper import rerank_scores
from dalle_tpu_torch.text.tokenizer import SimpleTokenizer
from dalle_tpu_torch.train.checkpoints import CheckpointManager

CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=32, num_text_tokens=100,
               text_enc_depth=1, text_seq_len=8, text_heads=2, visual_enc_depth=1,
               visual_heads=2, visual_image_size=16, visual_patch_size=8)
F32 = PrecisionConfig(compute="float32")


_SHAPES = {}


def _random_params(model, args, seed, **kw):
    """numpy weights on the flax tree's shapes (traced once per config):
    kernels N(0, 1/fan-in), embeddings N(0, 0.5²), norm scales near 1, the
    rest N(0, 0.1²)."""
    if repr(model) not in _SHAPES:
        keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(0)}
        _SHAPES[repr(model)] = jax.eval_shape(lambda: model.init(keys, *args, **kw))
    shapes = _SHAPES[repr(model)]
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


def _clip_pair(seed, **kw):
    cfg = dict(CLIP_KW, **kw)
    jc = JCLIP(JClipConfig(**cfg))
    jp = _random_params(jc, (jnp.zeros((1, cfg["text_seq_len"]), jnp.int32),
                             jnp.zeros((1, 16, 16, 3))), seed, return_loss=True)
    tc = CLIP(ClipConfig(**cfg))
    tc.load_state_dict(clip_state_dict(jp))
    return jc, jp, tc


def _batch(seed, b=4):
    """Text with rows padded to different lengths, and images in [0, 1]."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, CLIP_KW["num_text_tokens"], (b, 8)).astype(np.int32)
    for i in range(b):
        text[i, 8 - 2 * i:] = 0
    return text, rng.rand(b, 16, 16, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """One jitted JAX call → (loss, its gradient, the text and image
    embeddings, the per-pair scores, ``score_images`` of the first text)."""
    jc = JCLIP(JClipConfig(**CLIP_KW))

    @jax.jit
    def ref(p, text, img):
        loss, grads = jax.value_and_grad(
            lambda q: jc.apply(q, text, img, return_loss=True))(p)
        return (loss, grads, jc.apply(p, text, method=JCLIP.embed_text),
                jc.apply(p, img, method=JCLIP.embed_image), jc.apply(p, text, img),
                jc.apply(p, text[:1], img, method=JCLIP.score_images))
    return ref


def _close(got, want, atol=1e-5, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_embeddings_scores_and_loss_match_jax(jax_ref):
    """f32 within 1e-5 (summation order only), padded rows included."""
    _, jp, tc = _clip_pair(0)
    text, img = _batch(1)
    loss, _, t, v, pairs, group = jax_ref(jp, text, img)
    tt, ti = torch.from_numpy(text), torch.from_numpy(img)
    _close(tc.embed_text(tt), t)
    _close(tc.embed_image(ti), v)
    _close(tc(tt, ti), pairs)
    _close(tc.score_images(tt[:1], ti), group)
    _close(tc(tt, ti, return_loss=True), loss)
    np.testing.assert_allclose(torch.linalg.vector_norm(tc.embed_text(tt), dim=-1).detach(),
                               1.0, atol=1e-6)
    with pytest.raises(ValueError, match="16px"):
        tc.embed_image(torch.zeros(1, 8, 8, 3))


def test_loss_gradients_match_jax(jax_ref):
    """Every parameter's gradient, the temperature's included, within 1e-5 +
    1e-4 relative of ``jax.grad`` (f32 summation order)."""
    _, jp, tc = _clip_pair(2)
    text, img = _batch(3)
    want, jgrads, *_ = jax_ref(jp, text, img)
    loss = tc.train()(torch.from_numpy(text), torch.from_numpy(img), return_loss=True)
    loss.backward()
    _close(loss, want)
    ref = clip_state_dict(jgrads)
    assert sorted(ref) == sorted(n for n, _ in tc.named_parameters())
    for name, p in tc.named_parameters():
        _close(p.grad, ref[name].numpy(), atol=1e-5, rtol=1e-4, msg=name)


def test_clip_trainer_steps_match_optax(jax_ref):
    """Two steps against optax Adam with clipping (the JAX package's
    ``make_optimizer``): parameters within 2e-5 + 1e-4 relative. Adam moves
    an element by lr·g/(|g| + eps): where JAX's |g| is below 100·eps = 1e-6
    the f32 noise in g (measured 3e-9 on a 7e-9 gradient) moves that
    quotient, so such an element (fewer than 1 in 100; a zero gradient is
    exact on both sides) is held only to lr per step."""
    optim = dict(learning_rate=1e-3, grad_clip_norm=0.5)
    _, jp, _ = _clip_pair(4)
    tx = jts.make_optimizer(JOptimConfig(**optim))
    opt_state = jax.jit(tx.init)(jp)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state
    tr = CLIPTrainer(ClipConfig(**CLIP_KW), TrainConfig(batch_size=4, precision=F32,
                                                        optim=OptimConfig(**optim)),
                     device="cpu")
    with torch.no_grad():
        tr.model.load_state_dict(clip_state_dict(jp))
    tiny = {}
    for step in range(2):
        text, img = _batch(10 + step)
        want, grads, *_ = jax_ref(jp, text, img)
        jp, opt_state = update(grads, opt_state, jp)
        m = tr.train_step(text, img)
        assert m["step"] == step + 1
        np.testing.assert_allclose(m["loss"], float(want), rtol=1e-5, atol=1e-5)
        ref, g = clip_state_dict(jp), clip_state_dict(grads)
        for name, p in tr.model.state_dict().items():
            a = g[name].abs()
            tiny[name] = tiny.get(name, False) | ((a > 0) & (a <= 1e-6))
            diff = (p - ref[name]).abs()
            ok = diff <= 2e-5 + 1e-4 * ref[name].abs()
            assert bool(torch.all(ok | tiny[name])), f"step {step} {name}"
            assert torch.where(tiny[name], diff, 0.0).max() <= optim["learning_rate"] * (step + 1)
        assert sum(int(t.sum()) for t in tiny.values()) < 0.01 * tr.num_params
    _close(tr.similarity(text, img), jax_ref(jp, text, img)[4])


@pytest.mark.parametrize("which", ["clip", "anneal"])
def test_config_dicts_equal_jax(which):
    ours, theirs, kw = {"clip": (ClipConfig, JClipConfig, CLIP_KW),
                        "anneal": (AnnealConfig, JAnnealConfig, dict(anneal_rate=0.1))}[which]
    assert ours(**kw).to_dict() == theirs(**kw).to_dict()
    assert ours().to_dict() == theirs().to_dict()
    assert ours.from_dict(theirs(**kw).to_dict()) == ours(**kw)


def test_towers_take_the_dense_core_on_the_card_too():
    """``use_pallas`` stays "auto", and on a CUDA device that still gives
    both towers the dense core, not the causal K1."""
    tc = CLIP(ClipConfig(**dict(CLIP_KW, text_seq_len=256, visual_image_size=128,
                                visual_patch_size=16)))
    cuda = torch.device("cuda")
    assert tc.text_transformer.cfg.use_pallas == "auto"
    assert tc.visual_transformer.attention_mode(cuda) is False
    assert tc.text_transformer.attention_mode(cuda, torch.ones(1, 256, dtype=torch.bool)) is False


# ---------------------------------------------------------------------------
# the rerank through the wrapper and the entry points
# ---------------------------------------------------------------------------

DALLE_KW = dict(num_text_tokens=49408, text_seq_len=8, dim=32, depth=1, heads=2,
                dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)
VAE_KW = dict(image_size=16, num_tokens=48, codebook_dim=16, num_layers=2, hidden_dim=8)
# CLIP's vocabulary keeps "a"/"red"/"blue" (ids 320, 736, 1746) and turns "circle"
# and "square" (7117, 3999) into pads; its 6-token context crops DALL·E's 8
RERANK_CLIP = dict(num_text_tokens=2000, text_seq_len=6)
GREEDY = 0.999
PROMPTS = ["a red circle", "blue square"]


@pytest.fixture(scope="module")
def flow():
    """A JAX DALL·E, dVAE and CLIP, their port twins, and JAX's greedy
    ``generate_images(clip=…)`` jitted once."""
    jm = JDALLE(JDalleConfig(**DALLE_KW))
    jp = _random_params(jm, (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)), 0)
    jv = JDiscreteVAE(JDVAEConfig(**VAE_KW))
    jvp = _random_params(jv, (jnp.zeros((1, 16, 16, 3)),), 1, return_loss=True)
    jc, jcp, tc = _clip_pair(5, **RERANK_CLIP)
    jw = JDalleWithVae(jm, jp, JAdapter(jv, jvp))
    jgen = jax.jit(lambda t, k: jw.generate_images(t, k, filter_thres=GREEDY,
                                                   clip=(jc, jcp)))
    tm = DALLE(DalleConfig(**DALLE_KW))
    tm.load_state_dict(dalle_state_dict(jp))
    tv = DiscreteVAE(DVAEConfig(**VAE_KW))
    tv.load_state_dict(dvae_state_dict(jvp))
    return jgen, DalleWithVae(tm.eval(), DiscreteVAEAdapter(tv.eval())), tc.eval()


def _text(prompts):
    return SimpleTokenizer().tokenize(prompts, 8, truncate_text=True)


def test_generate_images_with_clip_matches_jax(flow):
    jgen, tw, tc = flow
    text = _text(PROMPTS)
    jimg, jscores = jgen(text.numpy().astype(np.int32), jax.random.PRNGKey(0))
    assert tw.attach_rerank(tc) is tw and tw.clip is tc
    images, scores = tw.generate_images(text, filter_thres=GREEDY, clip=tw.clip)
    _close(images, jimg, atol=1e-4)
    _close(scores, jscores, atol=1e-4)
    assert abs(float(jscores[0] - jscores[1])) > 1e-3            # two distinct scores
    np.testing.assert_array_equal(np.argsort(-scores.numpy(), kind="stable"),
                                  np.argsort(-np.asarray(jscores), kind="stable"))
    # ids at or above CLIP's vocabulary become pads, the context is cropped
    clip_text = torch.where(text >= 2000, 0, text)[:, :6]
    assert torch.equal(rerank_scores(tc, text, images), tc(clip_text, images))
    wide = init_clip(ClipConfig(**dict(CLIP_KW, **dict(RERANK_CLIP, text_seq_len=10))),
                     seed=1, device="cpu")            # a longer context: 0-padded
    assert torch.equal(rerank_scores(wide, clip_text, images),
                       wide(torch.nn.functional.pad(clip_text, (0, 4)), images))


def _save_flow(tmp_path, tw, tc):
    """The flow's port DALL·E (with its VAE sidecar) and CLIP as the
    checkpoints ``generate`` reads → (dalle dir, clip dir)."""
    ckpt, clip_ck = str(tmp_path / "dalle"), str(tmp_path / "clip")
    CheckpointManager(ckpt).save(0, {"model": tw.model.state_dict()},
                                 {"model_class": "DALLE", "hparams": tw.model.cfg.to_dict(),
                                  "vae_class_name": "DiscreteVAEAdapter"})
    _common.save_vae_sidecar(ckpt, tw.vae)
    CheckpointManager(clip_ck).save(0, {"model": tc.state_dict()},
                                    {"model_class": "CLIP", "hparams": tc.cfg.to_dict()})
    return ckpt, clip_ck


def test_generate_cli_reranks_like_jax(flow, tmp_path):
    """``generate --clip_path`` against JAX: greedy, so the two images of one
    prompt are one image and their scores tie; the scores written within
    1e-4 of JAX's and each PNG JAX's image. The order of scores that differ
    is held in ``test_generate_cli_writes_distinct_scores_best_first`` and,
    against JAX, in ``test_generate_images_with_clip_matches_jax``."""
    jgen, tw, tc = flow
    ckpt, clip_ck = _save_flow(tmp_path, tw, tc)
    out = str(tmp_path / "out")
    loaded, meta = load_clip(clip_ck, "cpu")
    assert meta["model_class"] == "CLIP" and loaded.cfg == tc.cfg
    assert generate.main(["--dalle_path", ckpt, "--clip_path", clip_ck, "--text", PROMPTS[0],
                          "--num_images", "2", "--batch_size", "1", "--top_k_thres",
                          str(GREEDY), "--device", "cpu", "--outputs_dir", out]) == 0
    outdir = os.path.join(out, PROMPTS[0].replace(" ", "_"))
    assert sorted(os.listdir(outdir)) == ["clip_scores.json", "img_0.png", "img_1.png"]
    jimg, jscores = (np.asarray(a) for a in jgen(_text(PROMPTS[:1] * 2).numpy().astype(np.int32),
                                                  jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(jimg[0], jimg[1])               # greedy: one image
    with open(os.path.join(outdir, "clip_scores.json")) as f:
        written = np.array(json.load(f))
    np.testing.assert_allclose(written, jscores, rtol=0, atol=1e-4)
    want = _common.to_uint8(jimg[0])
    for i in range(2):
        png = image_codec.read_png(os.path.join(outdir, f"img_{i}.png"))
        assert np.abs(png.astype(int) - want.astype(int)).max() <= 1
    # a path that holds no CLIP checkpoint is refused
    with pytest.raises(ValueError, match="not a CLIP checkpoint"):
        generate.main(["--dalle_path", ckpt, "--clip_path", ckpt, "--text", "x",
                       "--device", "cpu", "--outputs_dir", out])


def test_generate_cli_writes_distinct_scores_best_first(flow, tmp_path):
    """Sampled (top-k keeps 24 of the 48 image tokens), four images of one
    prompt in two batches: the four scores differ, and ``generate
    --clip_path`` writes them and the images in the order of a stable sort
    of the port's in-process ``generate_images(clip=…)`` on the same seed,
    best first. Both run the same code on the CPU: bit for bit."""
    _, tw, tc = flow
    ckpt, clip_ck = _save_flow(tmp_path, tw, tc)
    out = str(tmp_path / "out")
    assert generate.main(["--dalle_path", ckpt, "--clip_path", clip_ck, "--text", PROMPTS[0],
                          "--num_images", "4", "--batch_size", "2", "--top_k_thres", "0.5",
                          "--seed", "0", "--device", "cpu", "--outputs_dir", out]) == 0
    model, _ = generate.load_dalle(ckpt, "cpu")
    clip, _ = load_clip(clip_ck, "cpu")
    wrapper = DalleWithVae(model, _common.load_vae_sidecar(ckpt, "cpu"), clip)
    gen = torch.Generator().manual_seed(0)
    parts = [wrapper.generate_images(_text(PROMPTS[:1]).repeat(2, 1), generator=gen,
                                     filter_thres=0.5, clip=clip) for _ in range(2)]
    images = torch.cat([p[0] for p in parts])
    scores = torch.cat([p[1] for p in parts]).numpy()
    gaps = np.abs(scores[:, None] - scores[None, :])[~np.eye(4, dtype=bool)]
    assert gaps.min() > 1e-4                                     # four distinct scores
    order = np.argsort(-scores, kind="stable")
    assert not np.array_equal(order, np.arange(4))               # the files are reordered
    outdir = os.path.join(out, PROMPTS[0].replace(" ", "_"))
    with open(os.path.join(outdir, "clip_scores.json")) as f:
        assert json.load(f) == [float(scores[i]) for i in order]
    want = _common.to_uint8(images[torch.from_numpy(order)])
    for i in range(4):
        np.testing.assert_array_equal(image_codec.read_png(os.path.join(outdir, f"img_{i}.png")),
                                      want[i])


def test_train_clip_cli_writes_what_load_clip_reads(tmp_path):
    ck = str(tmp_path / "clip")
    argv = ["--synthetic", "--image_size", "16", "--patch_size", "8", "--dim", "32",
            "--depth", "1", "--heads", "2", "--text_seq_len", "8", "--batch_size", "2",
            "--steps", "2", "--output_dir", ck, "--rollback_snapshot", "host", "--device", "cpu"]
    assert train_clip.main(argv) == 0
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [0, 2]
    state = mgr.restore()[0]
    assert state["step"] == state["optimizer"]["count"] == 2 and "generator" not in state
    model, meta = load_clip(ck, "cpu")
    assert meta["model_class"] == "CLIP" and model.cfg.num_text_tokens == 49408
    assert meta["train"]["rollback_snapshot"] == "host"
    assert (model.cfg.visual_image_size, model.cfg.visual_patch_size) == (16, 8)
    for k, v in state["model"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert train_clip.main(argv + ["--num_text_tokens", "300"]) == 2


CLIP_UNPORTED = [["--image_text_folder", "x"], ["--trace"],
                 ["--watchdog_deadline_s", "5"], ["--prometheus_path", "p"]]
# ported since these cases were written: the telemetry flags run, each leaving
# its file (the relative path under the test's directory), and
# --image_text_folder trains on a folder of captioned images the test writes
CLIP_TELEMETRY = {"--trace": os.path.join("obs", "spans.jsonl"),
                  "--watchdog_deadline_s": "metrics.jsonl", "--prometheus_path": "p"}


@pytest.mark.parametrize("flags", CLIP_UNPORTED, ids=lambda f: f[0])
def test_train_clip_unported_flags_raise(tmp_path, flags):
    argv = ["--synthetic", "--device", "cpu", "--output_dir", str(tmp_path)]
    tiny = ["--image_size", "16", "--patch_size", "8", "--dim", "32", "--depth", "1",
            "--heads", "2", "--text_seq_len", "8", "--batch_size", "2", "--steps", "1"]
    if flags[0] == "--image_text_folder":
        folder = tmp_path / "data"
        folder.mkdir()
        rng = np.random.RandomState(0)
        for i in range(3):
            image_codec.write_png(str(folder / f"im{i}.png"),
                                  rng.randint(0, 256, (18, 20, 3)).astype(np.uint8))
            (folder / f"im{i}.txt").write_text(f"a red circle {i}\n")
        assert train_clip.main(argv[1:] + tiny + [flags[0], str(folder)]) == 0
        assert CheckpointManager(str(tmp_path)).latest_step() == 1
        return
    if flags[0] in CLIP_TELEMETRY:
        flags = [flags[0]] + [str(tmp_path / f) if f == "p" else f for f in flags[1:]]
        try:
            assert train_clip.main(argv + tiny + flags) == 0
        finally:
            obs.disable()
        assert os.path.isfile(tmp_path / CLIP_TELEMETRY[flags[0]])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        train_clip.main(argv + flags)
