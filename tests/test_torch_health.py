"""The port's model-health taps, sentries and breach actions ≡ the JAX
package's, on the CPU at tiny size.

* ``layer_groups`` gives the JAX group keys, in the JAX order, on DALL·E,
  the dVAE, CLIP and the VQGAN (``gen/…``) with its discriminator
  (``disc/…``), at depths 1–3: the port's groups come from the converter's
  name map (``convert.flax_path``), checked against the JAX trees built
  with ``jax.eval_shape``.
* ``tree_health``, ``codebook_health``, ``gumbel_health`` on the same
  numpy-seeded inputs: f32 reductions in both, rtol 1e-5 (summation order),
  ``nonfinite_frac`` exact.
* One ``DalleTrainer.train_step`` and one ``VAETrainer.train_step`` with
  health on, from the JAX trainer's own weights: the same metric keys, the
  values within the tolerances at each assert. Then a traced ``fit`` of the
  two DALL·E trainers: the same span names, step-breakdown and device-gauge
  columns, Prometheus names.
* Health on against off: the parameters and the optimizer's state bitwise
  equal after 3 steps, for every optimizer path.
* The detectors, ``HealthSentry`` and ``BreachActions`` fed one metrics
  sequence: the same breaches, actions, gauges and lr scale as the JAX
  ones.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.struct

from dalle_tpu import obs as jobs
from dalle_tpu.config import ClipConfig as JClipConfig
from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.config import MeshConfig as JMeshConfig
from dalle_tpu.config import ObsConfig as JObsConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.config import PrecisionConfig as JPrecisionConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.config import VQGANConfig as JVQGANConfig
from dalle_tpu.models import dvae as jdvae_mod
from dalle_tpu.models.clip import init_clip as jinit_clip
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.models.dvae import init_dvae as jinit_dvae
from dalle_tpu.models.gan import NLayerDiscriminator as JDisc
from dalle_tpu.models.vqgan import init_vqgan as jinit_vqgan
from dalle_tpu.obs import anomaly as janomaly
from dalle_tpu.obs import health as jhealth
from dalle_tpu.parallel.mesh import build_mesh
from dalle_tpu.train.actions import BreachActions as JBreachActions
from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
from dalle_tpu.train.trainer_vae import VAETrainer as JVAETrainer
from dalle_tpu_torch import obs
from dalle_tpu_torch.config import (ClipConfig, DalleConfig, DVAEConfig, ObsConfig,
                                    OptimConfig, PrecisionConfig, TrainConfig, VQGANConfig)
from dalle_tpu_torch.convert import dalle_state_dict, dvae_state_dict
from dalle_tpu_torch.models.clip import CLIP
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.dvae import DiscreteVAE
from dalle_tpu_torch.models.gan import GANLossConfig, NLayerDiscriminator
from dalle_tpu_torch.models.vqgan import VQModel
from dalle_tpu_torch.obs import anomaly, health
from dalle_tpu_torch.train.actions import BreachActions
from dalle_tpu_torch.train.train_state import Optimizer
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer
from dalle_tpu_torch.train.trainer_vae import VAETrainer
from dalle_tpu_torch.train.trainer_vqgan import VQGANTrainer

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)
# a dVAE of its own (odd widths): the JAX step body is cached per model
# config, and this file's JAX trainer draws its gumbel noise from a patch
VAE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=12,
           num_resnet_blocks=1)
CLIP_CFG = dict(dim_text=32, dim_image=32, dim_latent=32, num_text_tokens=100,
                text_enc_depth=1, text_seq_len=8, text_heads=2, visual_enc_depth=1,
                visual_heads=2, visual_image_size=16, visual_patch_size=8)
VQ = dict(resolution=32, ch=8, ch_mult=(1, 2), n_embed=16, embed_dim=8, z_channels=8,
          num_res_blocks=1, attn_resolutions=(16,))
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    obs.disable()
    obs.disable_recorder()
    jobs.disable()
    jobs.disable_recorder()


# ---------------------------------------------------------------------------
# layer groups through the converter's name map
# ---------------------------------------------------------------------------

def _jax_tree(name):
    if name == "dalle":
        return jax.eval_shape(lambda: jinit_dalle(JDalleConfig(**TINY), KEY)[1])
    if name == "dvae":
        return jax.eval_shape(lambda: jinit_dvae(JDVAEConfig(**VAE), KEY)[1])
    if name == "clip":
        return jax.eval_shape(lambda: jinit_clip(JClipConfig(**CLIP_CFG), KEY)[1])
    if name in ("vqgan", "vqgan_gumbel"):
        cfg = JVQGANConfig(**VQ, quantizer="gumbel" if name == "vqgan_gumbel" else "vq")
        return jax.eval_shape(lambda: jinit_vqgan(cfg, KEY)[1])
    variables = jax.eval_shape(lambda: JDisc(ndf=8, n_layers=2, use_actnorm=name == "disc_actnorm")
                               .init(KEY, jnp.zeros((2, 32, 32, 3)), train=True))
    return variables["params"]


def _port_model(name):
    if name == "dalle":
        return DALLE(DalleConfig(**TINY))
    if name == "dvae":
        return DiscreteVAE(DVAEConfig(**VAE))
    if name == "clip":
        return CLIP(ClipConfig(**CLIP_CFG))
    if name in ("vqgan", "vqgan_gumbel"):
        return VQModel(VQGANConfig(**VQ, quantizer="gumbel" if name == "vqgan_gumbel" else "vq"))
    return NLayerDiscriminator(8, 2, name == "disc_actnorm", 3)


# (model, prefix): the VQGAN trainer's generator groups are gen/…, its
# discriminator's disc/…
GROUP_CASES = [("dalle", ""), ("dvae", ""), ("clip", ""), ("vqgan", "gen"),
               ("vqgan_gumbel", "gen"), ("disc", "disc"), ("disc_actnorm", "disc")]


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name,prefix", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_layer_groups_match_jax(name, prefix, depth):
    want = jhealth.layer_groups(_jax_tree(name), depth, prefix)
    model = _port_model(name)
    got = health.layer_groups(model, depth, prefix)
    assert list(got) == list(want)
    assert {g: len(v) for g, v in got.items()} == {g: len(v) for g, v in want.items()}
    params = list(model.parameters())
    taps = health.GroupTaps(model, [n for n, _ in model.named_parameters()], params,
                            depth, prefix)
    assert taps.groups == list(want)


# ---------------------------------------------------------------------------
# the taps on the same inputs
# ---------------------------------------------------------------------------

def _trees(seed):
    rng = np.random.RandomState(seed)

    def tree():
        return {"params": {
            "encoder": {"conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
                                 "bias": rng.randn(8).astype(np.float32)},
                        "norm": {"scale": rng.randn(8).astype(np.float32)}},
            "decoder": {"out": {"kernel": rng.randn(8, 5).astype(np.float32)}},
            "codebook": {"embedding": rng.randn(16, 8).astype(np.float32)}}}
    grads, params, updates = tree(), tree(), tree()
    grads["params"]["encoder"]["conv"]["kernel"][0, 0, 0, :3] = [np.inf, -np.inf, np.nan]
    return grads, params, updates


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("depth,prefix", [(1, ""), (2, ""), (3, "gen"), (1, "disc")])
def test_tree_health_matches_jax(depth, prefix):
    grads, params, updates = _trees(depth)
    want = jhealth.tree_health(_to(grads, jnp.asarray), _to(params, jnp.asarray),
                               _to(updates, jnp.asarray), depth=depth, prefix=prefix)
    got = health.tree_health(_to(grads, torch.from_numpy), _to(params, torch.from_numpy),
                             _to(updates, torch.from_numpy), depth=depth, prefix=prefix)
    assert list(got) == list(want)
    for k, v in got.items():
        if "/nonfinite_frac/" in k:
            assert v.item() == float(want[k]), k
        elif math.isfinite(float(want[k])):
            # f32 sums on both sides: summation order only
            np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)
        else:
            assert not math.isfinite(v.item()), k
    without = health.tree_health(_to(grads, torch.from_numpy), _to(params, torch.from_numpy),
                                 depth=depth, prefix=prefix)
    assert not any("/update_ratio/" in k for k in without)


@pytest.mark.parametrize("case", ["spread", "collapsed", "uniform"])
def test_codebook_health_matches_jax(case):
    rng = np.random.RandomState(3)
    idx = {"spread": rng.randint(0, 32, (4, 8, 8)),
           "collapsed": np.where(rng.rand(4, 8, 8) < 0.9, 3, 7),
           "uniform": np.arange(64).reshape(2, 32) % 32}[case]
    want = jhealth.codebook_health(jnp.asarray(idx, jnp.int32), 32)
    got = health.codebook_health(torch.from_numpy(idx), 32)
    assert list(got) == list(want)
    for k, v in got.items():
        # f32 histogram and entropy: summation order only
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_health_matches_jax(dtype):
    rng = np.random.RandomState(4)
    logits = (rng.randn(4, 8, 8, 32) * 2).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jhealth.gumbel_health(jnp.asarray(logits).astype(dtype), jnp.asarray(soft), 0.7)
    got = health.gumbel_health(torch.from_numpy(logits).to(getattr(torch, dtype)),
                               torch.from_numpy(soft), 0.7)
    assert list(got) == list(want)
    for k, v in got.items():
        # the same (bf16-rounded) logits, softmax and max in f32 on both sides
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# trainer steps with health on, against the JAX trainers
# ---------------------------------------------------------------------------

def _jtc(tmp_path, optim, **obs_kw):
    return JTrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                        mesh=JMeshConfig(), precision=JPrecisionConfig(compute="float32"),
                        optim=JOptimConfig(**optim), device_prefetch=0,
                        obs=JObsConfig(health=True, **obs_kw))


def _tc(optim, **kw):
    obs_kw = kw.pop("obs", {})
    return TrainConfig(batch_size=2, optim=OptimConfig(**optim),
                       precision=PrecisionConfig(compute="float32"),
                       obs=ObsConfig(health=True, **obs_kw), **kw)


def _dalle_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"]))
    img = rng.randint(0, TINY["image_vocab_size"], (b, TINY["image_fmap_size"] ** 2))
    return text.astype(np.int32), img.astype(np.int32)


def _assert_columns(got, want, tol):
    """The same keys (a jitted step's dict comes back in sorted order, so
    the order is ``tree_health``'s test's), the values within ``tol``
    (metric → rtol; the reasons at the call)."""
    assert set(got) - {"step"} == set(want)
    hk = [k for k in got if k.startswith("health/")]
    for k in hk:
        metric = k.split("/")[1]
        if metric == "nonfinite_frac":
            assert got[k] == float(want[k]) == 0.0, k
        else:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=tol.get(metric, 1e-4),
                                       err_msg=k)


@pytest.fixture(scope="module")
def dalle_pair(tmp_path_factory):
    optim = dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5)
    jtr = JDalleTrainer(JDalleConfig(**TINY), _jtc(tmp_path_factory.mktemp("j"), optim),
                        mesh=build_mesh(JMeshConfig(), devices=jax.devices()[:1]))
    tr = DalleTrainer(DalleConfig(**TINY),
                      _tc(optim, checkpoint_dir=str(tmp_path_factory.mktemp("p")),
                          preflight_checkpoint=False), device="cpu")
    with torch.no_grad():
        tr.model.load_state_dict(dalle_state_dict(jax.device_get(jtr.state.params)))
    return jtr, tr


def test_dalle_train_step_health_columns_match_jax(dalle_pair):
    jtr, tr = dalle_pair
    for step in range(2):
        text, img = _dalle_batch(40 + step)
        want = jtr.train_step(text, img)
        got = tr.train_step(text, img)
        # grads: f32 sums in another order (1e-4); param norms after the
        # update: f32 (1e-5); the update ratio: Adam's first steps move an
        # element by ±lr whatever its gradient, so a near-zero gradient of
        # the other sign in the other framework moves |u| (1e-3)
        _assert_columns(got, want, {"grad_norm": 1e-4, "param_norm": 1e-5,
                                    "update_ratio": 1e-3})
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)


def test_traced_fit_matches_jax_spans_breakdown_and_prometheus(dalle_pair, tmp_path):
    """Four more steps of the two trainers through fit, traced, saving every
    2, the device gauges polled every step: the same span names (the
    asynchronous checkpoint writer's ``ckpt/drain`` among them), the same
    breakdown and gauge columns in each record, the same Prometheus names
    (the health gauges and ``ckpt.write_inflight`` among them)."""
    jtr, tr = dalle_pair
    jtr.train_cfg = dataclasses.replace(
        jtr.train_cfg, log_every=1, save_every_steps=2, device_prefetch=2,
        obs=dataclasses.replace(jtr.train_cfg.obs, trace=True, device_poll_every=1,
                                trace_dir=str(tmp_path / "jobs"),
                                prometheus_path=str(tmp_path / "j.prom")))
    tr.train_cfg = dataclasses.replace(
        tr.train_cfg, log_every=1, save_every_steps=2,
        obs=dataclasses.replace(tr.train_cfg.obs, trace=True, device_poll_every=1,
                                trace_dir=str(tmp_path / "obs"),
                                prometheus_path=str(tmp_path / "p.prom")))
    first = tr.step
    assert jtr._host_step == first
    jw, w = _Writer(), _Writer()
    jtr.fit(iter([_dalle_batch(80 + i) for i in range(6)]), steps=first + 4,
            log=lambda *a: None, metrics_writer=jw)
    tr.fit(iter([_dalle_batch(80 + i) for i in range(6)]), steps=first + 4,
           log=lambda *a: None, metrics_writer=w)

    def names(path):
        return {json.loads(line)["name"] for line in open(path)}
    want = names(tmp_path / "jobs" / "spans.jsonl")
    assert names(tmp_path / "obs" / "spans.jsonl") == want
    assert {"fit/step", "fit/batch_wait", "fit/dispatch", "fit/sync", "fit/checkpoint",
            "ckpt/snapshot", "ckpt/snapshot_good", "dalle/step", "data/h2d"} <= want
    doc = json.load(open(tmp_path / "obs" / "trace.json"))
    assert {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"} >= want - {"data/h2d"}

    steps = list(range(first + 1, first + 5))
    assert [s for s, _ in w.records] == [s for s, _ in jw.records] == steps
    for (step, got), (_, ref) in zip(w.records, jw.records):
        assert _breakdown(got) == _breakdown(ref), step
        assert {"t_batch_wait_s", "t_dispatch_s", "t_sync_s", "t_h2d_s"} <= _breakdown(got)
    assert "t_ckpt_s" in dict(w.records)[first + 3]      # the save at first + 2, a record late
    assert _prom_names(tmp_path / "p.prom") == _prom_names(tmp_path / "j.prom")
    assert ("dalle_ckpt_write_inflight", "gauge") in _prom_names(tmp_path / "p.prom")
    assert f"dalle_host_step {first + 4}" in open(tmp_path / "p.prom").read()
    assert 'dalle_health_grad_norm{layer_group="transformer"}' in open(tmp_path / "p.prom").read()


class _Writer:
    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append((step, dict(metrics)))


GAUGES = {"data_starvation", "hbm_bytes_in_use", "hbm_peak_bytes", "hbm_bytes_limit",
          "compiles_total", "recompiles_per_100_steps"}


def _breakdown(m):
    return {k for k in m if k.startswith("t_") or k in GAUGES}


def _prom_names(path):
    return {tuple(line.split()[2:4]) for line in open(path) if line.startswith("# TYPE")}


@pytest.fixture(scope="module")
def vae_pair(tmp_path_factory):
    optim = dict(optimizer="adam", learning_rate=1e-3)
    mesh = build_mesh(JMeshConfig(), devices=jax.devices()[:1])
    jtr = JVAETrainer(JDVAEConfig(**VAE), _jtc(tmp_path_factory.mktemp("jv"), optim), mesh=mesh)
    tr = VAETrainer(DVAEConfig(**VAE), _tc(optim), device="cpu")
    with torch.no_grad():
        tr.model.load_state_dict(dvae_state_dict(jax.device_get(jtr.state.params)))
    return jtr, tr


def test_vae_train_step_health_columns_match_jax(vae_pair, monkeypatch):
    """The JAX module draws its gumbel noise from its key; here its
    ``gumbel_softmax`` takes the drawn array instead, and the port's step
    the same array through ``noise``."""
    jtr, tr = vae_pair
    rng = np.random.RandomState(7)
    images = rng.rand(2, 16, 16, 3).astype(np.float32)
    noise = rng.gumbel(size=(2, 4, 4, VAE["num_tokens"])).astype(np.float32)

    def injected(key, logits, tau, hard=False, axis=-1):
        y_soft = jax.nn.softmax((logits + jnp.asarray(noise)) / tau, axis=axis)
        if not hard:
            return y_soft
        y_hard = jax.nn.one_hot(jnp.argmax(y_soft, axis), logits.shape[axis], axis=axis)
        return y_soft + jax.lax.stop_gradient(y_hard - y_soft)
    monkeypatch.setattr(jdvae_mod, "gumbel_softmax", injected)
    want = jtr.train_step(images)
    got = tr.train_step(images, torch.from_numpy(noise))
    _assert_columns(got, want, {"grad_norm": 1e-4, "param_norm": 1e-5, "update_ratio": 1e-3,
                                # the argmax's histogram: exact codes, f32 entropy
                                "codebook_perplexity": 1e-5, "codebook_dead_frac": 1e-6,
                                "codebook_usage_entropy": 1e-5, "gumbel_temp": 0,
                                # softmax and max over the same logits in f32
                                "st_sharpness": 1e-5, "encoder_confidence": 1e-5})
    for key in ("health/codebook_perplexity", "health/gumbel_temp", "health/st_sharpness",
                "health/encoder_confidence", "health/grad_norm/encoder"):
        assert key in got, key


@pytest.mark.parametrize("quantizer", ["vq", "gumbel"])
def test_vqgan_gan_step_health_columns_are_the_jax_ones(quantizer):
    """A ``gan`` step with health (both optimizers): the tree columns of
    the JAX groups, gen/ and disc/, the codebook vitals of the encode's
    VQOutput and, on the gumbel path, its temperature and confidence, as
    ``make_vqgan_train_step(health=True)`` emits them."""
    tr = VQGANTrainer(VQGANConfig(**VQ, quantizer=quantizer),
                      TrainConfig(batch_size=2, precision=PrecisionConfig(compute="float32"),
                                  obs=ObsConfig(health=True)),
                      GANLossConfig(disc_start=0, disc_num_layers=2, disc_ndf=8), device="cpu")
    images = np.random.RandomState(9).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    m = tr.train_step(images)
    want = (list(jhealth.layer_groups(_jax_tree("vqgan_gumbel" if quantizer == "gumbel"
                                                else "vqgan"), 1, "gen"))
            + list(jhealth.layer_groups(_jax_tree("disc"), 1, "disc")))
    for metric in ("grad_norm", "param_norm", "update_ratio", "nonfinite_frac"):
        got = [k.split("/", 2)[2] for k in m if k.startswith(f"health/{metric}/")]
        assert got == want, metric
    model_wide = {k for k in m if k.startswith("health/") and k.count("/") == 1}
    assert model_wide == {"health/codebook_perplexity", "health/codebook_dead_frac",
                          "health/codebook_usage_entropy"} | (
        {"health/gumbel_temp", "health/encoder_confidence"} if quantizer == "gumbel" else set())
    assert all(math.isfinite(v) for k, v in m.items() if k.startswith("health/"))


# ---------------------------------------------------------------------------
# health on ≡ off, bit for bit
# ---------------------------------------------------------------------------

ONOFF = {
    "adam_clip": dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5),
    "adamw_lr_scale": dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1),
    "sgd": dict(optimizer="sgd", learning_rate=0.1, grad_clip_norm=1.0),
    "adafactor": dict(optimizer="adafactor", learning_rate=1e-2),
    "adafactor_wd": dict(optimizer="adafactor", learning_rate=1e-2, weight_decay=0.01),
    "adam_accum_plateau": dict(optimizer="adam", learning_rate=1e-3, grad_accum_steps=2,
                               lr_scheduler="plateau"),
}


def _bits(t):
    return t.detach().view(torch.int32) if t.dtype == torch.float32 else t.detach()


@pytest.mark.parametrize("case", sorted(ONOFF))
def test_health_on_leaves_the_parameters_bitwise_equal(case):
    trainers = []
    for on in (False, True):
        tc = TrainConfig(batch_size=2, optim=OptimConfig(**ONOFF[case]),
                         precision=PrecisionConfig(compute="float32"),
                         runtime_lr_scale=case == "adamw_lr_scale", obs=ObsConfig(health=on))
        tr = DalleTrainer(DalleConfig(**TINY), tc, device="cpu")
        if case == "adamw_lr_scale":
            tr.set_lr_scale(0.5)
        for step in range(3):
            m = tr.train_step(*_dalle_batch(60 + step))
            assert any(k.startswith("health/") for k in m) == on
        trainers.append(tr)
    off, on = trainers
    for (name, a), (_, b) in zip(off.model.named_parameters(), on.model.named_parameters()):
        assert torch.equal(_bits(a), _bits(b)), name
    sd_off, sd_on = off.optimizer.state_dict(), on.optimizer.state_dict()
    for k, lst in sd_off["core"].items():
        for i, (a, b) in enumerate(zip(lst, sd_on["core"][k])):
            assert (a is None and b is None) or torch.equal(_bits(a), _bits(b)), (k, i)
    assert off.optimizer.taps is None and on.optimizer.taps is not None
    if case == "adam_accum_plateau":
        # the third call is an accumulation step: MultiSteps emits zeros
        assert not on.optimizer.taps.update_sq.any()


# ---------------------------------------------------------------------------
# detectors, sentry and actions against the JAX ones
# ---------------------------------------------------------------------------

def _sequence():
    """Metrics records that breach each detector, recover, and breach again."""
    recs = []
    for step in range(1, 15):
        m = {"loss": 2.0 - 0.01 * step,
             "health/grad_norm/transformer": 1.0, "health/grad_norm/text_emb": 0.5,
             "health/codebook_perplexity": 20.0,
             "health/nonfinite_frac/transformer": 0.0,
             "health/nonfinite_frac/text_emb": 0.0}
        if step == 7:
            m["loss"] = 9.0
        if step == 8:
            m["health/grad_norm/transformer"] = 50.0
            m["health/grad_norm/text_emb"] = 40.0
        if step in (9, 10):
            m["health/codebook_perplexity"] = 1.5
        if step == 11:
            m["health/nonfinite_frac/transformer"] = 0.25
        if step == 13:
            m["loss"] = float("nan")
        recs.append((step, m))
    return recs


@flax.struct.dataclass
class _JState:
    lr_scale: jnp.ndarray


class _JFake:
    def __init__(self):
        self.state = _JState(lr_scale=jnp.asarray(1.0, jnp.float32))
        self.health_sentry = None
        self.train_cfg = JTrainConfig(obs=JObsConfig(health=True, health_min_samples=3))
        self.calls = []

    def take_preemptive_snapshot(self):
        self.calls.append("snapshot")

    def _rollback(self):
        self.calls.append("rollback")

    def reanneal_gumbel(self, step):
        self.calls.append(("reanneal", step))


class _Fake:
    def __init__(self):
        self.optimizer = Optimizer(OptimConfig(), [torch.nn.Parameter(torch.zeros(2))],
                                   lr_scale=True)
        self.health_sentry = None
        self.train_cfg = TrainConfig(obs=ObsConfig(health=True, health_min_samples=3))
        self.calls = []

    def set_lr_scale(self, value):
        self.optimizer.set_lr_scale(value)

    def take_preemptive_snapshot(self):
        self.calls.append("snapshot")

    def _rollback(self):
        self.calls.append("rollback")

    def reanneal_gumbel(self, step):
        self.calls.append(("reanneal", step))


@pytest.mark.parametrize("cooldown", [0, 3])
def test_sentry_and_breach_actions_match_jax(cooldown):
    jobs.configure()
    obs.configure()
    jt, pt = _JFake(), _Fake()
    ja = JBreachActions(jt, lr_cut_factor=0.5, cooldown_steps=cooldown, log=lambda *a: None)
    pa = BreachActions(pt, lr_cut_factor=0.5, cooldown_steps=cooldown, log=lambda *a: None)
    ja.attach()
    pa.attach()
    for step, m in _sequence():
        jm, pm = dict(m), dict(m)
        jb = jt.health_sentry.observe(step, jm)
        pb = pt.health_sentry.observe(step, pm)
        assert [b.as_fields() for b in pb] == [b.as_fields() for b in jb], step
        assert pm.keys() == jm.keys() and all(
            pm[k] == jm[k] or (pm[k] != pm[k] and jm[k] != jm[k]) for k in pm), step
        assert float(pt.optimizer.lr_scale) == float(jt.state.lr_scale)
    assert pa.fired == ja.fired and pt.calls == jt.calls
    assert {"preemptive_snapshot", "rollback_lr_cut", "lr_cut_reanneal"} <= {
        f[1] for f in pa.fired} or cooldown
    want = {k: v for k, v in jobs.metrics_snapshot().items()
            if k.startswith(("health.", "actions."))}
    got = {k: v for k, v in obs.metrics_snapshot().items()
           if k.startswith(("health.", "actions."))}
    assert got == want


def test_detectors_alone_match_jax():
    for jd, pd in ((janomaly.LossSpikeDetector(min_samples=3), anomaly.LossSpikeDetector(min_samples=3)),
                   (janomaly.GradExplosionDetector(min_samples=3),
                    anomaly.GradExplosionDetector(min_samples=3)),
                   (janomaly.CodebookCollapseDetector(), anomaly.CodebookCollapseDetector()),
                   (janomaly.NaNPrecursorDetector(), anomaly.NaNPrecursorDetector())):
        for step, m in _sequence():
            assert ([b.as_fields() for b in pd.observe(step, m)]
                    == [b.as_fields() for b in jd.observe(step, m)]), (pd.name, step)
            assert pd.pop_recoveries() == jd.pop_recoveries()


def test_sentry_survives_a_detector_crash(capsys):
    class Broken(anomaly.Detector):
        name = "broken"

        def observe(self, step, metrics):
            raise RuntimeError("boom")
    s = anomaly.HealthSentry([Broken(), anomaly.NaNPrecursorDetector()])
    m = {"health/nonfinite_frac/transformer": 0.5}
    new = s.observe(3, m)
    assert [b.detector for b in new] == ["nan-precursor"]
    assert m["health/breach_detector"] == "nan-precursor"
    assert "detector broken failed" in capsys.readouterr().out
