"""The port's VQGAN stack against the JAX package on the CPU: the VQModel,
the quantizers, the discriminator and GAN losses, LPIPS on the shipped
weights, and one two-optimizer trainer step.

Inputs are made with numpy from a seed. The weights are the port's, drawn
from a seed and perturbed, and go to the JAX modules through
``convert.state_dict_to_flax`` (the inverse of the maps in
``dalle_tpu_torch/convert.py``, which these tests hold too); the JAX
modules are built with ``jax.eval_shape`` and run jitted, so no JAX init is
compiled. Tolerances (f32):
1e-5 on O(1) activations and losses (summation order), indices equal where
the nearest code wins by more than 1e-4 (a near tie may fall either way in
two frameworks), 1e-5 absolute on parameters after one SGD step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_tpu.config import VQGANConfig as JVQGANConfig
from dalle_tpu.models import gan as jgan
from dalle_tpu.models.lpips import load_tiny_perceptual as jload_tiny_perceptual
from dalle_tpu.models.vqgan import VQModel as JVQModel
from dalle_tpu.ops import quantize as jq
from dalle_tpu.train.trainer_vqgan import GANTrainState
from dalle_tpu.train.trainer_vqgan import LambdaWarmUpCosineScheduler as JSched
from dalle_tpu.train.trainer_vqgan import make_vqgan_train_step
from dalle_tpu_torch.cli import train_vqgan
from dalle_tpu_torch.config import OptimConfig, PrecisionConfig, TrainConfig, VQGANConfig
from dalle_tpu_torch.convert import (disc_state_dict, lpips_state_dict, state_dict_to_flax,
                                     vqgan_state_dict)
from dalle_tpu_torch.models import gan
from dalle_tpu_torch.models.lpips import TINY_WEIGHTS, load_tiny_perceptual
from dalle_tpu_torch.models.vqgan import VQModel, init_vqgan
from dalle_tpu_torch.ops import quantize as q
from dalle_tpu_torch.train.checkpoints import CheckpointManager
from dalle_tpu_torch.train.trainer_vqgan import LambdaWarmUpCosineScheduler, VQGANTrainer

TINY = dict(embed_dim=8, n_embed=16, z_channels=8, resolution=32, ch=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(16,))
LOSS = dict(disc_start=0, disc_num_layers=2, disc_ndf=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """At these sizes torch's thread pool beside JAX's costs more than it
    gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, b=2, res=32):
    return np.random.RandomState(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


def _like(module, *args, **kw):
    """The abstract variables of a flax module (no compile)."""
    return jax.eval_shape(lambda k: module.init({"params": k, "gumbel": k}, *args, **kw),
                          jax.random.PRNGKey(0))


def _perturb(module, seed):
    """Every parameter moved by N(0, 0.05): biases and norms off 0 and 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return module


def _vq_pair(**kw):
    cfg = dict(TINY, **kw)
    tm = _perturb(init_vqgan(VQGANConfig(**cfg), device="cpu"), 0)
    jm = JVQModel(JVQGANConfig(**cfg))
    jp = state_dict_to_flax(tm.state_dict(), _like(jm, jnp.zeros((1, 32, 32, 3))))
    return jm, jp, tm


@pytest.fixture(scope="module")
def vq_pair():
    return _vq_pair()


def _clear_codes(z, codebook, margin=1e-4):
    """Where the nearest code wins by more than ``margin``."""
    d = ((z[..., None, :] - codebook) ** 2).sum(-1)
    top2 = np.sort(d, axis=-1)[..., :2]
    return top2[..., 1] - top2[..., 0] > margin


def test_config_dict_is_the_jax_packages():
    assert VQGANConfig(**TINY).to_dict() == JVQGANConfig(**TINY).to_dict()
    assert VQGANConfig().num_layers == JVQGANConfig().num_layers == 4


def test_vqmodel_encode_decode_and_codes_against_jax(vq_pair):
    jm, jp, tm = vq_pair
    x = _images(0)
    for k, v in vqgan_state_dict(jp).items():
        assert torch.equal(v, tm.state_dict()[k]), k

    @jax.jit
    def ref(p, x):
        out = jm.apply(p, x, method=JVQModel.encode)
        ids = out.indices.reshape(2, -1)
        return out, ids, jm.apply(p, ids, method=JVQModel.decode_code)
    jout, ids, jdec = jax.device_get(ref(jp, jnp.asarray(x)))
    with torch.no_grad():
        z = tm.quant_conv(tm.encoder(_t(x).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        tout = tm.encode(_t(x))
        dec = tm.decode_code(_t(ids).long())
        recon, loss, _ = tm(_t(x))
    np.testing.assert_allclose(tout.quantized.numpy(), jout.quantized, atol=1e-5)
    np.testing.assert_allclose(tout.loss.item(), float(jout.loss), rtol=1e-5)
    clear = _clear_codes(z.numpy(), jp["params"]["codebook"]["embedding"])
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tout.indices.numpy()[clear], jout.indices[clear])
    np.testing.assert_array_equal(tm.get_codebook_indices(_t(x)).numpy()[clear.reshape(2, -1)],
                                  ids[clear.reshape(2, -1)])
    np.testing.assert_allclose(dec.numpy(), jdec, atol=1e-5)
    # the forward decodes z + (z_q - z), z_q up to one rounding
    np.testing.assert_allclose(recon.numpy(), jdec, atol=1e-5)
    assert tm.fmap_size == 16


def test_vector_quantize_loss_and_straight_through_gradient():
    rng = np.random.RandomState(1)
    z, cb, w = rng.randn(2, 5, 5, 8), rng.randn(16, 8), rng.randn(2, 5, 5, 8)
    z, cb, w = (a.astype(np.float32) for a in (z, cb, w))

    def jloss(z, cb):
        out = jq.vector_quantize(z, cb, beta=0.3)
        return jnp.sum(out.quantized * w) + 2.0 * out.loss, out
    (jl, jout), (jgz, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(z), jnp.asarray(cb))
    tz, tc = _t(z).requires_grad_(), _t(cb).requires_grad_()
    out = q.vector_quantize(tz, tc, beta=0.3)
    (torch.sum(out.quantized * _t(w)) + 2.0 * out.loss).backward()
    clear = _clear_codes(z, cb)
    np.testing.assert_array_equal(out.indices.numpy()[clear], np.asarray(jout.indices)[clear])
    np.testing.assert_allclose(out.loss.item(), float(jout.loss), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), atol=1e-5)


@pytest.fixture(scope="module")
def gumbel_refs():
    """The JAX package's gumbel_quantize, hard and soft, and its draw, in
    one compile."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 4, 4, 16).astype(np.float32)
    cb = rng.randn(16, 8).astype(np.float32)
    key = jax.random.PRNGKey(5)

    @jax.jit
    def ref(lg, cb):
        return ({hard: jq.gumbel_quantize(key, lg, cb, tau=0.7, hard=hard, kl_weight=5e-4)
                 for hard in (True, False)}, jax.random.gumbel(key, lg.shape, jnp.float32))
    outs, noise = jax.device_get(ref(jnp.asarray(logits), jnp.asarray(cb)))
    return logits, cb, outs, noise


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_quantize_with_injected_noise(gumbel_refs, hard):
    logits, cb, outs, noise = gumbel_refs
    jout = outs[hard]
    out = q.gumbel_quantize(_t(logits), _t(cb), 0.7, hard, 5e-4, noise=_t(noise))
    np.testing.assert_allclose(out.quantized.numpy(), jout.quantized, atol=1e-5)
    np.testing.assert_array_equal(out.indices.numpy(), jout.indices)
    np.testing.assert_allclose(out.loss.item(), float(jout.loss), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(out.probs.numpy(), jout.probs, atol=1e-6)


def test_gumbel_vqmodel_quantize_deterministic_pass_against_jax():
    """The gumbel VQModel's quantizer in its deterministic pass: the JAX
    package draws from its fixed key (``deterministic_key()``), injected
    here as ``noise``."""
    jm, jp, tm = _vq_pair(quantizer="gumbel")
    h = np.random.RandomState(3).randn(2, 16, 16, 8).astype(np.float32)
    jout, noise = jax.jit(lambda p, h: (
        jm.apply(p, h, method=JVQModel.quantize),
        jax.random.gumbel(jax.random.PRNGKey(0), (2, 16, 16, 16), jnp.float32)))(
            jp, jnp.asarray(h))
    with torch.no_grad():
        tout = tm.quantize(_t(h).permute(0, 3, 1, 2), noise=_t(np.asarray(noise)))
    np.testing.assert_allclose(tout.quantized.numpy(), np.asarray(jout.quantized), atol=1e-5)
    np.testing.assert_array_equal(tout.indices.numpy(), np.asarray(jout.indices))
    np.testing.assert_allclose(tout.loss.item(), float(jout.loss), rtol=1e-4)


@pytest.mark.parametrize("unknown", ["extra", 1, "random"])
def test_remap_and_unmap_against_jax(unknown):
    used = (3, 7, 11, 42)
    idx = np.array([[3, 42, 7, 5], [11, 3, 11, 60]])
    want = np.asarray(jq.remap_indices(jnp.asarray(idx), used, unknown=unknown,
                                       key=jax.random.PRNGKey(0)))
    got = q.remap_indices(_t(idx), used, unknown=unknown).numpy()
    found = np.isin(idx, used)
    np.testing.assert_array_equal(got[found], want[found])
    if unknown == "random":
        assert ((got >= 0) & (got < len(used))).all()
        assert np.array_equal(got, q.remap_indices(_t(idx), used, unknown=unknown).numpy())
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(q.unmap_indices(_t(got), used).numpy(),
                                  np.asarray(jq.unmap_indices(jnp.asarray(got), used)))


def test_vqmodel_remap_interface_round_trips():
    cfg = VQGANConfig(**dict(TINY, remap_used=(0, 2, 5, 9, 13), remap_unknown="extra"))
    tm = init_vqgan(cfg, device="cpu")
    ids = tm.get_codebook_indices(_t(_images(4)))
    assert int(ids.max()) <= 5 and ids.shape == (2, 256)
    with torch.no_grad():
        assert torch.isfinite(tm.decode_code(ids)).all()


def test_discriminator_and_its_batch_stats_against_jax():
    x, x2 = _images(5), _images(6)
    disc = jgan.NLayerDiscriminator(ndf=8, n_layers=2)
    td = _perturb(gan.NLayerDiscriminator(8, 2).reset_parameters(torch.Generator().manual_seed(2)),
                  3)
    with torch.no_grad():
        td.norm_1.running_var.add_(0.5)
    variables = state_dict_to_flax(td.state_dict(), _like(disc, jnp.asarray(x), train=True))

    @jax.jit
    def ref(v, x2, x):
        out, upd = disc.apply(v, x2, train=True, mutable=["batch_stats"])
        return out, upd, disc.apply({"params": v["params"], **upd}, x, train=False)
    jout, upd, evaled = jax.device_get(ref(variables, jnp.asarray(x2), jnp.asarray(x)))
    before = {k: v.clone() for k, v in td.state_dict().items()}
    with torch.no_grad():
        np.testing.assert_allclose(td(_t(x2), update_stats=False).numpy(), jout, atol=1e-5)
        assert all(torch.equal(v, td.state_dict()[k]) for k, v in before.items())
        np.testing.assert_allclose(td(_t(x2)).numpy(), jout, atol=1e-5)
    want = disc_state_dict({"params": variables["params"], **upd})
    for k in ("norm_1.running_mean", "norm_1.running_var", "norm_2.running_var"):
        np.testing.assert_allclose(td.state_dict()[k].numpy(), want[k].numpy(), atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(td(_t(x), train=False).numpy(), evaled, atol=1e-5)


def test_actnorm_initializes_from_its_first_batch():
    x = _images(7)
    variables = jax.jit(jgan.ActNorm().init)(jax.random.PRNGKey(0), jnp.asarray(x))
    an = gan.ActNorm(3)
    with torch.no_grad():
        out = an(_t(x).permute(0, 3, 1, 2))
    want = jax.jit(jgan.ActNorm().apply)(variables, jnp.asarray(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    # a converted ActNorm counts as initialized: it keeps the JAX init
    converted = gan.ActNorm(3)
    sd = disc_state_dict({"params": {"n": jax.device_get(variables["params"])}})
    converted.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        again = converted(_t(_images(8)).permute(0, 3, 1, 2))
    want = jax.jit(jgan.ActNorm().apply)(variables, jnp.asarray(_images(8)))
    np.testing.assert_allclose(again.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(an.loc.detach().numpy(), np.asarray(variables["params"]["loc"]),
                               atol=1e-6)
    np.testing.assert_allclose(an.scale.detach().numpy(), np.asarray(variables["params"]["scale"]),
                               rtol=1e-5)


def test_discriminator_rejects_a_collapsing_resolution():
    with pytest.raises(ValueError, match="disc_num_layers"):
        gan.NLayerDiscriminator(8, 3)(torch.zeros(1, 16, 16, 3))


def test_gan_losses_and_gate_against_jax():
    rng = np.random.RandomState(8)
    real, fake = rng.randn(2, 3, 3, 1).astype(np.float32), rng.randn(2, 3, 3, 1).astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        np.testing.assert_allclose(getattr(gan, name)(_t(real), _t(fake)).item(),
                                   float(getattr(jgan, name)(real, fake)), rtol=1e-6)
    tgt = (rng.rand(2, 3, 3, 1) > 0.5).astype(np.float32)
    total, parts = gan.bce_with_quant_loss(_t(real), _t(tgt), torch.tensor(0.3), 2.0)
    jtotal, jparts = jgan.bce_with_quant_loss(real, tgt, jnp.float32(0.3), 2.0)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(parts["bce_loss"].item(), float(jparts["bce_loss"]), rtol=1e-6)
    for step in (0, 4, 5, 9):
        want = float(jgan.adopt_weight(0.7, step, 5))
        assert gan.adopt_weight(0.7, step, 5) == pytest.approx(want)


def test_adaptive_disc_weight_against_jax():
    """‖∂nll/∂w‖ / (‖∂g/∂w‖ + 1e-4) at a last conv, taken on the step's own
    graph in the port and by re-applying the conv in the JAX package."""
    rng = np.random.RandomState(9)
    h = rng.randn(2, 6, 6, 4).astype(np.float32)
    kernel = (rng.randn(3, 3, 4, 3) * 0.2).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    target = rng.randn(2, 6, 6, 3).astype(np.float32)

    def nll_of(r):
        return jnp.mean(jnp.abs(r - target))

    def g_of(r):
        return -jnp.mean(jnp.tanh(r) * 3.0)
    want = jax.jit(lambda h, k, b: jgan.adaptive_disc_weight(
        nll_of, g_of, h, {"kernel": k, "bias": b}, 0.8))(jnp.asarray(h), jnp.asarray(kernel),
                                                         jnp.asarray(bias))
    w = _t(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_()
    r = torch.nn.functional.conv2d(_t(h).permute(0, 3, 1, 2), w, _t(bias),
                                   padding=1).permute(0, 2, 3, 1)
    got = gan.adaptive_disc_weight(torch.mean(torch.abs(r - _t(target))),
                                   -torch.mean(torch.tanh(r) * 3.0), w, 0.8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert not got.requires_grad


def test_tiny_lpips_on_the_shipped_weights_against_jax():
    jm, jp = jload_tiny_perceptual()
    sd = lpips_state_dict(jax.device_get(jp))
    shipped = np.load(TINY_WEIGHTS)
    assert sorted(shipped.files) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(shipped[k], sd[k].numpy())
    tm = load_tiny_perceptual(device="cpu")
    x, y = _images(10), _images(11)
    np.testing.assert_allclose(tm(_t(x), _t(y)).numpy(),
                               np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5)
    assert float(tm(_t(x), _t(x)).abs().max()) == 0.0


def test_temperature_schedule_is_the_jax_packages():
    mine, ref = LambdaWarmUpCosineScheduler(10, 0.0, 1.0, 0.1, 110), JSched(10, 0.0, 1.0, 0.1, 110)
    for n in (0, 5, 10, 50, 110, 1000):
        assert mine(n) == pytest.approx(ref(n), abs=1e-12)


def _gan_trainer():
    tr = VQGANTrainer(VQGANConfig(**TINY),
                      TrainConfig(batch_size=2, precision=PrecisionConfig(compute="float32"),
                                  optim=OptimConfig(optimizer="sgd", learning_rate=0.05,
                                                    grad_clip_norm=0.0)),
                      gan.GANLossConfig(**LOSS), device="cpu")
    _perturb(tr.model, 4)
    _perturb(tr.disc, 5)
    return tr


def test_gan_step_with_the_discriminator_on_against_jax():
    """One ``gan`` step (disc_start 0: LPIPS, the adaptive weight and the
    discriminator all run) against ``make_vqgan_train_step`` on the same
    weights, f32, SGD: every metric, both networks' parameters after the
    update and the BatchNorm statistics."""
    pt = _gan_trainer()
    jm = JVQModel(JVQGANConfig(**TINY))
    disc = jgan.NLayerDiscriminator(ndf=8, n_layers=2)
    x = _images(12)
    gen_p = state_dict_to_flax(pt.model.state_dict(), _like(jm, jnp.asarray(x)))
    dv = state_dict_to_flax(pt.disc.state_dict(), _like(disc, jnp.asarray(x), train=True))
    lpips, lpips_p = jload_tiny_perceptual()
    state = GANTrainState.create(gen_params=gen_p, disc_params={"params": dv["params"]},
                                 lpips_params=lpips_p, batch_stats=dv["batch_stats"],
                                 gen_tx=optax.sgd(0.05), disc_tx=optax.sgd(0.05))
    step = make_vqgan_train_step(jm, disc, lpips, jgan.GANLossConfig(**LOSS))
    state, want = jax.device_get(step(state, jnp.asarray(x), jax.random.PRNGKey(0),
                                      jnp.float32(1.0)))
    got = pt.train_step(x)
    for k in ("loss", "disc_loss", "nll_loss", "g_loss", "quant_loss", "d_weight",
              "logits_real", "logits_fake"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for mine, ref in ((pt.model.state_dict(), vqgan_state_dict(state.params["gen"])),
                      (pt.disc.state_dict(), disc_state_dict(
                          {"params": state.params["disc"]["params"],
                           "batch_stats": state.batch_stats}))):
        for k, v in ref.items():
            np.testing.assert_allclose(mine[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["nodisc", "segmentation"])
def test_single_optimizer_modes_learn(mode):
    cfg = VQGANConfig(**dict(TINY, out_ch=4 if mode == "segmentation" else 3))
    tr = VQGANTrainer(cfg, TrainConfig(batch_size=2, optim=OptimConfig(learning_rate=3e-3)),
                      device="cpu", loss_mode=mode)
    x = _images(13)
    rng = np.random.RandomState(0)
    tgt = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 32, 32))] if mode != "nodisc" else None
    first = tr.train_step(x, tgt)["nll_loss"]
    for _ in range(2):
        m = tr.train_step(x, tgt)
    assert m["nll_loss"] < first and tr.disc is None
    assert tr.get_codebook_indices(x).shape == (2, 256)


def test_train_vqgan_cli_trains_saves_and_resumes(tmp_path):
    argv = ["--synthetic", "--resolution", "32", "--ch", "8", "--ch_mult", "1,2",
            "--n_embed", "16", "--embed_dim", "8", "--z_channels", "8", "--disc_num_layers",
            "2", "--disc_ndf", "8", "--batch_size", "2", "--disc_start", "0",
            "--output_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--sample_every_steps", "2", "--sample_dir", str(tmp_path / "s")]
    assert train_vqgan.main(argv + ["--steps", "2"]) == 0
    mgr = CheckpointManager(str(tmp_path / "ck"))
    meta = mgr.load_metadata()
    assert meta["model_class"] == "VQModel" and meta["hparams"]["n_embed"] == 16
    assert (tmp_path / "s" / "step2_recon.png").exists()
    state, _ = mgr.restore(map_location="cpu")
    assert {"model", "disc", "disc_optimizer", "optimizer", "generator"} <= set(state)
    assert train_vqgan.main(argv + ["--steps", "3", "--resume"]) == 0
    assert mgr.latest_step() == 3
    # ported since: --image_folder trains on a folder of images the test writes
    from dalle_tpu_torch.data.image_codec import write_png
    folder = tmp_path / "data" / "shapes"
    folder.mkdir(parents=True)
    for i in range(2):
        write_png(str(folder / f"im{i}.png"),
                  np.random.RandomState(i).randint(0, 256, (40, 36, 3)).astype(np.uint8))
    argv = [a for a in argv if a != "--synthetic"] + ["--output_dir", str(tmp_path / "f")]
    assert train_vqgan.main(argv + ["--steps", "1", "--image_folder",
                                    str(tmp_path / "data")]) == 0
    assert CheckpointManager(str(tmp_path / "f")).latest_step() == 1


def test_nan_rollback_restores_the_discriminator_too():
    pt = _gan_trainer()
    pt._snapshot_good()
    disc_before = {k: v.clone() for k, v in pt.disc.state_dict().items()}
    pt.train_step(_images(14))
    assert not all(torch.equal(v, pt.disc.state_dict()[k]) for k, v in disc_before.items())
    pt._rollback()
    for k, v in disc_before.items():
        assert torch.equal(v, pt.disc.state_dict()[k]), k


def test_health_taps_raise_until_ported():
    """Ported since: the taps of an encode's VQOutput, codebook vitals from
    its indices and, on the gumbel path, the temperature and confidence."""
    x = _t(_images(15))
    for quantizer in ("vq", "gumbel"):
        model = VQModel(VQGANConfig(**TINY, quantizer=quantizer))
        q = model.encode(x, 0.5)
        taps = model.health_taps(q, 0.5)
        assert 1.0 <= taps["health/codebook_perplexity"].item() <= TINY["n_embed"]
        assert ("health/gumbel_temp" in taps) == (quantizer == "gumbel")
        if quantizer == "gumbel":
            assert taps["health/gumbel_temp"].item() == 0.5
