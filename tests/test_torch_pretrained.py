"""Pretrained import from local files, against the JAX package on the CPU:
taming's yaml and checkpoint through ``VQGanVAE``, OpenAI's pickles through
``OpenAIDiscreteVAE``, and DALL·E over a VQGAN from the command line.

Checkpoints are written here in the upstream layouts from seeded numpy
weights (no download). Tolerances (f32): token ids equal where the nearest
code wins by more than 1e-4, decoded pixels within 1e-5; the OpenAI
encoder's ids equal where the best logit leads by more than 1e-4, the
decoder's pixels within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dalle_tpu.config import VQGANConfig as JVQGANConfig
from dalle_tpu.models import pretrained as jpre
from dalle_tpu.models.vqgan import VQModel as JVQModel
from dalle_tpu_torch.cli import _common, generate, train_dalle
from dalle_tpu_torch.data import image_codec
from dalle_tpu_torch.config import VQGANConfig
from dalle_tpu_torch.convert import state_dict_to_flax
from dalle_tpu_torch.models import pretrained as pre
from dalle_tpu_torch.models.vqgan import init_vqgan
from dalle_tpu_torch.train.checkpoints import CheckpointManager

TINY = dict(embed_dim=8, n_embed=16, z_channels=8, resolution=32, ch=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(16,))

TAMING_YAML = """\
model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.VQModel   # the autoencoder
  params:
    embed_dim: 8
    n_embed: 16
    monitor: val/rec_loss
    ddconfig:
      double_z: false
      z_channels: 8
      resolution: 32
      in_channels: 3
      out_ch: 3
      ch: 8
      ch_mult:
      - 1
      - 2
      num_res_blocks: 1
      attn_resolutions: [16]
      dropout: 0.0
    lossconfig:
      target: taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator
      params:
        disc_conditional: false
        disc_start: 250001
        disc_weight: 0.8
        codebook_weight: 1.0
        ckpt_path: null
        name: 'a # not a comment'
data:
  target: main.DataModuleFromConfig
  params:
    batch_size: 12
    wrap: true
    train:
      target: taming.data.imagenet.ImageNetTrain
      params:
        config:
          size: 256
"""


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


def test_yaml_reader_equals_safe_load_on_taming_configs():
    assert pre.read_yaml(TAMING_YAML) == yaml.safe_load(TAMING_YAML)
    inline = "a: [1, 2.5, x]\nb:\n  - 'q'\n  - null\nc: ~\nd: TRUE\n"
    assert pre.read_yaml(inline) == yaml.safe_load(inline)
    for bad in ("a:\n  - b: 1\n", "a: |\n  text\n", "a: {b: 1}\n"):
        with pytest.raises(ValueError):
            pre.read_yaml(bad)


def test_vqgan_config_from_yaml_is_the_jax_packages(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(TAMING_YAML)
    cfg = pre.vqgan_config_from_yaml(str(path))
    assert cfg.to_dict() == jpre.vqgan_config_from_yaml(str(path)).to_dict()
    assert cfg == VQGANConfig(**TINY)
    gumbel = TAMING_YAML.replace("taming.models.vqgan.VQModel", "taming.models.vqgan.GumbelVQ")
    path.write_text(gumbel.replace("    n_embed: 16\n",
                                   "    n_embed: 16\n    kl_weight: 1.0e-08\n"))
    cfg = pre.vqgan_config_from_yaml(str(path))
    assert cfg.quantizer == "gumbel" and cfg.gumbel_kl_weight == 1e-8
    assert cfg.to_dict() == jpre.vqgan_config_from_yaml(str(path)).to_dict()


def _taming_state(seed=0):
    """A random taming ``VQModel`` state_dict (upstream names, NCHW) over the
    tiny config, with the loss's keys beside it as a real checkpoint has."""
    rng = np.random.RandomState(seed)
    model = init_vqgan(VQGANConfig(**TINY), device="cpu")
    renames = {}
    state = {}
    for key, v in model.state_dict().items():
        up = key
        for lvl in range(2):
            for i in range(2):
                up = up.replace(f"down_{lvl}_block_{i}.", f"down.{lvl}.block.{i}.")
                up = up.replace(f"up_{lvl}_block_{i}.", f"up.{lvl}.block.{i}.")
                up = up.replace(f"down_{lvl}_attn_{i}.", f"down.{lvl}.attn.{i}.")
                up = up.replace(f"up_{lvl}_attn_{i}.", f"up.{lvl}.attn.{i}.")
            up = up.replace(f"down_{lvl}_downsample.", f"down.{lvl}.downsample.")
            up = up.replace(f"up_{lvl}_upsample.", f"up.{lvl}.upsample.")
        up = up.replace(".mid_", ".mid.").replace("codebook.weight", "quantize.embedding.weight")
        renames[up] = key
        w = rng.randn(*v.shape)
        if v.dim() == 4:               # kernels at std 1/sqrt(fan-in): O(1) activations
            w = w / np.sqrt(np.prod(v.shape[1:]))
        elif ".norm" in key and key.endswith("weight"):
            w = 1.0 + 0.1 * w
        elif v.dim() == 1:
            w = 0.1 * w
        state[up] = torch.from_numpy(w.astype(np.float32))
    state["loss.discriminator.main.0.weight"] = torch.zeros(4, 3, 4, 4)
    return state, renames


def test_taming_names_map_onto_every_tensor_of_the_model():
    state, renames = _taming_state()
    for up, key in renames.items():
        assert pre.taming_key(up) == key, up
    model = init_vqgan(VQGANConfig(**TINY), device="cpu")
    converted = pre.convert_vqgan_state(state, model)
    assert set(converted) == set(model.state_dict())
    del state["encoder.conv_in.weight"]
    with pytest.raises(KeyError, match="lacks 1"):
        pre.convert_vqgan_state(state, model)


@pytest.fixture(scope="module")
def taming_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("taming")
    state, _ = _taming_state()
    torch.save({"state_dict": state, "global_step": 7}, str(d / "last.ckpt"))
    (d / "model.yaml").write_text(TAMING_YAML)
    return str(d / "last.ckpt"), str(d / "model.yaml"), state


def test_vqgan_vae_from_a_taming_checkpoint_against_jax(taming_files):
    ckpt, cfg_path, state = taming_files
    vae = pre.VQGanVAE.from_pretrained(ckpt, cfg_path, device="cpu")
    assert (vae.image_size, vae.num_layers, vae.num_tokens, vae.image_fmap_size) == (32, 1, 16, 16)
    jcfg = JVQGANConfig(**TINY)
    jm = JVQModel(jcfg)
    like = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((1, 32, 32, 3))),
                          jax.random.PRNGKey(0))
    jparams = jpre.convert_vqgan_state({k: v.numpy() for k, v in state.items()},
                                       state_dict_to_flax(vae.model.state_dict(), like), jcfg)
    jvae = jpre.VQGanVAE(jcfg, params=jparams)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jvae.get_codebook_indices(jnp.asarray(x)))
    got = vae.get_codebook_indices(x).numpy()
    with torch.no_grad():
        z = vae.model.quant_conv(vae.model.encoder(_t(2 * x - 1).permute(0, 3, 1, 2)))
    d = ((z.permute(0, 2, 3, 1).reshape(2, -1, 1, 8) - vae.model.codebook.weight) ** 2).sum(-1)
    top2 = torch.sort(d, dim=-1).values[..., :2]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    images = vae.decode(_t(want).long()).numpy()
    np.testing.assert_allclose(images, np.asarray(jvae.decode(jnp.asarray(want))), atol=1e-5)
    assert images.min() >= 0.0 and images.max() <= 1.0


def _openai_modules(seed):
    """OpenAI's encoder and decoder as the ``dall_e`` package pickles them
    (``blocks.group_g.block_b.res_path.conv_i.{w,b}``, ``id_path``,
    ``blocks.output.conv``), built from the stub classes at a tiny size:
    8 hidden, one block a group, 32 codes."""
    pre.install_dall_e_stubs()
    enc_mod, dec_mod, utils = (sys.modules[m] for m in
                               ("dall_e.encoder", "dall_e.decoder", "dall_e.utils"))
    rng = np.random.RandomState(seed)

    def conv(n_in, n_out, k):
        c = utils.Conv2d()
        w = rng.randn(n_out, n_in, k, k) / np.sqrt(n_in * k * k)
        c.w = torch.nn.Parameter(_t(w.astype(np.float32)))
        c.b = torch.nn.Parameter(_t((rng.randn(n_out) * 0.1).astype(np.float32)))
        return c

    def block(cls, n_in, n_out):
        blk = cls()
        blk.id_path = conv(n_in, n_out, 1) if n_in != n_out else torch.nn.Identity()
        blk.res_path = torch.nn.Sequential()
        hid = n_out // 4
        for i, (a, b, k) in enumerate(((n_in, hid, 3), (hid, hid, 3), (hid, hid, 3),
                                       (hid, n_out, 1)), start=1):
            blk.res_path.add_module(f"relu_{i}", torch.nn.ReLU())
            blk.res_path.add_module(f"conv_{i}", conv(a, b, k))
        return blk

    def stack(top, cls, first, mults, n_in, n_out_ch, last_k):
        top.blocks = torch.nn.Sequential()
        top.blocks.add_module("input", first)
        ch = n_in
        for g in range(1, 5):
            grp = torch.nn.Sequential()
            grp.add_module("block_1", block(cls, ch, 8 * mults[g]))
            ch = 8 * mults[g]
            top.blocks.add_module(f"group_{g}", grp)
        out = torch.nn.Sequential()
        out.add_module("relu", torch.nn.ReLU())
        out.add_module("conv", conv(ch, n_out_ch, last_k))
        top.blocks.add_module("output", out)
        return top

    enc = stack(enc_mod.Encoder(), enc_mod.EncoderBlock, conv(3, 8, 7), (1, 1, 2, 4, 8), 8, 32, 1)
    dec = stack(dec_mod.Decoder(), dec_mod.DecoderBlock, conv(32, 8, 1), (0, 8, 4, 2, 1), 8, 6, 1)
    return enc, dec


def test_openai_dvae_from_local_pickles_against_jax(tmp_path):
    enc, dec = _openai_modules(0)
    torch.save(enc, str(tmp_path / "encoder.pkl"))
    torch.save(dec, str(tmp_path / "decoder.pkl"))
    arch = dict(encoder=pre.OpenAIEncoder(8, 1, 32), image_size=32,
                decoder=pre.OpenAIDecoder(8, 8, 1, 3, 32))
    vae = pre.OpenAIDiscreteVAE.from_pretrained(str(tmp_path), device="cpu", **arch)
    assert (vae.num_tokens, vae.image_fmap_size) == (32, 4)
    jenc = jpre.OpenAIEncoder(n_hid=8, n_blk_per_group=1, vocab_size=32)
    jdec = jpre.OpenAIDecoder(n_hid=8, n_init=8, n_blk_per_group=1)
    ep = jpre._convert_openai_state({k: v.detach().numpy() for k, v in enc.state_dict().items()},
                                    jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3))))
    dp = jpre._convert_openai_state({k: v.detach().numpy() for k, v in dec.state_dict().items()},
                                    jax.eval_shape(jdec.init, jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 4, 4, 32))))
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    logits = np.asarray(jax.jit(jenc.apply)(ep, jpre.map_pixels(jnp.asarray(x))))
    want = logits.argmax(-1).reshape(2, -1)
    top2 = np.sort(logits, axis=-1)[..., -2:].reshape(2, -1, 2)
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    got = vae.get_codebook_indices(x).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    z = jax.nn.one_hot(want, 32).reshape(2, 4, 4, 32)
    pixels = jpre.unmap_pixels(jax.nn.sigmoid(jax.jit(jdec.apply)(dp, z)[..., :3]))
    np.testing.assert_allclose(vae.decode(_t(want).long()).numpy(), np.asarray(pixels),
                               atol=1e-5)
    # plain state-dict files load too
    torch.save(enc.state_dict(), str(tmp_path / "encoder.pkl"))
    again = pre.OpenAIDiscreteVAE.from_pretrained(str(tmp_path), device="cpu", **dict(
        arch, encoder=pre.OpenAIEncoder(8, 1, 32), decoder=pre.OpenAIDecoder(8, 8, 1, 3, 32)))
    assert torch.equal(again.get_codebook_indices(x), vae.get_codebook_indices(x))


@pytest.mark.parametrize("flags", [["--taming"], ["--vqgan_model_path", "m.ckpt"], []],
                         ids=["taming", "model_path_without_yaml", "openai"])
def test_pretrained_vaes_without_local_files_raise_naming_the_flags(flags):
    args = train_dalle.build_parser().parse_args(["--synthetic"] + flags)
    with pytest.raises(FileNotFoundError, match="--vqgan_config_path.*--openai_vae_dir"):
        _common.build_vae_from_args(args, "cpu")


def test_dalle_over_a_taming_vqgan_from_the_command_line(taming_files, tmp_path):
    """``train_dalle`` and ``generate`` with ``--vqgan_model_path`` and
    ``--vqgan_config_path``: the checkpoint records the VQGAN, and the
    images are the VQGAN's decode of the sampled tokens."""
    ckpt, cfg_path, _ = taming_files
    vq = ["--vqgan_model_path", ckpt, "--vqgan_config_path", cfg_path, "--device", "cpu"]
    out = str(tmp_path / "dalle")
    assert train_dalle.main(["--synthetic", "--image_size", "32", "--dim", "32", "--depth", "1",
                             "--heads", "2", "--dim_head", "16", "--text_seq_len", "8",
                             "--batch_size", "2", "--steps", "1", "--output_dir", out] + vq) == 0
    meta = CheckpointManager(out).load_metadata()
    assert meta["vae_class_name"] == "VQGanVAE" and meta["vae_hparams"]["n_embed"] == 16
    assert meta["hparams"]["image_vocab_size"] == 16 and meta["hparams"]["image_fmap_size"] == 16
    gen_dir = str(tmp_path / "gen")
    assert generate.main(["--dalle_path", out, "--text", "a red circle", "--num_images", "2",
                          "--batch_size", "2", "--outputs_dir", gen_dir] + vq) == 0
    written = sorted(os.path.join(d, f) for d, _, fs in os.walk(gen_dir) for f in fs)
    assert len(written) == 2
    assert image_codec.read_png(written[0]).shape == (32, 32, 3)
    with pytest.raises(ValueError, match="trained with VQGanVAE"):
        generate.main(["--dalle_path", out, "--text", "x", "--untrained_vae", "--image_size",
                       "32", "--device", "cpu", "--outputs_dir", gen_dir])
