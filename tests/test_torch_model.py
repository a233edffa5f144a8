"""The port's DALLE, transformer pieces and dVAE decoder ≡ the JAX package's
on the same converted weights (CPU, tiny shapes).

Every JAX parameter is perturbed by seeded noise before conversion, so zero
biases and unit norms cannot hide a mapping error. Tolerances: f32 logits
and pixels ≤ 1e-4 absolute (only summation order differs); caches in bf16
are looser, with the reason at the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.models import transformer as jtr
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.models.dvae import init_dvae as jinit_dvae
from dalle_tpu_torch.config import DalleConfig, DVAEConfig
from dalle_tpu_torch.convert import (dalle_state_dict, dvae_state_dict,
                                     flax_to_state_dict)
from dalle_tpu_torch.models import transformer as ttr
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.dvae import DiscreteVAE

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


def dalle_pair(**kw):
    cfg = {**TINY, **kw}
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0))
    jp = _perturb(jp)
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


def _inputs(cfg, b=2, seed=1):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg["num_text_tokens"], (b, cfg["text_seq_len"]))
    text[:, -2:] = 0                                   # pads → per-position ids
    img = rng.randint(0, cfg["image_vocab_size"], (b, cfg["image_fmap_size"] ** 2))
    return text.astype(np.int32), img.astype(np.int32)


VARIANTS = {
    "rotary_untied": {},
    "tied": dict(share_input_output_emb=True),
    "axial_pos": dict(rotary_emb=False),
    "every_mask": dict(depth=5, sparse_block_size=4, sparse_attn_kernel=3,
                       attn_types=("full", "axial_row", "axial_col",
                                   "conv_like", "sparse")),
    "sandwich_shared": dict(depth=3, sandwich_norm=True, shared_attn_ids=(0, 1, 0),
                            shared_ff_ids=(0, 0, 1)),
    "stable": dict(stable=True),
    "bf16_scores_flag": dict(attn_softmax_f32=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_jax(variant):
    jm, jp, tm = dalle_pair(**VARIANTS[variant])
    cfg = {**TINY, **VARIANTS[variant]}
    text, img = _inputs(cfg)
    ref = np.asarray(jm.apply(jp, jnp.asarray(text), jnp.asarray(img)))
    with torch.no_grad():
        out = tm(torch.from_numpy(text).long(), torch.from_numpy(img).long()).numpy()
    assert out.shape == ref.shape == (2, cfg["text_seq_len"] + cfg["image_fmap_size"] ** 2,
                                      tm.total_tokens)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_state_dict_maps_every_parameter_once():
    """Shared layers appear once in both trees; nothing is left over."""
    _, jp, tm = dalle_pair(**VARIANTS["sandwich_shared"])
    sd = dalle_state_dict(jp)
    assert set(sd) == set(tm.state_dict())
    assert "transformer.attn_2.to_qkv.weight" not in sd        # shared with attn_0
    assert sd["transformer.layer_attn_0.scale"].shape == (1, 1, 64)
    assert sd["transformer.attn_0.to_qkv.weight"].shape == (3 * 64, 64)
    # an int8-weight tree (ported): every kernel's scales become its
    # weight_scale; an unknown quant leaf is refused
    from dalle_tpu.ops.quantize_weights import quantize_params_int8
    qsd = flax_to_state_dict(quantize_params_int8(jp))
    scales = {k for k in qsd if k.endswith(".weight_scale")}
    assert set(qsd) == set(sd) | scales and scales
    for k in scales:
        w = qsd[k[:-len("_scale")]]
        assert w.dtype == torch.int8 and qsd[k].shape == (w.shape[0],)
    with pytest.raises(ValueError, match="unexpected quant leaf"):
        flax_to_state_dict({"params": jp["params"], "quant": {"x": {"bogus": np.zeros(1)}}})


def test_layer_norm_epsilon_and_tanh_gelu_match_flax():
    """flax LayerNorm's eps is 1e-6 (torch's default 1e-5) and jax.nn.gelu is
    the tanh form: small-variance inputs and large gate values expose both."""
    import flax.linen as fnn
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((2, 5, 64)) * 1e-3).astype(np.float32)
    ln = fnn.LayerNorm()
    p = _perturb(ln.init(jax.random.PRNGKey(0), x))
    layer = ttr.TransformerLayer(64, 1)
    layer.norm.load_state_dict(flax_to_state_dict(p))
    np.testing.assert_allclose(layer.norm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ln.apply(p, x)), atol=1e-5)

    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    ff = jtr.GEGLUFeedForward(64, 2)
    p = _perturb(ff.init(jax.random.PRNGKey(1), x))
    tff = ttr.GEGLUFeedForward(64, 2)
    tff.load_state_dict(flax_to_state_dict(p))
    np.testing.assert_allclose(tff(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ff.apply(p, x)), atol=1e-4)


def test_unported_transformer_options_raise():
    # reversible blocks are ported: the model builds and runs the coupling
    # (tests/test_torch_reversible.py holds it against the JAX package)
    rev = DALLE(DalleConfig(**TINY, reversible=True))
    assert rev.transformer.cfg.reversible
    # token shift is ported: its model builds with a shift in every layer
    shifted = DALLE(DalleConfig(**TINY, shift_tokens=True))
    layers = [m for m in shifted.modules() if isinstance(m, ttr.TransformerLayer)]
    assert len(layers) == 2 * TINY["depth"] and all(m.shift for m in layers)


def _jax_steps(jm, jp, text, img, dtype):
    """The JAX package's prefill logits, then each decode step's logits,
    feeding ``img`` as the sampled tokens."""
    b = text.shape[0]
    logits, cache, plen = jm.apply(jp, jnp.asarray(text), None, b, dtype,
                                   method=JDALLE._prefill)
    out = [np.asarray(logits)]
    for i in range(img.shape[1] - 1):
        logits, cache = jm.apply(jp, jnp.asarray(img[:, i]), i, plen + i, cache,
                                 method=JDALLE._decode_one)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def _port_steps(tm, text, img, dtype):
    b = text.shape[0]
    with torch.no_grad():
        logits, cache, plen = tm._prefill(torch.from_numpy(text).long(), None, b, dtype)
        out = [logits]
        for i in range(img.shape[1] - 1):
            logits, cache = tm._decode_one(torch.from_numpy(img[:, i]).long(), i,
                                           plen + i, cache)
            out.append(logits)
    return torch.stack(out, 1).float().numpy()


# f32 and int8 caches: both sides attend in f32 (the JAX dense path
# dequantizes int8 in the f32 query dtype), 1e-4. bf16 cache: the JAX dense
# path rounds the attention probabilities to bf16 before the AV product, the
# port's kernel keeps them in f32: bf16's error, 3e-2.
STEP_CASES = {"f32": (jnp.float32, torch.float32, 1e-4, {}),
              "int8": (jnp.int8, torch.int8, 1e-4, {}),
              "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, {}),
              "f32_axial_conv": (jnp.float32, torch.float32, 1e-4,
                                 dict(attn_types=("axial_row", "conv_like"),
                                      sparse_attn_kernel=3)),
              "f32_tied_axial_pos": (jnp.float32, torch.float32, 1e-4,
                                     dict(share_input_output_emb=True,
                                          rotary_emb=False))}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_prefill_and_decode_logits_match_jax(case):
    jdt, tdt, tol, kw = STEP_CASES[case]
    jm, jp, tm = dalle_pair(**kw)
    text, img = _inputs({**TINY, **kw})
    ref = _jax_steps(jm, jp, text, img, jdt)
    out = _port_steps(tm, text, img, tdt)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("attn_types", [("full",), ("axial_col", "conv_like")])
def test_cached_decode_equals_full_forward(attn_types):
    """The port against itself: cached decode logits at every image position
    equal the uncached forward's (f32, 1e-4)."""
    _, _, tm = dalle_pair(attn_types=attn_types, sparse_attn_kernel=3)
    text, img = _inputs({**TINY})
    steps = _port_steps(tm, text, img, torch.float32)
    with torch.no_grad():
        full = tm(torch.from_numpy(text).long(), torch.from_numpy(img).long()).numpy()
    t = TINY["text_seq_len"]
    np.testing.assert_allclose(steps, full[:, t:], atol=1e-4, rtol=0)


DVAE_CASES = {
    "default_shape": dict(image_size=32, num_tokens=64, codebook_dim=32,
                          num_layers=2, hidden_dim=16),
    "no_resblocks": dict(image_size=16, num_tokens=32, codebook_dim=24,
                         num_layers=2, hidden_dim=8, num_resnet_blocks=0),
    "three_layers_two_blocks": dict(image_size=32, num_tokens=16, codebook_dim=8,
                                    num_layers=3, hidden_dim=8, num_resnet_blocks=2),
}


@pytest.mark.parametrize("case", sorted(DVAE_CASES))
def test_dvae_decode_pixels_match_jax(case):
    """Holds the ConvTranspose mapping (flipped kernel, padding 1) and the
    NHWC layout against flax."""
    kw = DVAE_CASES[case]
    jm, jp = jinit_dvae(JDVAEConfig(**kw), jax.random.PRNGKey(0))
    jp = _perturb(jp, scale=0.1)
    tm = DiscreteVAE(DVAEConfig(**kw))
    tm.load_state_dict(dvae_state_dict(jp))
    fmap = kw["image_size"] // 2 ** kw["num_layers"]
    ids = np.random.RandomState(3).randint(0, kw["num_tokens"], (2, fmap * fmap))
    ref = np.asarray(jm.apply(jp, jnp.asarray(ids), method=JDiscreteVAE.decode))
    with torch.no_grad():
        out = tm.decode(torch.from_numpy(ids)).numpy()
    assert out.shape == ref.shape == (2, kw["image_size"], kw["image_size"], 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
