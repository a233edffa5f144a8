"""The port's token shift ≡ the JAX package's (CPU, the tiny config of
``tests/test_speculative.py``).

Token shift is data movement: ``shift_tokens_full``,
``shift_prefill_state`` and ``shift_decode_step`` equal the JAX package's
bit for bit, f32 and a bf16 ring beside f32 activations (the int8 cache's
case). A shifted model's loss and every gradient match ``jax.grad`` within
1e-5 absolute and 1e-4 relative (f32, summation order only); its cached
decode equals its forward (f32, 1e-4); its generated tokens equal the JAX
package's under the JAX sampler's own draws, injected.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models import transformer as jtr
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu_torch import DalleConfig, dalle_state_dict
from dalle_tpu_torch.convert import flax_to_state_dict
from dalle_tpu_torch.models import transformer as ttr
from dalle_tpu_torch.models.dalle import DALLE

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
N_STEPS = CFG["image_fmap_size"] ** 2
VOCAB = CFG["image_vocab_size"]
TEXT = np.array([[3, 4, 5, 0, 0, 0], [7, 8, 0, 0, 0, 0]], np.int32)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


@functools.lru_cache(maxsize=None)
def _pair(**kw):
    """(JAX model, perturbed params, the port's model on them), one per config."""
    cfg = {**CFG, **kw, "shift_tokens": True}
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0), batch=2)
    jp = _perturb(jp)
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


TEXT_LEN = CFG["text_seq_len"] + 1
FMAP = CFG["image_fmap_size"]


@pytest.mark.parametrize("n", [TEXT_LEN - 3, TEXT_LEN, TEXT_LEN + 5, TEXT_LEN + N_STEPS])
def test_shift_tokens_full_and_prefill_state_bit_for_bit(n):
    x = np.random.RandomState(n).standard_normal((2, n, 32)).astype(np.float32)
    want = np.asarray(jtr.shift_tokens_full(jnp.asarray(x), TEXT_LEN, FMAP))
    got = ttr.shift_tokens_full(torch.from_numpy(x), TEXT_LEN, FMAP).numpy()
    np.testing.assert_array_equal(got, want)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        js = jtr.shift_prefill_state(jnp.asarray(x), TEXT_LEN, FMAP,
                                     jtr.ShiftState.init(2, FMAP, 8, jdt))
        ts = ttr.shift_prefill_state(torch.from_numpy(x), TEXT_LEN, FMAP,
                                     ttr.ShiftState.init(2, FMAP, 8, tdt))
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
            assert b.dtype == tdt


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_shift_decode_steps_bit_for_bit(state_dtype):
    """A prefill of 3 positions, then one decode step at every later
    position through the text band and the whole image grid: each shifted
    token and each state equal the JAX package's (a bf16 state beside f32
    activations is the int8 cache's case)."""
    jdt, tdt = ((jnp.float32, torch.float32) if state_dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    x = np.random.RandomState(1).standard_normal((2, TEXT_LEN + N_STEPS, 32)).astype(np.float32)
    js = jtr.shift_prefill_state(jnp.asarray(x[:, :3]), TEXT_LEN, FMAP,
                                 jtr.ShiftState.init(2, FMAP, 8, jdt))
    ts = ttr.shift_prefill_state(torch.from_numpy(x[:, :3]), TEXT_LEN, FMAP,
                                 ttr.ShiftState.init(2, FMAP, 8, tdt))
    for off in range(3, x.shape[1]):
        jy, js = jtr.shift_decode_step(jnp.asarray(x[:, off:off + 1]), js, off, TEXT_LEN, FMAP)
        ty, ts = ttr.shift_decode_step(torch.from_numpy(x[:, off:off + 1]), ts, off,
                                       TEXT_LEN, FMAP)
        assert ty.dtype == torch.float32
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy), err_msg=f"offset {off}")
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, CFG["num_text_tokens"], (2, CFG["text_seq_len"]))
    text[:, -2:] = 0
    img = rng.randint(0, VOCAB, (2, N_STEPS))
    return text.astype(np.int32), img.astype(np.int32)


def test_shifted_model_loss_and_gradients_match_jax():
    jm, jp, tm = _pair()
    text, img = _batch()
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(text), jnp.asarray(img), return_loss=True),
        has_aux=True))(jp)
    ref = flax_to_state_dict(jax.device_get(jgrad))
    tm.zero_grad()
    loss, _ = tm(_t(text), _t(img), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-4)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    tm.zero_grad()


@pytest.mark.parametrize("kw", [dict(), dict(rotary_emb=False), dict(shared_ff_ids=(0, 0))],
                         ids=["rotary", "axial", "shared_ff"])
def test_shifted_cached_decode_equals_the_forward(kw):
    """Prefill of the text, then every image token one decode step at a time
    (teacher-forced): each position's logits equal the uncached forward's
    (f32, 1e-4); layers that share a function keep their own shift state."""
    _, _, tm = _pair(**kw)
    text, img = _batch(2)
    with torch.no_grad():
        full = tm(_t(text), _t(img))
        logits, cache, plen = tm._prefill(_t(text), None, 2)
        np.testing.assert_allclose(logits.numpy(), full[:, plen - 1].numpy(), atol=1e-4)
        assert "shift_attn_1" in cache and "shift_ff_0" in cache
        for i in range(N_STEPS - 1):
            logits, cache = tm._decode_one(_t(img[:, i]), i, plen + i, cache)
            np.testing.assert_allclose(logits.numpy(), full[:, plen + i].numpy(),
                                       atol=1e-4, err_msg=f"image position {i}")


def jax_noise(key, n_steps, b, vocab):
    """The gumbel draws of the JAX sequential samplers, in order: the split
    chain, then ``fold_in(key, n_steps)`` for the last token."""
    k, rows = key, []
    for _ in range(n_steps - 1):
        k, sub = jax.random.split(k)
        rows.append(jax.random.gumbel(sub, (b, vocab), jnp.float32))
    rows.append(jax.random.gumbel(jax.random.fold_in(key, n_steps), (b, vocab), jnp.float32))
    return torch.from_numpy(np.array(jnp.stack(rows)))


@pytest.mark.parametrize("cond_scale", [2.0])
def test_shifted_generation_equals_jax(cond_scale):
    jm, jp, tm = _pair()
    key = jax.random.PRNGKey(5)
    ref = jm.apply(jp, jnp.asarray(TEXT), key, cond_scale=cond_scale,
                   method=JDALLE.generate_images_tokens)
    out = tm.generate_images_tokens(_t(TEXT), cond_scale=cond_scale,
                                    noise=jax_noise(key, N_STEPS, 2, VOCAB))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_shifted_int8_cache_keeps_bf16_rings():
    _, _, tm = _pair()
    cache = tm.transformer.init_cache(2, 20, torch.int8)
    assert cache["kv_0"].kv.dtype == torch.int8
    assert all(cache[f"shift_{r}_{i}"].top.dtype == torch.bfloat16
               for r in ("attn", "ff") for i in range(CFG["depth"]))
    out = tm.generate_images_tokens(_t(TEXT), generator=torch.Generator().manual_seed(0),
                                    cache_dtype=torch.int8)
    assert out.shape == (2, N_STEPS) and (out >= 0).all() and (out < VOCAB).all()
