"""The port's generation path ≡ the JAX package's: text ids → image tokens →
pixels, on the same converted weights (CPU, tiny shapes).

JAX's threefry and torch's Philox give different draws from one seed, so the
tests rebuild the JAX sampler's own gumbel draws (``k, sub = split(k)`` per
step, ``fold_in(key, n_steps)`` for the final token) and inject them into
the port: the tokens must then be equal, in f32, with and without CFG and
image priming. The pixels of the whole path agree within 1e-4 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.models.dvae import init_dvae as jinit_dvae
from dalle_tpu.models.wrapper import DalleWithVae as JDalleWithVae
from dalle_tpu.models.wrapper import DiscreteVAEAdapter as JAdapter
from dalle_tpu_torch import (DALLE, DalleConfig, DalleWithVae, DiscreteVAE,
                             DiscreteVAEAdapter, DVAEConfig, dalle_state_dict,
                             dvae_state_dict, init_dalle, init_dvae,
                             resolve_device)

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)
VAE = dict(image_size=16, num_tokens=48, codebook_dim=16, num_layers=2,
           hidden_dim=8)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def models():
    jm, jp = jinit_dalle(JDalleConfig(**TINY), jax.random.PRNGKey(0))
    jp = _perturb(jp)
    tm = DALLE(DalleConfig(**TINY))
    tm.load_state_dict(dalle_state_dict(jp))
    jv, jvp = jinit_dvae(JDVAEConfig(**VAE), jax.random.PRNGKey(1))
    jvp = _perturb(jvp, seed=1, scale=0.1)
    tv = DiscreteVAE(DVAEConfig(**VAE))
    tv.load_state_dict(dvae_state_dict(jvp))
    return (jm, jp, jv, jvp), (tm.eval(), tv.eval())


def jax_noise(key, n_steps, b, vocab):
    """The gumbel draws ``DALLE.generate_images_tokens`` makes, in order."""
    k, rows = key, []
    for _ in range(n_steps - 1):
        k, sub = jax.random.split(k)
        rows.append(jax.random.gumbel(sub, (b, vocab), jnp.float32))
    rows.append(jax.random.gumbel(jax.random.fold_in(key, n_steps), (b, vocab),
                                  jnp.float32))
    return torch.from_numpy(np.array(jnp.stack(rows)))


def _text(b=2, seed=0):
    rng = np.random.RandomState(seed)
    t = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"]))
    t[:, -1] = 0
    return t.astype(np.int32)


CASES = {"plain": dict(), "cfg": dict(cond_scale=3.0),
         "prime": dict(n_prime=3), "cfg_prime_hot": dict(cond_scale=2.0, n_prime=5,
                                                         temperature=0.5, filter_thres=0.8)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_equal_with_injected_noise(models, case):
    (jm, jp, _, _), (tm, _) = models
    kw = dict(CASES[case])
    n_prime = kw.pop("n_prime", 0)
    text = _text()
    b, n_img = text.shape[0], TINY["image_fmap_size"] ** 2
    prime = np.random.RandomState(5).randint(0, TINY["image_vocab_size"],
                                             (b, n_prime)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    ref = jm.apply(jp, jnp.asarray(text), key,
                   image_prime=jnp.asarray(prime) if n_prime else None,
                   method=JDALLE.generate_images_tokens, **kw)
    noise = jax_noise(key, n_img - n_prime, b, TINY["image_vocab_size"])
    out = tm.generate_images_tokens(torch.from_numpy(text), noise=noise,
                                    image_prime=torch.from_numpy(prime) if n_prime else None,
                                    **kw)
    assert out.shape == (b, n_img)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_images_pixels_match_jax(models):
    (jm, jp, jv, jvp), (tm, tv) = models
    text = _text(seed=3)
    key = jax.random.PRNGKey(11)
    jw = JDalleWithVae(jm, jp, JAdapter(jv, jvp))
    ref = np.asarray(jw.generate_images(jnp.asarray(text), key, cond_scale=2.0))
    tw = DalleWithVae(tm, DiscreteVAEAdapter(tv))
    noise = jax_noise(key, TINY["image_fmap_size"] ** 2, 2, TINY["image_vocab_size"])
    out = tw.generate_images(torch.from_numpy(text), noise=noise, cond_scale=2.0)
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_fast_precisions_run_and_keep_one_bf16_copy(models):
    """bf16 and bf16_int8kv generate finite images of the right shape from
    one cached bf16 copy of the weights; the f32 source is left as it was."""
    _, (tm, tv) = models
    tw = DalleWithVae(tm, DiscreteVAEAdapter(tv))
    text = torch.from_numpy(_text())
    for precision in ("bfloat16", "bf16_int8kv"):
        gen = torch.Generator().manual_seed(0)
        img = tw.generate_images(text, generator=gen, precision=precision)
        assert img.shape == (2, 16, 16, 3) and torch.isfinite(img).all()
    m1, dt1 = tw._resolve_precision("bfloat16")
    m2, dt2 = tw._resolve_precision("bf16_int8kv")
    assert m1 is m2 and m1 is not tm
    assert (dt1, dt2) == (torch.bfloat16, torch.int8)
    assert m1.to_logits.weight.dtype == torch.bfloat16
    assert tm.to_logits.weight.dtype == torch.float32


def test_same_generator_seed_same_tokens(models):
    _, (tm, _) = models
    text = torch.from_numpy(_text())
    a = tm.generate_images_tokens(text, generator=torch.Generator().manual_seed(3))
    b = tm.generate_images_tokens(text, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kw, err", [
    (dict(precision="int8w"), NotImplementedError),
    (dict(speculative=2), NotImplementedError),
    # priming itself is ported; priming under speculative decoding is not
    (dict(img=np.zeros((2, 16, 16, 3)), speculative=2), NotImplementedError),
    # CLIP reranking is ported: a clip that is not a models.clip.CLIP is refused
    (dict(clip=object()), TypeError),
    (dict(precision="fp8"), ValueError)])
def test_unported_generate_options_raise(models, kw, err):
    _, (tm, tv) = models
    tw = DalleWithVae(tm, DiscreteVAEAdapter(tv))
    with pytest.raises(err):
        tw.generate_images(torch.from_numpy(_text()), **kw)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_dalle(DalleConfig(**TINY))
    with pytest.raises(RuntimeError):
        init_dvae(DVAEConfig(**VAE))
    assert resolve_device("cpu") == torch.device("cpu")
    m = init_dalle(DalleConfig(**TINY), seed=4, device="cpu")
    m2 = init_dalle(DalleConfig(**TINY), seed=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))
    v = init_dvae(DVAEConfig(**VAE), seed=4, device="cpu")
    assert next(v.parameters()).device.type == "cpu"
