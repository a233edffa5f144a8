"""The taming second stage against the JAX package on the CPU: the
permuters, minGPT (forward, prefill, cached decode), its sampler with the
JAX package's gumbel draws injected, the coordinate and SOS stages, and the
Net2Net transformer's loss and sampling over a VQGAN.

Weights are the port's, drawn from a seed and perturbed, and go to the JAX
modules through ``convert.state_dict_to_flax``; the JAX side runs jitted.
Tolerances (f32): logits within 1e-4 (summation order over O(1) values;
the cached decode attends through K2's plain version on the CPU, where the
JAX package's CPU path is dense), sampled tokens equal under the same
draws, images within 1e-5, losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import VQGANConfig as JVQGANConfig
from dalle_tpu.models import cond_transformer as jct
from dalle_tpu.models import mingpt as jgpt
from dalle_tpu.models.vqgan import VQModel as JVQModel
from dalle_tpu.ops import permuter as jperm
from dalle_tpu_torch.config import VQGANConfig
from dalle_tpu_torch.convert import gpt_state_dict, state_dict_to_flax
from dalle_tpu_torch.models import cond_transformer as ct
from dalle_tpu_torch.models.mingpt import GPTConfig, init_gpt, make_sampler
from dalle_tpu_torch.models.vqgan import init_vqgan
from dalle_tpu_torch.ops import permuter as perm

GPT = dict(vocab_size=16, block_size=128, n_layer=2, n_head=2, n_embd=32, n_unmasked=16)
VQ = dict(embed_dim=8, n_embed=16, z_channels=8, resolution=16, ch=8, ch_mult=(1, 2),
          num_res_blocks=1, attn_resolutions=(8,))


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


def _perturb(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return module


@pytest.mark.parametrize("kind", sorted(perm.PERMUTERS))
def test_permuter_tables_and_gathers_are_the_jax_packages(kind):
    mine, ref = perm.make_permuter(kind, 8, 8), jperm.make_permuter(kind, 8, 8)
    np.testing.assert_array_equal(mine.idx, ref.idx)
    np.testing.assert_array_equal(mine.inv, ref.inv)
    ids = np.random.RandomState(0).randint(0, 100, (2, 64))
    np.testing.assert_array_equal(mine(_t(ids)).numpy(), np.asarray(ref(jnp.asarray(ids))))
    assert torch.equal(mine(mine(_t(ids)), reverse=True), _t(ids))
    emb = torch.randn(2, 64, 3)
    assert torch.equal(mine(emb, axis=-2)[:, :, 0], mine(emb[:, :, 0]))


def test_permuters_refuse_a_wrong_axis_and_an_unknown_kind():
    with pytest.raises(ValueError, match="expected 64"):
        perm.make_permuter("zcurve", 8, 8)(torch.zeros(2, 63))
    with pytest.raises(ValueError, match="unknown permuter"):
        perm.make_permuter("hilbert", 8, 8)


@pytest.fixture(scope="module")
def gpt_pair():
    tm = _perturb(init_gpt(GPTConfig(**GPT), seed=0, device="cpu"), 1)
    jm = jgpt.GPT(jgpt.GPTConfig(**GPT))
    like = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((1, 4), jnp.int32)),
                          jax.random.PRNGKey(0))
    jp = state_dict_to_flax(tm.state_dict(), like)
    for k, v in gpt_state_dict(jp).items():
        assert torch.equal(v, tm.state_dict()[k]), k
    return jm, jp, tm


def test_gpt_forward_prefill_and_cached_decode_against_jax(gpt_pair):
    jm, jp, tm = gpt_pair
    idx = np.random.RandomState(1).randint(0, 16, (2, 24))

    emb = np.random.RandomState(4).randn(2, 3, 32).astype(np.float32)

    @jax.jit
    def ref(p, idx):
        full = jm.apply(p, idx)
        prepended = jm.apply(p, idx[:, :10], embeddings=jnp.asarray(emb))
        last, cache, n = jm.apply(p, idx[:, :20], jm.init_cache(2), method=jgpt.GPT.prefill)
        steps = []
        for i in range(20, 23):
            logits, cache = jm.apply(p, idx[:, i:i + 1], i, cache, method=jgpt.GPT.decode_one)
            steps.append(logits)
        return full, last, jnp.stack(steps, 1), prepended
    full, last, steps, prepended = jax.device_get(ref(jp, jnp.asarray(idx)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(idx)).numpy(), full, atol=1e-4)
        np.testing.assert_allclose(tm(_t(idx[:, :10]), embeddings=_t(emb)).numpy(), prepended,
                                   atol=1e-4)
        got_last, cache, n = tm.prefill(_t(idx[:, :20]), tm.init_cache(2))
        assert n == 20
        np.testing.assert_allclose(got_last.numpy(), last, atol=1e-4)
        for j, i in enumerate(range(20, 23)):
            logits, cache = tm.decode_one(_t(idx[:, i:i + 1]), i, cache)
            np.testing.assert_allclose(logits.numpy(), steps[:, j], atol=1e-4)
    with pytest.raises(ValueError, match="block_size"):
        tm(torch.zeros(1, 129, dtype=torch.long))


def _jax_draws(key, steps, shape):
    """The gumbel draws of the JAX package's sampler: one split a step."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return _t(np.stack(out))


def test_sampler_with_the_jax_draws_injected(gpt_pair):
    jm, jp, tm = gpt_pair
    prompt = np.random.RandomState(2).randint(0, 16, (3, 5))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jgpt.make_sampler(jm, 12, top_k=4, temperature=0.8, vocab_limit=12)(
        jp, jnp.asarray(prompt), key))
    got = make_sampler(tm, 12, top_k=4, temperature=0.8, vocab_limit=12)(
        _t(prompt), noise=_jax_draws(key, 12, (3, 16)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 5:].max() < 12
    with pytest.raises(ValueError, match="exceeds block_size"):
        make_sampler(tm, 124)(_t(prompt))


def test_coord_and_sos_stages_against_jax():
    c = np.random.RandomState(3).rand(2, 16, 16, 1).astype(np.float32)
    jq, jids = jct.CoordStage(16, 2).encode(jnp.asarray(c))
    q, ids = ct.CoordStage(16, 2).encode(_t(c))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ct.CoordStage(16, 2).decode(q).numpy(),
                               np.asarray(jct.CoordStage(16, 2).decode(jq)), atol=1e-7)
    _, sos = ct.SOSProvider(9).encode(_t(c))
    assert sos.tolist() == np.asarray(jct.SOSProvider(9).encode(jnp.asarray(c))[1]).tolist()


@pytest.fixture(scope="module")
def net2net(gpt_pair):
    jm, jp, tm = gpt_pair
    vq = _perturb(init_vqgan(VQGANConfig(**VQ), seed=3, device="cpu"), 4)
    jvq = JVQModel(JVQGANConfig(**VQ))
    like = jax.eval_shape(lambda k: jvq.init({"params": k}, jnp.zeros((1, 16, 16, 3))),
                          jax.random.PRNGKey(0))
    vqp = jax.tree.map(jnp.asarray, state_dict_to_flax(vq.state_dict(), like))
    permuter = perm.make_permuter("zcurve", 8, 8)
    coord = ct.CoordStage(16, 2)
    mine = ct.Net2NetTransformer.from_vqgan(GPTConfig(**GPT), vq, cond_encode=coord.encode,
                                            permuter=permuter, pkeep=0.7, gpt=tm)
    jcoord = jct.CoordStage(16, 2)
    ref = jct.Net2NetTransformer(
        jm, jax.jit(lambda x: jvq.apply(vqp, x, method=JVQModel.get_codebook_indices)),
        jax.jit(lambda ids: jvq.apply(vqp, ids, method=JVQModel.decode_code)),
        jcoord.encode, permuter=jperm.make_permuter("zcurve", 8, 8), pkeep=0.7,
        first_stage_vocab=16)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    c = rng.rand(2, 16, 16, 1).astype(np.float32)
    return ref, jp, mine, x, c


def test_net2net_loss_with_pkeep_1_and_with_injected_masks_against_jax(net2net):
    ref, jp, mine, x, c = net2net
    key = jax.random.PRNGKey(11)
    loss = jax.jit(lambda p, x, c, train: ref.loss(p, x, c, key=key, train=train),
                   static_argnums=3)
    with torch.no_grad():
        np.testing.assert_allclose(mine.loss(_t(x), _t(c), train=False).item(),
                                   float(loss(jp, x, c, False)), rtol=1e-5)
        # the JAX package's corruption: bernoulli and randint from the split key
        kmask, krand = jax.random.split(key)
        z = ref.encode_to_z(jnp.asarray(x))
        keep = np.asarray(jax.random.bernoulli(kmask, 0.7, z.shape))
        rand = np.asarray(jax.random.randint(krand, z.shape, 0, 16, jnp.int32))
        assert 0 < keep.mean() < 1
        got = mine.loss(_t(x), _t(c), masks=(_t(keep), _t(rand).long()))
    np.testing.assert_allclose(got.item(), float(loss(jp, x, c, True)), rtol=1e-5)
    with torch.no_grad():
        drawn = mine.loss(_t(x), _t(c), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn) and drawn.item() != got.item()


def test_net2net_sample_against_jax(net2net):
    ref, jp, mine, x, c = net2net
    key = jax.random.PRNGKey(13)
    want = np.asarray(ref.sample(jp, jnp.asarray(c), 64, key, top_k=5))
    images, z = mine.sample(_t(c), 64, top_k=5, noise=_jax_draws(key, 64, (2, 16)),
                            return_ids=True)
    np.testing.assert_allclose(images.numpy(), want, atol=1e-5)
    assert z.shape == (2, 64) and int(z.max()) < 16
    again = mine.sample(_t(c), 64, top_k=5, generator=torch.Generator().manual_seed(1))
    assert again.shape == (2, 16, 16, 3)
