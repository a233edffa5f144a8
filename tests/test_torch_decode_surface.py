"""The port's decode surface ≡ the JAX package's: the speculative sampler,
text generation, int8 weights end to end and the int8w engine (CPU, the
tiny config of ``tests/test_speculative.py``; token shift is
``tests/test_torch_token_shift.py``).

JAX's threefry and torch's Philox give different draws from one seed, so
the tests rebuild the JAX samplers' own draws and inject them: the
speculative sampler's per-(step, row) fold-in keys as its (n_steps, b, V)
table, text generation's split chain plus ``fold_in(key, n_new)`` for the
last token. The tokens must then be equal. Tolerance: int8w logits 5e-2
of the largest |logit| (bf16 weights and activations in both, rounded at
other points; int8 weights and caches bit for bit the same values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.ops.quantize_weights import quantize_params_int8 as jquantize_params
from dalle_tpu.ops.sampling import top_p_filter as jtop_p
from dalle_tpu_torch import DalleConfig, DalleWithVae, dalle_state_dict
from dalle_tpu_torch.convert import flax_to_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops.quantize_weights import quantize_params_int8
from dalle_tpu_torch.ops.sampling import gumbel_noise, top_k_filter, top_p_filter
from dalle_tpu_torch.serve import DecodeEngine, RequestQueue

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
N_STEPS = CFG["image_fmap_size"] ** 2
VOCAB = CFG["image_vocab_size"]
TEXT = np.array([[3, 4, 5, 0, 0, 0], [7, 8, 0, 0, 0, 0]], np.int32)
FMAP = CFG["image_fmap_size"]


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


@functools.lru_cache(maxsize=None)
def _pair(**kw):
    """(JAX model, perturbed params, the port's model on them), one per config."""
    cfg = {**CFG, **kw}
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0), batch=2)
    jp = _perturb(jp)
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def jax_noise(key, n_steps, b, vocab):
    """The gumbel draws of the JAX sequential samplers, in order: the split
    chain, then ``fold_in(key, n_steps)`` for the last token."""
    k, rows = key, []
    for _ in range(n_steps - 1):
        k, sub = jax.random.split(k)
        rows.append(jax.random.gumbel(sub, (b, vocab), jnp.float32))
    rows.append(jax.random.gumbel(jax.random.fold_in(key, n_steps), (b, vocab), jnp.float32))
    return torch.from_numpy(np.array(jnp.stack(rows)))


# ---------------------------------------------------------------------------
# the speculative sampler
# ---------------------------------------------------------------------------

def spec_noise(key, b):
    """(n_steps, b, V): the JAX sampler's draw for (step t, row r),
    gumbel(fold_in(fold_in(key, t), r))."""
    return torch.from_numpy(np.array(jnp.stack([
        jnp.stack([jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(key, t), r),
                                     (VOCAB,), jnp.float32) for r in range(b)])
        for t in range(N_STEPS)])))


SPEC_CASES = [pytest.param(g, d, c, id=f"g{g}-{d}-{c}",
                           marks=[pytest.mark.slow] if d == "repeat" else [])
              for g in (0, 1, 3) for d in ("row", "repeat") for c in ("float32", "int8")
              if not (g == 0 and d == "repeat")]


@pytest.mark.parametrize("gamma, draft, cache", SPEC_CASES)
def test_speculative_equals_jax(gamma, draft, cache):
    """Tokens and (rounds, committed) equal the JAX sampler's under its own
    draws, and equal the port's gamma=0 tokens."""
    jm, jp, tm = _pair()
    key = jax.random.PRNGKey(42)
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    ref, jr, jc = jm.apply(jp, jnp.asarray(TEXT), key, gamma=gamma, draft=draft,
                           cache_dtype=jdt, return_stats=True,
                           method=JDALLE.generate_images_tokens_speculative)
    noise = spec_noise(key, 2)
    out, rounds, committed = tm.generate_images_tokens_speculative(
        _t(TEXT), gamma=gamma, draft=draft, noise=noise, cache_dtype=tdt, return_stats=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (rounds, committed) == (int(jr), int(jc))
    assert committed == 2 * N_STEPS and 1 <= rounds <= N_STEPS
    seq = tm.generate_images_tokens_speculative(_t(TEXT), gamma=0, noise=noise,
                                                cache_dtype=tdt)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


def test_speculative_axial_posemb_equals_jax():
    jm, jp, tm = _pair(rotary_emb=False)
    key = jax.random.PRNGKey(7)
    ref = jm.apply(jp, jnp.asarray(TEXT), key, gamma=2,
                   method=JDALLE.generate_images_tokens_speculative)
    out = tm.generate_images_tokens_speculative(_t(TEXT), gamma=2, noise=spec_noise(key, 2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("gamma", [1, 2, 3])
def test_speculative_with_a_generator_is_gamma_invariant(gamma):
    """The draw table comes from the generator up front, so gamma moves no
    token."""
    _, _, tm = _pair()
    seq = tm.generate_images_tokens_speculative(
        _t(TEXT), gamma=0, generator=torch.Generator().manual_seed(9))
    spec = tm.generate_images_tokens_speculative(
        _t(TEXT), gamma=gamma, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(spec.numpy(), seq.numpy())


def test_speculative_errors_are_the_jax_packages():
    jm, jp, tm = _pair()
    with pytest.raises(AssertionError, match="'row' draft needs gamma"):
        jm.apply(jp, jnp.asarray(TEXT), jax.random.PRNGKey(0), gamma=FMAP,
                 method=JDALLE.generate_images_tokens_speculative)
    with pytest.raises(ValueError, match="'row' draft needs gamma"):
        tm.generate_images_tokens_speculative(_t(TEXT), gamma=FMAP)
    jms, jps, tms = _pair(shift_tokens=True)
    with pytest.raises(AssertionError, match="does not support shift_tokens"):
        jms.apply(jps, jnp.asarray(TEXT), jax.random.PRNGKey(0), gamma=1,
                  method=JDALLE.generate_images_tokens_speculative)
    with pytest.raises(ValueError, match="does not support shift_tokens"):
        tms.generate_images_tokens_speculative(_t(TEXT), gamma=1)
    wrapper = DalleWithVae(tm, None)
    for kw in (dict(cond_scale=2.0), ):
        with pytest.raises(ValueError, match="cond_scale=1.0 and no image priming"):
            wrapper.generate_images(_t(TEXT), speculative=2, **kw)


# ---------------------------------------------------------------------------
# text generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix, kw", [(2, dict(filter_thres=0.8, temperature=0.7)),
                                        (None, {}), (4, dict(shift_tokens=True))],
                         ids=["prefix2_hot", "none", "shift"])
def test_generate_texts_equals_jax(prefix, kw):
    model_kw = {k: v for k, v in kw.items() if k == "shift_tokens"}
    samp = {k: v for k, v in kw.items() if k != "shift_tokens"}
    jm, jp, tm = _pair(**model_kw)
    key = jax.random.PRNGKey(3)
    text = None if prefix is None else TEXT[:, :prefix]
    b = 2
    start = 0 if text is None else text.shape[1]
    n_new = CFG["text_seq_len"] - start
    ref = jm.apply(jp, key, None if text is None else jnp.asarray(text), batch=b,
                   method=JDALLE.generate_texts_tokens, **samp)
    noise = jax_noise(key, n_new, b, tm.num_text_tokens)
    out = tm.generate_texts_tokens(None if text is None else _t(text), batch=b, noise=noise,
                                   **samp)
    assert out.shape == (b, CFG["text_seq_len"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out < tm.num_text_tokens).all()
    with pytest.raises(ValueError, match="shorter than text_seq_len"):
        tm.generate_texts_tokens(_t(TEXT))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.999])
def test_top_p_filter_equals_jax(top_p):
    logits = np.random.RandomState(int(top_p * 1000)).standard_normal((4, 50)).astype(np.float32)
    logits[0, :3] = 2.5                                      # a tie at the top
    want = np.asarray(jtop_p(jnp.asarray(logits), top_p))
    got = top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# int8 weights end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("share", [False, True], ids=["untied", "tied"])
def test_int8w_decode_logits_within_bf16_of_jax(share):
    """The JAX package's int8w tree through the converter: the port's prefill
    and four teacher-forced decode steps over an int8 cache give logits
    within 5e-2 of the largest |logit| of the JAX package's int8w model."""
    jm, jp, _ = _pair(share_input_output_emb=share)
    jq = jquantize_params(jp)
    tq = DALLE(DalleConfig(**CFG, share_input_output_emb=share)).to(torch.bfloat16)
    tq.load_state_dict(dalle_state_dict(jq))
    tq.eval()
    assert tq.compute_dtype == torch.bfloat16
    img = np.random.RandomState(0).randint(0, VOCAB, (2, 4)).astype(np.int32)

    def close(j, t):
        j = np.asarray(jnp.asarray(j, jnp.float32))
        t = t.float().numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-2 * np.abs(j).max())

    plen = CFG["text_seq_len"] + 1
    jl, jc = jax.jit(lambda p, t: jm.apply(p, t, None, 2, jnp.int8,
                                           method=JDALLE._prefill)[:2])(jq, jnp.asarray(TEXT))
    step = jax.jit(lambda p, tok, i, c: jm.apply(p, tok, i, plen + i, c,
                                                 method=JDALLE._decode_one))
    with torch.no_grad():
        tl, tc, tplen = tq._prefill(_t(TEXT), None, 2, torch.int8)
        assert tplen == plen
        close(jl, tl)
        for i in range(4):
            jl, jc = step(jq, jnp.asarray(img[:, i]), i, jc)
            tl, tc = tq._decode_one(_t(img[:, i]), i, plen + i, tc)
            close(jl, tl)


def test_int8w_precision_mode_and_its_derived_models():
    """generate_images(precision="int8w") runs on the int8w copy; the bf16
    copy lives beside it; a new source model drops both."""
    _, _, tm = _pair()
    tw = DalleWithVae(tm, None)
    m8, dt8 = tw._resolve_precision("int8w")
    mb, dtb = tw._resolve_precision("bf16_int8kv")
    assert (dt8, dtb) == (torch.int8, torch.int8) and m8 is not mb
    assert m8.transformer.attn_0.to_qkv.weight.dtype == torch.int8
    assert m8.to_logits.weight.dtype == torch.int8 and m8.compute_dtype == torch.bfloat16
    assert mb.to_logits.weight.dtype == torch.bfloat16
    assert tw._resolve_precision("int8w")[0] is m8 and tw._resolve_precision("bfloat16")[0] is mb
    toks = m8.generate_images_tokens(_t(TEXT), generator=torch.Generator().manual_seed(1),
                                     cache_dtype=torch.int8)
    spec = m8.generate_images_tokens_speculative(
        _t(TEXT), gamma=2, generator=torch.Generator().manual_seed(1), cache_dtype=torch.int8)
    assert toks.shape == spec.shape == (2, N_STEPS)
    tw.model = DALLE(DalleConfig(**CFG)).eval()
    assert tw._resolve_precision("int8w")[0] is not m8


def _engine_run(eng, texts, base):
    q = RequestQueue()
    for i, t in enumerate(texts):
        q.submit(text=t, seed=base + i, request_id=i, cond_scale=2.0 if i == 2 else 1.0)
    q.close()
    return {c.request_id: c.tokens for c in eng.run(q)}


ENGINE_TEXTS = [TEXT[0], TEXT[1], np.array([9, 1, 2, 3, 0, 0], np.int32)]


@pytest.mark.parametrize("kw", [dict(), dict(kv_block_tokens=4)], ids=["dense", "paged"])
def test_int8_weight_engine_equals_sequential_generation(kw):
    """int8 weights at f32 compute over an f32 cache (every attention path
    then computes in f32): each request's tokens, a CFG pair's included,
    equal the same model's sequential generate_images_tokens under the
    request's generator, bit for bit; the W8 plain version gives a row the
    same bits whatever the row count."""
    _, _, tm = _pair()
    m8 = quantize_params_int8(tm, compute_dtype=None)
    assert m8.to_logits.is_int8 and m8.compute_dtype == torch.float32
    eng = DecodeEngine(m8, slots=2, cache_dtype=torch.float32, device="cpu", **kw)
    got = _engine_run(eng, ENGINE_TEXTS, 30)
    for i, t in enumerate(ENGINE_TEXTS):
        ref = m8.generate_images_tokens(
            _t(t[None]), generator=torch.Generator().manual_seed(30 + i),
            cond_scale=2.0 if i == 2 else 1.0)[0]
        np.testing.assert_array_equal(got[i], ref.numpy(), err_msg=f"request {i}")


# a first divergence of the int8w engine from sequential generation must be
# a near-tie: within 2^-5 of the largest |logit| (a few bf16 roundings of
# the logits through two layers, doubled by the CFG merge at scale 2)
NEAR_TIE = 2.0 ** -5


def _request_draws(seed):
    """A request's draws as its engine generator gives them: one (1, V) row
    per token, in order."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([gumbel_noise((1, VOCAB), generator=g) for _ in range(N_STEPS)])


def _near_tie(m, text, toks, t, other, cond_scale, noise):
    """(gap, largest |logit|) at step t of sequential int8w generation,
    teacher-forced on ``toks[:t]`` over an int8 cache: the least of the gap
    between the scores of ``toks[t]`` and ``other`` and the gaps of either
    token's logit to the top-k cut."""
    with torch.no_grad():
        logits, cache, plen = m._prefill(text, None, 1, torch.int8)
        if cond_scale != 1.0:
            nl, ncache, _ = m._prefill(torch.zeros_like(text), None, 1, torch.int8)
            logits = nl + (logits - nl) * cond_scale
        for i in range(t):
            logits, cache = m._decode_one(toks[i:i + 1], i, plen + i, cache)
            if cond_scale != 1.0:
                nl, ncache = m._decode_one(toks[i:i + 1], i, plen + i, ncache)
                logits = nl + (logits - nl) * cond_scale
    band = logits[0, m.num_text_tokens:].float()
    kept = top_k_filter(band, thres=0.5)
    kth = kept[torch.isfinite(kept)].min()
    score = band + noise[t, 0]
    a, z = int(toks[t]), int(other)
    gap = min(abs(score[a] - score[z]).item(), abs(band[a] - kth).item(),
              abs(band[z] - kth).item())
    return gap, band.abs().max().item()


@pytest.mark.parametrize("base", [30, 50])
@pytest.mark.parametrize("kw", [dict(), dict(kv_block_tokens=4)], ids=["dense", "paged"])
def test_int8w_engine_pinned_equals_sequential_generation(kw, base):
    """The int8w engine pinned to the dense attend (``use_kernel=False``)
    against sequential int8w generation pinned alike, under each request's
    draws: equal tokens, the CFG request's included, as the JAX package
    promises under the pin (``dalle_tpu/models/dalle.py:290-296``)."""
    _, _, tm = _pair()
    eng = DalleWithVae(tm, None).serve_engine(slots=2, use_kernel=False, **kw)
    m8 = eng.model
    got = _engine_run(eng, ENGINE_TEXTS, base)
    for i, t in enumerate(ENGINE_TEXTS):
        ref = m8.generate_images_tokens(_t(t[None]), noise=_request_draws(base + i),
                                        cond_scale=2.0 if i == 2 else 1.0,
                                        cache_dtype=torch.int8, use_kernel=False)[0]
        np.testing.assert_array_equal(got[i], ref.numpy(), err_msg=f"request {i}")


@pytest.mark.parametrize("base", [30, 50])
@pytest.mark.parametrize("kw", [dict(), dict(kv_block_tokens=4)], ids=["dense", "paged"])
def test_int8w_engine_against_sequential_generation(kw, base):
    """The int8w engine (the default: int8 weights, bf16 compute, an int8
    cache) under ``auto`` against sequential int8w generation under each
    request's draws: the reference's TPU caveat
    (``dalle_tpu/models/dalle.py:290-296``), which the port shows on the
    CPU too. The engine attends through K3/K5's plain version, which rounds
    q·scale and p to bf16; the sequential path's dense prefill rounds at
    other points and K2 keeps f32, and the CFG merge doubles the
    difference. So each request's tokens equal the sequential ones up to
    its first divergence, which must be a near-tie (``NEAR_TIE``); on these
    draws the CFG request diverges. Pinned, the two are equal
    (``test_int8w_engine_pinned_equals_sequential_generation``)."""
    _, _, tm = _pair()
    eng = DalleWithVae(tm, None).serve_engine(slots=2, **kw)
    m8 = eng.model
    got = _engine_run(eng, ENGINE_TEXTS, base)
    diverged = []
    for i, t in enumerate(ENGINE_TEXTS):
        cond_scale = 2.0 if i == 2 else 1.0
        noise = _request_draws(base + i)
        ref = m8.generate_images_tokens(_t(t[None]), noise=noise, cond_scale=cond_scale,
                                        cache_dtype=torch.int8)[0]
        diff = np.flatnonzero(ref.numpy() != got[i])
        if diff.size:
            step = int(diff[0])
            gap, scale = _near_tie(m8, _t(t[None]), ref, step, got[i][step], cond_scale,
                                   noise)
            assert gap <= NEAR_TIE * scale, (i, step, gap, scale)
            diverged.append(i)
    assert diverged == [2], f"the known mismatch moved: requests {diverged} diverge"


def test_int8w_is_the_engines_default_and_paged_equals_dense():
    """``serve_engine`` defaults to int8w (the int8w model, an int8 cache);
    the paged engine gives the dense engine's tokens, per request. (Against
    sequential generation the bf16 modes are not bit for bit: the engine's
    windowed attention rounds q·scale and p to bf16 where the sequential
    prefill and K2 keep f32.)"""
    _, _, tm = _pair()
    wrapper = DalleWithVae(tm, None)
    dense = wrapper.serve_engine(slots=2)
    paged = wrapper.serve_engine(slots=2, kv_block_tokens=4)
    m8, _ = wrapper._resolve_precision("int8w")
    assert dense.model is m8 and paged.model is m8 and dense.cache_dtype == torch.int8
    a = _engine_run(dense, ENGINE_TEXTS, 30)
    b = _engine_run(paged, ENGINE_TEXTS, 30)
    assert sorted(a) == sorted(b) == [0, 1, 2]
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
        assert a[rid].shape == (N_STEPS,) and (a[rid] >= 0).all() and (a[rid] < VOCAB).all()
