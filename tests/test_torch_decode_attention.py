"""The port's attention ops ≡ the JAX package's, on the same numpy inputs.

Covers the decode kernel's plain version (``dalle_tpu_torch.ops.
decode_attention.decode_attend_plain``, what ``decode_attend`` runs for a
CPU tensor) against the Pallas kernel in interpret mode and against the
dense ``cached_attend``; the merged ``KVCache`` (append, int8 quantization,
read_kv); ``attend``; rotary; the static masks; sampling. The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops import attention as jattn
from dalle_tpu.ops import attn_masks as jmasks
from dalle_tpu.ops import rotary as jrot
from dalle_tpu.ops import sampling as jsamp
from dalle_tpu.ops.decode_attention import decode_attend_kernel
from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import attn_masks as tmasks
from dalle_tpu_torch.ops import decode_attention as tdec
from dalle_tpu_torch.ops import rotary as trot
from dalle_tpu_torch.ops import sampling as tsamp

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _caches(rng, b, h, S, d, dt):
    """The same random keys/values appended to a JAX and a port cache."""
    jdt, tdt = DTYPES[dt]
    k = rng.standard_normal((b, h, S, d)).astype(np.float32)
    v = rng.standard_normal((b, h, S, d)).astype(np.float32)
    jc = jattn.KVCache.init(b, h, S, d, jdt).append(jnp.asarray(k), jnp.asarray(v), 0)
    tc = tattn.KVCache.init(b, h, S, d, tdt, device="cpu").append(
        torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


# ---------------------------------------------------------------------------
# KVCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_kv_cache_append_and_read_match_jax(dt):
    """Storage is bitwise the JAX package's (f32 copy, bf16 round-to-nearest,
    int8 with the same scales); read_kv equal within f32 rounding."""
    rng = np.random.RandomState(0)
    b, h, S, d = 2, 3, 12, 16
    jc, tc = _caches(rng, b, h, 7, d, dt)
    # a one-token append at a later offset into a longer cache
    jbig = jattn.KVCache.init(b, h, S, d, DTYPES[dt][0])
    tbig = tattn.KVCache.init(b, h, S, d, DTYPES[dt][1], device="cpu")
    k1 = rng.standard_normal((b, h, 1, d)).astype(np.float32) * 3
    v1 = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    jbig = jbig.append(jnp.asarray(k1), jnp.asarray(v1), 9)
    tbig.append(torch.from_numpy(k1), torch.from_numpy(v1), 9)
    for j, t in ((jc, tc), (jbig, tbig)):
        np.testing.assert_array_equal(_np(t.kv), _np(j.kv))
        if dt == "int8":
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        for a, c in zip(t.read_kv(dtype=torch.float32),
                        j.read_kv(dtype=jnp.float32)):
            np.testing.assert_allclose(_np(a), _np(c), rtol=1e-6, atol=1e-6)


def test_int8_quantize_rounds_half_to_even_and_clips():
    # amax 127 → scale 1: the halves land exactly on .5 and round to even
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.49, -127.0]]]],
                 np.float32)
    tq, ts = tattn._quantize_int8(torch.from_numpy(x))
    jq, js = jattn._quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.numpy().ravel().tolist() == [127, 0, 2, 2, -2, 0, 3, -127]
    # an all-zero row keeps the 1e-8 scale floor instead of dividing by 0
    zq, zs = tattn._quantize_int8(torch.zeros(1, 1, 1, 4))
    assert zs.item() == pytest.approx(1e-8) and not zq.any()


# ---------------------------------------------------------------------------
# the decode kernel's plain version
# ---------------------------------------------------------------------------

# f32 cache: the Pallas kernel does f32 dots, so only summation order
# differs (1e-5). bf16/int8 caches: the Pallas kernel rounds q and the
# probabilities to bf16 before its dots while the port stays in f32 — the
# error is bf16's (2^-8 relative on O(1) outputs), hence 2e-2.
PALLAS_TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_plain_kernel_matches_pallas_interpret(dt, masked):
    rng = np.random.RandomState(1)
    b, h, S, d = 2, 4, 128, 32
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    length = 77
    row = (rng.rand(S) > 0.4).astype(np.int32) if masked else None
    ref = decode_attend_kernel(jnp.asarray(q), jc, jnp.int32(length),
                               mask_row=None if row is None else jnp.asarray(row),
                               interpret=True)
    out = tdec.decode_attend_plain(
        torch.from_numpy(q), tc.kv, tc.scale, length,
        mask_row=None if row is None else torch.from_numpy(row))
    assert out.shape == (b, h, 1, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=PALLAS_TOL[dt], rtol=0)


# vs the dense cached path: f32 and int8 (dequantized in the f32 query
# dtype) run in f32 on both sides, 1e-5; a bf16 cache makes the dense path
# cast its probabilities to bf16 before the AV product, 2e-2.
DENSE_TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 1e-5}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_plain_kernel_matches_dense_cached_attend(dt, masked):
    rng = np.random.RandomState(2)
    b, h, S, d = 2, 2, 40, 16
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    length, qpos = 31, 30
    mask = (rng.rand(S + 1, S + 1) > 0.5) | np.eye(S + 1, dtype=bool)
    ref = jattn.cached_attend(jnp.asarray(q), jc, jnp.int32(length),
                              static_mask=jnp.asarray(mask) if masked else None,
                              qpos=jnp.int32(qpos), use_kernel=False)
    out = tattn.cached_attend(
        torch.from_numpy(q), tc, length,
        static_mask=torch.from_numpy(mask.astype(np.int32)) if masked else None,
        qpos=qpos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=DENSE_TOL[dt], rtol=0)


def test_plain_kernel_no_valid_position_gives_zero():
    rng = np.random.RandomState(3)
    _, tc = _caches(rng, 1, 2, 8, 8, "f32")
    q = torch.randn(1, 2, 1, 8)
    out = tdec.decode_attend_plain(q, tc.kv, None, 5,
                                   mask_row=torch.zeros(8, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like"])
def test_cached_attend_static_mask_rows_match_jax(attn_type):
    """Mask rows are indexed by qpos=offset and trimmed to the cache
    length S (the mask covers one more position than the cache)."""
    rng = np.random.RandomState(4)
    text_len, fmap = 5, 3
    S = text_len + fmap * fmap - 1
    mask = jmasks.build_mask(attn_type, text_len, fmap, kernel_size=3)
    jc, tc = _caches(rng, 2, 2, S, 8, "f32")
    tmask = torch.from_numpy(tmasks.build_mask(attn_type, text_len, fmap,
                                               kernel_size=3).astype(np.int32))
    for offset in (text_len, S - 1):
        q = rng.standard_normal((2, 2, 1, 8)).astype(np.float32)
        ref = jattn.cached_attend(jnp.asarray(q), jc, jnp.int32(offset + 1),
                                  static_mask=jnp.asarray(mask),
                                  qpos=jnp.int32(offset), use_kernel=False)
        out = tattn.cached_attend(torch.from_numpy(q), tc, offset + 1,
                                  static_mask=tmask, qpos=offset)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_cached_attend_stable_takes_the_dense_path(monkeypatch):
    rng = np.random.RandomState(5)
    jc, tc = _caches(rng, 2, 2, 16, 8, "f32")
    q = rng.standard_normal((2, 2, 1, 8)).astype(np.float32) * 4
    ref = jattn.cached_attend(jnp.asarray(q), jc, jnp.int32(11), stable=True,
                              use_kernel=False)
    monkeypatch.setattr(tattn, "decode_attend", None)   # must not be called
    out = tattn.cached_attend(torch.from_numpy(q), tc, 11, stable=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_attend_counts_no_launch_on_cpu():
    rng = np.random.RandomState(6)
    _, tc = _caches(rng, 1, 2, 8, 8, "f32")
    before = tdec.launches
    tdec.decode_attend(torch.randn(1, 2, 1, 8), tc, 4)
    assert tdec.launches == before


@pytest.mark.parametrize("case, err", [
    ("d_too_big", ValueError), ("d_unaligned", ValueError),
    ("int8_without_scale", ValueError), ("bool_mask", ValueError),
    ("f64_query", TypeError), ("two_queries", ValueError),
    ("strided_query", ValueError)])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    """The shape/type checks that guard the CUDA launch (they run before any
    device work, so they are testable on CPU tensors)."""
    b, h, S = 1, 2, 16
    d = {"d_too_big": 264, "d_unaligned": 12}.get(case, 32)
    kv_dtype = torch.int8 if case in ("int8_without_scale", "d_unaligned") else torch.float32
    kv = torch.zeros(b, S, 2 * h * d, dtype=kv_dtype)
    scale = None
    if kv_dtype == torch.int8 and case != "int8_without_scale":
        scale = torch.ones(b, 2 * h, S)
    q = torch.zeros(b, h, 2 if case == "two_queries" else 1, d,
                    dtype=torch.float64 if case == "f64_query" else torch.float32)
    if case == "strided_query":
        q = torch.zeros(b, h, 1, 2 * d)[..., ::2]
    mask = torch.ones(S, dtype=torch.bool) if case == "bool_mask" else None
    with pytest.raises(err):
        tdec._check_cuda(q, kv, scale, mask)


def test_cuda_wrapper_accepts_the_main_path_shapes():
    b, h, S, d = 8, 14, 512, 128
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        scale = torch.ones(b, 2 * h, S) if kv_dtype == torch.int8 else None
        q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
        tdec._check_cuda(torch.zeros(b, h, 1, d, dtype=q_dtype),
                         torch.zeros(b, S, 2 * h * d, dtype=kv_dtype), scale,
                         torch.ones(S + 1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# dense attend, rotary, masks, sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["causal", "key_mask", "static_decode",
                                     "stable", "bf16_scores"])
def test_attend_matches_jax(variant):
    rng = np.random.RandomState(7)
    b, h, i, j, d = 2, 2, 6, 6, 16
    if variant == "static_decode":
        i = 2       # query block aligned to the end of the keys
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for n in (i, j, j))
    kw_j, kw_t = {}, {}
    if variant == "key_mask":
        km = rng.rand(b, j) > 0.3
        km[:, 0] = True
        kw_j["key_mask"], kw_t["key_mask"] = jnp.asarray(km), torch.from_numpy(km)
    if variant == "static_decode":
        m = jmasks.build_mask("axial_row", 2, 2)            # (6, 6)
        kw_j["static_mask"] = jnp.asarray(m)
        kw_t["static_mask"] = torch.from_numpy(m.astype(np.int32))
    if variant == "stable":
        kw_j["stable"] = kw_t["stable"] = True
    if variant == "bf16_scores":
        kw_j["softmax_f32"] = kw_t["softmax_f32"] = False
    ref = jattn.attend(*(jnp.asarray(x) for x in (q, k, v)), **kw_j)
    out = tattn.attend(*(torch.from_numpy(x) for x in (q, k, v)), **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32, 1e-6),
                                   (jnp.bfloat16, torch.bfloat16, 3e-2)])
def test_apply_rotary_matches_jax(dtype):
    """bf16: both cast the angles to bf16 before cos/sin; the two libraries'
    bf16 cos/sin and products round differently, hence bf16's tolerance."""
    jdt, tdt, tol = dtype
    table = jrot.dalle_pos_emb(5, 3, 24)
    np.testing.assert_array_equal(trot.dalle_pos_emb(5, 3, 24), table)
    rng = np.random.RandomState(8)
    t = rng.standard_normal((2, 3, table.shape[0], 24)).astype(np.float32)
    ref = jrot.apply_rotary(jnp.asarray(table)[None, None], jnp.asarray(t, jdt))
    out = trot.apply_rotary(torch.from_numpy(table)[None, None],
                            torch.from_numpy(t).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


@pytest.mark.parametrize("attn_type", ["full", "axial_row", "axial_col",
                                       "conv_like", "sparse"])
def test_masks_are_the_jax_masks(attn_type):
    kw = dict(kernel_size=3, block=4, seed=3)
    np.testing.assert_array_equal(
        tmasks.build_mask(attn_type, 7, 4, **kw),
        jmasks.build_mask(attn_type, 7, 4, **kw))


@pytest.mark.parametrize("thres", [0.5, 0.9, 0.999])
def test_top_k_filter_and_gumbel_sample_match_jax(thres):
    rng = np.random.RandomState(9)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[0, :4] = logits[0, 4]        # ties at the threshold stay
    ref = jsamp.top_k_filter(jnp.asarray(logits), thres=thres)
    out = tsamp.top_k_filter(torch.from_numpy(logits), thres=thres)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    key = jax.random.PRNGKey(int(thres * 1000))
    g = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    for temp in (1.0, 0.7):
        tok_j = jsamp.gumbel_sample(key, ref, temperature=temp)
        tok_t = tsamp.gumbel_sample(out, temperature=temp,
                                    noise=torch.from_numpy(g))
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_gumbel_draws_follow_the_generator():
    logits = torch.zeros(4, 100)
    a = tsamp.gumbel_sample(logits, generator=torch.Generator().manual_seed(1))
    b = tsamp.gumbel_sample(logits, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    g = tsamp.gumbel_noise((20000,), generator=torch.Generator().manual_seed(2))
    # standard Gumbel: mean = Euler–Mascheroni constant, var = π²/6
    assert abs(g.mean().item() - 0.5772) < 0.03
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.08
    with pytest.raises(ValueError):
        tsamp.gumbel_sample(logits, noise=torch.zeros(4, 99))
