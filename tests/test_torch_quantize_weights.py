"""The port's int8 weight quantization ≡ the JAX package's, and the W8
product's arithmetic (CPU, tiny shapes).

``quantize_kernel_int8`` and ``quantize_params_int8`` give the JAX
package's int8 values and scales bit for bit from the same f32 weights (the
port's Linear weight is (out, in): the contraction axis is 1 where the JAX
kernel's is 0). ``QLinear`` in f32 tracks ``QDense`` with
``compute_dtype=None`` within 1e-5 (summation order only) and in bf16
within 2e-2 of the largest output (bf16 roundings at other points: the JAX
CPU dot rounds its bf16 product once, as the port's does, but sums in
another order). The W8 kernel's order of work is written out in tensor
code and held to the plain version within ``int8w_tolerance``: for bf16 x,
``w8_plan``'s split of the contraction into ranges of 128-element stages,
each range's k16 products in k order summed in f32, the ranges added in
rank order; for f32 x, warps' runs of 64-byte steps, f32 FMA over 16
columns a lane, then the quad and the warps. A row of it alone equals the
same row inside 64, and the plan depends on (N, K) alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.ops.quantize_weights import QDense
from dalle_tpu.ops.quantize_weights import quantize_kernel_int8 as jquantize_kernel
from dalle_tpu.ops.quantize_weights import quantize_params_int8 as jquantize_params
from dalle_tpu_torch import CLIP, ClipConfig, DalleConfig, dalle_state_dict
from dalle_tpu_torch.convert import flax_to_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops import int8w_linear as w8
from dalle_tpu_torch.ops.quantize_weights import (QLinear, assert_float_params,
                                                  quantize_kernel_int8,
                                                  quantize_params_int8)

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)


def _weights(kind, shape, seed):
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if kind == "constant_channels":
        w[:, 1] = 0.0           # amax 0: the 1e-8 floor
        w[:, 2] = 0.25          # zero variance
        w[:, 3] = -3.0
    elif kind == "halves":
        # values on .5 after division: round half to even on both sides
        w[:, 0] = np.arange(shape[0], dtype=np.float32) - shape[0] / 2
    return w


@pytest.mark.parametrize("kind", ["normal", "constant_channels", "halves"])
def test_quantize_kernel_bit_for_bit(kind):
    w = _weights(kind, (64, 8), 1)                     # JAX kernel (in, out)
    jq, js = jquantize_kernel(jnp.asarray(w), axis=0)
    tq, ts = quantize_kernel_int8(torch.from_numpy(w.T.copy()), axis=1)
    assert tq.dtype == torch.int8 and ts.shape == (8, 1)
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().T, np.asarray(js))
    assert (ts > 0).all()


@functools.lru_cache(maxsize=None)
def _dalle(share: bool):
    cfg = dict(CFG, share_input_output_emb=share)
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0), batch=2)
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


@pytest.mark.parametrize("share", [False, True], ids=["untied", "tied"])
def test_quantize_params_equal_jax_and_leave_the_source(share):
    """Every QLinear weight and the tied table: int8 values and scales equal
    the JAX package's; every other float is the JAX package's bf16 cast; the
    source model keeps its f32 weights."""
    _, jp, tm = _dalle(share)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ref = dalle_state_dict(jquantize_params(jp))
    got = quantize_params_int8(tm).state_dict()
    assert set(got) == set(ref)
    n_int8 = 0
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == 4 * CFG["depth"] + 1                # + to_logits or shared_emb
    after = tm.state_dict()
    assert all(torch.equal(before[k], after[k]) and after[k].dtype == before[k].dtype
               for k in before)
    assert not any(isinstance(m, QLinear) and m.is_int8 for m in tm.modules())


@pytest.mark.parametrize("use_bias", [True, False])
def test_qlinear_float_is_nn_linear(use_bias):
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 16).astype(np.float32))
    torch.manual_seed(3)
    a = torch.nn.Linear(16, 8, bias=use_bias)
    torch.manual_seed(3)
    b = QLinear(16, 8, bias=use_bias)
    assert a.state_dict().keys() == b.state_dict().keys()
    for k in a.state_dict():
        assert torch.equal(a.state_dict()[k], b.state_dict()[k])
    assert torch.equal(a(x), b(x))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_qlinear_int8_matches_qdense(compute, use_bias):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    m = QDense(16, use_bias=use_bias)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v)
    cdt = None if compute == "float32" else jnp.bfloat16
    qv = jquantize_params(v, compute_dtype=cdt)
    jx = jnp.asarray(x, jnp.float32 if cdt is None else cdt)
    ref = np.asarray(jnp.asarray(m.apply(qv, jx), jnp.float32))
    layer = QLinear(32, 16, bias=use_bias)
    layer.load_state_dict(flax_to_state_dict(qv))
    assert layer.is_int8 and layer.weight_scale.dtype == torch.float32
    tdt = torch.float32 if cdt is None else torch.bfloat16
    with torch.no_grad():
        got = layer.to(tdt)(torch.from_numpy(x).to(tdt)).float().numpy()
    assert layer.weight_scale.dtype == torch.float32
    if cdt is None:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max(), rtol=0)


def test_int8_weight_without_scale_is_refused():
    layer = QLinear(16, 8)
    q, s = quantize_kernel_int8(layer.weight)
    layer.set_int8(q, s[:, 0])
    layer.weight_scale = None
    with pytest.raises(ValueError, match="weight_scale"):
        layer(torch.zeros(2, 16))
    with pytest.raises(RuntimeError, match="without weight_scale"):
        QLinear(16, 8).load_state_dict({"weight": q, "bias": torch.zeros(8)})
    # a float state into an int8 layer would be cast to int8 without scales
    with pytest.raises(RuntimeError, match="float32 weight into a torch.int8 layer"):
        layer.load_state_dict(QLinear(16, 8).state_dict(), strict=False)


def test_clip_refuses_int8_params():
    clip = CLIP(ClipConfig(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=20,
                           text_enc_depth=1, text_seq_len=4, text_heads=2,
                           visual_enc_depth=1, visual_heads=2, visual_image_size=8,
                           visual_patch_size=4))
    clip.embed_text(torch.ones(1, 4, dtype=torch.long))
    lin = clip.text_transformer.attn_0.to_qkv
    q, s = quantize_kernel_int8(lin.weight)
    lin.set_int8(q, s[:, 0])
    with pytest.raises(ValueError, match="int8 params"):
        clip.embed_text(torch.ones(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="int8 params"):
        assert_float_params(clip)


# ---------------------------------------------------------------------------
# W8's order of work, in tensor code (no JAX)
# ---------------------------------------------------------------------------

def _w8_inputs(M, N, K, dtype, seed, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(dtype)
    q = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    s = torch.rand(N, generator=g) * 0.02 + 1e-3
    b = (torch.randn(N, generator=g) * 0.5).to(dtype) if bias else None
    return x, q, s, b


def _warp_runs(K):
    n = -(-K // w8.STEP)
    return [(n * w // w8.WARPS, n * (w + 1) // w8.WARPS) for w in range(w8.WARPS)]


def _split_ranges(N, K):
    """The bf16 route's contraction ranges: ``w8_plan``'s split of the
    ``UNIT``-element stages, as element ranges."""
    split = w8.w8_plan(N, K)
    units = -(-K // w8.UNIT)
    return [(units * r // split * w8.UNIT, min(K, units * (r + 1) // split * w8.UNIT))
            for r in range(split)]


def w8_order_of_work(x, q, s, b):
    """The kernel's sums. bf16 x: each contraction range of the plan, its
    k16 products in k order (the dequantized weight rounded to bf16, each
    product summed in f32), the ranges' sums added in rank order. f32 x:
    each warp's run of 64-byte steps, a step as 16 columns a lane in order,
    then the quad's four lanes; the warps' sums in warp order. Then the
    rounding to x's dtype and the bias."""
    M, K = x.shape
    N = q.shape[0]
    w = w8.dequantize(q, s, x.dtype).float()
    xf = x.float()
    total = None
    if x.dtype == torch.bfloat16:
        for k0, k1 in _split_ranges(N, K):
            part = torch.zeros(M, N)
            for k in range(k0, k1, 16):
                part = part + xf[:, k:k + 16] @ w[:, k:k + 16].t()
            total = part if total is None else total + part
    else:
        total = torch.zeros(M, N)
        for s0, s1 in _warp_runs(K):
            part = torch.zeros(M, N)
            for step in range(s0, s1):
                base = step * w8.STEP
                lanes = []
                for t in range(4):
                    cols = [k for k in range(base + 16 * t, base + 16 * t + 16) if k < K]
                    lanes.append(xf[:, cols] @ w[:, cols].t() if cols
                                 else torch.zeros(M, N))
                part = part + ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
            total = total + part
    y = total.to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["tc", "fma"])
@pytest.mark.parametrize("shape", [(8, 40, 1792), (16, 24, 448), (40, 16, 200 * 16),
                                   (64, 33, 64), (1, 48, 7168)])
def test_w8_order_of_work_within_tolerance(dtype, shape):
    M, N, K = shape
    x, q, s, b = _w8_inputs(M, N, K, dtype, seed=M + N)
    want = w8.int8w_linear_plain(x, q, s, b)
    got = w8_order_of_work(x, q, s, b)
    diff = (got.float() - want.float()).abs()
    assert (diff <= w8.int8w_tolerance(x, q, s, b, want)).all(), diff.max()


def test_w8_rows_alone_equal_rows_inside_64():
    x, q, s, b = _w8_inputs(64, 24, 448, torch.bfloat16, seed=9)
    full = w8_order_of_work(x, q, s, b)
    for r in (0, 17, 63):
        assert torch.equal(w8_order_of_work(x[r:r + 1], q, s, b)[0], full[r])


def test_w8_plan_fills_the_card_from_n_and_k_alone():
    """The bf16 route's plan takes no row count; at the 1.4B model's QLinear
    shapes it gives two CTAs an SM of 132 (or its largest split) where the
    64-channel tiles alone do not fill them; tiles of rows grow with M and
    hold it."""
    for N, K in ((5376, 1792), (1792, 1792), (14336, 1792), (1792, 7168), (58624, 1792)):
        split = w8.w8_plan(N, K)
        units, tiles = -(-K // w8.UNIT), -(-N // 64)
        assert 1 <= split <= min(w8.MAX_SPLIT, units)
        assert (split == 1) == (tiles >= 132), (N, K, split)
        assert tiles >= 132 or tiles * split >= 264 or split == min(w8.MAX_SPLIT, units)
    last = 0
    for M in (1, 8, 9, 33, 64, 65, 257, 2056):
        nt = w8.tile_rows(M)
        assert nt >= min(M, 128) and nt >= last
        last = nt


def test_w8_wrapper_on_the_cpu_is_the_plain_version():
    x, q, s, b = _w8_inputs(3, 16, 64, torch.bfloat16, seed=4)
    before = (w8.launches, w8.matmul_calls)
    assert torch.equal(w8.int8w_linear(x[None], q, s, b)[0], w8.int8w_linear_plain(x, q, s, b))
    assert (w8.launches, w8.matmul_calls) == before
    # the plain version rounds each dequantized weight to x's dtype
    w = w8.dequantize(q, s, torch.bfloat16)
    assert torch.equal(w, (q.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None]))
