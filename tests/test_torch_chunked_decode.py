"""The port's chunked long-cache decode attention (K7) ≡ the JAX package's,
on the same numpy inputs, on the CPU.

``decode_attend_chunked`` runs its plain version for a CPU tensor (the CUDA
kernel is held against it in ``test_torch_cuda.py``). Here the plain version
meets ``decode_attend_kernel_chunked`` in interpret mode for f32, bf16 and
int8 caches, at lengths that end inside a block, on a block edge and at the
end of the cache, with a mask row, and at length 0. Also: the copied gate,
the CUDA kernel's per-block arithmetic (written out here in tensor code)
against the stated tolerance, and the checks that guard the launch.

Tolerances: f32 1e-5 (summation order only). bf16 and int8: both round
q·scale and the probabilities to bf16 at the same points, so they differ
only where a probability sits on a rounding boundary and the two summation
orders put it on different sides: one bf16 ulp (2^-7 relative at most) of
some p_j times |v_j|, bounded by 2^-7 of the largest value a V row holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops import attention as jattn
from dalle_tpu.ops.decode_attention import (decode_attend_kernel_chunked,
                                            decode_kernel_chunk_supported)
from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import decode_attention as tdec

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _caches(rng, b, h, S, d, dt):
    jdt, tdt = DTYPES[dt]
    k = rng.standard_normal((b, h, S, d)).astype(np.float32)
    v = rng.standard_normal((b, h, S, d)).astype(np.float32)
    jc = jattn.KVCache.init(b, h, S, d, jdt).append(jnp.asarray(k), jnp.asarray(v), 0)
    tc = tattn.KVCache.init(b, h, S, d, tdt, device="cpu").append(
        torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


def _tol(dt, tc, h):
    if dt == "f32":
        return 1e-5
    hd2 = tc.kv.shape[2]
    v = tc.kv[:, :, hd2 // 2:].float().abs().amax(dim=-1)                 # (b, S)
    if tc.scale is not None:
        v = v * tc.scale[:, h:].amax(dim=1)
    return 2.0 ** -7 * v.max().item()


@pytest.mark.parametrize("length", [135, 640, 1280])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_plain_matches_pallas_interpret(dt, length):
    rng = np.random.RandomState(length)
    b, h, S, d = 2, 2, 1280, 64
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    ref = decode_attend_kernel_chunked(jnp.asarray(q), jc, jnp.int32(length), blk=256,
                                       interpret=True)
    out = tdec.decode_attend_chunked(torch.from_numpy(q), tc, length, blk=256)
    assert out.shape == (b, h, 1, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=_tol(dt, tc, h))


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_mask_row_at_block_128_matches_pallas_interpret(dt):
    rng = np.random.RandomState(3)
    b, h, S, d = 2, 2, 512, 64
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    row = (rng.rand(S) > 0.4).astype(np.int32)
    row[290:] = 0                         # the last valid block sees nothing
    ref = decode_attend_kernel_chunked(jnp.asarray(q), jc, jnp.int32(300), blk=128,
                                       mask_row=jnp.asarray(row), interpret=True)
    out = tdec.decode_attend_chunked(torch.from_numpy(q), tc, 300, blk=128,
                                     mask_row=torch.from_numpy(row))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=_tol(dt, tc, h))


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_length_zero_gives_zero(dt):
    rng = np.random.RandomState(4)
    b, h, S, d = 2, 2, 512, 64
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    ref = decode_attend_kernel_chunked(jnp.asarray(q), jc, jnp.int32(0), blk=128,
                                       interpret=True)
    out = tdec.decode_attend_chunked(torch.from_numpy(q), tc, 0, blk=128)
    assert not np.asarray(ref).any() and not out.any()


def _per_block_max(q, kv, kv_scale, length, blk, mask_row=None):
    """The CUDA kernel's arithmetic in tensor code: each block's
    probabilities against its own max, rounded, then the blocks merged."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    dot_dt = torch.float32 if kv.dtype == torch.float32 else torch.bfloat16
    qs = (q[:, :, 0].float() * d ** -0.5).to(dot_dt).float()
    parts = []
    for j0 in range(0, min(length, S), blk):
        sl = slice(j0, j0 + blk)
        s = torch.einsum("bhd,bshd->bhs", qs, kv[:, sl, :h * d].reshape(b, -1, h, d).float())
        if kv_scale is not None:
            s = s * kv_scale[:, :h, sl]
        valid = torch.arange(j0, j0 + s.shape[-1]) < length
        if mask_row is not None:
            valid = valid & (mask_row[sl] != 0)
        s = torch.where(valid, s, -torch.inf)
        m = s.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        if kv_scale is not None:
            p = p * kv_scale[:, h:, sl]
        acc = torch.einsum("bhs,bshd->bhd", p.to(dot_dt).float(),
                           kv[:, sl, h * d:].reshape(b, -1, h, d).float())
        parts.append((m, l, acc))
    if not parts:
        return torch.zeros_like(q)
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(m == -torch.inf, 0.0, torch.exp(m - big_m)) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    o = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
    return (o / torch.where(l > 0, l, 1.0)).to(q.dtype)[:, :, None]


@pytest.mark.parametrize("dt, qdt", [("f32", torch.float32), ("bf16", torch.bfloat16),
                                     ("int8", torch.bfloat16), ("int8", torch.float32)])
def test_per_block_rounding_stays_within_chunked_tolerance(dt, qdt):
    """The CUDA kernel rounds each probability against its block's max,
    the TPU against the running max: the gap stays inside
    ``chunked_tolerance``, and is not zero (the test can tell them apart)."""
    rng = np.random.RandomState(6)
    b, h, S, d = 3, 2, 1024, 64
    _, tc = _caches(rng, b, h, S, d, dt)
    q = torch.from_numpy(3 * rng.standard_normal((b, h, 1, d)).astype(np.float32)).to(qdt)
    row = torch.from_numpy((rng.rand(S) > 0.3).astype(np.int32))
    for length, mask in ((1000, None), (700, row)):
        want = tdec.decode_attend_chunked_plain(q, tc.kv, tc.scale, length, blk=256,
                                                mask_row=mask)
        got = _per_block_max(q, tc.kv, tc.scale, length, 256, mask)
        tol = tdec.chunked_tolerance(q, tc.kv, tc.scale, length, want, mask_row=mask)
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= tol).all()), (diff / tol).max()
        if dt != "f32":
            assert diff.max() > 0


def test_chunk_gate_equals_jax():
    for b, h, S, d, dt, blk in ((2, 8, 1280, 64, "bf16", 256), (2, 14, 2560, 128, "int8", 256),
                                (2, 8, 256, 64, "f32", 256), (2, 2, 1280, 48, "f32", 256),
                                (1, 8, 1300, 64, "bf16", 256), (2, 8, 512, 64, "f32", 128)):
        jc, tc = _caches(np.random.RandomState(0), b, h, S, d, dt)
        for stable in (False, True):
            want = decode_kernel_chunk_supported(jnp.zeros((b, h, 1, d)), jc, stable=stable,
                                                 blk=blk)
            got = tdec.decode_kernel_chunk_supported(torch.zeros(b, h, 1, d), tc,
                                                     stable=stable, blk=blk)
            assert got == want, (b, h, S, d, dt, blk, stable)


def test_cpu_runs_count_no_launch_and_the_block_must_divide_the_cache():
    _, tc = _caches(np.random.RandomState(1), 1, 2, 512, 16, "f32")
    before = tdec.chunked_launches
    tdec.decode_attend_chunked(torch.randn(1, 2, 1, 16), tc, 300, blk=128)
    assert tdec.chunked_launches == before
    with pytest.raises(ValueError, match="multiple"):
        tdec.decode_attend_chunked(torch.randn(1, 2, 1, 16), tc, 300, blk=96)
