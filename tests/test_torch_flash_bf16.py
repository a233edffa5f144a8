"""The arithmetic of K4's tensor-core route (bf16 operands), on the CPU.

On the card a bf16 q, k, v goes through ``csrc/flash_attention.cu``'s
tensor-core kernels, which round p and dS to bf16 before the second product
and scale s after q·kᵀ. The plain versions with ``operands="bf16"`` compute
exactly that (the kernels are held to them in ``test_torch_cuda.py``). Here
that arithmetic meets the TPU's, ``operands="f32"`` (the default, which the
JAX-parity tests of ``test_torch_flash_attention.py`` use), on the same bf16
inputs: o, dq, dk and dv within ``rounding_tolerance`` (2^-8 of the absolute
products that ``rounding_bound`` sums, plus ``kernel_tolerance``), and lse
within ``lse_tolerance`` (l is the f32 sum of the unrounded p on both sides).
The wrapper's checks of what the route takes run here too: a misaligned
bf16 operand raises.
"""

import numpy as np
import pytest
import torch

from dalle_tpu_torch.ops import flash_attention as tfl
from dalle_tpu_torch.ops.attn_masks import build_mask

TEXT_LEN, FMAP = 17, 8
N = TEXT_LEN + FMAP * FMAP - 1       # 80 positions: the masks are built for 81


def _sched(kind, n, causal=True):
    """The schedule of a layer kind; "holes" is a tabled 16-block sparse
    mask with row 5 fully masked."""
    if kind == "none":
        return tfl.flash_schedule(n, causal=causal)
    if kind == "holes":
        mask = build_mask("sparse", TEXT_LEN, FMAP, block=16, num_random_blocks=1)[:n, :n]
        mask[5] = False
        return tfl.flash_schedule(n, mask, None, causal)
    spec = {"axial_row": ("axial", TEXT_LEN, FMAP, 0), "axial_col": ("axial", TEXT_LEN, FMAP, 1),
            "conv_like": ("conv", TEXT_LEN, FMAP, 3, 1)}[kind]
    return tfl.flash_schedule(n, build_mask(kind, TEXT_LEN, FMAP, kernel_size=3), spec, causal)


def _bf16(b, h, n, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32)).bfloat16()
            for _ in range(4)]


def _all(q, k, v, do, sched, operands, lse=None, delta=None):
    """{o, lse, dq, dk, dv} of the plain versions; the backward from the
    given lse and delta (the same for both arithmetics)."""
    o, lse_o = tfl.flash_fwd_plain(q, k, v, sched, operands=operands)
    lse = lse_o if lse is None else lse
    delta = (do.float() * o.float()).sum(-1).contiguous() if delta is None else delta
    dk, dv = tfl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched, operands=operands)
    return dict(o=o, lse=lse_o, dq=tfl.flash_bwd_dq_plain(q, k, v, do, lse, delta, sched,
                                                          operands=operands),
                dk=dk, dv=dv), lse, delta


@pytest.mark.parametrize("kind, causal, n, d", [
    ("none", True, 150, 32), ("none", False, 150, 16), ("axial_row", True, N, 32),
    ("axial_col", True, N, 32), ("conv_like", True, N, 64), ("holes", True, N, 32)])
def test_bf16_operands_stay_within_the_rounding_bound(kind, causal, n, d):
    sched = _sched(kind, n, causal)
    q, k, v, do = _bf16(2, 2, n, d, seed=n + d)
    want, lse, delta = _all(q, k, v, do, sched, "f32")
    got, _, _ = _all(q, k, v, do, sched, "bf16", lse, delta)
    bound = tfl.rounding_bound(q, k, v, do, lse, delta, sched)
    for out in ("o", "dq", "dk", "dv"):
        g, w = got[out], want[out]
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape == bound[out].shape
        share = ((g.float() - w.float()).abs() / tfl.rounding_tolerance(w, bound[out])).max()
        assert share.item() <= 1.0, (out, share.item())
        # not vacuous: the rounding term stays a small share of the output
        assert (2.0 ** -8 * bound[out].max() <= 1.5e-2 * w.float().abs().max()).item(), out
    # and the two arithmetics do differ: the rounding is really applied
    assert any(not torch.equal(got[o], want[o]) for o in ("o", "dq", "dk", "dv"))
    share = ((got["lse"] - want["lse"]).abs() / tfl.lse_tolerance(want["lse"])).max()
    assert share.item() <= 1.0
    if kind == "holes":
        # the fully masked row: o = 0, lse = +1e9 in the bf16 arithmetic too
        assert torch.equal(got["o"][:, :, 5], torch.zeros_like(got["o"][:, :, 5]))
        assert bool((got["lse"][:, :, 5] == 1e9).all())


def test_default_operands_are_the_tpu_arithmetic():
    """No keyword is "f32", the arithmetic the JAX-parity tests hold to
    the Pallas kernels; f32 inputs are not rounded by it; any other value
    raises."""
    sched = _sched("axial_row", N)
    q, k, v, do = (x.float() for x in _bf16(1, 2, N, 32, seed=3))
    q = q + 1e-3                                   # not bf16-representable
    o, lse = tfl.flash_fwd_plain(q, k, v, sched)
    o32, lse32 = tfl.flash_fwd_plain(q, k, v, sched, operands="f32")
    assert torch.equal(o, o32) and torch.equal(lse, lse32)
    delta = (do * o).sum(-1).contiguous()
    assert torch.equal(tfl.flash_bwd_dq_plain(q, k, v, do, lse, delta, sched),
                       tfl.flash_bwd_dq_plain(q, k, v, do, lse, delta, sched, operands="f32"))
    for a, b in zip(tfl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched),
                    tfl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched, operands="f32")):
        assert torch.equal(a, b)
    # scale·q in f32 before the product: the TPU kernel's order
    s = torch.einsum("bhid,bhjd->bhij", q * 32 ** -0.5, k)
    vis = tfl._visible(sched, torch.arange(N)[:, None], torch.arange(N)[None, :])
    ref = torch.softmax(torch.where(vis, s, tfl.NEG_INF), dim=-1) @ v
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=0)
    with pytest.raises(ValueError):
        tfl.flash_fwd_plain(q, k, v, sched, operands="fp8")


def test_tc_kernel_tolerance_is_per_element_and_bf16_aware():
    """2^-7 of the rounding bound (one bf16 ulp of every rounded factor)
    plus kernel_tolerance: 2e-5 of the largest output (at least 1), and
    2^-7 of a bf16 element; rounding_tolerance takes 2^-8 of the bound."""
    want = torch.tensor([0.0, -0.5, 4.0])
    bound = torch.tensor([1.0, 2.0, 0.0])
    torch.testing.assert_close(tfl.tc_kernel_tolerance(want, bound),
                               torch.tensor([1 / 128, 2 / 128, 0.0]) + 8e-5)
    torch.testing.assert_close(
        tfl.tc_kernel_tolerance(want.bfloat16(), bound),
        torch.tensor([1 / 128 + 8e-5, 2 / 128 + 8e-5 + 0.5 / 128, 8e-5 + 4 / 128]))
    torch.testing.assert_close(tfl.rounding_tolerance(want, bound),
                               torch.tensor([1 / 256, 2 / 256, 0.0]) + 8e-5)


def test_rounding_bound_sums_the_absolute_products():
    """One q tile, full causal: rounding_bound is Σ|P|·|v| (P the softmax)
    and its backward forms, written out densely."""
    n, d = 40, 16
    sched = _sched("none", n)
    q, k, v, do = (x.float() for x in _bf16(1, 1, n, d, seed=7))
    o, lse = tfl.flash_fwd_plain(q, k, v, sched)
    delta = (do * o).sum(-1).contiguous()
    sc = d ** -0.5
    s = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), q @ k.transpose(-1, -2) * sc,
                    tfl.NEG_INF)
    p = torch.softmax(s, dim=-1)
    ds = (p * (do @ v.transpose(-1, -2) - delta[..., None])).abs()
    want = dict(o=p @ v.abs(), dq=sc * ds @ k.abs(), dk=sc * ds.transpose(-1, -2) @ q.abs(),
                dv=p.transpose(-1, -2) @ do.abs())
    got = tfl.rounding_bound(q, k, v, do, lse, delta, sched)
    for out, w in want.items():
        torch.testing.assert_close(got[out], w, atol=1e-5, rtol=1e-5)


def test_bf16_operands_must_be_aligned_for_the_tensor_cores():
    """cp.async moves 16-byte pieces: a bf16 operand whose base is not on 16
    bytes, or whose (b, h, n) strides are not multiples of 8 elements,
    raises before any launch; the transformer's head split of the qkv
    projection passes, and f32 operands (the other route) need neither."""
    n, d = 70, 32
    sched = tfl.flash_schedule(n)
    q = torch.zeros(1, 2, n, d, dtype=torch.bfloat16)
    assert tfl._check_cuda(q, q, q, sched) == d
    qkv = torch.zeros(1, n, 3 * 2 * d, dtype=torch.bfloat16)
    split = [t.reshape(1, n, 2, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    assert tfl._check_cuda(*split, sched) == d
    shifted = torch.zeros(2 * n * d + 4, dtype=torch.bfloat16)[4:].view(1, 2, n, d)
    padded = torch.zeros(1, 2, n, d + 4, dtype=torch.bfloat16)[..., :d]
    for bad in (shifted, padded):
        with pytest.raises(ValueError, match="multiples of 8"):
            tfl._check_cuda(bad, bad, bad, sched)
        with pytest.raises(ValueError, match="multiples of 8"):
            tfl._check_cuda(q, q, q, sched, do=bad, lse=torch.zeros(1, 2, n),
                            delta=torch.zeros(1, 2, n))
    f32 = torch.zeros(2 * n * d + 1)[1:].view(1, 2, n, d)
    assert tfl._check_cuda(f32, f32, f32, sched) == d
