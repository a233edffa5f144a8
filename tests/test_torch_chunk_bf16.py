"""The arithmetic of K6's tensor-core route (bf16 operands), on the CPU.

On the card a bf16 q, k, v (and dO) goes through the tensor-core kernels of
``csrc/chunk_attention.cu`` (K4's design), which round p and dS to bf16
before the second product and scale s after q·kᵀ; the forward walks the pair's 64-key
tiles in order with a running max. The plain versions with
``operands="bf16"`` compute exactly that (the kernels are held to them in
``test_torch_cuda.py``). Here that arithmetic meets the TPU's,
``operands="f32"`` (the default, which the JAX-parity tests of
``test_torch_ring_attention.py`` use), on the same bf16 inputs, pair by
pair: o, dq, dk and dv within ``rounding_tolerance`` (2^-8 of the absolute
products that ``rounding_bound`` sums, plus ``kernel_tolerance``), lse
within ``lse_tolerance`` (l is the f32 sum of the unrounded p on both
sides). The wrapper's check of what the route takes runs here too: a
misaligned bf16 operand raises.
"""

import numpy as np
import pytest
import torch

from dalle_tpu_torch.ops import chunk_attention as ca

TEXT, FMAP = 20, 16                  # 20 text + 16 x 16 image positions = 276
N = TEXT + FMAP * FMAP
NEG_INF = -1e9

PAIRS = {
    # (b, h, c, d, q_off, k_off, n_valid, causal, spec): chunks of up to
    # three 64-row tiles, the last one ragged
    "diagonal": (2, 2, 150, 32, 150, 150, 600, True, None),
    "before": (1, 2, 100, 16, 300, 0, 600, True, None),
    "future": (1, 2, 100, 16, 0, 300, 600, True, None),
    "ragged_cut": (2, 2, 130, 32, 260, 130, 200, True, None),
    "axial_row": (1, 4, 92, 32, 184, 92, N, True, ("axial", TEXT, FMAP, 0)),
    "axial_col": (1, 4, 92, 16, 184, 0, N, True, ("axial", TEXT, FMAP, 1)),
    "conv": (2, 2, 92, 32, 184, 92, N, True, ("conv", TEXT, FMAP, 3, 1)),
    "non_causal": (1, 2, 120, 16, 0, 120, 200, False, None),
}


def _inputs(b, h, c, d, seed, mul=1.0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, c, d)).astype(np.float32))
                   for _ in range(4))
    return [(q * mul).bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16()]


def _all(q, k, v, do, q_off, k_off, kw, operands, lse=None, delta=None):
    """{o, lse, dq, dk, dv} of the plain versions; the backward takes the
    given lse and delta (the same for both arithmetics), by default the
    forward's, empty rows flipped to +1e9 as the ring flips them."""
    o, lse_o = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands=operands, **kw)
    lse = torch.where(lse_o <= -5e8, 1e9, lse_o) if lse is None else lse
    delta = (do.float() * o).sum(-1) if delta is None else delta
    args = (q, k, v, do, lse, delta, q_off, k_off)
    dk, dv = ca.chunk_flash_dkv_plain(*args, operands=operands, **kw)
    return dict(o=o, lse=lse_o, dq=ca.chunk_flash_dq_plain(*args, operands=operands, **kw),
                dk=dk, dv=dv), lse, delta


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_bf16_operands_stay_within_the_rounding_bound(case):
    b, h, c, d, q_off, k_off, n_valid, causal, spec = PAIRS[case]
    kw = dict(scale=d ** -0.5, n_valid=n_valid, causal=causal, mask_spec=spec)
    q, k, v, do = _inputs(b, h, c, d, seed=sorted(PAIRS).index(case))
    want, lse, delta = _all(q, k, v, do, q_off, k_off, kw, "f32")
    got, _, _ = _all(q, k, v, do, q_off, k_off, kw, "bf16", lse, delta)
    bound = ca.rounding_bound(q, k, v, do, lse, delta, q_off, k_off, **kw)
    for out in ("o", "dq", "dk", "dv"):
        g, w = got[out], want[out]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape == bound[out].shape
        share = ((g - w).abs() / ca.rounding_tolerance(w, bound[out])).max()
        assert share.item() <= 1.0, (out, share.item())
        # not vacuous: the rounding term stays a small share of the output
        assert (2.0 ** -8 * bound[out].max() <= 1.5e-2 * w.abs().max().clamp(min=1e-30)).item(), out
    share = ((got["lse"] - want["lse"]).abs() / ca.lse_tolerance(want["lse"])).max()
    assert share.item() <= 1.0
    if case == "future":
        # nothing visible: o = 0, lse = -1e9 and zero gradients on both sides
        assert not any(got[o].any() for o in ("o", "dq", "dk", "dv"))
        assert bool((got["lse"] == NEG_INF).all())
    else:
        # and the two arithmetics do differ: the rounding is really applied
        assert any(not torch.equal(got[o], want[o]) for o in ("o", "dq", "dk", "dv"))


def _tpu_arithmetic(q, k, v, do, q_off, k_off, kw):
    """The f32 arithmetic written out: q cast to f32 and scaled, the whole
    pair at once with its row max, every product f32."""
    vis = ca.chunk_visible(q.shape[2], k.shape[2], q_off, k_off, n_valid=kw["n_valid"],
                           causal=kw["causal"], mask_spec=kw["mask_spec"])
    sc = kw["scale"]
    s = torch.where(vis, torch.einsum("bhid,bhjd->bhij", q.float() * sc, k.float()), NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhij,bhjd->bhid", p, v.float()) / safe_l
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)[..., 0]
    blse = torch.where(lse <= -5e8, 1e9, lse)
    delta = (do.float() * o).sum(-1)
    pb = torch.exp(s - blse[..., None])
    ds = pb * (torch.einsum("bhid,bhjd->bhij", do.float(), v.float()) - delta[..., None])
    dq = torch.einsum("bhij,bhjd->bhid", ds, k.float()) * sc
    dv = torch.einsum("bhij,bhid->bhjd", pb, do.float())
    dk = torch.einsum("bhij,bhid->bhjd", ds, q.float() * sc)
    return dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv), blse, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["diagonal", "axial_col", "future"])
def test_default_operands_are_the_tpu_arithmetic(case, dtype):
    """No keyword is "f32": the arithmetic the JAX-parity tests hold to the
    Pallas kernels, bit for bit, for f32 and bf16 inputs (f32 inputs are
    not rounded); "f32" spelled out is the same; any other value raises."""
    b, h, c, d, q_off, k_off, n_valid, causal, spec = PAIRS[case]
    kw = dict(scale=d ** -0.5, n_valid=n_valid, causal=causal, mask_spec=spec)
    q, k, v, do = _inputs(b, h, c, d, seed=5)
    if dtype == torch.float32:
        q, k, v, do = (x.float() + 1e-3 for x in (q, k, v, do))    # not bf16-representable
    want, blse, delta = _tpu_arithmetic(q, k, v, do, q_off, k_off, kw)
    o, lse = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, **kw)
    args = (q, k, v, do, blse, delta, q_off, k_off)
    dk, dv = ca.chunk_flash_dkv_plain(*args, **kw)
    got = dict(o=o, lse=lse, dq=ca.chunk_flash_dq_plain(*args, **kw), dk=dk, dv=dv)
    for out in want:
        assert torch.equal(got[out], want[out]), out
    o32, lse32 = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands="f32", **kw)
    assert torch.equal(o32, o) and torch.equal(lse32, lse)
    assert torch.equal(ca.chunk_flash_dq_plain(*args, operands="f32", **kw), got["dq"])
    with pytest.raises(ValueError):
        ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands="fp8", **kw)


@pytest.mark.parametrize("case, mul", [("diagonal", 1.0), ("before", 1.0), ("diagonal", 8.0),
                                       ("conv", 8.0)])
def test_bf16_tile_walk_matches_the_whole_pair_form(case, mul):
    """The forward's walk over 64-key tiles with a running max rounds each p
    against the max so far; the whole-pair form rounds it against the row's
    final max. The two differ only where a rounded p sits on another side
    of a rounding boundary: within tc_kernel_tolerance, a peaked softmax
    (q × 8) included."""
    b, h, c, d, q_off, k_off, n_valid, causal, spec = PAIRS[case]
    kw = dict(scale=d ** -0.5, n_valid=n_valid, causal=causal, mask_spec=spec)
    q, k, v, do = _inputs(b, h, c, d, seed=9, mul=mul)
    o, lse = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands="bf16", **kw)
    vis = ca.chunk_visible(c, c, q_off, k_off, n_valid=n_valid, causal=causal, mask_spec=spec)
    s = torch.where(vis, torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * kw["scale"],
                    NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)            # a row that sees no key of this chunk
    whole = torch.einsum("bhij,bhjd->bhid", p.bfloat16().float(), v.float()) / safe_l
    whole_lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)[..., 0]
    assert c > ca.TILE                             # the walk crosses tiles
    bound = ca.rounding_bound(q, k, v, do, whole_lse, torch.zeros(b, h, c), q_off, k_off, **kw)
    share = ((o - whole).abs() / ca.tc_kernel_tolerance(whole, bound["o"])).max()
    assert share.item() <= 1.0, share.item()
    assert not torch.equal(o, whole)               # the two forms do round differently
    share = ((lse - whole_lse).abs() / ca.lse_tolerance(whole_lse)).max()
    assert share.item() <= 1.0


def test_tc_kernel_tolerance_is_per_element():
    """2^-7 of the rounding bound (one bf16 ulp of every rounded factor)
    plus kernel_tolerance: 2e-5 of the largest output (at least 1), f32
    outputs; rounding_tolerance takes 2^-8 of the bound."""
    want = torch.tensor([0.0, -0.5, 4.0])
    bound = torch.tensor([1.0, 2.0, 0.0])
    torch.testing.assert_close(ca.tc_kernel_tolerance(want, bound),
                               torch.tensor([1 / 128, 2 / 128, 0.0]) + 8e-5)
    torch.testing.assert_close(ca.rounding_tolerance(want, bound),
                               torch.tensor([1 / 256, 2 / 256, 0.0]) + 8e-5)


def test_rounding_bound_sums_the_absolute_products():
    """A small pair on the diagonal with an axial spec: rounding_bound is
    Σ|P|·|v| (P = exp(s - lse), the pair's softmax) and its backward forms,
    summed term by term."""
    c, d, q_off, k_off = 20, 16, 40, 36
    kw = dict(scale=d ** -0.5, n_valid=N, causal=True, mask_spec=("axial", TEXT, 4, 1))
    q, k, v, do = (x.float() for x in _inputs(1, 1, c, d, seed=7))
    o, lse = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, **kw)
    delta = (do * o).sum(-1)
    got = ca.rounding_bound(q, k, v, do, lse, delta, q_off, k_off, **kw)
    vis = ca.chunk_visible(c, c, q_off, k_off, n_valid=N, causal=True,
                           mask_spec=kw["mask_spec"])[None, None]
    s = (q[..., :, None, :] * k[..., None, :, :]).sum(-1) * kw["scale"]
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = (do[..., :, None, :] * v[..., None, :, :]).sum(-1)
    ds = (p * (dp - delta[..., None])).abs()
    sc = kw["scale"]
    want = dict(o=(p[..., None] * v.abs()[..., None, :, :]).sum(-2),
                dq=sc * (ds[..., None] * k.abs()[..., None, :, :]).sum(-2),
                dk=sc * (ds[..., None] * q.abs()[..., :, None, :]).sum(-3),
                dv=(p[..., None] * do.abs()[..., :, None, :]).sum(-3))
    for out, w in want.items():
        torch.testing.assert_close(got[out], w, atol=1e-5, rtol=1e-5)


def test_bf16_operands_must_be_aligned_for_the_tensor_cores():
    """cp.async moves 16-byte pieces: a bf16 operand whose base is not on 16
    bytes, or whose (b, h, n) strides are not multiples of 8 elements,
    raises before any launch; the zigzag ring's sub-chunk views pass, and
    f32 operands (the other route) need neither."""
    m, d = 70, 32
    q2 = torch.zeros(1, 2, 2 * m, d, dtype=torch.bfloat16)
    views = q2[:, :, m:]
    assert not views.is_contiguous()
    lse = torch.zeros(1, 2, m)
    assert ca._check_cuda(views, views, views, views, lse, lse) == d
    shifted = torch.zeros(2 * m * d + 4, dtype=torch.bfloat16)[4:].view(1, 2, m, d)
    padded = torch.zeros(1, 2, m, d + 4, dtype=torch.bfloat16)[..., :d]
    for bad in (shifted, padded):
        with pytest.raises(ValueError, match="multiples of 8"):
            ca._check_cuda(bad, views, views)
        with pytest.raises(ValueError, match="multiples of 8"):
            ca._check_cuda(views, views, views, bad, lse, lse)
    f32 = torch.zeros(2 * m * d + 1)[1:].view(1, 2, m, d)
    assert ca._check_cuda(f32, f32, f32) == d
