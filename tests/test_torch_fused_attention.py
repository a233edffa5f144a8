"""The port's fused-boundary attention (K1) ≡ the JAX package's, on the same
numpy inputs, on the CPU.

``dalle_tpu_torch.ops.fused_attention`` runs its plain version for a CPU
tensor (the CUDA kernels are held against it in ``test_torch_cuda.py``).
Here the plain forward, and the backward through the
``torch.autograd.Function``, meet the Pallas kernels in interpret mode and
the fwd-kernel/XLA-backward tier. Also: mask tables, the attention-mode
table, the settings that raised before K4 was ported, launch counts, and
the checks that guard the CUDA launch.

Tolerances: against the Pallas kernels 1e-5, since both round to bf16 at
the same points and differ only in f32 summation order. Against
``fused_qkv_attention_xbwd``, 2e-2 absolute plus 2e-2 relative: that tier's
XLA backward rounds every product (scores, dp, dq, dk, dv) to bf16, where
the kernels accumulate in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops import fused_attention as jfa
from dalle_tpu.ops.attn_masks import build_mask
from dalle_tpu.ops.flash_attention import elem_fn_from_spec as jelem_fn
from dalle_tpu_torch.config import DalleConfig
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops import flash_attention as tflash
from dalle_tpu_torch.ops import fused_attention as tfa

TEXT_LEN, FMAP = 4, 4
N = TEXT_LEN + FMAP * FMAP          # 20 positions: a (21, 21) mask's top-left block
MASKS = {"none": (None, None),
         "axial_row": ("axial_row", ("axial", TEXT_LEN, FMAP, 0)),
         "axial_col": ("axial_col", ("axial", TEXT_LEN, FMAP, 1)),
         "conv_like": ("conv_like", ("conv", TEXT_LEN, FMAP, 3, 1)),
         "sparse": ("sparse", ("block", 4))}
SHAPES = {"h2_d16": (2, 16), "h4_d64": (4, 64)}


def _mask(kind):
    """(numpy table, spec) as the JAX transformer hands them to the kernel:
    the (N+1)² training table and the structured spec."""
    name, spec = MASKS[kind]
    if name is None:
        return None, None
    return build_mask(name, TEXT_LEN + 1, FMAP, kernel_size=3, block=4), spec


def _inputs(h, d, seed, b=2):
    rng = np.random.RandomState(seed)
    qkv = rng.standard_normal((b, N, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((b, N, h * d)).astype(np.float32)
    return qkv, do


def _as(x, dt):
    if dt == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _np(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_forward_matches_pallas(dt, kind, shape):
    h, d = SHAPES[shape]
    qkv, _ = _inputs(h, d, seed=len(kind) + h)
    mask, spec = _mask(kind)
    jq, tq = _as(qkv, dt)
    ref = jfa.fused_qkv_attention(jq, mask, h, None, True, spec)
    out = tfa.fused_qkv_attention(tq, h, tfa.mask_table(N, mask, spec))
    assert out.dtype == tq.dtype and out.shape == (2, N, h * d)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_matches_pallas_and_xbwd(dt, kind):
    h, d = 2, 16
    qkv, do = _inputs(h, d, seed=7 + len(kind))
    mask, spec = _mask(kind)
    jq, tq = _as(qkv, dt)
    tq.requires_grad_(True)

    def jloss(fn, table):
        return lambda a: jnp.sum(fn(a, table, h, None, True, spec).astype(jnp.float32) * do)

    g_pallas = jax.grad(jloss(jfa.fused_qkv_attention, mask))(jq)
    # the XLA backward applies its table whole: hand it the (N, N) block
    g_xbwd = jax.grad(jloss(jfa.fused_qkv_attention_xbwd,
                            None if mask is None else mask[:N, :N]))(jq)
    out = tfa.fused_qkv_attention(tq, h, tfa.mask_table(N, mask, spec))
    (out.float() * torch.from_numpy(do)).sum().backward()
    assert tq.grad.dtype == tq.dtype
    np.testing.assert_allclose(_np(tq.grad), _np(g_pallas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tq.grad), _np(g_xbwd), atol=2e-2, rtol=2e-2)


def test_plain_versions_repeat_each_other():
    """The backward's plain version takes the forward's (m, l): m is the row
    max of the masked scores, l the sum of exp(s - m)."""
    qkv, do = _inputs(2, 16, seed=3)
    t = torch.from_numpy(qkv)
    out, m, l = tfa.fused_attention_fwd_plain(t, 2)
    assert m.shape == l.shape == (2, 2, N)
    q, k, _ = tfa._split_bf16(t, 2)
    s = tfa._scores(q, k, 16 ** -0.5, torch.ones(N, N, dtype=torch.bool).tril())
    torch.testing.assert_close(m, s.amax(-1))
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1))


@pytest.mark.parametrize("kind", ["axial_row", "axial_col", "conv_like", "sparse"])
def test_validity_table_matches_jax(kind):
    """The port ANDs causality into every table; the transformer's tables
    are causal already, so the two packages' tables are equal."""
    mask, spec = _mask(kind)
    ref = jfa.validity_table(N, mask, spec)
    got = tfa.validity_table(N, mask, spec)
    np.testing.assert_array_equal(got, np.asarray(ref)[:N, :N])
    if spec[0] != "block":
        ri, ci = np.arange(N)[:, None], np.arange(N)[None, :]
        np.testing.assert_array_equal(tflash.elem_fn_from_spec(spec)(ri, ci),
                                      jelem_fn(spec)(ri, ci))


def test_mask_table_tiles_and_diagonal():
    n = 150                       # three 64-row tiles, the last ragged
    mask = np.tril(np.ones((n, n), bool))
    mask[64:, :64] = False        # tile (1, 0) and (2, 0) hold nothing
    mt = tfa.mask_table(n, mask)
    assert mt.table.dtype == torch.int8 and mt.table.shape == (n, n)
    assert mt.tiles.tolist() == [[1, 0, 0], [0, 1, 0], [0, 1, 1]]
    assert tfa.mask_table(n) is None          # plain causal: no table
    hole = mask.copy()
    hole[5, 5] = False
    with pytest.raises(ValueError):
        tfa.mask_table(n, hole)


@pytest.mark.parametrize("kind", ["full", "axial_row", "conv_like", "sparse"])
@pytest.mark.parametrize("text_seq_len, fmap, block", [(6, 4, 8), (256, 16, 128)])
def test_layer_table_is_the_transformers(kind, text_seq_len, fmap, block):
    """The table the kernel checks use is the one training hands K1."""
    cfg = DalleConfig(num_text_tokens=60, text_seq_len=text_seq_len, dim=32, depth=1,
                      heads=2, dim_head=16, image_vocab_size=48, image_fmap_size=fmap,
                      attn_types=(kind,), sparse_block_size=block)
    n = text_seq_len + fmap * fmap
    want = DALLE(cfg).transformer.fused_table(0, n, "cpu")
    got = tfa.layer_table(kind, n)
    if kind == "full":
        assert got is None and want is None
        return
    assert torch.equal(got.table, want.table) and torch.equal(got.tiles, want.tiles)


def test_kernel_tolerance_is_per_element():
    """2e-3 of the largest output (at least 1) for every element; a bf16
    output adds 2^-7 of the element itself."""
    want = torch.tensor([0.0, -0.5, 4.0])
    torch.testing.assert_close(tfa.kernel_tolerance(want), torch.full((3,), 8e-3))
    torch.testing.assert_close(tfa.kernel_tolerance(want.bfloat16()),
                               torch.tensor([8e-3, 8e-3 + 0.5 / 128, 8e-3 + 4 / 128]))
    torch.testing.assert_close(tfa.kernel_tolerance(want[:2]), torch.full((2,), 2e-3))


def test_layer_table_takes_the_grid_width():
    """``fmap`` overrides the default grid: an 8×8 image after 8 text
    tokens is the transformer's layout, which the default (4×4 below 257
    positions) is not."""
    cfg = DalleConfig(num_text_tokens=60, text_seq_len=8, dim=32, depth=1, heads=2,
                      dim_head=16, image_vocab_size=48, image_fmap_size=8,
                      attn_types=("axial_row",))
    want = DALLE(cfg).transformer.fused_table(0, 72, "cpu")
    got = tfa.layer_table("axial_row", 72, fmap=8)
    assert torch.equal(got.table, want.table) and torch.equal(got.tiles, want.tiles)
    assert not torch.equal(tfa.layer_table("axial_row", 72).table, want.table)


# ---------------------------------------------------------------------------
# the CUDA kernels' order of work, written out in tensor code
# ---------------------------------------------------------------------------

def _tile_slices(n):
    return [slice(k0, min(k0 + tfa.TILE, n)) for k0 in range(0, n, tfa.TILE)]


def _kernel_order_fwd(qkv, heads, table=None):
    """The forward kernel's order of work: pass 1 updates each row's
    (m, l) online over 64-key tiles; pass 2 forms p = exp(s - m) / l with
    the final (m, l), rounds it to bf16 and adds p16·v tile by tile."""
    b, n, _ = qkv.shape
    scale = tfa._scale(qkv, heads, None)
    q, k, v = tfa._split_bf16(qkv, heads)
    vis = tfa._visible(n, table, qkv.device)
    qs = (q.float() * scale).to(torch.bfloat16).float()

    def scores(sl):
        s = torch.einsum("bihd,bjhd->bhij", qs, k[:, sl].float())
        return torch.where(vis[:, sl], s, -torch.inf)

    m = torch.full((b, heads, n), -torch.inf)
    l = torch.zeros(b, heads, n)
    for sl in _tile_slices(n):                                  # pass 1
        s = scores(sl)
        m_new = torch.maximum(m, s.amax(-1))
        seen = m_new > -torch.inf
        corr = torch.exp(m - torch.where(seen, m_new, 0.0))
        tile_sum = torch.exp(s - torch.where(seen, m_new, 0.0)[..., None]).sum(-1)
        l = torch.where(seen, l * corr + tile_sum, l)
        m = torch.where(seen, m_new, m)
    o = torch.zeros(b, n, heads, q.shape[-1])
    for sl in _tile_slices(n):                                  # pass 2
        p16 = (torch.exp(scores(sl) - m[..., None]) / l[..., None]).to(torch.bfloat16)
        o += torch.einsum("bhij,bjhd->bihd", p16.float(), v[:, sl].float())
    return o.reshape(b, n, -1).to(qkv.dtype), m, l


def _kernel_order_bwd(qkv, dout, m, l, heads, table=None):
    """The backward kernels' order of work. dq: sweep 1 adds p16·v tile by
    tile into two halves (each 64-key tile's first and last 32 keys), adds
    the halves, and forms delta = rowsum(o·dO) from that f32 o; sweep 2
    adds bf16(p·(dp − delta))·k into two halves the same way, scaled once
    at the end. dk/dv: for each 64-key tile, q tile by q tile, s^T from the
    scaled q and dk from the unscaled one, in two halves of each q tile."""
    b, n, _ = qkv.shape
    scale = tfa._scale(qkv, heads, None)
    q, k, v = (t.float() for t in tfa._split_bf16(qkv, heads))
    do = dout.to(torch.bfloat16).reshape(b, n, heads, -1).float()
    vis = tfa._visible(n, table, qkv.device)
    qs = (q * scale).to(torch.bfloat16).float()

    def p_ds(qsl, ksl, delta=None):
        s = torch.einsum("bihd,bjhd->bhij", qs[:, qsl], k[:, ksl])
        p = torch.where(vis[qsl, ksl], torch.exp(s - m[:, :, qsl, None]) / l[:, :, qsl, None],
                        0.0)
        if delta is None:
            return p, None
        dp = torch.einsum("bihd,bjhd->bhij", do[:, qsl], v[:, ksl])
        return p, (p * (dp - delta[:, :, qsl, None])).to(torch.bfloat16).float()

    def halves(sl):
        mid = min(sl.start + tfa.TILE // 2, sl.stop)
        return [slice(sl.start, mid), slice(mid, sl.stop)]

    everything = slice(0, n)
    o = [torch.zeros_like(q), torch.zeros_like(q)]
    dq = [torch.zeros_like(q), torch.zeros_like(q)]
    for sl in _tile_slices(n):
        for half, hs in enumerate(halves(sl)):
            p, _ = p_ds(everything, hs)
            o[half] += torch.einsum("bhij,bjhd->bihd", p.to(torch.bfloat16).float(), v[:, hs])
    delta = ((o[0] + o[1]) * do).sum(-1).transpose(1, 2)          # (b, h, n)
    for sl in _tile_slices(n):
        for half, hs in enumerate(halves(sl)):
            _, ds = p_ds(everything, hs, delta)
            dq[half] += torch.einsum("bhij,bjhd->bihd", ds, k[:, hs])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for ksl in _tile_slices(n):
        parts = [[0.0, 0.0], [0.0, 0.0]]                          # [dk, dv][half]
        for qsl in _tile_slices(n):
            for half, hs in enumerate(halves(qsl)):
                p, ds = p_ds(hs, ksl, delta)
                parts[0][half] = parts[0][half] + torch.einsum("bhij,bihd->bjhd", ds, q[:, hs])
                parts[1][half] = parts[1][half] + torch.einsum(
                    "bhij,bihd->bjhd", p.to(torch.bfloat16).float(), do[:, hs])
        dk[:, ksl] = (parts[0][0] + parts[0][1]) * scale
        dv[:, ksl] = parts[1][0] + parts[1][1]
    grads = ((dq[0] + dq[1]) * scale, dk, dv)
    return torch.cat([t.reshape(b, n, -1) for t in grads], dim=-1).to(qkv.dtype)


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("n", [77, 513])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel_order_of_work_matches_the_plain_versions(dt, n, peaked):
    """The CUDA kernels' tile order and roundings (online (m, l), p rounded
    with the final (m, l), delta from the f32 o, the two column halves)
    against the plain versions within ``kernel_tolerance``, m within 1e-5
    and l within 1e-5 relative; peaked scales q by 8, so one key dominates
    each row."""
    h, d = 2, 32
    rng = np.random.RandomState(n + peaked)
    qkv = rng.standard_normal((2, n, 3 * h * d)).astype(np.float32)
    if peaked:
        qkv[..., :h * d] *= 8
    do = rng.standard_normal((2, n, h * d)).astype(np.float32)
    _, tq = _as(qkv, dt)
    _, tdo = _as(do, dt)
    table = tfa.layer_table("axial_row", n) if n == 513 else None
    out, m, l = _kernel_order_fwd(tq, h, table)
    ro, rm, rl = tfa.fused_attention_fwd_plain(tq, h, table)
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    dqkv = _kernel_order_bwd(tq, tdo, rm, rl, h, table)
    rdq = tfa.fused_attention_bwd_plain(tq, tdo, rm, rl, h, table)
    for got, want in ((out, ro), (dqkv, rdq)):
        assert got.dtype == want.dtype
        share = ((got.float() - want.float()).abs() / tfa.kernel_tolerance(want)).max().item()
        assert share <= 1.0, share


def _one_ulp_up(x):
    """Every nonzero bf16 value one ulp further from zero, as f32."""
    bits = x.to(torch.bfloat16).view(torch.int16)
    return torch.where(x != 0, (bits + 1).view(torch.bfloat16), 0).float()


def _plain_with_flips(qkv, dout, heads, table=None):
    """The plain forward and backward with every p16 and ds rounded one ulp
    the wrong way (away from zero): the worst case ``rounding_bound`` covers."""
    b, n, _ = qkv.shape
    scale = tfa._scale(qkv, heads, None)
    q, k, v = tfa._split_bf16(qkv, heads)
    vis = tfa._visible(n, table, qkv.device)
    s = tfa._scores(q, k, scale, vis)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m) / torch.exp(s - m).sum(dim=-1, keepdim=True), 0.0)
    p16 = _one_ulp_up(p)
    q, k, v = q.float(), k.float(), v.float()
    do = dout.to(torch.bfloat16).reshape(b, n, heads, -1).float()
    o = torch.einsum("bhij,bjhd->bihd", p16, v)
    delta = (o * do).sum(dim=-1).transpose(1, 2)[..., None]
    ds = _one_ulp_up(p * (torch.einsum("bihd,bjhd->bhij", do, v) - delta))
    grads = (torch.einsum("bhij,bjhd->bihd", ds, k) * scale,
             torch.einsum("bhij,bihd->bjhd", ds, q) * scale,
             torch.einsum("bhij,bihd->bjhd", p16, do))
    return (o.reshape(b, n, -1).to(qkv.dtype),
            torch.cat([t.reshape(b, n, -1) for t in grads], dim=-1).to(qkv.dtype))


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rounding_bound_covers_every_factor_rounded_the_wrong_way(dt, peaked):
    """``flip_tolerance`` holds the plain versions with every p16 and ds one
    bf16 ulp off; on the peaked input (q scaled by 8) ``kernel_tolerance``
    does not, which is why the peaked card case is held to the former."""
    h, d, n = 2, 32, 150
    rng = np.random.RandomState(7 + peaked)
    qkv = rng.standard_normal((2, n, 3 * h * d)).astype(np.float32)
    if peaked:
        qkv[..., :h * d] *= 8
    do = rng.standard_normal((2, n, h * d)).astype(np.float32)
    _, tq = _as(qkv, dt)
    _, tdo = _as(do, dt)
    table = tfa.layer_table("axial_row", n)
    ro, m, l = tfa.fused_attention_fwd_plain(tq, h, table)
    rdq = tfa.fused_attention_bwd_plain(tq, tdo, m, l, h, table)
    bounds = tfa.rounding_bound(tq, tdo, m, l, h, table)
    shares = []
    for got, want, bound in zip(_plain_with_flips(tq, tdo, h, table), (ro, rdq), bounds):
        assert bound.shape == want.shape and bound.dtype == torch.float32
        diff = (got.float() - want.float()).abs()
        assert (diff / tfa.flip_tolerance(want, bound)).max().item() <= 1.0
        shares.append((diff / tfa.kernel_tolerance(want)).max().item())
    if peaked and dt == "f32":
        assert max(shares) > 1.0, shares


# ---------------------------------------------------------------------------
# mode resolution, options left out, launch counts, CUDA-launch checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting, seq, device, want", [
    ("auto", 512, "cpu", False), ("auto", 4096, "cpu", False),
    ("auto", 512, "cuda", "fused"), ("auto", 2047, "cuda", "fused"),
    ("fused", 512, "cpu", "fused"), ("fused", 4096, "cuda", "fused"),
    ("off", 512, "cuda", False), (False, 512, "cuda", False),
    ("0", 512, "cpu", False), ("none", 512, None, False)])
def test_resolve_use_pallas_table(setting, seq, device, want):
    assert tflash.resolve_use_pallas(setting, seq, device) == want


@pytest.mark.parametrize("setting, seq, want", [
    ("flash", 512, "flash"), ("on", 512, "flash"), (True, 512, "flash"), ("1", 512, "flash"),
    ("persist", 512, "persist"), ("auto", 2048, "flash"), ("auto", 4096, "flash")])
def test_unported_attention_modes_raise(setting, seq, want):
    """The settings that raised before K4 and K8 were ported: the flash ones
    now resolve to K4 on the card, and "persist" to K8 where it fits."""
    assert tflash.resolve_use_pallas(setting, seq, "cuda") == want
    with pytest.raises(ValueError):
        tflash.resolve_use_pallas("bogus", seq, "cuda")


def test_model_forward_raises_for_flash_mode():
    """A DALL·E in "flash" mode (formerly refused) runs K4's plain version on
    the CPU and gives the dense forward's logits (f32, summation order)."""
    cfg = DalleConfig(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
                      dim_head=16, image_size=16, image_vocab_size=48,
                      image_fmap_size=4, use_pallas="flash",
                      attn_types=("full", "axial_row"))
    text = torch.randint(1, 60, (1, 6), generator=torch.Generator().manual_seed(0))
    img = torch.randint(0, 48, (1, 16), generator=torch.Generator().manual_seed(1))
    model = DALLE(cfg).eval()
    with torch.no_grad():
        flash = model(text, img)
        model.transformer.cfg = dataclasses.replace(model.transformer.cfg, use_pallas="off")
        dense = model(text, img)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=0)


def test_cpu_runs_count_no_launch():
    qkv, do = _inputs(2, 16, seed=5)
    t = torch.from_numpy(qkv).requires_grad_(True)
    before = tfa.fwd_launches, tfa.bwd_launches
    out = tfa.fused_qkv_attention(t, 2)
    (out * torch.from_numpy(do)).sum().backward()
    assert (tfa.fwd_launches, tfa.bwd_launches) == before


def _case(case):
    """CPU tensors shaped as ``case`` describes, for the CUDA-launch checks
    (they run before any device work)."""
    b, n, h, d = 2, 70, 2, 32
    dtype = {"f64": torch.float64, "f16": torch.float16}.get(case, torch.float32)
    if case == "d_unaligned":
        d = 24
    if case == "d_too_big":
        d = 144
    qkv = torch.zeros(b, n, 3 * h * d, dtype=dtype)
    if case == "strided":
        qkv = torch.zeros(b, n, 6 * h * d)[..., ::2]
    if case == "rank4":
        qkv = qkv.reshape(b, n, 3 * h, d)
    table = None
    if case in ("bool_table", "short_tiles"):
        mt = tfa.mask_table(n, np.tril(np.ones((n, n), bool)), None)
        table = tfa.MaskTable(mt.table.bool(), mt.tiles) if case == "bool_table" \
            else tfa.MaskTable(mt.table, mt.tiles[:1])
    heads = 5 if case == "heads_mismatch" else h
    dout = m = l = None
    if case in ("dout_dtype", "stats_shape"):
        dout = torch.zeros(b, n, h * d,
                           dtype=torch.bfloat16 if case == "dout_dtype" else torch.float32)
        m = l = torch.zeros(b, h, n if case == "dout_dtype" else n - 1)
    return qkv, heads, table, dout, m, l


@pytest.mark.parametrize("case, err", [
    ("f64", TypeError), ("f16", TypeError), ("d_unaligned", ValueError),
    ("d_too_big", ValueError), ("strided", ValueError), ("rank4", ValueError),
    ("heads_mismatch", ValueError), ("bool_table", ValueError),
    ("short_tiles", ValueError), ("dout_dtype", ValueError),
    ("stats_shape", ValueError)])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    with pytest.raises(err):
        tfa._check_cuda(*_case(case))


def test_cuda_wrapper_accepts_the_main_path_shapes():
    b, n, h, d = 8, 512, 14, 128
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(b, n, 3 * h * d, dtype=dtype)
        dout = torch.zeros(b, n, h * d, dtype=dtype)
        stats = torch.zeros(b, h, n)
        assert tfa._check_cuda(qkv, h, None) == d
        assert tfa._check_cuda(qkv, h, None, dout, stats, stats) == d
    mt = tfa.mask_table(513, build_mask("axial_row", 258, 16), ("axial", 258, 16, 0))
    assert tfa._check_cuda(torch.zeros(1, 513, 3 * 4 * 64), 4, mt) == 64
