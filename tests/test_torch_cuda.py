"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit (the repository's conftest
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: an f32 cache runs the kernel in f32 like the plain version, so
only the summation order differs (2e-5 on O(1) outputs). bf16 and int8
caches take a bf16 query and write a bf16 output, as on the main path, so
the two differ by up to one bf16 rounding of an O(1) value (1.6e-2).

The fused attention kernels (K1) are held to their plain versions element
by element, within ``fused_attention.kernel_tolerance`` (its docstring gives
the reasons), and their row max and sum within 1e-5; a peaked softmax (q
scaled by 8) within ``fused_attention.flip_tolerance`` and its row max
within 1e-5 of max(1, |m|). The flash kernels (K4:
forward, dq, dk/dv) are held to theirs within
``flash_attention.kernel_tolerance`` and ``lse_tolerance`` for f32 operands
(the TPU's arithmetic); bf16 operands take the tensor-core route, held to
the plain versions with ``operands="bf16"`` within
``flash_attention.tc_kernel_tolerance`` (one bf16 ulp of every rounded p and
dS, from ``rounding_bound``) and ``lse_tolerance``. The windowed kernels
(K3 over the dense slab, K5 over the paged pool) are held to theirs within
``decode_attention.window_tolerance`` on every route of ``window_plan``,
a peaked softmax included, and K5 must equal K3 on the gathered slab bit
for bit. The whole-sequence kernels (K8: forward, and the backward's
dq and dk/dv kernels) are held to their plain versions within
``fused_attention.kernel_tolerance`` (the same arithmetic as K1), a peaked
softmax within ``fused_attention.flip_tolerance`` over K8's
``rounding_bound``, and the
chunked decode kernel (K7) to its plain version within
``decode_attention.chunked_tolerance``. The chunk kernels (K6: forward, dq,
dk/dv of one ring pair) are held to their plain versions within
``chunk_attention.kernel_tolerance`` and ``lse_tolerance``, and the ring
through them to K4 on the whole sequence. The int8-weight product (W8) is
held to its plain version within ``int8w_linear.int8w_tolerance`` on both
routes, and a row alone to its bits inside M rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import DalleConfig, OptimConfig, PrecisionConfig, TrainConfig
from dalle_tpu_torch.models.dalle import init_dalle
from dalle_tpu_torch.ops import chunk_attention as ca
from dalle_tpu_torch.ops import decode_attention as dec
from dalle_tpu_torch.ops import flash_attention as fl
from dalle_tpu_torch.ops import fused_attention as fa
from dalle_tpu_torch.ops import persistent_attention as pa
from dalle_tpu_torch.ops.attention import KVCache, cached_attend
from dalle_tpu_torch.ops.attn_masks import build_mask
from dalle_tpu_torch.ops.paged_kv import PagedKVCache
from dalle_tpu_torch.serve import DecodeEngine, RequestQueue
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2, torch.int8: 1.6e-2}
TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cache(b, h, S, d, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    k = torch.randn(b, h, S, d, device="cuda", generator=gen)
    v = torch.randn(b, h, S, d, device="cuda", generator=gen)
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen)
    q = q.to(torch.float32 if dtype == torch.float32 else torch.bfloat16)
    return q, KVCache.init(b, h, S, d, dtype, device="cuda").append(k, v, 0)


@pytest.mark.parametrize("shape", [(8, 14, 128, 512), (3, 6, 64, 300),
                                   (2, 3, 32, 17), (1, 2, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_matches_plain(dtype, shape):
    b, h, d, S = shape
    q, cache = _cache(b, h, S, d, dtype, seed=d + S)
    for length in sorted({1, S // 2 + 1, S}):
        before = dec.launches
        out = dec.decode_attend(q, cache, length)
        assert dec.launches == before + 1
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype and out.shape == q.shape
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], (length, err)


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_with_static_mask_rows_matches_plain(dtype, attn_type):
    text_len, fmap = 17, 4
    S = text_len + fmap * fmap - 1
    mask = torch.from_numpy(build_mask(attn_type, text_len, fmap, kernel_size=3)
                            .astype(np.int32)).cuda()
    q, cache = _cache(2, 4, S, 32, dtype, seed=1)
    for qpos in (0, text_len - 1, text_len + 3, S - 1):
        out = cached_attend(q, cache, qpos + 1, static_mask=mask, qpos=qpos)
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, qpos + 1,
                                      mask_row=mask[qpos])
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_with_no_valid_position_writes_zero():
    q, cache = _cache(1, 2, 16, 32, torch.float32, seed=2)
    out = dec.decode_attend(q, cache, 8, mask_row=torch.zeros(16, dtype=torch.int32,
                                                              device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(1, 1, 64, 65536), (2, 8, 64, 4352)],
                         ids=["S65536", "longseq"])
def test_kernel_matches_plain_on_long_caches(shape, dtype):
    """A cache far past what one CTA's shared memory could score (the split
    kernel's shared memory does not grow with S) and the long-sequence
    model's cache, full, ragged and with a mask row."""
    b, h, d, S = shape
    q, cache = _cache(b, h, S, d, dtype, seed=S + 1)
    row = (torch.arange(S, device="cuda") % 5 != 2).int()
    for length, mask in ((S, None), (S // 3 + 17, None), (S - 100, row)):
        before = dec.launches
        out = dec.decode_attend(q, cache, length, mask_row=mask)
        assert dec.launches == before + 1
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length, mask_row=mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], (length, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_is_deterministic(dtype):
    """Two runs give the same bits: the ranks merge in rank order, no atomics."""
    q, cache = _cache(8, 14, 512, 128, dtype, seed=7)
    row = (torch.arange(512, device="cuda") % 7 != 3).int()
    for length, mask in ((512, None), (300, row), (1, None)):
        first = dec.decode_attend(q, cache, length, mask_row=mask)
        second = dec.decode_attend(q, cache, length, mask_row=mask)
        torch.cuda.synchronize()
        assert torch.equal(first, second), length


def test_wrapper_raises_instead_of_falling_back():
    q, cache = _cache(1, 2, 16, 32, torch.float32, seed=3)
    with pytest.raises(ValueError):
        dec.decode_attend(q[..., ::2], cache, 4)        # strided, d mismatch
    with pytest.raises(ValueError):
        dec.decode_attend(q, cache, 4, mask_row=torch.ones(16, dtype=torch.bool,
                                                           device="cuda"))


@pytest.mark.parametrize("rotary_emb", [True, False])
def test_cached_decode_on_the_card_equals_forward(rotary_emb):
    """The whole decode path on the card, through the kernel: cached logits
    at every image position equal the uncached forward's (f32, 1e-4)."""
    # dense full forward: the fused kernel rounds to bf16 and would not hold
    # the cached f32 path to 1e-4
    cfg = DalleConfig(**TINY, rotary_emb=rotary_emb,
                      attn_types=("full", "axial_row"), use_pallas="off")
    model = init_dalle(cfg, seed=5)
    gen = torch.Generator("cuda").manual_seed(6)
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         device="cuda", generator=gen)
    img = torch.randint(0, cfg.image_vocab_size, (2, cfg.image_seq_len),
                        device="cuda", generator=gen)
    before = dec.launches
    with torch.no_grad():
        full = model(text, img)[:, cfg.text_seq_len:]
        logits, cache, plen = model._prefill(text, None, 2)
        steps = [logits]
        for i in range(cfg.image_seq_len - 1):
            logits, cache = model._decode_one(img[:, i], i, plen + i, cache)
            steps.append(logits)
    assert dec.launches - before == cfg.depth * (cfg.image_seq_len - 1)
    err = (torch.stack(steps, 1) - full).abs().max().item()
    assert err <= 1e-4


# ---------------------------------------------------------------------------
# K1: the fused-boundary attention kernels
# ---------------------------------------------------------------------------

def _k1_case(b, n, h, d, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, n, h * d, device="cuda", generator=gen).to(dtype)
    return qkv, do


def _assert_k1_close(got, want):
    """Every element within ``fa.kernel_tolerance`` of the plain version."""
    diff = (got.float() - want.float()).abs()
    share = (diff / fa.kernel_tolerance(want)).max().item()
    assert share <= 1.0, (share, diff.max().item())


def _check_k1(qkv, do, h, table=None):
    """K1's forward and backward on the card against their plain versions:
    out and dqkv within ``kernel_tolerance``, the row max within 1e-5 and
    the row sum within 1e-5 relative."""
    out, m, l = fa.fused_attention_fwd(qkv, h, table)
    dqkv = fa.fused_attention_bwd(qkv, do, m, l, h, table)
    ro, rm, rl = fa.fused_attention_fwd_plain(qkv, h, table)
    rdq = fa.fused_attention_bwd_plain(qkv, do, rm, rl, h, table)
    torch.cuda.synchronize()
    assert out.dtype == dqkv.dtype == qkv.dtype and dqkv.shape == qkv.shape
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    for got, want in ((out, ro), (dqkv, rdq)):
        _assert_k1_close(got, want)


# the training shape, ragged ones, one row / one short tile / one full tile
# / one row past it at the widest head, and h=14 heads of 32 and 80 (every
# head's columns on a 16-byte boundary, not a 128-byte one)
@pytest.mark.parametrize("shape", [(8, 512, 14, 128), (3, 77, 6, 64), (2, 513, 14, 128),
                                   (2, 20, 2, 16), (1, 130, 3, 48), (3, 1, 2, 128),
                                   (3, 63, 2, 128), (3, 64, 2, 128), (3, 65, 2, 128),
                                   (2, 300, 14, 32), (2, 300, 14, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_match_plain(dtype, shape):
    b, n, h, d = shape
    qkv, do = _k1_case(b, n, h, d, dtype, seed=n + d)
    before = fa.fwd_launches, fa.bwd_launches
    _check_k1(qkv, do, h)
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse"])
@pytest.mark.parametrize("n", [320, 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_with_tables_match_plain(dtype, n, kind):
    h, d = 4, 64
    qkv, do = _k1_case(2, n, h, d, dtype, seed=3)
    _check_k1(qkv, do, h, fa.layer_table(kind, n, device="cuda"))


@pytest.mark.parametrize("case", [(2, 200, 4, 64, torch.bfloat16),
                                  (8, 512, 14, 128, torch.float32),
                                  (8, 512, 14, 128, torch.bfloat16)])
def test_fused_kernels_are_deterministic(case):
    """Two runs give the same bits (the training shape in both dtypes among
    the cases): no atomics, and every sum in a fixed order."""
    b, n, h, d, dtype = case
    qkv, do = _k1_case(b, n, h, d, dtype, seed=9)
    runs = []
    for _ in range(2):
        out, m, l = fa.fused_attention_fwd(qkv, h)
        runs.append((out, m, l, fa.fused_attention_bwd(qkv, do, m, l, h)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_match_plain_on_a_peaked_softmax(dtype):
    """q scaled ×8 at the training shape: one key dominates each row, so
    the forward's first pass must find the row max before p is formed.
    There p sits near 1, where one flipped bf16 rounding costs more than
    ``kernel_tolerance`` allows, and |m| reaches ~50, where f32 sums of s
    in another order differ by a few ulps (~1e-5): out and dqkv are held to
    ``flip_tolerance`` (2^-7 of ``rounding_bound`` + ``kernel_tolerance``),
    m within 1e-5 of max(1, |m|), l within 1e-5 relative."""
    b, n, h, d = 8, 512, 14, 128
    qkv, do = _k1_case(b, n, h, d, dtype, seed=21)
    qkv[..., :h * d] *= 8
    out, m, l = fa.fused_attention_fwd(qkv, h)
    dqkv = fa.fused_attention_bwd(qkv, do, m, l, h)
    ro, rm, rl = fa.fused_attention_fwd_plain(qkv, h)
    rdq = fa.fused_attention_bwd_plain(qkv, do, rm, rl, h)
    bounds = fa.rounding_bound(qkv, do, rm, rl, h)
    torch.cuda.synchronize()
    assert ((m - rm).abs() <= 1e-5 * rm.abs().clamp(min=1.0)).all()
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    for got, want, bound in zip((out, dqkv), (ro, rdq), bounds):
        diff = (got.float() - want.float()).abs()
        share = (diff / fa.flip_tolerance(want, bound)).max().item()
        assert share <= 1.0, (share, diff.max().item())


def test_fused_kernels_at_4352_tokens_with_an_axial_row_table():
    """The long-sequence model's layer (b=2, h=8, d=64, 256 text + 64×64
    image positions) through K1 with its axial_row table, bf16."""
    qkv, do = _k1_case(2, 4352, 8, 64, torch.bfloat16, seed=43)
    _check_k1(qkv, do, 8, fa.layer_table("axial_row", 4352, device="cuda", fmap=64))


def test_fused_f32_and_bf16_qkv_of_the_same_values_agree():
    """f32 qkv and dO holding bf16 values run the same arithmetic as the
    bf16 tensors: (m, l) equal, and out and dqkv equal after the output's
    cast to bf16."""
    qkv, do = _k1_case(4, 300, 6, 64, torch.bfloat16, seed=8)
    table = fa.layer_table("conv_like", 300, device="cuda")
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        q, g = qkv.to(dt), do.to(dt)
        out, m, l = fa.fused_attention_fwd(q, 6, table)
        res[dt] = (out.bfloat16(), m, l, fa.fused_attention_bwd(q, g, m, l, 6, table).bfloat16())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(res[torch.bfloat16], res[torch.float32]))


def test_fused_wrapper_raises_instead_of_falling_back():
    qkv, _ = _k1_case(1, 16, 2, 32, torch.float32, seed=4)
    with pytest.raises(ValueError):
        fa.fused_attention_fwd(qkv[..., ::2], 1)          # strided
    with pytest.raises(TypeError):
        fa.fused_attention_fwd(qkv.half(), 2)


def _tiny_trainer(use_pallas, device):
    cfg = DalleConfig(**TINY, use_pallas=use_pallas, use_remat=False, loss_chunk=11)
    tc = TrainConfig(batch_size=2, optim=OptimConfig(learning_rate=1e-3),
                     precision=PrecisionConfig(compute="float32"))
    return DalleTrainer(cfg, tc, device=device)


def test_train_step_on_the_card_goes_through_k1_and_matches_the_plain_version():
    """One training step on the card launches K1's forward and backward once
    per layer, and its loss and gradients equal the same step on the CPU,
    whose attention is K1's plain version (f32 compute; the bf16 roundings
    inside K1 may flip where the two devices' f32 inputs differ in the last
    bit: 1e-2 of each tensor's largest gradient, 1e-4 of the loss)."""
    card = _tiny_trainer("auto", "cuda")
    host = _tiny_trainer("fused", "cpu")
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    rng = np.random.RandomState(0)
    text = rng.randint(1, TINY["num_text_tokens"], (2, TINY["text_seq_len"]))
    img = rng.randint(0, TINY["image_vocab_size"], (2, TINY["image_fmap_size"] ** 2))
    before = fa.fwd_launches, fa.bwd_launches
    got = card.train_step(text, img)
    assert (fa.fwd_launches - before[0], fa.bwd_launches - before[1]) == (2, 2)
    card_grads = {n: p.grad.cpu() for n, p in card.model.named_parameters()}
    want = host.train_step(text, img)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for name, p in host.model.named_parameters():
        ref = p.grad
        tol = 1e-2 * ref.abs().max().item()
        assert (card_grads[name] - ref).abs().max().item() <= tol, name


# ---------------------------------------------------------------------------
# K4: the block-sparse flash attention kernels
# ---------------------------------------------------------------------------

def _k4_mask(kind, n, text_len, fmap):
    """(numpy mask, spec) of a layer kind at length n: the training table
    (one position longer than n) and its structured spec; "holes" is a
    16-block sparse table with row 5 fully masked."""
    if kind == "none":
        return None, None
    if kind == "holes":
        mask = build_mask("sparse", text_len, fmap, block=16, num_random_blocks=1)[:n, :n]
        mask[5] = False
        return mask, None
    spec = {"axial_row": ("axial", text_len, fmap, 0), "axial_col": ("axial", text_len, fmap, 1),
            "conv_like": ("conv", text_len, fmap, 5, 1), "sparse": ("block", 128)}[kind]
    return build_mask(kind, text_len, fmap, block=128), spec


def _k4_case(b, h, n, d, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype) for _ in range(4)]


def _assert_k4_close(got, want, lse=False, bound=None):
    """lse_tolerance for lse; for o, dq, dk, dv kernel_tolerance (f32
    route) or, given the rounding bound, tc_kernel_tolerance (bf16)."""
    if lse:
        tol = fl.lse_tolerance(want)
    else:
        tol = fl.kernel_tolerance(want) if bound is None else fl.tc_kernel_tolerance(want, bound)
    diff = (got.float() - want.float()).abs()
    share = (diff / tol).max().item()
    assert share <= 1.0, (share, diff.max().item())


def _k4_all(q, k, v, do, sched):
    """The three kernels, the plain versions in the route's arithmetic on
    the same inputs (o, lse, dq, dk, dv each), and for bf16 the rounding
    bounds of o, dq, dk, dv (None for f32)."""
    ops = "bf16" if q.dtype == torch.bfloat16 else "f32"
    o, lse = fl.flash_attention_fwd(q, k, v, sched)
    ro, rlse = fl.flash_fwd_plain(q, k, v, sched, operands=ops)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    got = [o, lse, fl.flash_attention_bwd_dq(q, k, v, do, rlse, delta, sched),
           *fl.flash_attention_bwd_dkv(q, k, v, do, rlse, delta, sched)]
    want = [ro, rlse, fl.flash_bwd_dq_plain(q, k, v, do, rlse, delta, sched, operands=ops),
            *fl.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, sched, operands=ops)]
    bounds = None
    if ops == "bf16":
        rb = fl.rounding_bound(q, k, v, do, rlse, delta, sched)
        bounds = [rb["o"], None, rb["dq"], rb["dk"], rb["dv"]]
    torch.cuda.synchronize()
    return got, want, bounds


def _k4_counts():
    return (fl.fwd_launches, fl.bwd_dq_launches, fl.bwd_dkv_launches,
            fl.tc_fwd_launches, fl.tc_bwd_dq_launches, fl.tc_bwd_dkv_launches)


@pytest.mark.parametrize("case", [
    # (b, h, n, d, causal, mask kind, text_len, fmap)
    (2, 4, 300, 64, True, "axial_row", 45, 16), (2, 4, 300, 64, True, "axial_col", 45, 16),
    (2, 4, 300, 64, True, "conv_like", 45, 16), (2, 3, 577, 64, True, "sparse", 322, 16),
    (3, 6, 77, 64, True, "holes", 13, 8), (2, 2, 300, 32, False, "none", 0, 0),
    (2, 14, 512, 128, True, "none", 0, 0), (1, 3, 130, 16, True, "none", 0, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(dtype, case):
    b, h, n, d, causal, kind, text_len, fmap = case
    mask, spec = _k4_mask(kind, n, text_len, fmap)
    sched = fl.flash_schedule(n, mask, spec, causal, device="cuda")
    q, k, v, do = _k4_case(b, h, n, d, dtype, seed=n + d)
    before = _k4_counts()
    got, want, bounds = _k4_all(q, k, v, do, sched)
    # each kernel once, on the route of the dtype: tensor cores for bf16
    tc = int(dtype == torch.bfloat16)
    assert _k4_counts() == tuple(x + step for x, step in zip(before, (1, 1, 1, tc, tc, tc)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_k4_close(g, w, lse=i == 1, bound=None if bounds is None else bounds[i])
    if kind == "holes":
        # the fully masked row: zero output, lse +1e9, finite gradients
        assert torch.equal(got[0][:, :, 5], torch.zeros_like(got[0][:, :, 5]))
        assert bool((got[1][:, :, 5] == 1e9).all())
        assert all(bool(torch.isfinite(g.float()).all()) for g in got[2:])


def test_flash_kernels_are_deterministic():
    q, k, v, do = _k4_case(2, 4, 200, 64, torch.bfloat16, seed=9)
    sched = fl.flash_schedule(200, device="cuda")
    runs = [_k4_all(q, k, v, do, sched)[0] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_structured_spec_equals_table_on_the_card():
    n, text_len, fmap = 300, 45, 16
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _k4_case(2, 2, n, 64, dtype, seed=5)
        for kind in ("axial_row", "axial_col", "conv_like"):
            mask, spec = _k4_mask(kind, n, text_len, fmap)
            a = _k4_all(q, k, v, do, fl.flash_schedule(n, mask, spec, device="cuda"))[0]
            t = _k4_all(q, k, v, do, fl.flash_schedule(n, mask, None, device="cuda"))[0]
            assert all(torch.equal(x, y) for x, y in zip(a, t)), (kind, dtype)


def test_flash_wrapper_raises_instead_of_falling_back():
    q, k, v, _ = _k4_case(1, 2, 16, 32, torch.float32, seed=4)
    sched = fl.flash_schedule(16, device="cuda")
    with pytest.raises(ValueError):
        fl.flash_attention_fwd(q[..., ::2], k[..., ::2], v[..., ::2], sched)   # d 16 strided
    with pytest.raises(TypeError):
        fl.flash_attention_fwd(q.half(), k.half(), v.half(), sched)
    with pytest.raises(ValueError):
        fl.flash_attention_fwd(q, k, v, fl.flash_schedule(17, device="cuda"))
    # the tensor-core route raises on a bf16 row that cp.async cannot copy
    # whole: a base off 16 bytes, or an n stride that is no multiple of 8
    base = torch.zeros(2 * 16 * 32 + 4, dtype=torch.bfloat16, device="cuda")
    shifted = base[4:].view(1, 2, 16, 32)
    padded = torch.zeros(1, 2, 16, 36, dtype=torch.bfloat16, device="cuda")[..., :32]
    before = _k4_counts()
    for bad in (shifted, padded):
        with pytest.raises(ValueError):
            fl.flash_attention_fwd(bad, bad, bad, sched)
    assert _k4_counts() == before


def test_flash_transformer_on_the_card_matches_dense():
    """A DALL·E forward on the card in "flash" mode (K4 in every layer) and
    in "off" mode (dense) on the same weights: f32 logits within 1e-4."""
    cfg = DalleConfig(**{**TINY, "depth": 4}, use_pallas="flash",
                      attn_types=("full", "axial_row", "axial_col", "conv_like"))
    model = init_dalle(cfg, seed=11).eval()
    gen = torch.Generator("cuda").manual_seed(12)
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len), device="cuda",
                         generator=gen)
    img = torch.randint(0, cfg.image_vocab_size, (2, cfg.image_seq_len), device="cuda",
                        generator=gen)
    before = fl.fwd_launches
    with torch.no_grad():
        flash = model(text, img)
        assert fl.fwd_launches - before == cfg.depth
        model.transformer.cfg = dataclasses.replace(model.transformer.cfg, use_pallas="off")
        dense = model(text, img)
    assert (flash - dense).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# K3 / K5: windowed decode attention over the dense slab and the paged pool
# ---------------------------------------------------------------------------

def _paged(cache, bt, seed):
    """The cache's content behind a shuffled page table (one page per row
    unmapped)."""
    b, S, _ = cache.kv.shape
    h = cache.heads
    d = cache.kv.shape[2] // (2 * h)
    mb = -(-S // bt)
    nb = b * mb + 3
    pages = np.random.RandomState(seed).permutation(nb)[:b * mb].reshape(b, mb)
    pages = pages.astype(np.int32)
    pages[np.arange(b), np.arange(b) % mb] = -1
    pc = PagedKVCache.init(nb, bt, h, S, d, cache.kv.dtype, device="cuda").bind(pages)
    k, v = cache.read_kv(dtype=torch.float32)
    return pc.append_rows(k.contiguous(), v.contiguous(), np.zeros(b, np.int64))


def _route_counts():
    return {r: getattr(dec, f"window_{r}_launches") for r in dec.WINDOW_ROUTES}


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("w", [1, 2, 15, 16, 17, 63, 64, 65, 257])
@pytest.mark.parametrize("shape", [(8, 14, 128, 512), (1, 14, 128, 512),
                                   (8, 6, 64, 300), (1, 6, 64, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_window_kernels_match_plain_and_paged_equals_dense(dtype, shape, w, peaked):
    """Every route of ``window_plan`` (tensor-core tiles of 64 rows; the
    cluster split of a decode step; f32 FMA) against the plain
    versions, within ``window_tolerance``, a peaked softmax (q × 8)
    included. Each launch is counted on its route, a second call gives the
    same bits, and K5 equals K3 on the gathered slab."""
    b, h, d, S = shape
    q1, cache = _cache(b, h, S, d, dtype, seed=w + S)
    gen = torch.Generator("cuda").manual_seed(w)
    q = torch.randn(b, h, w, d, device="cuda", generator=gen) * (8.0 if peaked else 1.0)
    q = q.to(q1.dtype)
    st = [S - w, 0, S] + list(np.random.RandomState(w).randint(0, S - w + 1, b))
    starts = torch.tensor(st[:b], dtype=torch.int32, device="cuda")
    pc = _paged(cache, 16, seed=w)
    route = dec.window_plan(b, h, w, S, dtype, dec._sm_count(q.device))[0]
    before = dec.window_launches, dec.paged_launches, _route_counts()
    out3 = dec.decode_attend_window(q, cache, starts)
    out5 = dec.decode_attend_window_paged(q, pc, starts)
    assert (dec.window_launches, dec.paged_launches) == (before[0] + 1, before[1] + 1)
    assert _route_counts() == {r: n + 2 * (r == route) for r, n in before[2].items()}
    for got, slab in ((out3, cache), (out5, pc.gather_dense())):
        want = dec.decode_attend_window_plain(q, slab.kv, slab.scale, starts)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == q.shape
        share = dec.window_share(got, want, dtype)
        assert share <= 1.0, share
    assert torch.equal(dec.decode_attend_window(q, cache, starts), out3)
    slab = dec.decode_attend_window(q, pc.gather_dense(), starts)
    live = starts < S
    assert torch.equal(out5[live], slab[live])


def test_window_wrapper_raises_instead_of_falling_back():
    q, cache = _cache(2, 2, 16, 32, torch.float32, seed=3)
    starts = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        dec.decode_attend_window(q[..., ::2], cache, starts)       # strided, d mismatch
    with pytest.raises(ValueError):
        dec.decode_attend_window(q, cache, starts[:1])              # starts shape
    pc = PagedKVCache.init(4, 8, 2, 16, 32, device="cuda")
    with pytest.raises(ValueError):
        dec.decode_attend_window_paged(q, pc, starts)               # no page table
    # plans the routes refuse: an f32 cache on the tensor cores, a tile
    # height the tensor-core route does not have, a cluster beyond the
    # portable 8, a bf16 cache on the f32 route
    for kv, plan in ((cache.kv, ("tc", 64, 1)), (cache.kv.to(torch.bfloat16), ("tc", 16, 1)),
                     (cache.kv, ("split", 1, 16)),
                     (cache.kv.to(torch.bfloat16), ("fma", 16, 1))):
        with pytest.raises(RuntimeError):
            dec._launch_window(q, kv, None, None, starts, 16, 0, 0, None, plan)


def test_engine_on_the_card_goes_through_k3_and_k5_and_matches_sequential():
    """A tiny engine on the card, dense then paged: every attending dispatch
    launches the windowed kernel once per layer (K3 dense, K5 paged), and
    each request's tokens equal the port's sequential generation under its
    generator (f32)."""
    model = init_dalle(DalleConfig(**TINY), seed=7)
    rng = np.random.RandomState(1)
    texts = rng.randint(1, TINY["num_text_tokens"], (4, TINY["text_seq_len"])).astype(np.int32)
    n = TINY["image_fmap_size"] ** 2
    refs = [model.generate_images_tokens(
        torch.from_numpy(t[None]).cuda(),
        generator=torch.Generator("cuda").manual_seed(10 + i))[0].cpu().numpy()
        for i, t in enumerate(texts)]
    for kw in (dict(), dict(kv_block_tokens=4)):
        eng = DecodeEngine(model, slots=2, **kw)
        q = RequestQueue()
        for i, t in enumerate(texts):
            q.submit(t, seed=10 + i, request_id=i, max_tokens=9 if i == 2 else None)
        q.close()
        before = dec.window_launches, dec.paged_launches
        done = {c.request_id: c.tokens for c in eng.run(q)}
        k3, k5 = dec.window_launches - before[0], dec.paged_launches - before[1]
        want = TINY["depth"] * eng.stats.window_dispatches
        assert (k3, k5) == ((0, want) if kw else (want, 0))
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(done[i], ref[:9 if i == 2 else n])


# ---------------------------------------------------------------------------
# K8: the whole-sequence attention kernels
# ---------------------------------------------------------------------------

def _k8_case(b, h, n, d, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype) for _ in range(4)]


# the training shape, ragged ones, the widest n persistent_fits admits at
# d = 64, and n = 2,048 at d = 128 (beyond it: shared memory does not grow
# with n)
@pytest.mark.parametrize("shape", [(8, 14, 512, 128), (3, 6, 77, 64), (2, 4, 513, 64),
                                   (2, 2, 20, 16), (1, 3, 130, 48), (1, 2, 800, 64),
                                   (1, 4, 2048, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_persist_kernels_match_plain(dtype, shape):
    """The backward from the forward's (m, l), as the training step runs it,
    gives the bits of the backward that computes them itself."""
    b, h, n, d = shape
    q, k, v, do = _k8_case(b, h, n, d, dtype, seed=n + d)
    before = pa.fwd_launches, pa.bwd_launches
    out, stats = pa.persist_fwd(q, k, v, return_stats=True)
    grads = pa.persist_bwd(q, k, v, do)
    again = pa.persist_bwd(q, k, v, do, stats=stats)
    assert (pa.fwd_launches, pa.bwd_launches) == (before[0] + 1, before[1] + 2)
    want = (pa.persist_fwd_plain(q, k, v),) + pa.persist_bwd_plain(q, k, v, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    for got, ref in zip((out,) + grads, want):
        assert got.dtype == dtype and got.shape == q.shape
        _assert_k1_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_persist_kernels_match_plain_on_a_peaked_softmax(dtype):
    """q scaled ×8 at the training shape, as K1's peaked case: p near 1,
    where one flipped bf16 rounding costs more than ``kernel_tolerance``
    allows, so o, dq, dk, dv are held to ``fa.flip_tolerance`` over K8's
    ``rounding_bound``."""
    q, k, v, do = _k8_case(8, 14, 512, 128, dtype, seed=21)
    q = q * 8
    got = (pa.persist_fwd(q, k, v),) + pa.persist_bwd(q, k, v, do)
    want = (pa.persist_fwd_plain(q, k, v),) + pa.persist_bwd_plain(q, k, v, do)
    bounds = pa.rounding_bound(q, k, v, do)
    torch.cuda.synchronize()
    for g, w, bound in zip(got, want, bounds):
        diff = (g.float() - w.float()).abs()
        share = (diff / fa.flip_tolerance(w, bound)).max().item()
        assert share <= 1.0, (share, diff.max().item())


@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "holes"])
@pytest.mark.parametrize("n", [320, 77])
def test_persist_kernels_with_tables_match_plain(n, kind):
    """K1's tables, and one whose row 5 sees nothing (softmax 1/n over all
    keys, as the TPU kernel's -1e9 fill gives). A layer's ``MaskTable``
    (the transformer's, with its tile map) gives the bits of its raw table
    (whose map and empty-row flags the wrapper builds)."""
    q, k, v, do = _k8_case(2, 4, n, 64, torch.bfloat16, seed=5)
    if kind == "holes":
        tbl = torch.ones(n, n, dtype=torch.int8, device="cuda").tril()
        tbl[5] = 0
    else:
        masked = fa.layer_table(kind, n, device="cuda")
        tbl = masked.table
    got = (pa.persist_fwd(q, k, v, tbl),) + pa.persist_bwd(q, k, v, do, tbl)
    want = (pa.persist_fwd_plain(q, k, v, tbl),) + pa.persist_bwd_plain(q, k, v, do, tbl)
    if kind != "holes":
        out, stats = pa.persist_fwd(q, k, v, masked, return_stats=True)
        same = (out,) + pa.persist_bwd(q, k, v, do, masked, stats=stats)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_k1_close(g, w)


def test_persist_kernels_take_strided_heads_and_are_deterministic():
    """The head split of a (b, n, 3·h·d) projection, read through strides,
    gives the bits of the contiguous copy; two runs give the same bits."""
    gen = torch.Generator("cuda").manual_seed(8)
    b, n, h, d = 2, 200, 4, 64
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16()
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    do = torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
    runs = [(pa.persist_fwd(q, k, v),) + pa.persist_bwd(q, k, v, do) for _ in range(2)]
    dense = (pa.persist_fwd(*(t.contiguous() for t in (q, k, v))),)
    for a, b_, c in zip(runs[0], runs[1], dense + runs[0][1:]):
        assert torch.equal(a, b_) and torch.equal(a, c)


def test_persist_wrapper_raises_instead_of_falling_back():
    q, k, v, _ = _k8_case(1, 2, 64, 32, torch.float32, seed=4)
    with pytest.raises(ValueError):
        pa.persist_fwd(q, k, v[:, :, :32])                          # shape mismatch
    with pytest.raises(ValueError):
        pa.persist_fwd(q[..., :24], k[..., :24], v[..., :24])       # d not a multiple of 16
    with pytest.raises(ValueError):                                 # a table of the wrong shape
        pa.persist_fwd(q, k, v, torch.ones(32, 32, dtype=torch.int8, device="cuda"))
    with pytest.raises(ValueError):                                 # (m, l) of the wrong shape
        pa.persist_bwd(q, k, v, q, stats=(q[..., 0].contiguous(), q[:, :1, :, 0].contiguous()))


def test_persist_train_step_on_the_card_goes_through_k8_and_matches_the_plain_version():
    """One training step on the card in persist mode launches K8's forward
    and backward once per layer, and its loss and gradients equal the same
    step on the CPU through K8's plain versions (f32 compute; bf16 roundings
    may flip where the two devices' f32 inputs differ in the last bit: 1e-2
    of each tensor's largest gradient, 1e-4 of the loss)."""
    card = _tiny_trainer("persist", "cuda")
    host = _tiny_trainer("persist", "cpu")
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    rng = np.random.RandomState(0)
    text = rng.randint(1, TINY["num_text_tokens"], (2, TINY["text_seq_len"]))
    img = rng.randint(0, TINY["image_vocab_size"], (2, TINY["image_fmap_size"] ** 2))
    before = pa.fwd_launches, pa.bwd_launches, fa.fwd_launches
    got = card.train_step(text, img)
    assert (pa.fwd_launches - before[0], pa.bwd_launches - before[1]) == (2, 2)
    assert fa.fwd_launches == before[2]
    card_grads = {n: p.grad.cpu() for n, p in card.model.named_parameters()}
    want = host.train_step(text, img)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for name, p in host.model.named_parameters():
        tol = 1e-2 * p.grad.abs().max().item()
        assert (card_grads[name] - p.grad).abs().max().item() <= tol, name


# ---------------------------------------------------------------------------
# K7: the chunked long-cache decode kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 8, 64, 1280), (2, 14, 128, 2560), (1, 3, 32, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_chunked_kernel_matches_plain(dtype, shape):
    b, h, d, S = shape
    q, cache = _cache(b, h, S, d, dtype, seed=S + d)
    row = (torch.arange(S, device="cuda") % 3 != 1).int()
    for length, blk, mask in ((S, 256, None), (S // 4 + 7, 256, None), (S // 2, 128, row),
                              (0, 256, None)):
        before = dec.chunked_launches
        out = dec.decode_attend_chunked(q, cache, length, blk=blk, mask_row=mask)
        assert dec.chunked_launches == before + 1
        ref = dec.decode_attend_chunked_plain(q, cache.kv, cache.scale, length, blk=blk,
                                              mask_row=mask)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype and out.shape == q.shape
        if length == 0:
            assert not out.any()
            continue
        tol = dec.chunked_tolerance(q, cache.kv, cache.scale, length, ref, mask_row=mask)
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= tol).all()), (length, (diff / tol).max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_chunked_kernel_is_deterministic(dtype):
    q, cache = _cache(16, 14, 2560, 128, dtype, seed=11)
    row = (torch.arange(2560, device="cuda") % 3 != 1).int()
    for length, mask in ((2560, None), (1111, row)):
        first = dec.decode_attend_chunked(q, cache, length, mask_row=mask)
        second = dec.decode_attend_chunked(q, cache, length, mask_row=mask)
        torch.cuda.synchronize()
        assert torch.equal(first, second), length


def test_chunked_wrapper_raises_instead_of_falling_back():
    q, cache = _cache(2, 2, 512, 32, torch.float32, seed=3)
    with pytest.raises(ValueError):
        dec.decode_attend_chunked(q, cache, 100, blk=96)            # block must divide S
    with pytest.raises(ValueError):
        dec.decode_attend_chunked(q[..., ::2], cache, 100)          # strided, d mismatch


# ---------------------------------------------------------------------------
# K6: the chunk kernels (ring attention's inner step)
# ---------------------------------------------------------------------------

LS_TEXT, LS_FMAP, LS_N = 257, 64, 4352     # the long-sequence model's layout


K6_COUNTERS = ("fwd_launches", "dq_launches", "dkv_launches",
               "tc_fwd_launches", "tc_dq_launches", "tc_dkv_launches")


def _k6_counts():
    return tuple(getattr(ca, c) for c in K6_COUNTERS)


def _k6_all(q, k, v, do, q_off, k_off, kw, operands="f32"):
    """The three kernels, and the plain versions on the same inputs in the
    route's arithmetic; the backward takes the plain forward's lse, flipped
    as the ring flips it. Also returns that lse and delta."""
    o, lse = ca.chunk_flash_fwd(q, k, v, q_off, k_off, **kw)
    ro, rlse = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands=operands, **kw)
    blse = torch.where(rlse <= -5e8, 1e9, rlse)
    delta = (do.float() * ro).sum(-1)
    args = (q, k, v, do, blse, delta, q_off, k_off)
    got = [o, lse, ca.chunk_flash_dq(*args, **kw), *ca.chunk_flash_dkv(*args, **kw)]
    want = [ro, rlse, ca.chunk_flash_dq_plain(*args, operands=operands, **kw),
            *ca.chunk_flash_dkv_plain(*args, operands=operands, **kw)]
    torch.cuda.synchronize()
    return got, want, blse, delta


def _assert_k6_close(got, want, lse=False, bound=None, tol=None):
    """lse_tolerance for lse; for o, dq, dk, dv kernel_tolerance (f32
    route) or, given the rounding bound, ``tol`` (tc_kernel_tolerance for
    the tensor-core route against operands="bf16")."""
    if lse:
        tol = ca.lse_tolerance(want)
    elif bound is None:
        tol = ca.kernel_tolerance(want)
    else:
        tol = (tol or ca.tc_kernel_tolerance)(want, bound)
    diff = (got - want).abs()
    share = (diff / tol).max().item()
    assert share <= 1.0, (share, diff.max().item())


K6_CASES = {
    # (b, h, c, d, q_off, k_off, n_valid, causal, spec, q scale): the
    # slice's pair (zigzag sub-chunks of 1,088 rows at sp=2) on the
    # diagonal, wholly before and wholly in the future; a peaked softmax
    # (q x 8) on the diagonal; a ragged one (544 rows, not a multiple of
    # the 64-row tile) with n_valid inside the k chunk; the layer kinds'
    # specs on global positions; non-causal
    "slice_diagonal": (2, 8, 1088, 64, 1088, 1088, LS_N, True, None, 1.0),
    "slice_before": (2, 8, 1088, 64, 3264, 0, LS_N, True, None, 1.0),
    "slice_future": (2, 8, 1088, 64, 0, 3264, LS_N, True, None, 1.0),
    "peaked_diagonal": (2, 8, 1088, 64, 1088, 1088, LS_N, True, None, 8.0),
    "ragged_cut": (2, 4, 544, 128, 1088, 544, 900, True, None, 1.0),
    "axial_row": (2, 4, 544, 64, 1632, 1088, LS_N, True, ("axial", LS_TEXT, LS_FMAP, 0), 1.0),
    "axial_col": (2, 4, 544, 64, 1632, 544, LS_N, True, ("axial", LS_TEXT, LS_FMAP, 1), 1.0),
    "conv": (2, 4, 544, 64, 1632, 1088, LS_N, True, ("conv", LS_TEXT, LS_FMAP, 5, 1), 1.0),
    "non_causal": (1, 2, 300, 32, 0, 300, 600, False, None, 1.0),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_kernels_match_plain(dtype, case):
    """f32 operands on the f32 route against the plain versions (the TPU's
    arithmetic) within kernel_tolerance; bf16 operands on the tensor-core
    route against operands="bf16" within tc_kernel_tolerance, and against
    the f32 arithmetic on the same inputs within rounding_tolerance; every
    launch counted, the bf16 ones on the tc_* counters too."""
    b, h, c, d, q_off, k_off, n_valid, causal, spec, mul = K6_CASES[case]
    q, k, v, do = _k4_case(b, h, c, d, dtype, seed=c + d + q_off)
    q = (q.float() * mul).to(dtype)                 # exact: mul is a power of two
    kw = dict(scale=d ** -0.5, n_valid=n_valid, causal=causal, mask_spec=spec)
    tc = dtype == torch.bfloat16
    before = _k6_counts()
    got, want, blse, delta = _k6_all(q, k, v, do, q_off, k_off, kw, "bf16" if tc else "f32")
    assert _k6_counts() == tuple(x + i for x, i in zip(before, (1, 1, 1, tc, tc, tc)))
    bound = (ca.rounding_bound(q, k, v, do, blse, delta, q_off, k_off, **kw) if tc
             else dict.fromkeys(("o", "dq", "dk", "dv")))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        out = ("o", "lse", "dq", "dk", "dv")[i]
        _assert_k6_close(g, w, lse=i == 1, bound=bound.get(out))
    if tc:
        # the cost of the route: the bf16 kernels against the TPU's f32
        # arithmetic on the same inputs and backward statistics
        args = (q, k, v, do, blse, delta, q_off, k_off)
        f32 = [ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, **kw)[0],
               ca.chunk_flash_dq_plain(*args, **kw), *ca.chunk_flash_dkv_plain(*args, **kw)]
        for g, w, out in zip([got[0]] + got[2:], f32, ("o", "dq", "dk", "dv")):
            _assert_k6_close(g, w, bound=bound[out], tol=ca.rounding_tolerance)
    if case == "slice_future":
        assert not got[0].any() and bool((got[1] == -1e9).all())
        assert not any(g.any() for g in got[2:])


def test_chunk_kernels_take_zigzag_views_without_copies():
    """The zigzag ring hands sub-chunk views of its rotating k/v, and rows
    of q, dO, lse and delta: the tensor-core kernels on the views equal the
    kernels on contiguous copies bit for bit, and the plain versions with
    operands="bf16" within the bound."""
    m = 544
    q2, k2, v2, do2 = _k4_case(2, 4, 2 * m, 64, torch.bfloat16, seed=31)
    lse2 = torch.randn(2, 4, 2 * m, device="cuda") + 5.0
    delta2 = torch.randn(2, 4, 2 * m, device="cuda")
    kw = dict(scale=0.125, n_valid=LS_N, causal=True, mask_spec=("axial", LS_TEXT, LS_FMAP, 0))
    views = [t[:, :, m:] for t in (q2, k2, v2, do2, lse2, delta2)]
    assert not views[0].is_contiguous()
    copies = [t.contiguous() for t in views]
    bound = ca.rounding_bound(*copies, 2176, 1632, **kw)
    before = _k6_counts()
    for fn, plain, outs in ((ca.chunk_flash_dq, ca.chunk_flash_dq_plain, ("dq",)),
                            (ca.chunk_flash_dkv, ca.chunk_flash_dkv_plain, ("dk", "dv"))):
        a = fn(*views, 2176, 1632, **kw)
        b = fn(*copies, 2176, 1632, **kw)
        p = plain(*copies, 2176, 1632, operands="bf16", **kw)
        a, b, p = (x if isinstance(x, tuple) else (x,) for x in (a, b, p))
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        for x, y, out in zip(a, p, outs):
            _assert_k6_close(x, y, bound=bound[out])
    o_v, lse_v = ca.chunk_flash_fwd(*views[:3], 2176, 1632, **kw)
    o_c, lse_c = ca.chunk_flash_fwd(*copies[:3], 2176, 1632, **kw)
    assert torch.equal(o_v, o_c) and torch.equal(lse_v, lse_c)
    assert _k6_counts() == tuple(x + i for x, i in zip(before, (2, 2, 2, 2, 2, 2)))


def test_chunk_wrapper_raises_instead_of_falling_back():
    q, k, v, do = _k4_case(1, 2, 64, 32, torch.float32, seed=4)
    lse = torch.zeros(1, 2, 64, device="cuda")
    kw = dict(scale=0.2, n_valid=128)
    with pytest.raises(TypeError):
        ca.chunk_flash_fwd(q.half(), k.half(), v.half(), 0, 0, **kw)
    with pytest.raises(ValueError):
        ca.chunk_flash_fwd(q[..., ::2], k[..., ::2], v[..., ::2], 0, 0, **kw)   # d 16 strided
    with pytest.raises(ValueError):
        ca.chunk_flash_dq(q, k, v, do, lse.double(), lse, 0, 0, **kw)
    with pytest.raises(ValueError):
        ca.chunk_flash_fwd(q, k, v, 0, 0, mask_spec=("block", 64), **kw)
    # a bf16 operand the tensor cores' 16-byte copies cannot take raises,
    # rather than run on the f32 route
    qb = torch.zeros(2 * 64 * 32 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(1, 2, 64, 32)
    before = _k6_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        ca.chunk_flash_fwd(qb, k.bfloat16(), v.bfloat16(), 0, 0, **kw)
    assert _k6_counts() == before


@pytest.mark.parametrize("spec", [None, ("axial", LS_TEXT, LS_FMAP, 1)],
                         ids=["full", "axial_col"])
def test_ring_at_the_layer_matches_k4_on_the_whole_sequence(spec):
    """The slice's layer (b=2, h=8, n=4,352, d=64, f32) through the zigzag
    ring at P = 2, every pair on K6 (16 launches of each kernel), against
    K4 on the whole sequence: output and gradients. Both compute in f32;
    the sums run in another order (kernel_tolerance)."""
    from dalle_tpu_torch.parallel import ring_attention as ra
    base = _k4_case(2, 8, LS_N, 64, torch.float32, seed=41)
    mask = None if spec is None else build_mask("axial_col", LS_TEXT, LS_FMAP)
    outs = {}
    for name in ("ring", "k4"):
        q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
        before = ca.fwd_launches, ca.dq_launches, ca.dkv_launches
        if name == "ring":
            o = ra.ring_attention(q, k, v, nper=2, zigzag=True, mask_spec=spec)
        else:
            o = fl.flash_attention(q, k, v, mask=mask, mask_spec=spec)
        o.backward(base[3])
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (ca.fwd_launches, ca.dq_launches, ca.dkv_launches), before))
        assert launched == ((16, 16, 16) if name == "ring" else (0, 0, 0))
        outs[name] = [o.detach(), q.grad, k.grad, v.grad]
    for g, w in zip(outs["ring"], outs["k4"]):
        _assert_k6_close(g, w)


def test_sp_train_step_on_the_card_goes_through_k6_and_matches_the_cpu(monkeypatch):
    """One sp=2 training step at 2,048 tokens (zigzag sub-chunks of 512 rows:
    "auto" takes K6 on the card), f32 compute, remat on: K6 launched 4·P²
    times a layer each way (the forward twice), K4, K1 and K8 never; the
    loss and gradients equal the same step on the CPU, whose pairs run K6's
    plain versions (summation order: 1e-5 of the loss, 1e-4 of each
    tensor's largest gradient)."""
    from dalle_tpu_torch.config import MeshConfig
    from dalle_tpu_torch.parallel import ring_attention as ra
    cfg = DalleConfig(num_text_tokens=60, text_seq_len=112, dim=64, depth=2, heads=2,
                      dim_head=32, image_size=352, image_vocab_size=48, image_fmap_size=44,
                      attn_types=("full", "axial_row"))
    tc = TrainConfig(batch_size=2, optim=OptimConfig(learning_rate=1e-3),
                     precision=PrecisionConfig(compute="float32"), mesh=MeshConfig(sp=2))
    card, host = DalleTrainer(cfg, tc, device="cuda"), DalleTrainer(cfg, tc, device="cpu")
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    rng = np.random.RandomState(0)
    text = rng.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len))
    img = rng.randint(0, cfg.image_vocab_size, (2, cfg.image_seq_len))
    counts = lambda: (ca.fwd_launches, ca.dq_launches, ca.dkv_launches, fl.fwd_launches,  # noqa: E731
                      fa.fwd_launches, pa.fwd_launches)
    before = counts()
    got = card.train_step(text, img)
    launched = tuple(a - b for a, b in zip(counts(), before))
    assert launched == (2 * 16 * cfg.depth, 16 * cfg.depth, 16 * cfg.depth, 0, 0, 0)
    card_grads = {n: p.grad.cpu() for n, p in card.model.named_parameters()}
    use = ra._use_kernel
    monkeypatch.setattr(ra, "_use_kernel", lambda kernel, chunk, device: use(
        True if kernel is None else kernel, chunk, device))
    want = host.train_step(text, img)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name, p in host.model.named_parameters():
        tol = 1e-4 * p.grad.abs().max().item()
        assert (card_grads[name] - p.grad).abs().max().item() <= tol, name


def test_cli_flow_on_the_card(tmp_path, monkeypatch):
    """The command-line flow at a tiny size on the card: train_dalle (K1
    launched) for 2 steps, a --resume run for one more, then generate in
    bf16 (K2 launched); the dVAE encoder's logits on the card within 1e-5 of
    the CPU's (TF32 off) and its tokens equal wherever the top two differ by
    more than 2e-5."""
    from dalle_tpu_torch.cli import generate, train_dalle
    from dalle_tpu_torch.cli._common import load_vae_sidecar, read_png
    from dalle_tpu_torch.train.checkpoints import CheckpointManager
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ckpt, out = str(tmp_path / "ck"), str(tmp_path / "out")
    argv = ["--synthetic", "--untrained_vae", "--image_size", "32", "--untrained_vae_tokens",
            "64", "--dim", "64", "--depth", "2", "--heads", "2", "--dim_head", "32",
            "--text_seq_len", "16", "--batch_size", "4", "--keep_n_checkpoints", "1",
            "--output_dir", ckpt]
    before = fa.fwd_launches
    assert train_dalle.main(argv + ["--steps", "2"]) == 0
    assert fa.fwd_launches > before
    assert train_dalle.main(argv + ["--steps", "3", "--resume"]) == 0
    assert CheckpointManager(ckpt).all_steps() == [3]
    before = dec.launches
    assert generate.main(["--dalle_path", ckpt, "--text", "red circle", "--num_images", "2",
                          "--batch_size", "2", "--bf16", "--outputs_dir", out]) == 0
    assert dec.launches > before
    assert read_png(str(tmp_path / "out" / "red_circle" / "img_0_1.png")).shape == (32, 32, 3)
    vae = load_vae_sidecar(ckpt, "cuda")
    img = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    got = vae.model.encode_logits(img.cuda()).cpu()
    host = vae.model.to("cpu")
    want = host.encode_logits(img)
    assert (got - want).abs().max().item() <= 1e-5
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 2e-5).reshape(3, -1)
    assert torch.equal(got.argmax(-1).reshape(3, -1)[clear],
                       host.get_codebook_indices(img)[clear])


# ---------------------------------------------------------------------------
# W8: the int8-weight product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 48, 64), (8, 200, 1792), (24, 72, 1792),
                                   (40, 33, 448), (64, 16, 7168)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["tc", "fma"])
def test_int8w_linear_matches_plain_and_is_row_invariant(dtype, shape):
    """W8 within ``int8w_tolerance`` of its plain version on its route, at
    1-4 tiles of 16 rows and a ragged N; rows 0, M/2 and M-1 alone give the
    bits they have inside M rows."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    M, N, K = shape
    gen = torch.Generator("cuda").manual_seed(M + N)
    x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    q = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
    s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
    b = torch.randn(N, device="cuda", generator=gen).to(dtype)
    route = "tc_launches" if dtype == torch.bfloat16 else "fma_launches"
    before = getattr(w8, route)
    got = w8.int8w_linear_kernel(x, q, s, b)
    assert getattr(w8, route) == before + 1
    want = w8.int8w_linear_plain(x, q, s, b)
    torch.cuda.synchronize()
    assert ((got.float() - want.float()).abs() <= w8.int8w_tolerance(x, q, s, b, want)).all()
    for r in sorted({0, M // 2, M - 1}):
        assert torch.equal(w8.int8w_linear_kernel(x[r:r + 1], q, s, b)[0], got[r])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8w_linear_routes_by_rows(dtype):
    """Up to ``MAX_ROWS`` rows launch the kernel, more take the matmul route;
    both within ``int8w_tolerance`` of the plain version."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    gen = torch.Generator("cuda").manual_seed(5)
    N, K = 96, 512
    q = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
    s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
    b = torch.randn(N, device="cuda", generator=gen).to(dtype)
    for M, counter in ((w8.MAX_ROWS, "launches"), (w8.MAX_ROWS + 1, "matmul_calls")):
        x = torch.randn(1, M, K, device="cuda", generator=gen).to(dtype)
        before = getattr(w8, counter)
        got = w8.int8w_linear(x, q, s, b)
        assert getattr(w8, counter) == before + 1 and got.shape == (1, M, N)
        want = w8.int8w_linear_plain(x, q, s, b)
        torch.cuda.synchronize()
        assert ((got.float() - want.float()).abs()
                <= w8.int8w_tolerance(x, q, s, b, want)).all()


def test_int8w_generation_and_speculative_on_the_card():
    """An int8w model generates in-range tokens through W8 and K2; its
    speculative sampler at gamma 2 gives gamma 0's tokens on one draw table
    in f32 compute (the fma routes of W8 and K3)."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    from dalle_tpu_torch.ops.quantize_weights import quantize_params_int8
    model = init_dalle(DalleConfig(**TINY), seed=0, device="cuda")
    m8 = quantize_params_int8(model, compute_dtype=None)
    text = torch.randint(1, 60, (2, 6), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    before = w8.launches
    toks = m8.generate_images_tokens(text, generator=torch.Generator("cuda").manual_seed(1))
    assert w8.launches > before and toks.shape == (2, 16) and int(toks.max()) < 48
    noise = -torch.log(-torch.log(torch.rand(16, 2, 48, device="cuda",
                                             generator=torch.Generator("cuda").manual_seed(2))))
    seq = m8.generate_images_tokens_speculative(text, gamma=0, noise=noise)
    spec = m8.generate_images_tokens_speculative(text, gamma=2, noise=noise)
    assert torch.equal(seq, spec)
