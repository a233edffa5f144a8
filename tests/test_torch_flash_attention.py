"""The port's block-sparse flash attention (K4) ≡ the JAX package's, on the
same numpy inputs, on the CPU.

``dalle_tpu_torch.ops.flash_attention`` runs its plain versions for a CPU
tensor (the CUDA kernels are held against them in ``test_torch_cuda.py``).
Here they meet the Pallas kernels in interpret mode, the JAX package's
default off the TPU: the block lists, the forward, dq/dk/dv through the
``torch.autograd.Function``, every mask kind, the fully masked row, spec ≡
table and block spec ≡ table; then the attention-mode table, the flash-mode
Transformer, the DALL·E loss and gradients, and two ``DalleTrainer`` steps
against the JAX trainer, on the long-sequence shape cut to a small size.

Tolerances: both packages compute K4 in f32 from the same inputs and differ
only in the order of their sums, so outputs and gradients agree to 2e-5
absolute (the bound ``tests/test_flash_attention.py`` holds the kernel to
against dense attention), with 2e-5 relative for the larger gradients. bf16
outputs add one bf16 rounding of values that differ that little: 2^-7
relative. The structured spec and the block spec run the same arithmetic as
the tabled mask on the same schedule, so those are held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import MeshConfig as JMeshConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.config import PrecisionConfig as JPrecisionConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.config import TransformerConfig as JTransformerConfig
from dalle_tpu.models.transformer import Transformer as JTransformer
from dalle_tpu.ops import flash_attention as jfl
from dalle_tpu.ops.attn_masks import block_sparse_mask, build_mask
from dalle_tpu.parallel.mesh import build_mesh
from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
from dalle_tpu_torch.config import DalleConfig, OptimConfig, PrecisionConfig, TrainConfig
from dalle_tpu_torch.config import TransformerConfig
from dalle_tpu_torch.convert import flax_to_state_dict
from dalle_tpu_torch.models.transformer import Transformer
from dalle_tpu_torch.ops import flash_attention as tfl
from dalle_tpu_torch.ops import fused_attention as tfa
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

TEXT_LEN, FMAP = 17, 8
N = TEXT_LEN + FMAP * FMAP - 1       # 80 positions: the masks are built for 81
ATOL = 2e-5


def _launches():
    return (tfl.fwd_launches, tfl.bwd_dq_launches, tfl.bwd_dkv_launches,
            tfa.fwd_launches, tfa.bwd_launches)


def _mask(kind, text_len=TEXT_LEN, fmap=FMAP):
    """(numpy mask, spec) as the JAX transformer hands them to the kernel:
    the mask one position longer than the sequence, and the structured spec.
    "sparse" is a 32-block random pattern, tabled (32 is no multiple of
    either package's tile)."""
    if kind == "none":
        return None, None
    spec = {"axial_row": ("axial", text_len, fmap, 0), "axial_col": ("axial", text_len, fmap, 1),
            "conv_like": ("conv", text_len, fmap, 3, 1), "sparse": None}[kind]
    mask = build_mask(kind, text_len, fmap, kernel_size=3, block=32, num_random_blocks=1)
    return mask, spec


def _qkv(b, h, n, d, seed, n_out=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(n_out)]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    "causal": (None, True), "non_causal": (None, False),
    "axial_row": ("axial_row", True), "conv_like": ("conv_like", True),
    "sparse": ("sparse", True),
}


@pytest.mark.parametrize("geometry", [(128, 32, 32), (192, 64, 64), (128, 64, 32)])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_lists_and_sparsity_match_jax(case, geometry):
    kind, causal = BLOCK_CASES[case]
    mask = None if kind is None else _mask(kind)[0]          # (81, 81)
    n_pad, bq, bk = geometry
    got = tfl.build_block_lists(n_pad, bq, bk, mask, causal)
    want = jfl.build_block_lists(n_pad, bq, bk, mask, causal)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tfl.sparsity_fraction(N, bq, bk, mask, causal) == jfl.sparsity_fraction(
        N, bq, bk, mask, causal)


def test_block_lists_trim_a_mask_larger_than_the_sequence():
    """The transformer's masks cover seq_len + 1 positions; training feeds
    seq_len. The lists use the mask's top-left block."""
    mask = build_mask("axial_col", 40, 16)                  # (296, 296)
    got = tfl.build_block_lists(256, 64, 64, mask)
    want = jfl.build_block_lists(256, 64, 64, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tfl.flash_schedule(200, mask).table.shape == (200, 200)


def test_schedule_kinds():
    mask, spec = _mask("conv_like")
    assert tfl.flash_schedule(N, mask, spec).kind == tfl.MASK_CONV
    assert tfl.flash_schedule(N, mask, ("axial", 17, 8, 1)).kind == tfl.MASK_AXIAL_COL
    assert tfl.flash_schedule(N, mask).kind == tfl.MASK_TABLE
    assert tfl.flash_schedule(N, mask, ("block", 128)).kind == tfl.MASK_NONE
    assert tfl.flash_schedule(N, mask, ("block", 32)).kind == tfl.MASK_TABLE
    s = tfl.flash_schedule(130, causal=True)
    assert s.k_cnt.tolist() == [1, 2, 3] and s.q_cnt.tolist() == [3, 2, 1]
    assert s.visited_tiles == 6 and tfl.visible_pairs(s) == 130 * 131 // 2
    with pytest.raises(ValueError):
        tfl.flash_schedule(N, mask[:40, :40])               # smaller than (n, n)


# ---------------------------------------------------------------------------
# the forward and the gradients against the Pallas kernels
# ---------------------------------------------------------------------------

FWD_CASES = {
    "causal_96": (96, "none", True, "f32"), "causal_130": (130, "none", True, "f32"),
    "axial_row": (N, "axial_row", True, "f32"), "axial_col": (N, "axial_col", True, "f32"),
    "conv_like": (N, "conv_like", True, "f32"), "sparse": (N, "sparse", True, "f32"),
    "non_causal": (100, "none", False, "f32"), "axial_row_bf16": (N, "axial_row", True, "bf16"),
    "causal_bf16": (130, "none", True, "bf16"),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_pallas(case):
    n, kind, causal, dt = FWD_CASES[case]
    mask, spec = _mask(kind)
    q, k, v = _qkv(2, 3, n, 16, seed=n, n_out=3)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jfl.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), mask=mask,
                              mask_spec=spec, causal=causal)
    out = tfl.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), mask=mask,
                              mask_spec=spec, causal=causal)
    assert out.dtype == tdt and out.shape == (2, 3, n, 16)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL,
                               rtol=0 if dt == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("kind", ["none", "axial_row", "conv_like", "sparse"])
def test_gradients_match_jax_grad(kind):
    mask, spec = _mask(kind)
    q, k, v, do = _qkv(2, 2, N, 32, seed=7)

    def jloss(q, k, v):
        return jnp.sum(jfl.flash_attention(q, k, v, mask=mask, mask_spec=spec) * do)

    ref = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = _launches()
    (tfl.flash_attention(*t, mask=mask, mask_spec=spec) * torch.from_numpy(do)).sum().backward()
    assert _launches() == before                              # CPU runs count no launch
    for got, want in zip(t, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_fully_masked_row_gives_zero_and_finite_gradients():
    n = 70
    mask = np.tril(np.ones((n, n), dtype=bool))
    mask[10, :] = False                                       # row 10 sees nothing
    q, k, v, do = _qkv(2, 3, n, 16, seed=8)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfl.flash_attention(*t, mask=mask)
    assert torch.equal(out[:, :, 10], torch.zeros_like(out[:, :, 10]))
    _, lse = tfl.flash_fwd_plain(*(x.detach() for x in t), tfl.flash_schedule(n, mask))
    assert bool((lse[:, :, 10] == 1e9).all())
    (out * torch.from_numpy(do)).sum().backward()

    def jloss(q, k, v):
        return jnp.sum(jfl.flash_attention(q, k, v, mask=mask) * do)

    ref = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for got, want in zip(t, ref):
        assert bool(torch.isfinite(got.grad).all())
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_np(out), _np(jfl.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), mask=mask)), atol=ATOL)


def _value_and_grads(q, k, v, do, **kw):
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfl.flash_attention(*t, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    return [out.detach()] + [x.grad for x in t]


@pytest.mark.parametrize("kind", ["axial_row", "axial_col", "conv_like"])
def test_structured_spec_equals_table_bit_for_bit(kind):
    mask, spec = _mask(kind)
    q, k, v, do = _qkv(2, 2, N, 16, seed=9)
    a = _value_and_grads(q, k, v, do, mask=mask, mask_spec=spec)
    b = _value_and_grads(q, k, v, do, mask=mask)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n, B", [(26, 8), (300, 128), (200, 64)])
def test_block_spec_equals_table(n, B):
    """A ("block", B) spec: B a multiple of the tile is encoded by the block
    lists alone; any other B takes the tabled mask. Either way the same
    function as the table, bit for bit, and the JAX package's within 2e-5."""
    mask = np.asarray(block_sparse_mask(n, text_len=10, block=B, num_random_blocks=1, seed=3))
    q, k, v, do = _qkv(2, 2, n, 16, seed=n)
    spec = _value_and_grads(q, k, v, do, mask=mask, mask_spec=("block", B))
    table = _value_and_grads(q, k, v, do, mask=mask)
    for x, y in zip(spec, table):
        assert torch.equal(x, y)

    def jloss(q, k, v):
        return jnp.sum(jfl.flash_attention(q, k, v, mask=mask, mask_spec=("block", B)) * do)

    ref = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for got, want in zip(spec[1:], ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_launch_checks_guard_the_kernel():
    """The checks that guard the CUDA launch run before any device work."""
    q = torch.zeros(1, 2, 70, 32)
    sched = tfl.flash_schedule(70)
    assert tfl._check_cuda(q, q, q, sched) == 32
    for bad, err in ((q.double(), TypeError), (torch.zeros(1, 2, 70, 24), ValueError),
                     (torch.zeros(1, 2, 70, 64)[..., ::2], ValueError)):
        with pytest.raises(err):
            tfl._check_cuda(bad, bad, bad, sched)
    with pytest.raises(ValueError):
        tfl._check_cuda(q, q, q, tfl.flash_schedule(71))
    with pytest.raises(ValueError):                               # lse missing
        tfl._check_cuda(q, q, q, sched, do=q)
    # the head split of a qkv projection: strided, dense along d
    qkv = torch.zeros(1, 70, 3 * 2 * 32)
    split = [t.reshape(1, 70, 2, 32).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    assert tfl._check_cuda(*split, sched) == 32


# ---------------------------------------------------------------------------
# attention-mode resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", ["auto", "fused", "flash", "on", "1", "true", "yes", True,
                                     "off", False, "0", "none"])
@pytest.mark.parametrize("seq", [512, 2047, 2048, 4352])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_use_pallas_table(setting, seq, device):
    """The JAX package's table with the card in place of the TPU: "auto" is
    K4 at 2048 tokens and above on the card, K1 below, dense on the CPU;
    the explicit settings pick their kernel on any device."""
    s = str(setting).lower()
    if s == "auto":
        want = False if device == "cpu" else ("flash" if seq >= 2048 else "fused")
    elif s == "fused":
        want = "fused"
    elif s in ("flash", "on", "1", "true", "yes"):
        want = "flash"
    else:
        want = False
    assert tfl.resolve_use_pallas(setting, seq, device) == want
    # where the JAX package's answer does not hang on its VMEM gates, it is
    # the same (its mode "flash" is spelled "on" in a config)
    if s == "auto" and (device == "cpu" or seq >= 2048):
        jwant = jfl.resolve_use_pallas("auto", seq, backend="tpu" if device == "cuda" else "cpu")
        assert jwant == want
    elif s not in ("auto", "fused", "flash"):
        assert jfl.resolve_use_pallas(setting, seq, backend="tpu") == want


def test_persist_and_unknown_settings_raise():
    """"persist" (K8, ported since) resolves by the JAX package's gate:
    K8 where persistent_fits holds, dense where it does not; an unknown
    setting still raises."""
    assert tfl.resolve_use_pallas("persist", 512, "cuda", dim_head=128) == "persist"
    assert tfl.resolve_use_pallas("persist", 1280, "cuda", dim_head=64) is False
    with pytest.raises(ValueError):
        tfl.resolve_use_pallas("sometimes", 512, "cuda")


# ---------------------------------------------------------------------------
# the slice: the flash-mode transformer, the DALL·E loss, the trainer
# ---------------------------------------------------------------------------

TRANSFORMER_CASES = {
    "every_mask": dict(attn_types=("full", "axial_row", "axial_col", "conv_like")),
    "stable": dict(attn_types=("full", "axial_row"), stable=True),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMER_CASES))
def test_flash_transformer_matches_jax(case):
    kw = dict(dim=32, depth=4, heads=2, dim_head=16, seq_len=80, image_fmap_size=8,
              sparse_attn_kernel=3, **TRANSFORMER_CASES[case])
    x = np.random.RandomState(0).standard_normal((2, 80, 32)).astype(np.float32)
    jm = JTransformer(JTransformerConfig(**kw, use_pallas=True))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    ref = jm.apply(params, jnp.asarray(x))
    tm = Transformer(TransformerConfig(**kw, use_pallas="flash")).eval()
    tm.load_state_dict(flax_to_state_dict(params))
    before = _launches()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert _launches() == before
    assert tm.attention_mode(torch.device("cpu")) == "flash"
    # f32 on both sides, four layers of summation-order differences
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


LS_SMALL = dict(num_text_tokens=60, text_seq_len=8, dim=64, depth=4, heads=4, dim_head=16,
                image_size=64, image_vocab_size=48, image_fmap_size=8,
                attn_types=("full", "axial_row", "axial_col", "full"), attn_softmax_f32=False)


def _jax_trainer(tmp_path, optim):
    tc = JTrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                      mesh=JMeshConfig(), precision=JPrecisionConfig(compute="float32"),
                      optim=JOptimConfig(**optim), device_prefetch=0)
    return JDalleTrainer(JDalleConfig(**LS_SMALL, use_pallas="on"), tc,
                         mesh=build_mesh(JMeshConfig(), devices=jax.devices()[:1]))


def test_train_steps_on_the_long_sequence_shape_match_jax_trainer(tmp_path):
    """Two Adam steps on the long-sequence model's shape cut to a small size
    (4 layers, full/axial_row/axial_col/full, 8 text tokens, an 8×8 grid),
    K4 in every layer on both sides (Pallas in interpret mode, the port's
    plain versions), use_remat on: losses and updated parameters."""
    optim = dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5)
    jtr = _jax_trainer(tmp_path, optim)
    tr = DalleTrainer(DalleConfig(**LS_SMALL, use_pallas="on"),
                      TrainConfig(batch_size=2, optim=OptimConfig(**optim),
                                  precision=PrecisionConfig(compute="float32")), device="cpu")
    tr.load_jax_state(jax.device_get(jtr.state.params))
    assert tr.model.transformer.attention_mode(torch.device("cpu")) == "flash"
    assert tr.model_cfg.use_remat
    rng = np.random.RandomState(5)
    before = _launches()
    # Adam's first update is lr·g/(|g| + 1e-8): where a gradient is within
    # 100 eps of zero, the two packages' summation-order noise moves that
    # element's update by up to 2·lr (measured 2.6e-5 at |g| = 1e-8). Such
    # elements are held to 2·lr per step, the rest to f32 summation order
    # (an exact zero, as an unused embedding row's, moves neither side).
    tiny = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in tr.model.named_parameters()}
    for step in range(2):
        text = rng.randint(1, LS_SMALL["num_text_tokens"], (2, 8)).astype(np.int32)
        text[:, -2:] = 0
        img = rng.randint(0, LS_SMALL["image_vocab_size"], (2, 64)).astype(np.int32)
        ref, got = jtr.train_step(text, img), tr.train_step(text, img)
        for key in ("loss", "loss_text", "loss_img", "grad_norm"):
            # f32: summation order
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, err_msg=f"{step} {key}")
        want = flax_to_state_dict(jax.device_get(jtr.state.params))
        for name, p in tr.model.named_parameters():
            tiny[name] |= (p.grad.abs() < 1e-6) & (p.grad != 0)
            diff = (p.detach() - want[name]).abs()
            close = diff <= 2e-5 + 1e-4 * want[name].abs()
            assert bool(close[~tiny[name]].all()), f"step {step} {name}"
            assert bool((diff[tiny[name]] <= 2 * optim["learning_rate"] * (step + 1)).all())
    share = sum(int(t.sum()) for t in tiny.values()) / sum(t.numel() for t in tiny.values())
    assert share <= 0.01, share
    assert _launches() == before
