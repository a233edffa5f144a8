"""The port's whole-sequence attention (K8) ≡ the JAX package's, on the same
numpy inputs, on the CPU.

``dalle_tpu_torch.ops.persistent_attention`` runs its plain version for a
CPU tensor (the CUDA kernels are held against it in ``test_torch_cuda.py``).
Here the plain forward, and the backward through the
``torch.autograd.Function``, meet the Pallas kernels in interpret mode, with
and without a table, at ragged lengths and with a row that sees nothing;
``persistent_fits`` meets the JAX gate; the persist-mode ``Transformer``
and two ``DalleTrainer`` steps meet the JAX package's with its mode forced
to "persist" (off the TPU it resolves dense).

Tolerances: against the Pallas kernels 1e-5 for f32 outputs, since both
round to bf16 at the same points and differ only in f32 summation order;
bf16 outputs add one bf16 ulp (2^-7 of the value). Whole models: see the
asserts.
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
from dalle_tpu.ops import flash_attention as jflash
from dalle_tpu.ops import persistent_attention as jpa
from dalle_tpu.ops.attn_masks import build_mask
from dalle_tpu.parallel.mesh import build_mesh
from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
from dalle_tpu_torch.config import (DalleConfig, OptimConfig, PrecisionConfig, TrainConfig,
                                    TransformerConfig)
from dalle_tpu_torch.convert import flax_to_state_dict
from dalle_tpu_torch.models.transformer import Transformer
from dalle_tpu_torch.ops import flash_attention as tflash
from dalle_tpu_torch.ops import fused_attention as tfa
from dalle_tpu_torch.ops import persistent_attention as tpa
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

TEXT_LEN, FMAP = 4, 4
N = TEXT_LEN + FMAP * FMAP          # 20 positions: a (21, 21) mask's top-left block
MASKS = {"none": None, "axial_row": "axial_row", "conv_like": "conv_like",
         "sparse": "sparse"}


def _mask(kind, n=N):
    """(JAX numpy mask, port int8 table) of a case. The JAX transformer
    hands the kernel its (n+1)² training mask, whose (n, n) block the kernel
    reads; the port hands K8 K1's causal table. "holes" hides row 5 whole."""
    if kind in (None, "none"):
        return None, None
    if kind == "holes":
        mask = np.tril(np.ones((n, n), bool))
        mask[5] = False
    else:
        mask = build_mask(kind, TEXT_LEN + 1, FMAP, kernel_size=3, block=4)
    return mask, torch.from_numpy(tfa.validity_table(n, mask))


def _qkv(seed, b=2, h=2, n=N, d=16):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4)]


def _as(x, dt):
    if dt == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _np(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, dt):
    tol = 1e-5 + (2.0 ** -7 * np.abs(_np(want)) if dt == "bf16" else 0.0)
    assert np.all(np.abs(_np(got) - _np(want)) <= tol), np.abs(_np(got) - _np(want)).max()


# ---------------------------------------------------------------------------
# the kernel's function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MASKS) + ["holes"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_forward_matches_pallas(dt, kind):
    q, k, v, _ = _qkv(len(kind))
    mask, table = _mask(kind)
    jq, jk, jv = (_as(t, dt)[0] for t in (q, k, v))
    tq, tk, tv = (_as(t, dt)[1] for t in (q, k, v))
    ref = jpa.persistent_attention(jq, jk, jv, mask, None, True)
    out = tpa.persistent_attention(tq, tk, tv, table)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, dt)


@pytest.mark.parametrize("kind", ["none", "axial_row", "holes"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gradients_match_jax_grad(dt, kind):
    q, k, v, do = _qkv(7 + len(kind))
    mask, table = _mask(kind)
    jargs = [_as(t, dt)[0] for t in (q, k, v)]
    targs = [_as(t, dt)[1].requires_grad_(True) for t in (q, k, v)]

    def jloss(a, b, c):
        return jnp.sum(jpa.persistent_attention(a, b, c, mask, None, True)
                       .astype(jnp.float32) * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    (tpa.persistent_attention(*targs, table).float() * torch.from_numpy(do)).sum().backward()
    for t, r in zip(targs, ref):
        assert t.grad.dtype == t.dtype
        _close(t.grad, r, dt)


@pytest.mark.parametrize("n, d", [(37, 16), (77, 32), (129, 64)])
def test_ragged_lengths_match_pallas(n, d):
    """Lengths that are no multiple of 16 or 64, forward and gradients."""
    q, k, v, do = _qkv(n, b=1, h=2, n=n, d=d)
    ref = jpa.persistent_attention(*(jnp.asarray(t) for t in (q, k, v)), None, None, True)
    targs = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tpa.persistent_attention(*targs)
    _close(out, ref, "f32")
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jpa.persistent_attention(
        a, b, c, None, None, True) * do), argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    (out * torch.from_numpy(do)).sum().backward()
    for t, r in zip(targs, jgrads):
        _close(t.grad, r, "f32")


def test_a_row_that_sees_nothing_averages_every_key():
    """The TPU kernel's -1e9 fill makes an empty row's softmax 1/n over all
    n keys, future ones included; the plain version keeps that."""
    q, k, v, _ = _qkv(3, b=1, h=1)
    _, table = _mask("holes")
    out = tpa.persist_fwd_plain(*(torch.from_numpy(t) for t in (q, k, v)), table)
    v16 = torch.from_numpy(v).bfloat16().float()
    want = (torch.full((N,), 1.0 / N).bfloat16().float() @ v16[0, 0])
    torch.testing.assert_close(out[0, 0, 5], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_persistent_fits_equals_jax(d):
    """The routing gate, verbatim: the same answer over a grid of lengths
    that crosses the edge (about 800 at d = 64)."""
    for n in list(range(1, 1400, 11)) + [512, 513, 771, 772, 773, 803, 804, 805, 1280]:
        assert tpa.persistent_fits(n, d) == jpa.persistent_fits(n, d), (n, d)


def test_cpu_runs_count_no_launch():
    q, k, v, do = _qkv(5)
    targs = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    before = tpa.fwd_launches, tpa.bwd_launches
    (tpa.persistent_attention(*targs) * torch.from_numpy(do)).sum().backward()
    assert (tpa.fwd_launches, tpa.bwd_launches) == before


@pytest.mark.parametrize("case, err", [
    ("f64", TypeError), ("rank3", ValueError), ("d_unaligned", ValueError),
    ("d_too_big", ValueError), ("k_shape", ValueError), ("bool_table", ValueError),
    ("short_table", ValueError), ("dout_shape", ValueError)])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    """The checks that guard the CUDA launch (on CPU tensors they run before
    any device work; the shared-memory check needs the card)."""
    b, h, n, d = 2, 2, 40, {"d_unaligned": 24, "d_too_big": 144}.get(case, 32)
    q = torch.zeros(b, h, n, d, dtype=torch.float64 if case == "f64" else torch.float32)
    if case == "rank3":
        q = q[0]
    k = torch.zeros(b, h, n + (case == "k_shape"), d)
    table = None
    if case in ("bool_table", "short_table"):
        table = torch.ones(n, n - (case == "short_table"),
                           dtype=torch.bool if case == "bool_table" else torch.int8)
    do = torch.zeros(b, h, n - 1, d) if case == "dout_shape" else None
    with pytest.raises(err):
        tpa._check_cuda(q, k, k if case != "k_shape" else q, table, do)


def test_cuda_wrapper_accepts_the_main_path_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(8, 14, 512, 128, dtype=dtype)
        assert tpa._check_cuda(q, q, q, None, q) == 128
    q = torch.zeros(1, 2, 513, 64).transpose(1, 2).reshape(1, 2, 513, 64)
    assert tpa._check_cuda(q, q, q, torch.ones(513, 513, dtype=torch.int8)) == 64


# ---------------------------------------------------------------------------
# the mode, the transformer, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq, d, device, want", [
    (512, 128, "cuda", "persist"), (512, 128, "cpu", "persist"), (513, 64, None, "persist"),
    (1280, 64, "cuda", False), (800, 128, "cuda", False), (4352, 64, "cuda", False)])
def test_resolve_persist(seq, d, device, want):
    """"persist" is K8 on any device where persistent_fits holds, dense where
    it does not: the JAX package's answer with the card for the TPU."""
    assert tflash.resolve_use_pallas("persist", seq, device, dim_head=d) == want
    assert jflash.resolve_use_pallas("persist", seq, backend="tpu", dim_head=d) == want


@pytest.mark.parametrize("kw, want", [
    ({}, "persist"), (dict(stable=True), False), (dict(causal=False), False)])
def test_attention_mode_takes_only_causal_layers_without_stable(kw, want):
    cfg = TransformerConfig(dim=32, depth=1, heads=2, dim_head=16, seq_len=20,
                            image_fmap_size=4, use_pallas="persist", **kw)
    tm = Transformer(cfg)
    assert tm.attention_mode(torch.device("cpu")) == want
    assert tm.attention_mode(torch.device("cpu"), key_mask=torch.ones(1, 20)) is False


@pytest.mark.parametrize("attn_types", [("full",), ("full", "axial_row", "conv_like")])
def test_persist_transformer_matches_jax(attn_types, monkeypatch):
    """Both packages in persist mode (Pallas in interpret mode, the port's
    plain versions). Both round q, k, v and p to bf16 at the same points,
    but their f32 activations differ in the last bit, so a few roundings
    flip; each moves one value by a bf16 ulp: within 2e-3 of the largest
    output, where the dense path would differ by 3e-2."""
    monkeypatch.setattr(jflash, "resolve_use_pallas", lambda *a, **k: "persist")
    kw = dict(dim=32, depth=3, heads=2, dim_head=16, seq_len=24, image_fmap_size=4,
              sparse_attn_kernel=3, attn_types=attn_types)
    x = np.random.RandomState(0).standard_normal((2, 25, 32)).astype(np.float32)
    jm = JTransformer(JTransformerConfig(**kw, use_pallas="persist"))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = Transformer(TransformerConfig(**kw, use_pallas="persist")).eval()
    tm.load_state_dict(flax_to_state_dict(params))
    assert tm.attention_mode(torch.device("cpu")) == "persist"
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-3 * np.abs(ref).max(), rtol=0)


SMALL = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4, dim_head=16,
             image_size=16, image_vocab_size=48, image_fmap_size=4,
             attn_types=("full", "axial_row"), use_pallas="persist")


def test_two_trainer_steps_match_jax_trainer(tmp_path, monkeypatch):
    """Two Adam steps with K8 in every layer on both sides, f32 compute.
    Losses agree to 1e-4 relative. K8's bf16 roundings flip in places (its
    f32 inputs differ in the last bit between the frameworks), which moves a
    gradient by up to ~1e-2 of its tensor's largest entry; Adam divides that
    out on small entries, so each step's update is held where the gradient
    is above 5 % of its tensor's largest, within lr/4, and at most 5 % of a
    tensor's updates may differ by more than lr/2."""
    monkeypatch.setattr(jflash, "resolve_use_pallas", lambda *a, **k: "persist")
    optim = dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5)
    jtc = JTrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                       mesh=JMeshConfig(), precision=JPrecisionConfig(compute="float32"),
                       optim=JOptimConfig(**optim), device_prefetch=0)
    jtr = JDalleTrainer(JDalleConfig(**SMALL), jtc,
                        mesh=build_mesh(JMeshConfig(), devices=jax.devices()[:1]))
    tr = DalleTrainer(DalleConfig(**SMALL),
                      TrainConfig(batch_size=2, optim=OptimConfig(**optim),
                                  precision=PrecisionConfig(compute="float32")), device="cpu")
    tr.load_jax_state(jax.device_get(jtr.state.params))
    assert tr.model.transformer.attention_mode(torch.device("cpu")) == "persist"
    rng = np.random.RandomState(4)
    lr = optim["learning_rate"]
    for step in range(2):
        text = rng.randint(1, SMALL["num_text_tokens"], (2, 6)).astype(np.int32)
        text[:, -2:] = 0
        img = rng.randint(0, SMALL["image_vocab_size"], (2, 16)).astype(np.int32)
        got_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        want_before = flax_to_state_dict(jax.device_get(jtr.state.params))
        ref, got = jtr.train_step(text, img), tr.train_step(text, img)
        for key in ("loss", "loss_text", "loss_img"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, err_msg=f"{step} {key}")
        want = flax_to_state_dict(jax.device_get(jtr.state.params))
        for name, p in tr.model.named_parameters():
            diff = np.abs((p.detach() - got_before[name]).numpy()
                          - (want[name] - want_before[name]).numpy())
            g = np.abs(p.grad.numpy())
            clear = g > 0.05 * g.max()
            assert diff[clear].max(initial=0.0) <= lr / 4, f"step {step} {name}"
            assert np.mean(diff > lr / 2) <= 0.05, f"step {step} {name}"
