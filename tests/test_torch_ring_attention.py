"""The port's ring attention and chunk kernels (K6) ≡ the JAX package's, on
the same numpy inputs, on the CPU.

``dalle_tpu_torch.ops.chunk_attention`` runs its plain versions for a CPU
tensor (the CUDA kernels are held against them in ``test_torch_cuda.py``).
Here they meet the Pallas chunk kernels in interpret mode, pair by pair.
The whole ring (P = 2 and 4 ranks in one process, plain and zigzag layout,
dense body and kernel body) is held against the JAX package's dense
``attend``, forward and ``jax.grad``: JAX's own tests hold its ring to
dense attention, and running its ring here costs seconds a call, so it is
called twice, forward only. The sequence-parallel model and trainer are held
against the JAX model without sp (whose own test holds sp2 ≡ sp1) and
against the port without sp. The ``torch.distributed`` ring is in
``test_torch_ring_gloo.py``.

Tolerances, each with its reason at the assert: K6 pairs 1e-5 relative +
1e-5 absolute (f32 on both sides, sums in another order); the ring 2e-5
(forward) and 3e-5 (gradients), JAX's own bounds for ring ≡ dense; the
model 1e-3 relative on the loss against JAX (JAX's own sp2 ≡ sp1 bound),
and tighter against the port without sp.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import TransformerConfig as JTransformerConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.transformer import Transformer as JTransformer
from dalle_tpu.ops import chunk_attention as jca
from dalle_tpu.ops.attention import attend
from dalle_tpu.ops.attn_masks import build_mask
from dalle_tpu.ops.flash_attention import elem_fn_from_spec as jelem_fn
from dalle_tpu_torch.config import (DalleConfig, MeshConfig, OptimConfig, PrecisionConfig,
                                    TrainConfig, TransformerConfig)
from dalle_tpu_torch.convert import dalle_state_dict, flax_to_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.transformer import Transformer
from dalle_tpu_torch.ops import chunk_attention as tca
from dalle_tpu_torch.parallel import ring_attention as tring
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

# the module (the JAX package's __init__ re-exports its function under the
# module's name)
jring = importlib.import_module("dalle_tpu.parallel.ring_attention")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _launches():
    return tca.fwd_launches, tca.dq_launches, tca.dkv_launches


# ---------------------------------------------------------------------------
# K6 pair by pair against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

C, D = 32, 16
TEXT_LEN, FMAP = 17, 8
# (q_off, k_off, n_valid, causal, mask spec): a chunk wholly before the q
# chunk, on the diagonal, wholly in its future, an n_valid cut through the k
# chunk, non-causal, and the axial and conv specs on global positions
PAIRS = {
    "before": (64, 0, 96, True, None),
    "diagonal": (32, 32, 96, True, None),
    "future": (0, 64, 96, True, None),
    "n_valid_cut": (32, 32, 50, True, None),
    "non_causal": (0, 32, 96, False, None),
    "axial_row": (32, 16, 81, True, ("axial", TEXT_LEN, FMAP, 0)),
    "conv": (64, 32, 81, True, ("conv", TEXT_LEN, FMAP, 3, 1)),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_chunk_kernels_match_pallas(case):
    q_off, k_off, n_valid, causal, spec = PAIRS[case]
    rng = np.random.RandomState(sorted(PAIRS).index(case))
    q, k, v, do = (rng.standard_normal((1, 2, C, D)).astype(np.float32) for _ in range(4))
    scale = D ** -0.5
    jkw = dict(scale=scale, n_valid=n_valid, causal=causal, block_q=8, block_k=8,
               elem_fn=jelem_fn(spec), interpret=True)
    tkw = dict(scale=scale, n_valid=n_valid, causal=causal, mask_spec=spec)
    jo, jlse = jca.chunk_flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, **jkw)
    before = _launches()
    to, tlse = tca.chunk_flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), q_off, k_off,
                                   **tkw)
    # f32 on both sides, sums in another order
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(_np(tlse), _np(jlse), **tol)
    if case == "future":
        assert not to.any() and bool((tlse == -1e9).all())
    # the backward takes the final lse with empty rows flipped to +1e9, as
    # the ring hands it over, and delta = rowsum(dO·o)
    lse = np.where(_np(tlse) <= -5e8, 1e9, _np(tlse)).astype(np.float32)
    delta = (do * _np(to)).sum(-1).astype(np.float32)
    args = (q, k, v, do, lse, delta)
    jdq = jca.chunk_flash_dq(*(jnp.asarray(x) for x in args), q_off, k_off, **jkw)
    jdk, jdv = jca.chunk_flash_dkv(*(jnp.asarray(x) for x in args), q_off, k_off, **jkw)
    targs = [torch.from_numpy(x) for x in args]
    tdq = tca.chunk_flash_dq(*targs, q_off, k_off, **tkw)
    tdk, tdv = tca.chunk_flash_dkv(*targs, q_off, k_off, **tkw)
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    # a CPU tensor takes the plain version and launches nothing
    assert _launches() == before


def test_chunk_kernels_take_bf16_inputs():
    """bf16 q, k, v, dO are cast to f32 first, on both sides, and the
    outputs are f32: the same 1e-5 bound as f32 inputs."""
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.standard_normal((1, 2, C, D)).astype(np.float32) for _ in range(4))
    kw = dict(scale=D ** -0.5, n_valid=96, causal=True)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    jo, jlse = jca.chunk_flash_fwd(*jb[:3], 32, 32, block_q=8, block_k=8, interpret=True, **kw)
    to, tlse = tca.chunk_flash_fwd(*tb[:3], 32, 32, **kw)
    assert to.dtype == torch.float32 and tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tlse), _np(jlse), rtol=1e-5, atol=1e-5)


def test_merge_pick_block_and_zigzag_perm_match_jax():
    rng = np.random.RandomState(3)
    o1, o2 = (rng.standard_normal((2, 3, 5, 4)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 5)).astype(np.float32) for _ in range(2))
    l1[0, 0] = -1e9                  # an empty contribution
    l1[1, 2, :2] = l2[1, 2, :2] = -1e9   # two: -1e9 + log 2
    jo, jl = jca.merge_chunk(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    to, tl = tca.merge_chunk(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    # logaddexp and exp in f32 on both sides
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-6, atol=1e-6)
    for n in (1, 6, 7, 8, 24, 512, 544, 1088, 1045, 2089, 4096):
        assert tca.pick_block(n) == jca.pick_block(n), n
    for nper, m in ((1, 3), (2, 8), (4, 5), (8, 1)):
        np.testing.assert_array_equal(tring.zigzag_perm(nper, m), jring.zigzag_perm(nper, m))


# ---------------------------------------------------------------------------
# the whole ring against JAX's dense attention
# ---------------------------------------------------------------------------

R_TEXT, R_FMAP = 28, 6
N = R_TEXT + R_FMAP * R_FMAP        # 64: every layout's chunk tiles at P = 2 and 4
SPECS = {"none": None, "axial_row": ("axial", R_TEXT, R_FMAP, 0),
         "axial_col": ("axial", R_TEXT, R_FMAP, 1),
         "conv_like": ("conv", R_TEXT, R_FMAP, 3, 1)}


def _qkv(n, seed, b=2, h=2, d=16):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _dense_ref(n, kind, causal, seed):
    """JAX's dense attention and the gradients of sum(sin(·)): (out,
    (dq, dk, dv)) as numpy."""
    q, k, v = (jnp.asarray(x) for x in _qkv(n, seed))
    static = None
    if kind != "none":
        static = jnp.asarray(build_mask(kind, R_TEXT, R_FMAP, kernel_size=3)[:n, :n])

    def f(q, k, v):
        return attend(q, k, v, causal=causal, static_mask=static)

    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))), (0, 1, 2))(q, k, v)
    return np.asarray(f(q, k, v)), tuple(np.asarray(g) for g in grads)


def _ring_value_and_grads(n, seed, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(n, seed))
    out = tring.ring_attention(q, k, v, **kw)
    out.sin().sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


def _assert_ring(got, want):
    out, grads = got
    # JAX's own bounds for its ring ≡ dense: 2e-5 forward, 3e-5 gradients
    np.testing.assert_allclose(_np(out), want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(_np(g), w, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("kernel", [False, True], ids=["dense_body", "kernel_body"])
@pytest.mark.parametrize("zigzag", [False, True], ids=["plain", "zigzag"])
@pytest.mark.parametrize("nper", [2, 4])
def test_ring_matches_dense_attention(nper, zigzag, kernel):
    """Causal with no mask and with the axial_row, axial_col and conv_like
    specs, and (plain layout) non-causal: forward and gradients."""
    cases = [(kind, True) for kind in SPECS] + ([] if zigzag else [("none", False)])
    for kind, causal in cases:
        got = _ring_value_and_grads(N, 0, nper=nper, causal=causal, zigzag=zigzag,
                                    kernel=kernel, mask_spec=SPECS[kind])
        _assert_ring(got, _dense_ref(N, kind, causal, 0))


@pytest.mark.parametrize("zigzag", [False, True], ids=["plain", "zigzag"])
@pytest.mark.parametrize("nper", [2, 4])
@pytest.mark.parametrize("n", [19, 61])
def test_ring_pads_a_sequence_that_does_not_divide(n, nper, zigzag):
    """Padded keys are masked and padded rows sliced off: exact on the true
    length, through the dense body and, where the padded chunk tiles, K6."""
    parts = 2 * nper if zigzag else nper
    chunk = -(-n // parts)
    kernels = [False] + ([True] if tca.pick_block(chunk) else [])
    for kernel in kernels:
        got = _ring_value_and_grads(n, 1, nper=nper, zigzag=zigzag, kernel=kernel)
        assert got[0].shape[2] == n
        _assert_ring(got, _dense_ref(n, "none", True, 1))


def test_ring_refuses_untileable_kernel_chunks_and_tabled_specs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(19, 2))
    with pytest.raises(ValueError, match="tiling"):
        tring.ring_attention(q, k, v, nper=8, kernel=True)
    with pytest.raises(ValueError, match="structured"):
        tring.ring_attention(q, k, v, nper=2, mask_spec=("block", 16))
    with pytest.raises(ValueError, match="causal"):
        tring.ring_attention(q, k, v, nper=2, zigzag=True, causal=False)
    # "auto" on the CPU is the dense body, whatever the chunk
    assert not tring._use_kernel(None, 1024, "cpu")
    assert tring._use_kernel(None, 1024, "cuda")
    assert not tring._use_kernel(None, 256, "cuda")
    assert not tring._use_kernel(None, 1045, "cuda")


@pytest.mark.parametrize("zigzag,kernel", [(True, False), (False, True)],
                         ids=["zigzag_dense_body", "plain_kernel_body"])
def test_ring_matches_the_jax_ring(zigzag, kernel):
    """The JAX ring itself on a 2-device CPU mesh (Pallas in interpret mode
    for its kernel body), forward, against the port's at P = 2: both f32,
    sums in another order."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    q, k, v = _qkv(N, 3)
    want = jring.ring_attention(*(jnp.asarray(x) for x in (q, k, v)), mesh=mesh, causal=True,
                                zigzag=zigzag, kernel=kernel)
    got = tring.ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), nper=2,
                               causal=True, zigzag=zigzag, kernel=kernel)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the sequence-parallel transformer, DALL·E and trainer
# ---------------------------------------------------------------------------

def _force_kernel_body(monkeypatch):
    """Route "auto" to K6 (plain on the CPU) wherever the chunk tiles, and
    count the pair calls the ring makes: {"fwd", "dq", "dkv"}."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    use = tring._use_kernel
    monkeypatch.setattr(tring, "_use_kernel",
                        lambda kernel, chunk, device: use(
                            True if kernel is None else kernel, chunk, device))
    for key, name in (("fwd", "chunk_flash_fwd"), ("dq", "chunk_flash_dq"),
                      ("dkv", "chunk_flash_dkv")):
        fn = getattr(tring, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tring, name, counted)
    return calls


T_CFG = dict(dim=32, depth=4, heads=2, dim_head=16, seq_len=N, image_fmap_size=R_FMAP,
             sparse_attn_kernel=3, attn_types=("full", "axial_row", "axial_col", "conv_like"))


@functools.lru_cache(maxsize=None)
def _jax_transformer():
    """(input, perturbed params, output) of the JAX transformer without sp."""
    x = np.random.RandomState(4).standard_normal((2, N, 32)).astype(np.float32)
    jm = JTransformer(JTransformerConfig(**T_CFG))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    return x, params, np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("nper", [2, 4])
def test_sp_transformer_matches_jax_without_sp(nper):
    """Every structured layer kind, zigzag ring at P ranks, against the JAX
    transformer without sp: f32, four layers of summation-order
    differences."""
    x, params, ref = _jax_transformer()
    tm = Transformer(TransformerConfig(**T_CFG), sp=nper).eval()
    tm.load_state_dict(flax_to_state_dict(params))
    assert tm.attention_mode(torch.device("cpu")) == "ring"
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


SP_CFG = dict(num_text_tokens=60, text_seq_len=16, dim=64, depth=2, heads=4, dim_head=16,
              image_size=16, image_vocab_size=48, image_fmap_size=4,
              attn_types=("full", "axial_row"))


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, SP_CFG["num_text_tokens"], (b, SP_CFG["text_seq_len"]))
    text[:, -3:] = 0
    img = rng.randint(0, SP_CFG["image_vocab_size"], (b, SP_CFG["image_fmap_size"] ** 2))
    return text.astype(np.int32), img.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_dalle():
    """The JAX DALL·E without sp, its weights perturbed by seeded noise, its
    loss and every gradient on one batch, as numpy."""
    jm = JDALLE(JDalleConfig(**SP_CFG))
    z = jnp.zeros((1, SP_CFG["text_seq_len"]), jnp.int32)
    jp = jax.jit(lambda key: jm.init({"params": key, "cfg": key}, z, z, return_loss=True))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), jp)
    text, img = _batch(6)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(text), jnp.asarray(img), return_loss=True)[0]))(jp)
    return jp, float(loss), flax_to_state_dict(jax.device_get(grads))


def _port_loss_and_grads(sp, remat, jp):
    tm = DALLE(DalleConfig(**SP_CFG, use_remat=remat), sp=sp)
    tm.load_state_dict(dalle_state_dict(jp))
    text, img = _batch(6)
    loss, _ = tm(torch.from_numpy(text).long(), torch.from_numpy(img).long(), True)
    loss.backward()
    return tm, loss.item(), {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("body", ["dense_body", "kernel_body"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_sp_dalle_loss_and_gradients(remat, body, monkeypatch):
    """DALL·E at sp = 2 (full + axial_row, depth 2, 32 tokens: zigzag
    sub-chunks of 8 rows), its loss and every parameter's gradient, against
    the JAX model without sp and against the port without sp; the kernel
    body runs K6's plain versions on every pair (4·P² forward calls a layer,
    twice with remat; 4·P² dq and dk/dv calls a layer)."""
    jp, jloss, jgrads = _jax_dalle()
    _, loss1, grads1 = _port_loss_and_grads(1, remat, jp)
    calls = _force_kernel_body(monkeypatch) if body == "kernel_body" else None
    tm, loss2, grads2 = _port_loss_and_grads(2, remat, jp)
    assert tm.transformer.attention_mode(torch.device("cpu")) == "ring"
    if calls is not None:
        per_layer = 4 * 2 * 2
        depth = SP_CFG["depth"]
        assert calls == {"fwd": per_layer * depth * (2 if remat else 1),
                         "dq": per_layer * depth, "dkv": per_layer * depth}
    # against JAX without sp: JAX's own sp2 ≡ sp1 bound on the loss (1e-3
    # relative); gradients f32 summation order, as the port's dense
    # gradients are held to JAX's (test_torch_train.py)
    np.testing.assert_allclose(loss2, jloss, rtol=1e-3)
    assert set(grads2) == set(jgrads)
    for name, g in grads2.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=2e-5, rtol=1e-3,
                                   err_msg=name)
    # against the port without sp: the same arithmetic but for the ring's
    # order of sums, 1e-6 relative on the loss and 1e-5 of each tensor's
    # largest gradient
    np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
    for name, g in grads2.items():
        want = grads1[name]
        bound = 1e-5 * max(float(want.abs().max()), 1e-6)
        assert float((g - want).abs().max()) <= bound, name


def test_sp_trainer_two_adam_steps_match_sp1():
    """Two Adam steps of ``DalleTrainer`` with ``mesh=MeshConfig(sp=2)``
    against sp = 1 from the same seed: losses, gradient norms and updated
    parameters."""
    optim = OptimConfig(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5)
    trainers = [DalleTrainer(DalleConfig(**SP_CFG), TrainConfig(
        batch_size=2, seed=3, optim=optim, mesh=MeshConfig(sp=sp),
        precision=PrecisionConfig(compute="float32")), device="cpu") for sp in (1, 2)]
    assert [t.model.transformer.attention_mode(torch.device("cpu")) for t in trainers] == \
        [False, "ring"]
    # Adam's first update is lr·g/(|g| + 1e-8): where a gradient is within
    # 100 eps of zero, summation-order noise moves that element's update by
    # up to 2·lr. Such elements are held to 2·lr a step, the rest to f32
    # summation order (as in test_torch_flash_attention.py).
    tiny = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in trainers[0].model.named_parameters()}
    for step in range(2):
        text, img = _batch(10 + step)
        ref, got = (t.train_step(text, img) for t in trainers)
        for key in ("loss", "loss_text", "loss_img", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=f"{step} {key}")
        want = dict(trainers[0].model.named_parameters())
        for name, p in trainers[1].model.named_parameters():
            tiny[name] |= (want[name].grad.abs() < 1e-6) & (want[name].grad != 0)
            diff = (p.detach() - want[name].detach()).abs()
            close = diff <= 2e-5 + 1e-4 * want[name].detach().abs()
            assert bool(close[~tiny[name]].all()), f"step {step} {name}"
            assert bool((diff[tiny[name]] <= 2 * optim.learning_rate * (step + 1)).all())


def test_sp_trainer_refuses_what_it_cannot_run():
    tc = TrainConfig(batch_size=2, mesh=MeshConfig(sp=2))
    with pytest.raises(ValueError, match="sparse"):
        DalleTrainer(DalleConfig(**{**SP_CFG, "attn_types": ("full", "sparse")}), tc,
                     device="cpu")
    for mesh in (MeshConfig(dp=2), MeshConfig(fsdp=2), MeshConfig(tp=2, sp=2)):
        with pytest.raises(NotImplementedError):
            DalleTrainer(DalleConfig(**SP_CFG), TrainConfig(batch_size=2, mesh=mesh),
                         device="cpu")
    # a layer with a tabled mask under the ring raises in the model too
    tm = DALLE(DalleConfig(**{**SP_CFG, "attn_types": ("sparse",), "sparse_block_size": 4}),
               sp=2)
    text, img = _batch(0)
    with pytest.raises(ValueError, match="full/axial/conv"):
        tm(torch.from_numpy(text).long(), torch.from_numpy(img).long())
