"""Reversible blocks against the JAX package on the CPU:
``reversible_sequence``'s gradients against autograd through stored
activations (``reversible_forward_naive``) and against the JAX package's
``custom_vjp``; the reversible ``Transformer`` (depth 3, layers shared
through ``shared_attn_ids``/``shared_ff_ids``) against the JAX package's,
with dropout masks injected into both; the trainer's bf16 step on its cast
copies; the activations the forward keeps; ``train_dalle --reversible``.

Tolerances (f32): outputs within 1e-5 relative (the same arithmetic);
gradients within 1e-5 absolute plus 1e-4 of the largest (the backward
recomputes each block from the inverted coupling, x2 = y2 - g(y1),
x1 = y1 - f(x2), whose roundings differ from stored activations'); the bf16
step's gradients against the naive coupling's within 2^-5 of each tensor's
largest (bf16 roundings of the recomputed inputs).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import TransformerConfig as JTransformerConfig
from dalle_tpu.models import reversible as jrev
from dalle_tpu.models.transformer import Transformer as JTransformer
from dalle_tpu_torch.cli import train_dalle
from dalle_tpu_torch.config import (DalleConfig, OptimConfig, PrecisionConfig, TrainConfig,
                                    TransformerConfig)
from dalle_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from dalle_tpu_torch.models import reversible as rev
from dalle_tpu_torch.models.transformer import Transformer
from dalle_tpu_torch.train.checkpoints import CheckpointManager
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

CFG = dict(dim=32, depth=3, heads=2, dim_head=16, seq_len=24, image_fmap_size=4,
           attn_types=("full", "axial_row"), shared_attn_ids=(0, 1, 0),
           shared_ff_ids=(0, 0, 1), reversible=True, use_pallas="off")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """At these sizes torch's thread pool beside JAX's costs more than it
    gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what=""):
    want = np.asarray(want)
    tol = 1e-5 + 1e-4 * np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() <= tol, what


def _toy(depth=3, dim=8, seed=0):
    """(f, g) MLP pairs; block 2 reuses block 0's f weights (a shared
    layer)."""
    rng = np.random.RandomState(seed)
    arrays = [((rng.randn(dim, dim) * 0.3).astype(np.float32), np.float32(0.5),
               (rng.randn(dim, dim) * 0.3).astype(np.float32),
               (rng.randn(dim) * 0.1).astype(np.float32)) for _ in range(depth)]
    arrays[2] = (arrays[0][0],) + arrays[2][1:]
    return arrays


def _toy_fns(lib, depth):
    if lib is torch:
        def f(p, x):
            return torch.tanh(x @ p[0]) * p[1]

        def g(p, x):
            return torch.sin(x @ p[0]) + p[1]
    else:
        def f(p, x):
            return jnp.tanh(x @ p[0]) * p[1]

        def g(p, x):
            return jnp.sin(x @ p[0]) + p[1]
    return tuple((f, g) for _ in range(depth))


def test_reversible_sequence_against_naive_autograd_and_the_jax_custom_vjp():
    arrays = _toy()
    rng = np.random.RandomState(1)
    x1, x2, w1, w2 = (rng.randn(4, 8).astype(np.float32) for _ in range(4))

    def jloss(params, x1, x2, run):
        y1, y2 = run(_toy_fns(jnp, 3), params, x1, x2)
        return jnp.sum(y1 * w1 + y2 * w2)
    jparams = tuple(((jnp.asarray(a), jnp.asarray(s)), (jnp.asarray(b), jnp.asarray(c)))
                    for a, s, b, c in arrays)
    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jparams, jnp.asarray(x1), jnp.asarray(x2), jrev.reversible_sequence)

    tensors = {}

    def shared(a):
        key = id(a) if isinstance(a, np.ndarray) else None
        if key is None:
            return _t(a).requires_grad_()
        if key not in tensors:
            tensors[key] = _t(a).requires_grad_()
        return tensors[key]
    results = {}
    for name, run in (("custom", rev.reversible_sequence), ("naive", rev.reversible_forward_naive)):
        tensors.clear()
        params = tuple(((shared(a), shared(s)), (shared(b), shared(c))) for a, s, b, c in arrays)
        tx1, tx2 = _t(x1).requires_grad_(), _t(x2).requires_grad_()
        y1, y2 = run(_toy_fns(torch, 3), params, tx1, tx2)
        loss = torch.sum(y1 * _t(w1) + y2 * _t(w2))
        loss.backward()
        results[name] = (loss.item(), params, tx1.grad, tx2.grad)
    for name, (loss, params, g1, g2) in results.items():
        np.testing.assert_allclose(loss, float(want), rtol=1e-5, err_msg=name)
        _close(g1.numpy(), jgrads[1], name)
        _close(g2.numpy(), jgrads[2], name)
        for i in range(3):
            for j in range(2):
                for k in range(2):
                    if i == 2 and j == 0 and k == 0:
                        continue        # shared with block 0: summed there
                    want_g = np.asarray(jgrads[0][i][j][k])
                    if i == 0 and j == 0 and k == 0:
                        want_g = want_g + np.asarray(jgrads[0][2][0][0])
                    _close(params[i][j][k].grad.numpy(), want_g, f"{name} {i}{j}{k}")


def _pair(**kw):
    cfg = dict(CFG, **kw)
    tm = Transformer(TransformerConfig(**cfg))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    jm = JTransformer(JTransformerConfig(**cfg))
    like = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 25, 32))), jax.random.PRNGKey(0))
    return jm, state_dict_to_flax(tm.state_dict(), like), tm


def _grads(tm, x, **kw):
    tm.zero_grad()
    tx = _t(x).requires_grad_()
    y = tm(tx, **kw)
    torch.sum(y ** 2).backward()
    return y.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}, tx.grad


def test_reversible_transformer_with_shared_layers_against_jax():
    jm, jp, tm = _pair()
    x = np.random.RandomState(2).randn(2, 25, 32).astype(np.float32)

    @jax.jit
    def ref(p, x):
        return jax.value_and_grad(lambda p, x: jnp.sum(jm.apply(p, x) ** 2), argnums=(0, 1))(p, x)
    want, (jg, jgx) = jax.device_get(ref(jp, jnp.asarray(x)))
    y, grads, gx = _grads(tm, x)
    np.testing.assert_allclose(float(torch.sum(y ** 2)), float(want), rtol=1e-5)
    _close(gx.numpy(), jgx, "x")
    for name, g in flax_to_state_dict(jg).items():
        _close(grads[name].numpy(), g.numpy(), name)
    # the naive coupling is the same function
    y_naive, naive, _ = _grads(tm, x, reversible_naive=True)
    assert torch.equal(y_naive, y)
    for name, g in naive.items():
        _close(grads[name].numpy(), g.numpy(), name)


def test_reversible_transformer_with_injected_dropout_against_jax(monkeypatch):
    """Dropout masks drawn up front and injected: the port's reversible
    forward and its recompute use them; the JAX side's coupling is built
    from its layers' apply methods, each call reading its depth's mask."""
    cfg = dict(attn_dropout=0.25, ff_dropout=0.5)
    jm, jp, tm = _pair(**cfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 25, 32).astype(np.float32)
    masks = [(rng.rand(2, 25, 32) > 0.25, rng.rand(2, 25, 128) > 0.5) for _ in range(3)]
    current = {}

    def injected(self, inputs, deterministic=None, rng=None):
        if deterministic or self.rate == 0:
            return inputs
        return jnp.where(jnp.asarray(current["mask"]), inputs / (1.0 - self.rate), 0)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", injected)

    def jloss(p, x):
        x1 = x2 = x
        for ind in range(3):
            current["mask"] = masks[ind][0]
            x1 = x1 + jm.apply(p, x2, ind, None, False, method=JTransformer._apply_attn_layer,
                               rngs={"dropout": jax.random.PRNGKey(0)})
            current["mask"] = masks[ind][1]
            x2 = x2 + jm.apply(p, x1, ind, False, method=JTransformer._apply_ff_layer,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(((x1 + x2) / 2.0) ** 2)
    want, jg = jax.device_get(jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(x)))
    drop = [(_t(a), _t(f)) for a, f in masks]
    y, grads, _ = _grads(tm, x, dropout_masks=drop)
    np.testing.assert_allclose(float(torch.sum(y ** 2)), float(want), rtol=1e-5)
    for name, g in flax_to_state_dict(jg).items():
        _close(grads[name].numpy(), g.numpy(), name)
    plain, _, _ = _grads(tm, x)
    assert not torch.allclose(plain, y)


def test_reversible_forward_keeps_no_block_activations():
    """What autograd keeps from the forward: the reversible stack's does not
    grow with depth, the naive coupling's does."""
    def saved_bytes(depth, naive):
        tm = Transformer(TransformerConfig(**dict(CFG, depth=depth, shared_attn_ids=None,
                                                  shared_ff_ids=None)))
        x = torch.randn(2, 25, 32, requires_grad=True)
        seen = {}

        def pack(t):
            seen[t.data_ptr()] = t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tm(x, reversible_naive=naive)
        params = {p.data_ptr() for p in tm.parameters()}
        return sum(v for k, v in seen.items() if k not in params)
    assert saved_bytes(2, False) == saved_bytes(6, False)
    assert saved_bytes(6, True) > 2 * saved_bytes(2, True) > 0


def test_reversible_trainer_bf16_step_on_cast_copies_against_the_naive_coupling():
    cfg = DalleConfig(num_text_tokens=40, text_seq_len=8, dim=32, depth=2, heads=2, dim_head=16,
                      image_size=16, image_vocab_size=24, image_fmap_size=4, reversible=True,
                      shared_ff_ids=(0, 0), use_pallas="off", loss_chunk=12)
    tr = DalleTrainer(cfg, TrainConfig(batch_size=2, precision=PrecisionConfig(),
                                       optim=OptimConfig(learning_rate=1e-3)), device="cpu")
    rng = np.random.RandomState(4)
    text = _t(rng.randint(1, 40, (2, 8)))
    img = _t(rng.randint(0, 24, (2, 16)))
    grads = []
    for naive in (False, True):
        for p in tr.model.parameters():
            p.grad = None
        if naive:
            forward = type(tr.model.transformer).forward
            tr.model.transformer.forward = (
                lambda x, key_mask=None, dropout_masks=None:
                forward(tr.model.transformer, x, key_mask, dropout_masks, reversible_naive=True))
        loss, _ = tr.loss_and_backward(text, img)
        grads.append({n: p.grad.clone() for n, p in tr.model.named_parameters()})
    del tr.model.transformer.forward
    for name, g in grads[1].items():
        assert g.dtype == torch.float32
        assert (grads[0][name] - g).abs().max() <= 2 ** -5 * g.abs().max() + 1e-6, name


def test_train_dalle_reversible_takes_a_step(tmp_path):
    out = str(tmp_path / "ck")
    assert train_dalle.main(["--synthetic", "--untrained_vae", "--image_size", "16",
                             "--untrained_vae_tokens", "48", "--dim", "32", "--depth", "2",
                             "--heads", "2", "--dim_head", "16", "--text_seq_len", "8",
                             "--batch_size", "2", "--steps", "1", "--reversible",
                             "--attn_dropout", "0.1", "--device", "cpu",
                             "--output_dir", out]) == 0
    meta = CheckpointManager(out).load_metadata()
    assert meta["hparams"]["reversible"] is True
    assert CheckpointManager(out).latest_step() == 1
