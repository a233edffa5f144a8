"""The port's training path ≡ the JAX package's, on the CPU at tiny size:
the DALL·E loss and its parts, every parameter's gradient, the learning-rate
schedules and clipping, whole ``DalleTrainer.train_step``s with adam, adamw
and sgd, and a JAX run continued in the port from its optax Adam state.

Weights are the JAX package's, perturbed by seeded noise (so zero biases
and unit norms cannot hide a mapping error) and converted with
``dalle_state_dict``. Tolerances, each with its reason at the assert:
f32 losses 1e-5 (summation order only); f32 gradients and parameters
after updates 1e-5 absolute plus a relative share for the larger values.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.config import MeshConfig as JMeshConfig
from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.config import PrecisionConfig as JPrecisionConfig
from dalle_tpu.config import TrainConfig as JTrainConfig
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.ops import flash_attention as jflash
from dalle_tpu.parallel.mesh import build_mesh
from dalle_tpu.train import train_state as jts
from dalle_tpu.train.trainer_dalle import DalleTrainer as JDalleTrainer
from dalle_tpu_torch.config import DalleConfig, OptimConfig, PrecisionConfig, TrainConfig
from dalle_tpu_torch.convert import adam_state_from_optax, dalle_state_dict, flax_to_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops import flash_attention as tflash
from dalle_tpu_torch.ops import fused_attention as tfa
from dalle_tpu_torch.train import train_state as tts
from dalle_tpu_torch.train.metrics import count_params, transformer_train_flops
from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)
N = 6 + 16


def _launches():
    return (tfa.fwd_launches, tfa.bwd_launches, tflash.fwd_launches,
            tflash.bwd_dq_launches, tflash.bwd_dkv_launches)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


def _pair(**kw):
    cfg = {**TINY, **kw}
    jm, jp = jinit_dalle(JDalleConfig(**cfg), jax.random.PRNGKey(0))
    jp = _perturb(jp)
    tm = DALLE(DalleConfig(**cfg))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"]))
    text[:, -2:] = 0                                   # pads → per-position ids
    img = rng.randint(0, TINY["image_vocab_size"], (b, TINY["image_fmap_size"] ** 2))
    return text.astype(np.int32), img.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


# ---------------------------------------------------------------------------
# (c) loss and its parts
# ---------------------------------------------------------------------------

LOSS_CASES = {"dense": {}, "chunked": dict(loss_chunk=11), "tied": dict(share_input_output_emb=True),
              "stable": dict(stable=True),
              "tied_chunked_axial_pos": dict(share_input_output_emb=True, loss_chunk=2,
                                             rotary_emb=False)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_parts_match_jax(case):
    jm, jp, tm = _pair(**LOSS_CASES[case])
    text, img = _batch(1)
    ref, ref_aux = jm.apply(jp, jnp.asarray(text), jnp.asarray(img), return_loss=True)
    loss, aux = tm(_t(text), _t(img), True)
    # f32 on both sides: summation order only
    for got, want in ((loss, ref), (aux["loss_text"], ref_aux["loss_text"]),
                      (aux["loss_img"], ref_aux["loss_img"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_injected_null_mask_matches_jax_on_nulled_text():
    """Classifier-free-guidance dropout: the rows in ``null_mask`` lose their
    text, as the JAX package's draw does to the rows it picks."""
    jm, jp, tm = _pair()
    text, img = _batch(2, b=3)
    null = np.array([True, False, True])
    nulled = np.where(null[:, None], 0, text)
    ref, _ = jm.apply(jp, jnp.asarray(nulled), jnp.asarray(img), return_loss=True)
    loss, _ = tm(_t(text), _t(img), True, null_mask=torch.from_numpy(null))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    # drawn with probability 1, every row is nulled
    drawn, _ = tm(_t(text), _t(img), True, null_cond_prob=1.0,
                  generator=torch.Generator().manual_seed(0))
    all_null, _ = jm.apply(jp, jnp.zeros_like(text), jnp.asarray(img), return_loss=True)
    np.testing.assert_allclose(drawn.item(), float(all_null), rtol=1e-5, atol=1e-5)


def test_loss_chunk_must_divide_the_sequence():
    tm = DALLE(DalleConfig(**TINY, loss_chunk=5))
    text, img = _batch(3)
    with pytest.raises(ValueError, match="loss_chunk"):
        tm(_t(text), _t(img), True)


# ---------------------------------------------------------------------------
# (d) every parameter's gradient
# ---------------------------------------------------------------------------

GRAD_CASES = {
    "dense": ("off", {}),
    "dense_tied_stable_chunked": ("off", dict(share_input_output_emb=True, stable=True,
                                              loss_chunk=11)),
    "fused": ("fused", {}),
    "fused_every_mask": ("fused", dict(depth=4, sparse_block_size=4, sparse_attn_kernel=3,
                                       attn_types=("axial_row", "axial_col", "conv_like",
                                                   "sparse"))),
    # K4 on both sides ("on" is the JAX package's spelling of the flash mode;
    # its Pallas kernels run in interpret mode), remat on
    "flash": ("on", {}),
    "flash_every_mask": ("on", dict(depth=4, sparse_block_size=4, sparse_attn_kernel=3,
                                    stable=True,
                                    attn_types=("axial_row", "axial_col", "conv_like",
                                                "sparse"))),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_parameter_gradients_match_jax(case, monkeypatch):
    mode, kw = GRAD_CASES[case]
    jm, jp, tm = _pair(use_pallas=mode, **kw)
    if mode == "fused":
        # the JAX package picks its fused kernel only on the TPU; force it, so
        # its Pallas kernels run in interpret mode
        monkeypatch.setattr(jflash, "resolve_use_pallas", lambda *a, **k: "fused")
    text, img = _batch(4)
    ref = jax.grad(lambda p: jm.apply(p, jnp.asarray(text), jnp.asarray(img),
                                      return_loss=True)[0])(jp)
    ref = flax_to_state_dict(jax.device_get(ref))
    before = _launches()
    loss, _ = tm(_t(text), _t(img), True)
    loss.backward()
    assert _launches() == before
    want_mode = {"off": False, "fused": "fused", "on": "flash"}[mode]
    assert tm.transformer.attention_mode(torch.device("cpu")) == want_mode
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        want = ref[name].numpy()
        if mode in ("off", "on"):
            # f32 throughout (K4 computes in f32): summation order only
            atol, rtol = 2e-5, 1e-3
        else:
            # K1 rounds q, k, v, dO, p and ds to bf16 at the same points in
            # both packages (the kernels alone agree to 1e-5,
            # test_torch_fused_attention.py), but its f32 inputs differ in
            # the last bit between the frameworks, so a few of those
            # roundings flip; each flip moves one term by a bf16 ulp (2^-8),
            # and a weight's gradient sums such terms over every position:
            # measured up to 2.7e-3 of the tensor's largest entry
            atol, rtol = 1e-2 * float(np.abs(want).max()), 0.0
        np.testing.assert_allclose(g.numpy(), want, atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# schedules, clipping, counters
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": dict(lr_scheduler="constant"),
    "cosine_warmup": dict(lr_scheduler="cosine", warmup_steps=3, total_steps=10),
    "exponential": dict(lr_scheduler="exponential", lr_transition_steps=4, lr_decay_rate=0.5),
    "exponential_warmup": dict(lr_scheduler="exponential", lr_transition_steps=3,
                               lr_decay_rate=0.9, warmup_steps=2)}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(case):
    kw = dict(learning_rate=2e-3, **SCHEDULES[case])
    ref = jts.make_lr_schedule(JOptimConfig(**kw))
    got = tts.make_lr_schedule(OptimConfig(**kw))
    for step in range(14):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(5)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    clip = optax.clip_by_global_norm(max_norm)
    ref, _ = clip.update(tree, clip.init(tree))
    grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    norm = tts.clip_by_global_norm_(grads, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(tree)), rtol=1e-6)
    for g, k in zip(grads, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


def test_param_and_flop_counts_match_jax():
    jm, jp, tm = _pair(share_input_output_emb=True, shared_attn_ids=(0, 0))
    from dalle_tpu.train import metrics as jmetrics
    assert count_params(tm) == jmetrics.count_params(jp)
    assert transformer_train_flops(10, 3) == jmetrics.transformer_train_flops(10, 3)


# ---------------------------------------------------------------------------
# (e) whole training steps against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_trainer(tmp_path, optim, compute="float32", **kw):
    tc = JTrainConfig(batch_size=2, checkpoint_dir=str(tmp_path), preflight_checkpoint=False,
                      mesh=JMeshConfig(), precision=JPrecisionConfig(compute=compute),
                      optim=JOptimConfig(**optim), device_prefetch=0)
    return JDalleTrainer(JDalleConfig(**TINY, **kw), tc,
                         mesh=build_mesh(JMeshConfig(), devices=jax.devices()[:1]))


def _port_trainer(optim, compute="float32", **kw):
    tc = TrainConfig(batch_size=2, optim=OptimConfig(**optim),
                     precision=PrecisionConfig(compute=compute))
    return DalleTrainer(DalleConfig(**TINY, **kw), tc, device="cpu")


def _jax_params(jtr):
    return flax_to_state_dict(jax.device_get(jtr.state.params))


# (optim config, compute, model overrides, parameter atol, parameter rtol);
# the bf16 case compares each step's update instead (_assert_updates_match)
STEP_CASES = {
    "adam_clip": (dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5),
                  "float32", {}, 2e-5, 1e-4),
    "adamw_warmup_cosine_chunked": (
        dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, warmup_steps=1,
             total_steps=4, lr_scheduler="cosine", grad_clip_norm=1.0),
        "float32", dict(loss_chunk=11), 2e-5, 1e-4),
    "sgd_exponential_clip": (
        dict(optimizer="sgd", learning_rate=0.5, lr_scheduler="exponential",
             lr_transition_steps=2, lr_decay_rate=0.5, grad_clip_norm=0.5),
        "float32", {}, 2e-5, 1e-4),
    "adam_bf16": (dict(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5),
                  "bfloat16", {}, None, None),
}


def _assert_updates_match(got_before, got_after, want_before, want_after, grads, lr, step):
    """bf16 compute: both packages run every op on bf16 copies, but bf16
    rounds at other places in the two frameworks (LayerNorm internals,
    matmul blocking): a bf16 ulp of the activations. A parameter moves by
    at most about lr per Adam step, so parameters are no test of the update;
    each step's update (after − before, on each side) is. Where the port's
    gradient is above 5% of its tensor's largest, that noise is small
    beside it: the updates agree within lr/4 (measured lr/9). On a near-zero
    element the noise can flip Adam's normalised update, by up to 2·lr:
    such elements stay below 5% of each tensor (measured 1/64, one element
    of a LayerNorm weight). A step that skips or scales the update fails
    the first bound on almost every element."""
    for name, after in got_after.items():
        diff = np.abs((after - got_before[name]).numpy()
                      - (want_after[name] - want_before[name]).numpy())
        g = grads.get(name)
        clear = (np.ones(diff.shape, bool) if g is None
                 else np.abs(g) > 0.05 * np.abs(g).max())
        assert diff[clear].max(initial=0.0) <= lr / 4, f"step {step} {name}"
        assert np.mean(diff > lr / 2) <= 0.05, f"step {step} {name}"


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax_trainer(case, tmp_path):
    optim, compute, kw, p_atol, p_rtol = STEP_CASES[case]
    jtr = _jax_trainer(tmp_path, optim, compute, **kw)
    tr = _port_trainer(optim, compute, **kw)
    tr.load_jax_state(jax.device_get(jtr.state.params))
    bf16 = compute == "bfloat16"
    for step in range(3):
        text, img = _batch(10 + step)
        got_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        want_before = _jax_params(jtr)
        ref = jtr.train_step(text, img)
        got = tr.train_step(text, img)
        assert got["step"] == step + 1
        for key in ("loss", "loss_text", "loss_img", "grad_norm"):
            # f32: summation order; bf16: a bf16 rounding of the logits
            np.testing.assert_allclose(got[key], ref[key], rtol=2e-2 if bf16 else 1e-4,
                                       err_msg=f"step {step} {key}")
        want = _jax_params(jtr)
        if bf16:
            grads = {n: p.grad.numpy() for n, p in tr.model.named_parameters()}
            _assert_updates_match(got_before, tr.model.state_dict(), want_before, want,
                                  grads, optim["learning_rate"], step)
            continue
        for name, p in tr.model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=p_atol,
                                       rtol=p_rtol, err_msg=f"step {step} {name}")
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())


# ---------------------------------------------------------------------------
# (f) a JAX run continued in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_port_resumes_from_optax_adam_state(optimizer, tmp_path):
    optim = dict(optimizer=optimizer, learning_rate=1e-3, weight_decay=0.1,
                 warmup_steps=1, lr_scheduler="cosine", total_steps=5)
    jtr = _jax_trainer(tmp_path, optim)
    b1, b2 = _batch(20), _batch(21)
    jtr.train_step(*b1)
    params1 = jax.device_get(jtr.state.params)
    opt1 = jax.device_get(jtr.state.opt_state)
    jtr.train_step(*b2)
    tr = _port_trainer(optim)
    tr.load_jax_state(params1, opt1)
    assert tr.step == 1
    tr.train_step(*b2)
    want = _jax_params(jtr)
    for name, p in tr.model.state_dict().items():
        # f32: summation order in one step's gradient
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_adam_state_converter_refuses_a_state_without_moments():
    tx = optax.sgd(0.1)
    with pytest.raises(ValueError):
        adam_state_from_optax(tx.init({"params": {"w": np.zeros(2)}}), ["w"])


# ---------------------------------------------------------------------------
# the trainer's loop
# ---------------------------------------------------------------------------

def test_fit_steps_and_logs():
    tr = _port_trainer(dict(learning_rate=1e-2))
    tr.train_cfg = TrainConfig(batch_size=2, log_every=2)
    lines = []
    batches = (_batch(30) for _ in range(10))
    m = tr.fit(batches, steps=4, log=lines.append)
    assert tr.step == 4 and m["step"] == 4
    assert len(lines) == 2 and lines[-1].startswith("[step 4]")
    assert math.isfinite(m["tokens_per_sec"]) and m["tokens_per_sec"] > 0
