"""The port's optimizer chain ≡ the JAX package's optax chain, on the CPU.

``train_state.Optimizer`` is held update by update to the transformation
``dalle_tpu.train.train_state.make_optimizer`` builds from the same
``OptimConfig`` (optax 0.2.6): Adafactor behind global-norm clipping,
``MultiSteps`` accumulation over Adam and Adafactor, the plateau schedule
(alone and over accumulation), and the runtime lr scale. The parameters are
a flax-style tree in the JAX layout; the port holds them in its own layout
(``convert.flax_to_state_dict``: Dense kernels transposed, a conv kernel
HWIO → OIHW), which is where Adafactor's choice of factored axes can
differ: a square kernel ties, and the port then factors over the other
physical axes (the same update in exact arithmetic).

Tolerance: f32 parameters after each update within rtol 1e-5 and atol 1e-6.
The update differs by a few f32 roundings of a value of size lr (Adam's in
``torch.optim``'s arithmetic, Adafactor's clip, learning rate and parameter
scale folded into one factor a tensor, sums in another order): that is the
rtol. Adding it to a parameter rounds at that parameter's size, and the
parameters are standard normal (|p| < 8, one ulp 2^-20 ≈ 9.5e-7): that is
the atol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from dalle_tpu.config import OptimConfig as JOptimConfig
from dalle_tpu.train import train_state as jts
from dalle_tpu_torch.config import OptimConfig
from dalle_tpu_torch.convert import adafactor_state_from_optax, flax_to_state_dict
from dalle_tpu_torch.train import train_state as tts

# JAX layout: (128, 256) and (256, 128) Dense kernels factor over their two
# axes; (192, 192) ties; (64, 300) is unfactored (64 < 128); the conv
# kernel factors over I and O, which also tie; the bias is 1-D
SHAPES = {"wide": ("kernel", (128, 256)), "tall": ("kernel", (256, 128)),
          "square": ("kernel", (192, 192)), "narrow": ("kernel", (64, 300)),
          "conv": ("kernel", (3, 3, 128, 128)), "vec": ("bias", (300,))}
RTOL, ATOL = 1e-5, 1e-6


def _tree(seed, scale=1.0, offset=0.0):
    rng = np.random.RandomState(seed)
    tree = {}
    for name, (leaf, shape) in SHAPES.items():
        tree[name] = {leaf: (offset + scale * rng.standard_normal(shape)).astype(np.float32)}
    return {"params": tree}


class _Pair:
    """One optax transformation and one port ``Optimizer`` on the same
    parameters."""

    def __init__(self, lr_scale=False, **optim):
        self.tx = jts.make_optimizer(JOptimConfig(**optim))
        self.jparams = _tree(0)
        self.state = self.tx.init(self.jparams)
        self._update = jax.jit(self.tx.update)
        sd = flax_to_state_dict(self.jparams)
        self.names = sorted(sd)
        self.params = [torch.nn.Parameter(sd[n].clone()) for n in self.names]
        self.opt = tts.Optimizer(OptimConfig(**optim), self.params, lr_scale=lr_scale)
        self.lr_scale = 1.0

    def update(self, seed, loss=1.0, offset=0.0):
        grads = _tree(100 + seed, scale=0.3, offset=offset)
        updates, self.state = self._update(grads, self.state, self.jparams,
                                           value=jnp.float32(loss))
        updates = jax.tree_util.tree_map(lambda u: u * self.lr_scale, updates)
        self.jparams = optax.apply_updates(self.jparams, updates)
        gsd = flax_to_state_dict(grads)
        for name, p in zip(self.names, self.params):
            p.grad = gsd[name].clone()
        return self.opt.step(torch.tensor(loss, dtype=torch.float32))

    def check(self, what):
        want = flax_to_state_dict(jax.device_get(self.jparams))
        for name, p in zip(self.names, self.params):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} {name}")


def test_factored_axes_follow_optax_on_the_ports_layout():
    """(second-largest, largest) by ``np.argsort`` as optax picks them, ties
    in argsort's order: the square kernel averages over the other physical
    axis in the port (its (out, in) against flax's (in, out)); the OIHW
    conv over O, as the HWIO one does."""
    assert tts.factored_dims((256, 128)) == (1, 0)        # the (128, 256) kernel
    assert tts.factored_dims((192, 192)) == (0, 1)
    assert tts.factored_dims((300, 64)) is None
    assert tts.factored_dims((128, 128, 3, 3)) == (1, 0)
    assert tts.factored_dims((300,)) is None
    for count in range(5):   # β_t = 1 - (t + 1)^-0.8 in f32, β_0 = 0
        np.testing.assert_allclose(tts._Adafactor.decay(count),
                                   float(factorized._decay_rate_pow(count, 0.8)), rtol=1e-7)


ADAFACTOR_CASES = {
    "constant_clip": dict(learning_rate=1e-2, grad_clip_norm=0.5),
    "decay_warmup_cosine_clip": dict(learning_rate=3e-2, weight_decay=0.1, warmup_steps=2,
                                     lr_scheduler="cosine", total_steps=6, grad_clip_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(ADAFACTOR_CASES))
def test_adafactor_matches_optax(case):
    pair = _Pair(optimizer="adafactor", **ADAFACTOR_CASES[case])
    for t in range(4):
        pair.update(t)
        pair.check(f"update {t}")
    # the square kernel's v_row is the mean over the port's axis 1 (in),
    # flax's over its axis 1 (out)
    core = pair.opt.core
    i = pair.names.index("square.weight")
    assert core.v_row[i].shape == (192,) and core.v[i] is None
    assert core.v[pair.names.index("narrow.weight")].shape == (300, 64)


ACCUMULATION_CASES = {"adam_plateau": dict(optimizer="adam", lr_scheduler="plateau",
                                            plateau_patience=1, plateau_cooldown=1),
                      "adafactor": dict(optimizer="adafactor")}


@pytest.mark.parametrize("case", sorted(ACCUMULATION_CASES))
def test_accumulation_matches_multisteps(case):
    """MultiSteps(k=3): the plateau schedule (outside it) sees every
    mini-step's loss. The gradients sit around 1 (0.3 spread), so no
    element's mean over a group nearly cancels: where it does, Adam's
    g / (|g| + eps) turns an f32 rounding of the mean into a change of the
    update, in either framework."""
    pair = _Pair(learning_rate=1e-2, grad_clip_norm=0.5, grad_accum_steps=3,
                 **ACCUMULATION_CASES[case])
    losses = [3.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    for t in range(6):
        before = [p.detach().clone() for p in pair.params]
        norm = pair.update(t, losses[t], offset=1.0)
        # grad_norm is the mini-batch's own, before averaging or clipping
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            _tree(100 + t, scale=0.3, offset=1.0))), rtol=1e-6)
        if t % 3 != 2:
            # a mini-step changes no parameter: the same bits
            assert all(torch.equal(a, p) for a, p in zip(before, pair.params))
            assert pair.opt.count == t // 3 and pair.opt.mini_step == t % 3 + 1
        pair.check(f"mini-step {t}")
    assert pair.opt.count == 2 and pair.opt.mini_step == 0
    if pair.opt.plateau is not None:
        assert float(pair.opt.plateau.scale) < 1.0


# two plateaus of the loss, each long enough for patience 2, then cooldown
LOSSES = [5.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 1.0]


def test_plateau_scale_matches_reduce_on_plateau():
    cfg = OptimConfig(lr_scheduler="plateau", plateau_factor=0.5, plateau_patience=2,
                      plateau_cooldown=2, plateau_min_scale=0.2)
    tx = optax.contrib.reduce_on_plateau(factor=0.5, patience=2, cooldown=2, min_scale=0.2)
    state = tx.init({"w": jnp.zeros(3)})
    update = jax.jit(tx.update)
    mine = tts._Plateau(cfg, "cpu")
    scales = []
    for loss in LOSSES:
        _, state = update({"w": jnp.ones(3)}, state, value=jnp.float32(loss))
        mine.update(torch.tensor(loss))
        for k in tts._Plateau.FIELDS:
            np.testing.assert_allclose(getattr(mine, k).numpy(), np.asarray(getattr(state, k)),
                                       err_msg=f"{k} after loss {loss}")
        scales.append(float(mine.scale))
    # a cut on each plateau, each followed by a 2-step cooldown in which the
    # plateau count stays 0; the third cut floored at min_scale
    assert scales == [1.0] * 4 + [0.5] * 6 + [0.25] * 4 + [float(np.float32(0.2))] * 2


def test_runtime_lr_scale_multiplies_the_update():
    pair = _Pair(lr_scale=True, optimizer="adafactor", learning_rate=1e-2)
    pair.update(0)
    pair.opt.set_lr_scale(0.25)
    pair.lr_scale = 0.25
    before = [p.detach().clone() for p in pair.params]
    ref = tts.Optimizer(pair.opt.cfg, [torch.nn.Parameter(p.clone()) for p in before])
    ref.load_state_dict({**pair.opt.state_dict(), "lr_scale": None})
    pair.update(1)
    pair.check("scaled update")
    for p, q, b in zip(pair.params, ref.params, before):
        q.grad = p.grad.clone()
    ref.step()
    for p, q, b in zip(pair.params, ref.params, before):
        # each difference carries one rounding of p (|p| < 8: 2^-20)
        np.testing.assert_allclose((p - b).detach().numpy(), 0.25 * (q - b).detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tts.Optimizer(pair.opt.cfg, pair.params).set_lr_scale(0.5)


def _port_only(cfg):
    sd = flax_to_state_dict(_tree(0))
    params = [torch.nn.Parameter(sd[n].clone()) for n in sorted(sd)]
    return params, tts.Optimizer(cfg, params, lr_scale=True)


def _port_step(params, opt, t):
    grads = flax_to_state_dict(_tree(100 + t, scale=0.3))
    for name, p in zip(sorted(grads), params):
        p.grad = grads[name].clone()
    opt.step(torch.tensor(3.0 - t))


def test_state_dict_round_trip_and_a_torch_optim_adam_state():
    """Every part of the state (Adafactor's statistics, the counts, the
    accumulator, the plateau's tensors, the runtime scale) carries over:
    a twin loaded mid-accumulation steps on to the same bits."""
    cfg = OptimConfig(optimizer="adafactor", learning_rate=1e-2, lr_scheduler="plateau",
                      plateau_patience=1, grad_accum_steps=2)
    params, opt = _port_only(cfg)
    opt.set_lr_scale(0.5)
    for t in range(5):
        _port_step(params, opt, t)
    twin_params, twin = _port_only(cfg)
    twin.load_state_dict(opt.state_dict())
    for p, q in zip(params, twin_params):
        q.data.copy_(p.data)
    assert (twin.count, twin.mini_step) == (2, 1)
    for t in (5, 6):
        _port_step(params, opt, t)
        _port_step(twin_params, twin, t)
    for p, q in zip(params, twin_params):
        assert torch.equal(p, q)
    # a checkpoint written with torch.optim.Adam (the format before the
    # port's own chain) restores its moments and count
    params = [torch.nn.Parameter(torch.randn(4, 3)), torch.nn.Parameter(torch.randn(5))]
    legacy = torch.optim.Adam(params, lr=1e-3)
    for p in params:
        p.grad = torch.randn_like(p)
    legacy.step()
    opt = tts.Optimizer(OptimConfig(optimizer="adam"), params)
    opt.load_state_dict(legacy.state_dict(), count=1)
    assert opt.count == 1
    assert torch.equal(opt.core.nu[0], legacy.state[params[0]]["exp_avg_sq"])
    with pytest.raises(ValueError):
        tts.Optimizer(OptimConfig(optimizer="adafactor"), params).load_state_dict(
            opt.state_dict())


def test_adafactor_state_converts_from_optax_with_the_square_swap():
    pair = _Pair(optimizer="adafactor", learning_rate=1e-2)
    pair.update(0)
    pair.update(1)
    state = jax.device_get(pair.state)
    count, core = adafactor_state_from_optax(state, pair.jparams, pair.names)
    assert count == 2
    for k in ("v_row", "v_col", "v"):
        for name, mine, conv in zip(pair.names, getattr(pair.opt.core, k), core[k]):
            assert (mine is None) == (conv is None), (k, name)
            if mine is not None:
                np.testing.assert_allclose(conv.numpy(), mine.numpy(), rtol=1e-5,
                                           err_msg=f"{k} {name}")
