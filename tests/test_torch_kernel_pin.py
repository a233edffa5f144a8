"""The JAX package's ``use_kernel`` pin in the port (CPU, tiny shapes).

``use_kernel=False`` sends ``cached_attend`` and ``cached_attend_window``
to the JAX package's dense formula instead of K2/K3/K5 (or their plain
versions); None and True keep the kernels. Three things are held here:

* the pinned attends against the JAX package's ``use_kernel=False`` ones
  on the same numpy inputs, dense and paged caches, f32, bf16 and int8
  caches: 1e-6 with an f32 query and cache (both run the same f32 formula,
  in other summation orders); with a bf16 query 2^-6 of the largest |V| a
  row can hold (both round q·scale, the scores, the probabilities and the
  output to bf16 at the same points; a score or probability summed in
  another order may round one bf16 ulp, 2^-8, the other way, and an output
  one ulp more);
* the port's cases of ``tests/test_serve.py:224-300``: the pinned engine's
  tokens equal pinned sequential ``generate_images_tokens`` under each
  request's generator, bit for bit, at f32, in bf16 over an int8 cache and
  with int8 weights (the serving default), through bulk and trickle
  admission and the paged engine, a CFG request among them;
* under the pin no decode kernel (nor its plain version) runs: K2's, K3's
  and K5's entry points are not reached and their launch counts stay 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops import attention as jattn
from dalle_tpu.ops import paged_kv as jpaged
from dalle_tpu_torch import DalleConfig, DalleWithVae
from dalle_tpu_torch.models.dalle import init_dalle
from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import decode_attention as tdec
from dalle_tpu_torch.ops import paged_kv as tpaged
from dalle_tpu_torch.serve import RequestQueue

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}

# bf16 queries: 2^-6 of the largest |V| (module docstring)
BF16_SHARE = 2.0 ** -6


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _kv(rng, b, h, n, d):
    return (rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, h, n, d)).astype(np.float32) * 2)


def _dense_pair(rng, dt, b=3, h=2, S=24, d=16):
    jdt, tdt = DTYPES[dt]
    k, v = _kv(rng, b, h, S, d)
    jc = jattn.KVCache.init(b, h, S, d, jdt).append(jnp.asarray(k), jnp.asarray(v), 0)
    tc = tattn.KVCache.init(b, h, S, d, tdt, device="cpu").append(
        torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


def _paged_pair(rng, dt, b=3, h=2, d=16, bt=4, max_seq=24, num_blocks=20):
    """A JAX and a port PagedKVCache on one permuted page table, the last
    page of row 1 unmapped."""
    jdt, tdt = DTYPES[dt]
    mb = max_seq // bt
    pages = rng.permutation(num_blocks)[:b * mb].reshape(b, mb).astype(np.int32)
    pages[1, -1] = -1
    jp = jpaged.PagedKVCache.init(num_blocks, bt, h, max_seq, d, jdt).replace(
        pages=jnp.asarray(pages))
    tp = tpaged.PagedKVCache.init(num_blocks, bt, h, max_seq, d, tdt,
                                  device="cpu").bind(pages)
    k, v = _kv(rng, b, h, max_seq, d)
    zeros = np.zeros((b,), np.int32)
    jp = jp.append_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(zeros))
    tp.append_rows(torch.from_numpy(k), torch.from_numpy(v), zeros)
    return jp, tp


def _v_abs_max(tc, h):
    """The largest |V| any row of the (dense) cache holds, dequantized."""
    hd = tc.kv.shape[2] // 2
    v = tc.kv[:, :, hd:].float().abs().amax(dim=-1)                      # (b, S)
    if tc.scale is not None:
        v = v * tc.scale[:, h:].amax(dim=1)
    return v.max().item()


def _tol(qdt, tc, h):
    return 1e-6 if qdt == "f32" else BF16_SHARE * _v_abs_max(tc, h)


def _q(rng, shape, qdt):
    q = rng.standard_normal(shape).astype(np.float32)
    jq = jnp.asarray(q, DTYPES[qdt][0])
    return jq, torch.from_numpy(q).to(DTYPES[qdt][1])


def _assert_close(out, ref, tol):
    assert out.dtype == {jnp.dtype(jnp.float32): torch.float32,
                         jnp.dtype(jnp.bfloat16): torch.bfloat16}[ref.dtype]
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=tol)


# the query dtype against the cache's: an f32 model over an f32 cache, a
# bf16 model over a bf16 or an int8 cache (the engine's modes)
# (query dtype, cache dtype, stable softmax); the window's cases add paged
ATTEND_CASES = [("f32", "f32", False), ("bf16", "bf16", True), ("bf16", "int8", False),
                ("bf16", "int8", True)]
WINDOW_CASES = [("f32", "f32", False, False), ("f32", "f32", True, True),
                ("bf16", "bf16", False, True), ("bf16", "bf16", True, False),
                ("bf16", "int8", False, False), ("bf16", "int8", True, True)]


def _ids(cases):
    return [f"{c[0]}-{c[1]}-{'stable' if c[2] else 'softmax'}"
            + ("" if len(c) == 3 else "-paged" if c[3] else "-dense") for c in cases]


@pytest.mark.parametrize("qdt, dt, stable", ATTEND_CASES, ids=_ids(ATTEND_CASES))
def test_pinned_cached_attend_matches_jax(qdt, dt, stable):
    """Lengths 1 and 24 (the whole cache), and 9 under a static mask row
    (its qpos row; the mask reaches one position past the cache)."""
    rng = np.random.RandomState(1)
    b, h, S, d = 3, 2, 24, 16
    jc, tc = _dense_pair(rng, dt, b, h, S, d)
    jq, tq = _q(rng, (b, h, 1, d), qdt)
    mask = rng.rand(S + 1, S + 1) < 0.7
    np.fill_diagonal(mask, True)
    for length, sm in ((1, None), (S, None), (9, mask)):
        kw = {} if sm is None else dict(qpos=length - 1)
        ref = jattn.cached_attend(jq, jc, jnp.int32(length), stable=stable,
                                  static_mask=None if sm is None else jnp.asarray(sm),
                                  use_kernel=False, **kw)
        out = tattn.cached_attend(tq, tc, length, stable=stable,
                                  static_mask=None if sm is None else torch.from_numpy(sm),
                                  use_kernel=False, **kw)
        _assert_close(out, ref, _tol(qdt, tc, h))


@pytest.mark.parametrize("qdt, dt, stable, paged", WINDOW_CASES, ids=_ids(WINDOW_CASES))
def test_pinned_cached_attend_window_matches_jax(qdt, dt, stable, paged):
    """Ragged starts: a fresh refill at 0, a mid-cache row and a parked row
    at max_seq (every position visible); a paged cache gathers its slab
    first (an unmapped page reads zeros), as the JAX package's does."""
    rng = np.random.RandomState(2)
    b, h, S, d, w = 3, 2, 24, 16, 5
    jc, tc = _paged_pair(rng, dt) if paged else _dense_pair(rng, dt, b, h, S, d)
    jq, tq = _q(rng, (b, h, w, d), qdt)
    starts = np.array([0, 11, S], np.int32)
    ref = jattn.cached_attend_window(jq, jc, jnp.asarray(starts), stable=stable,
                                     use_kernel=False)
    out = tattn.cached_attend_window(tq, tc, torch.from_numpy(starts), stable=stable,
                                     use_kernel=False)
    _assert_close(out, ref, _tol(qdt, tc.gather_dense() if paged else tc, h))


def test_pinned_window_at_w1_is_the_pinned_single_step():
    """The pinned window at w = 1 and the pinned single step are one
    formula: starts = length-1 gives the same bits, the engine's decode
    step against sequential generation's."""
    rng = np.random.RandomState(3)
    _, tc = _dense_pair(rng, "int8")
    _, tq = _q(rng, (3, 2, 1, 16), "bf16")
    for length in (1, 7, 24):
        one = tattn.cached_attend(tq, tc, length, use_kernel=False)
        win = tattn.cached_attend_window(tq, tc, torch.full((3,), length - 1),
                                         use_kernel=False)
        assert torch.equal(one, win)


# ---------------------------------------------------------------------------
# the engine against sequential generation, pinned
# ---------------------------------------------------------------------------

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
N_STEPS = CFG["image_fmap_size"] ** 2
TEXTS = [np.array([3, 4, 5, 0, 0, 0], np.int32),
         np.array([7, 8, 0, 0, 0, 0], np.int32),
         np.array([9, 1, 2, 3, 0, 0], np.int32),
         np.array([5, 5, 0, 0, 0, 0], np.int32),
         np.array([1, 2, 3, 4, 5, 6], np.int32)]


@functools.lru_cache(maxsize=None)
def _model():
    """The port's model with its weights perturbed from a seed (the logits
    then spread out, so ties are rare and a token that moves shows a
    fault)."""
    tm = init_dalle(DalleConfig(**CFG), seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return tm.eval()


# (engine slots, requests as (text index, seed, max_tokens, cond_scale))
ADMISSION = {
    # every admission covers at least half the slots: refill windows
    "bulk": (dict(slots=2), [(i, 300 + i, None, 2.0 if i == 2 else 1.0) for i in range(4)]),
    # ragged lengths free slots one at a time: per-row b=1 prefills
    "trickle": (dict(slots=3), [(i, 300 + i, n, 2.0 if i == 1 else 1.0)
                                for i, n in enumerate([16, 3, 9, 1, 12])]),
    # the block pool: radix hits, COW forks, block-wide prefill chunks
    "paged": (dict(slots=2, kv_block_tokens=4),
              [(0, 300, None, 1.0), (0, 301, None, 1.0), (2, 302, None, 2.0),
               (3, 303, 9, 1.0)]),
}
PRECISIONS = ["float32", "bf16_int8kv", "int8w"]


@pytest.mark.parametrize("admission", list(ADMISSION))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_pinned_engine_equals_pinned_sequential_generation(precision, admission):
    """Each request's tokens, bit for bit, against the engine model's own
    ``generate_images_tokens(text[None], use_kernel=False)`` under the
    request's generator and cache dtype (its first max_tokens)."""
    wrapper = DalleWithVae(_model(), None)
    kw, reqs = ADMISSION[admission]
    eng = wrapper.serve_engine(precision=precision, use_kernel=False, **kw)
    assert eng.use_kernel is False
    q = RequestQueue()
    for rid, (ti, seed, n, cs) in enumerate(reqs):
        q.submit(text=TEXTS[ti], seed=seed, request_id=rid, max_tokens=n, cond_scale=cs)
    q.close()
    got = {c.request_id: c.tokens for c in eng.run(q)}
    assert sorted(got) == list(range(len(reqs)))
    for rid, (ti, seed, n, cs) in enumerate(reqs):
        ref = eng.model.generate_images_tokens(
            torch.from_numpy(TEXTS[ti][None]).long(), cond_scale=cs,
            generator=torch.Generator().manual_seed(seed),
            cache_dtype=eng.cache_dtype, use_kernel=False)[0].numpy()
        np.testing.assert_array_equal(got[rid], ref[:n or N_STEPS],
                                      err_msg=f"{precision} {admission} request {rid}")


# ---------------------------------------------------------------------------
# no kernel under the pin
# ---------------------------------------------------------------------------

KERNEL_ENTRIES = ("decode_attend", "decode_attend_window", "decode_attend_window_paged")


def _counted(monkeypatch):
    """Count the calls of K2's, K3's and K5's entry points as the port's
    attention reaches them (on the CPU they run the plain versions)."""
    calls = dict.fromkeys(KERNEL_ENTRIES, 0)
    for name in KERNEL_ENTRIES:
        fn = getattr(tattn, name)

        def wrapped(*a, _name=name, _fn=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tattn, name, wrapped)
    return calls


def _launch_counts():
    return (tdec.launches, tdec.window_launches, tdec.paged_launches)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pin_reaches_no_decode_kernel(monkeypatch, paged):
    """Under the pin an engine run and sequential generation call none of
    K2, K3 and K5 (and launch none); under auto the same runs reach K3 (K5
    when paged) and K2."""
    calls = _counted(monkeypatch)
    before = _launch_counts()
    wrapper = DalleWithVae(_model(), None)
    kw = dict(kv_block_tokens=4) if paged else {}
    text = torch.from_numpy(TEXTS[0][None]).long()
    for pin in (False, None):
        eng = wrapper.serve_engine(slots=2, use_kernel=pin, **kw)
        q = RequestQueue()
        q.submit(text=TEXTS[0], seed=1, request_id=0, max_tokens=4)
        q.close()
        eng.run(q)
        eng.model.generate_images_tokens(text, generator=torch.Generator().manual_seed(1),
                                         cache_dtype=torch.int8, use_kernel=pin)
        if pin is False:
            assert calls == dict.fromkeys(KERNEL_ENTRIES, 0)
    window = "decode_attend_window_paged" if paged else "decode_attend_window"
    assert calls["decode_attend"] > 0 and calls[window] > 0
    # the CPU runs plain versions: no launch is ever counted here; the card
    # checks the counts under the pin in chip_smoke.py
    assert _launch_counts() == before
