"""The serve engine's attention pieces ≡ the JAX package's, on the same numpy
inputs (CPU, tiny shapes).

K3's plain version (``decode_attend_window_plain``, what
``decode_attend_window`` runs for a CPU tensor) against the Pallas kernel
``decode_attend_window_kernel`` in interpret mode and against the dense
``cached_attend_window``; K5's plain version against
``decode_attend_window_paged``; the windowed writes of ``KVCache`` and
``PagedKVCache`` (append_rows, gather_dense, copy_blocks) against their JAX
twins, parked rows and unmapped pages included; ``Attention.decode_window``
and ``Transformer.decode_window`` against JAX on weights carried across by
``convert.py``. The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.ops import attention as jattn
from dalle_tpu.ops import paged_kv as jpaged
from dalle_tpu.ops.decode_attention import (decode_attend_window_kernel,
                                            decode_attend_window_paged)
from dalle_tpu_torch.config import DalleConfig
from dalle_tpu_torch.convert import dalle_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import decode_attention as tdec
from dalle_tpu_torch.ops import paged_kv as tpaged

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _caches(rng, b, h, S, d, dt, fill=None):
    """The same random keys/values appended to a JAX and a port cache over
    the first ``fill`` positions (all by default)."""
    jdt, tdt = DTYPES[dt]
    n = S if fill is None else fill
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    jc = jattn.KVCache.init(b, h, S, d, jdt).append(jnp.asarray(k), jnp.asarray(v), 0)
    tc = tattn.KVCache.init(b, h, S, d, tdt, device="cpu").append(
        torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


def _tol(dt, kv_abs_max):
    """Plain K3 vs the Pallas kernel. f32: only the summation order differs
    (1e-5 on O(1) outputs). bf16 and int8: both round q·scale and the
    probabilities to bf16 at the same points, so they differ where a
    probability sits on a bf16 rounding boundary and the two summation
    orders put it on different sides: one bf16 ulp (2^-8 relative) of some
    p_j, times |v_j|. Bounded by 2^-7 of the largest value a V row can hold,
    which for int8 is 127 × its largest V scale."""
    return 1e-5 if dt == "f32" else 2.0 ** -7 * kv_abs_max


def _v_abs_max(tc, h):
    b, S, hd2 = tc.kv.shape
    v = tc.kv[:, :, hd2 // 2:].float().abs().amax(dim=-1)               # (b, S)
    if tc.scale is not None:
        v = v * tc.scale[:, h:].amax(dim=1)
    return v.max().item()


# ---------------------------------------------------------------------------
# K3: the windowed kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 5, 20])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_window_plain_matches_pallas_interpret(dt, w):
    """Ragged starts: a fresh refill at 0, mid-cache rows, a window that ends
    on the last slot, and a parked row at S (every position visible)."""
    rng = np.random.RandomState(w)
    b, h, S, d = 4, 2, 48, 16
    jc, tc = _caches(rng, b, h, S, d, dt)
    q = rng.standard_normal((b, h, w, d)).astype(np.float32)
    starts = np.array([0, 17, S - w, S], np.int32)
    ref = decode_attend_window_kernel(jnp.asarray(q), jc, jnp.asarray(starts),
                                      interpret=True)
    out = tdec.decode_attend_window_plain(torch.from_numpy(q), tc.kv, tc.scale,
                                          torch.from_numpy(starts))
    assert out.shape == (b, h, w, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=_tol(dt, _v_abs_max(tc, h)))


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_window_plain_matches_dense_cached_attend_window(dt, stable):
    """Against the JAX package's dense path (use_kernel=False), which keeps
    the scores in the query dtype: f32 to 1e-5; bf16/int8 within the bf16
    bound above (the dense path's q·k and p·v run in bf16 here). The port
    has no stable fork: a stable layer's window goes to K3 like any other,
    and must match JAX's stable dense path to the same bounds."""
    rng = np.random.RandomState(3)
    b, h, S, d, w = 3, 2, 40, 16, 4
    jc, tc = _caches(rng, b, h, S, d, dt)
    qdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    q = rng.standard_normal((b, h, w, d)).astype(np.float32)
    starts = np.array([2, 30, S], np.int32)
    ref = jattn.cached_attend_window(jnp.asarray(q, qdt), jc, jnp.asarray(starts),
                                     stable=stable, use_kernel=False)
    tq = torch.from_numpy(q).to(torch.float32 if dt == "f32" else torch.bfloat16)
    out = tattn.cached_attend_window(tq, tc, torch.from_numpy(starts))
    tol = 1e-5 if dt == "f32" else 2.0 ** -6 * _v_abs_max(tc, h)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=tol)


def test_window_w1_equals_single_token_plain():
    """w = 1 with starts = length-1 is K2's function: f32 caches agree to
    summation order."""
    rng = np.random.RandomState(4)
    b, h, S, d = 2, 3, 32, 16
    _, tc = _caches(rng, b, h, S, d, "f32")
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d)).astype(np.float32))
    out = tdec.decode_attend_window_plain(q, tc.kv, None, torch.tensor([20, 20]))
    ref = tdec.decode_attend_plain(q, tc.kv, None, 21)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# K5: the paged form
# ---------------------------------------------------------------------------

def _paged_pair(rng, dt, b=3, h=2, d=16, bt=4, max_seq=24, num_blocks=20):
    """A JAX and a port PagedKVCache with the same permuted page table (some
    pages unmapped) and the same content written through it."""
    jdt, tdt = DTYPES[dt]
    max_blocks = max_seq // bt
    perm = rng.permutation(num_blocks)[:b * max_blocks].reshape(b, max_blocks)
    pages = perm.astype(np.int32)
    pages[1, -2:] = -1                       # row 1: its last two pages unmapped
    pages[2, 3] = -1                         # row 2: a hole in the middle
    jp = jpaged.PagedKVCache.init(num_blocks, bt, h, max_seq, d, jdt).replace(
        pages=jnp.asarray(pages))
    tp = tpaged.PagedKVCache.init(num_blocks, bt, h, max_seq, d, tdt,
                                  device="cpu").bind(pages)
    k = rng.standard_normal((b, h, max_seq, d)).astype(np.float32)
    v = rng.standard_normal((b, h, max_seq, d)).astype(np.float32)
    zeros = np.zeros((b,), np.int32)
    jp = jp.append_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(zeros))
    tp.append_rows(torch.from_numpy(k), torch.from_numpy(v), zeros)
    return jp, tp


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_paged_plain_matches_pallas_paged_interpret(dt):
    rng = np.random.RandomState(5)
    jp, tp = _paged_pair(rng, dt)
    b, h, w, d = 3, 2, 6, 16
    q = rng.standard_normal((b, h, w, d)).astype(np.float32)
    starts = np.array([0, 11, 24], np.int32)
    ref = decode_attend_window_paged(jnp.asarray(q), jp, jnp.asarray(starts),
                                     interpret=True)
    out = tdec.decode_attend_window_paged_plain(torch.from_numpy(q), tp,
                                                torch.from_numpy(starts))
    tol = _tol(dt, _v_abs_max(tp.gather_dense(), h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_paged_plain_equals_window_plain_on_gathered_slab(dt):
    """K5's function is K3's on the gathered slab, bit for bit; and
    ``cached_attend_window`` sends a paged cache to K5 and a slab to K3."""
    rng = np.random.RandomState(6)
    _, tp = _paged_pair(rng, dt)
    q = torch.from_numpy(rng.standard_normal((3, 2, 3, 16)).astype(np.float32))
    starts = torch.tensor([4, 9, 24], dtype=torch.int32)
    dense = tp.gather_dense()
    before = tdec.window_launches, tdec.paged_launches
    a = tattn.cached_attend_window(q, tp, starts)
    b = tattn.cached_attend_window(q, dense, starts)
    assert torch.equal(a, b)
    assert torch.equal(a, tdec.decode_attend_window_plain(q, dense.kv, dense.scale, starts))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tdec.window_launches, tdec.paged_launches) == before


# ---------------------------------------------------------------------------
# windowed writes: KVCache.append_rows, PagedKVCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_kv_cache_append_rows_matches_jax(dt):
    """Per-row writes at ragged offsets, a parked row (offset S) dropped, and
    a row whose window overshoots the end (its tail dropped)."""
    rng = np.random.RandomState(7)
    b, h, S, d, w = 4, 2, 20, 16, 5
    jc, tc = _caches(rng, b, h, S, d, dt, fill=6)
    k = rng.standard_normal((b, h, w, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, h, w, d)).astype(np.float32)
    offsets = np.array([6, 0, S, S - 2], np.int32)
    jc = jc.append_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets))
    tc.append_rows(torch.from_numpy(k), torch.from_numpy(v), offsets)
    np.testing.assert_array_equal(_np(tc.kv), _np(jc.kv))
    if dt == "int8":
        np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_paged_append_rows_gather_and_copy_match_jax(dt):
    """Writes through a permuted page table with unmapped pages, a parked
    row, gather_dense, and a COW copy with a dropped lane."""
    rng = np.random.RandomState(8)
    jp, tp = _paged_pair(rng, dt)
    h, d = 2, 16
    k = rng.standard_normal((3, h, 4, d)).astype(np.float32)
    v = rng.standard_normal((3, h, 4, d)).astype(np.float32)
    offsets = np.array([5, 20, 24], np.int32)       # row 1 lands in unmapped pages
    jp = jp.append_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets))
    tp.append_rows(torch.from_numpy(k), torch.from_numpy(v), offsets)
    np.testing.assert_array_equal(_np(tp.pool), _np(jp.pool))
    jd, td = jp.gather_dense(), tp.gather_dense()
    np.testing.assert_array_equal(_np(td.kv), _np(jd.kv))
    if dt == "int8":
        np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
        np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))
    src, dst = np.array([3, 0, 7], np.int32), np.array([9, 20, 2], np.int32)
    jp = jp.copy_blocks(jnp.asarray(src), jnp.asarray(dst))
    tp.copy_blocks(src, dst)
    np.testing.assert_array_equal(_np(tp.pool), _np(jp.pool))
    if dt == "int8":
        np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))


def test_paged_cache_needs_its_page_table():
    tp = tpaged.PagedKVCache.init(4, 4, 1, 8, 16, device="cpu")
    with pytest.raises(RuntimeError, match="bind"):
        tp.gather_dense()
    with pytest.raises(ValueError, match="cover"):
        tp.bind(np.zeros((1, 1), np.int32))


# ---------------------------------------------------------------------------
# decode_window on converted weights
# ---------------------------------------------------------------------------

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)


def _models(**over):
    jm, jp = jinit_dalle(JDalleConfig(**TINY, **over), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), jp)
    tm = DALLE(DalleConfig(**TINY, **over))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def stable_models():
    return _models(stable=True)


def _window_inputs(seed, b, w):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, w, TINY["dim"])).astype(np.float32)
    return x


@pytest.mark.parametrize("stable", [False, True])
def test_attention_decode_window_matches_jax(request, stable):
    """A stable-softmax layer goes through K3's plain version here, and
    through K3 on the card; JAX takes its stable dense path."""
    jm, jp, tm = request.getfixturevalue("stable_models" if stable else "models")
    assert tm.transformer.attn_0.stable == stable
    S = tm.cfg.total_seq_len
    b, w = 3, 4
    x = _window_inputs(1, b, w)
    offsets = np.array([0, 9, S], np.int32)
    jcache = jattn.KVCache.init(b, TINY["heads"], S, TINY["dim_head"])
    tcache = tattn.KVCache.init(b, TINY["heads"], S, TINY["dim_head"], device="cpu")

    def jfn(m, x, c, o):
        return m.transformer.attn_layers[0].fn.decode_window(
            x, c, o, rotary=m.transformer.rotary)

    jy, jc = jm.apply(jp, jnp.asarray(x), jcache, jnp.asarray(offsets), method=jfn)
    with torch.no_grad():
        ty, tc = tm.transformer.attn_0.decode_window(
            torch.from_numpy(x), tcache, offsets, rotary=tm.transformer.rotary)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.kv.numpy(), np.asarray(jc.kv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_transformer_decode_window_matches_jax(models, paged):
    """A refill window at 0 for two rows (one parked), then one decode step
    per row at ragged offsets, through every layer; the paged cache maps
    each row's blocks through a shuffled page table."""
    jm, jp, tm = models
    S = tm.cfg.total_seq_len
    b, h, dh = 3, TINY["heads"], TINY["dim_head"]
    if paged:
        bt, nb = 4, 24
        mb = -(-S // bt)
        pages = np.random.RandomState(2).permutation(nb)[:b * mb].reshape(b, mb)
        pages = pages.astype(np.int32)

        def jinit():
            return {f"kv_{i}": jpaged.PagedKVCache.init(nb, bt, h, S, dh).replace(
                pages=jnp.asarray(pages)) for i in range(TINY["depth"])}

        tcache = tm.transformer.init_cache_paged(nb, bt, S)
        for c in tcache.values():
            c.bind(pages)
    else:
        def jinit():
            return {f"kv_{i}": jattn.KVCache.init(b, h, S, dh) for i in range(TINY["depth"])}

        tcache = tm.transformer.init_cache(b, S)
    jcache = jinit()

    def jfn(m, x, c, o):
        return m.transformer.decode_window(x, c, o)

    steps = [(_window_inputs(3, b, 7), np.array([0, S, 0], np.int32)),
             (_window_inputs(4, b, 1), np.array([7, S, 7], np.int32)),
             (_window_inputs(5, b, 1), np.array([8, 0, S], np.int32))]
    for x, offsets in steps:
        jy, jcache = jm.apply(jp, jnp.asarray(x), jcache, jnp.asarray(offsets), method=jfn)
        with torch.no_grad():
            ty, tcache = tm.transformer.decode_window(torch.from_numpy(x), tcache, offsets)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
