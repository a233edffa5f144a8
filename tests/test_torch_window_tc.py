"""K3/K5's launch plan and the CUDA routes' order of work, on the CPU.

``decode_attention.window_plan`` picks the route of a windowed launch: the
tensor-core tiles (``tc``) for a refill window over a bf16 or int8 cache, a
thread-block cluster split (``split``) for a decode step, the f32 FMA kernel
(``fma``) for an f32 cache at w > 1. The kernels run only on the card, so
their order of work is written out here in tensor code, from the same plan:

* tc: tiles of ``tile_rows`` queries, bf16(f32(q)·scale); 64-position K/V
  tiles addressed as ``Rows::at`` does (an unmapped page or a position past
  the tile's end reads zeros, scale 0); pass 1 keeps each row's online
  (m, l); pass 2 takes p = exp(s − m) with the final m, times the V scale,
  rounds it to bf16 and sums p16·v in f32.
* split: the visible positions of each (row, head) in ``nsplit`` slices;
  each slice's scores and max, the global max, p rounded against it, each
  slice's partial o and l, and their sum in rank order.

Each is held against the plain version and against the Pallas kernel in
interpret mode within ``window_tolerance``, dense and paged (K5 ≡ K3 on the
gathered slab, bit for bit), with ragged starts (a parked row at S) and a
peaked softmax (q × 8).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops import attention as jattn
from dalle_tpu.ops.decode_attention import decode_attend_window_kernel
from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import decode_attention as tdec
from dalle_tpu_torch.ops import paged_kv as tpaged

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
KEYS = tdec.WINDOW_KEYS


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 16, 257])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_plan_route_for_every_dtype_and_width(dt, w):
    route, rows, nsplit = tdec.window_plan(8, 14, w, 512, DTYPES[dt], 132)
    if w == 1:
        assert route == "split" and rows == 1 and nsplit in (2, 4, 8)
    elif dt == "f32":
        assert (route, rows, nsplit) == ("fma", 16, 1)
    else:
        assert (route, rows, nsplit) == ("tc", tdec.TC_ROWS, 1)


def test_plan_tile_rows_and_split_against_the_sm_count():
    """A refill window takes 64-row tiles whatever the grid: 257 queries at
    b=8 (560 CTAs for 132 SMs) and at b=1 (``DecodeEngine._refill_row``, 70
    CTAs), the paged engine's 16-query prefill chunks at b=8 and b=1 (112
    and 14 CTAs), 4 heads at 60 SMs. A decode step over 512 positions
    splits 8 ways at b·h = 8 and 112 (896 CTAs, one wave at 8 an SM), 2
    ways at b·h = 896, and never past 8."""
    assert tdec.window_plan(8, 14, 257, 512, torch.bfloat16, 132) == ("tc", 64, 1)
    assert tdec.window_plan(1, 14, 257, 512, torch.int8, 132) == ("tc", 64, 1)
    assert tdec.window_plan(8, 14, 16, 512, torch.int8, 132) == ("tc", 64, 1)
    assert tdec.window_plan(1, 14, 16, 512, torch.bfloat16, 132) == ("tc", 64, 1)
    assert tdec.window_plan(1, 4, 257, 512, torch.int8, 60) == ("tc", 64, 1)
    assert tdec.window_plan(8, 1, 1, 512, torch.int8, 132) == ("split", 1, 8)
    assert tdec.window_plan(8, 14, 1, 512, torch.int8, 132) == ("split", 1, 8)
    assert tdec.window_plan(64, 14, 1, 512, torch.float32, 132) == ("split", 1, 2)
    assert tdec.window_plan(1, 1, 1, 17, torch.bfloat16, 132) == ("split", 1, 2)
    for bh in (1, 3, 8, 112, 1000):
        for S in (1, 64, 300, 512, 4352, 100000):
            nsplit = tdec.window_plan(bh, 1, 1, S, torch.int8, 132)[2]
            assert nsplit in (2, 4, 8) and nsplit <= tdec.MAX_SPLIT


# ---------------------------------------------------------------------------
# the routes' order of work in tensor code
# ---------------------------------------------------------------------------

def _rows(cache, k0, n):
    """The cache rows (b, n, 2hd) as f32 and their scales (b, 2h, n) (None
    without scales) of positions k0 .. k0+n-1, addressed as ``Rows::at``:
    an unmapped page or a position at or past S reads zeros, scale 0."""
    paged = isinstance(cache, tpaged.PagedKVCache)
    S = cache.max_seq
    pos = torch.arange(k0, k0 + n)
    inside = pos < S
    if paged:
        bt = cache.block_tokens
        page = cache.pages.long()[:, pos.clamp(max=S - 1) // bt]          # (b, n)
        ok = (page >= 0) & inside
        flat = torch.where(ok, page * bt + pos % bt, 0)
        kv = cache.pool.reshape(-1, cache.pool.shape[-1])[flat].float()
        sc = (None if cache.scale is None
              else cache.scale.reshape(-1, cache.scale.shape[-1])[flat].transpose(1, 2))
    else:
        idx = pos.clamp(max=S - 1)
        ok = inside[None].expand(cache.kv.shape[0], n)
        kv = cache.kv[:, idx].float()
        sc = None if cache.scale is None else cache.scale[:, :, idx]
    kv = torch.where(ok[..., None], kv, 0.0)
    if sc is not None:
        sc = torch.where(ok[:, None], sc, 0.0)
    return kv, sc


def tc_order_of_work(q, cache, starts, plan, scale=None):
    """``tc_window_kernel``'s order of work (bf16 or int8 cache, w > 1)."""
    route, rows, _ = plan
    assert route == "tc"
    b, h, w, d = q.shape
    S = cache.max_seq
    scale = d ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(torch.bfloat16).float()
    starts = torch.as_tensor(starts).long()
    out = torch.zeros(b, h, w, d)
    for q0 in range(0, w, rows):
        nq = min(rows, w - q0)
        qt = qs[:, :, q0:q0 + nq]
        L = (starts + q0 + nq).clamp(0, S)                                   # (b,)
        qpos = starts[:, None] + q0 + torch.arange(nq)                        # (b, nq)

        def tile(k0):
            kv, sc = _rows(cache, k0, KEYS)
            k = kv[..., :h * d].reshape(b, KEYS, h, d)
            v = kv[..., h * d:].reshape(b, KEYS, h, d)
            s = torch.einsum("bhqd,bkhd->bhqk", qt, k)
            if sc is not None:
                s = s * sc[:, None, :h].transpose(1, 2)
            pos = k0 + torch.arange(KEYS)
            vis = (pos[None, None] < L[:, None, None]) & (pos[None, None] <= qpos[..., None])
            return torch.where(vis[:, None], s, -torch.inf), v, sc

        tiles = range(0, int(L.max()), KEYS)
        m = torch.full((b, h, nq), -torch.inf)
        l = torch.zeros(b, h, nq)
        for k0 in tiles:                       # pass 1: online (m, l)
            s, _, _ = tile(k0)
            m_new = torch.maximum(m, s.amax(-1))
            live = m_new != -torch.inf
            fresh = torch.exp(s - m_new[..., None]).sum(-1)
            l = torch.where(live, l * torch.exp(m - m_new) + fresh, l)
            m = torch.where(live, m_new, m)
        m = torch.where(m == -torch.inf, 0.0, m)
        acc = torch.zeros(b, h, nq, d)
        for k0 in tiles:                       # pass 2: p against the final m
            s, v, sc = tile(k0)
            p = torch.exp(s - m[..., None])
            if sc is not None:
                p = p * sc[:, None, h:].transpose(1, 2)
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), v)
        out[:, :, q0:q0 + nq] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.to(q.dtype)


def split_order_of_work(q, cache, starts, plan, scale=None):
    """``split_window_kernel``'s order of work (w = 1, every dtype)."""
    route, _, nsplit = plan
    assert route == "split"
    b, h, w, d = q.shape
    assert w == 1
    S = cache.max_seq
    f32 = (cache.pool if isinstance(cache, tpaged.PagedKVCache) else cache.kv).dtype \
        == torch.float32
    dot_dt = torch.float32 if f32 else torch.bfloat16
    scale = d ** -0.5 if scale is None else scale
    qs = (q[:, :, 0].float() * scale).to(dot_dt).float()                    # (b, h, d)
    out = torch.zeros(b, h, 1, d)
    for bi, start in enumerate(torch.as_tensor(starts).tolist()):
        L = max(0, min(S, start + 1))
        per = -(-L // nsplit)
        ranks = []
        for r in range(nsplit):
            p0 = min(L, r * per)
            n = min(L, p0 + per) - p0
            kv, sc = _rows(cache, p0, n)
            k = kv[bi, :, :h * d].reshape(n, h, d)
            v = kv[bi, :, h * d:].reshape(n, h, d)
            s = torch.einsum("hd,nhd->hn", qs[bi], k)
            if sc is not None:
                s = s * sc[bi, :h]
            ranks.append((s, v, None if sc is None else sc[bi, h:]))
        m = torch.stack([s.amax(-1) if s.shape[-1] else torch.full((h,), -torch.inf)
                         for s, _, _ in ranks]).amax(0)
        m = torch.where(m == -torch.inf, 0.0, m)
        o, l = torch.zeros(h, d), torch.zeros(h)
        for s, v, vs in ranks:                 # rank 0 adds the partials in rank order
            e = torch.exp(s - m[:, None])
            pv = e if vs is None else e * vs
            o = o + torch.einsum("hn,nhd->hd", pv.to(dot_dt).float(), v)
            l = l + e.sum(-1)
        out[bi, :, 0] = o / torch.where(l > 0, l, 1.0)[:, None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

H, D, S, BT = 2, 32, 300, 16


def _caches(dt, seed):
    """A dense cache and a paged copy of it (shuffled pages, one unmapped
    per row), from the same numpy keys and values."""
    rng = np.random.RandomState(seed)
    b = 4
    k = torch.from_numpy(rng.standard_normal((b, H, S, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, H, S, D)).astype(np.float32))
    dense = tattn.KVCache.init(b, H, S, D, DTYPES[dt], device="cpu").append(k, v, 0)
    mb = -(-S // BT)
    pages = rng.permutation(b * mb + 3)[:b * mb].reshape(b, mb).astype(np.int32)
    pages[np.arange(b), (np.arange(b) * 5) % mb] = -1
    paged = tpaged.PagedKVCache.init(b * mb + 3, BT, H, S, D, DTYPES[dt],
                                     device="cpu").bind(pages)
    paged.append_rows(k, v, np.zeros(b, np.int64))
    return dense, paged


def _query(w, peaked, seed):
    q = np.random.RandomState(seed).standard_normal((4, H, w, D)).astype(np.float32)
    return torch.from_numpy(q * (8.0 if peaked else 1.0))


def _pallas(q, slab, starts):
    """The Pallas kernel in interpret mode on the (gathered) slab."""
    kv = slab.kv.float().numpy()
    jkv = jnp.asarray(kv).astype({torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                                  torch.int8: jnp.int8}[slab.kv.dtype])
    jsc = None if slab.scale is None else jnp.asarray(slab.scale.numpy())
    jc = jattn.KVCache(kv=jkv, scale=jsc, heads=H)
    out = decode_attend_window_kernel(jnp.asarray(q.numpy()), jc, jnp.asarray(starts),
                                      interpret=True)
    return torch.from_numpy(np.array(out, np.float32))


@functools.lru_cache(maxsize=None)
def _case(dt, w, peaked):
    """Caches, query, ragged starts (0, 17, S - w, parked at S) and the
    plain version's and the Pallas kernel's outputs, shared by the plans
    each test runs on the same inputs."""
    dense, paged = _caches(dt, seed=w)
    q = _query(w, peaked, seed=w + 1)
    starts = torch.tensor([0, 17, S - w, S], dtype=torch.int32)
    wants = (tdec.decode_attend_window_plain(q, dense.kv, dense.scale, starts),
             _pallas(q, dense, starts),
             tdec.decode_attend_window_paged_plain(q, paged, starts))
    return dense, paged, q, starts, wants


def _hold(got, got5, case):
    """K3's order of work against the plain version and the Pallas kernel
    on the slab, K5's against the paged plain version, within
    window_tolerance."""
    dense, _, _, _, (plain, pallas, plain5) = case
    dt = dense.kv.dtype
    for out, want in ((got, plain), (got, pallas), (got5, plain5)):
        share = tdec.window_share(out, want, dt)
        assert share <= 1.0, share


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("w", [16, 257])
@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_tc_order_of_work_matches_plain_and_pallas(dt, w, peaked):
    """A paged prefill chunk (16 queries, 48 rows of its tile padding) and a
    refill window (257, one query past a tile edge) in 64-row tiles; K5's
    addressing (through the page table, one unmapped page per row)
    equals K3's on the gathered slab bit for bit."""
    case = _case(dt, w, peaked)
    _, paged, q, starts, _ = case
    plan = tdec.window_plan(4, H, w, S, DTYPES[dt], 132)
    assert plan == ("tc", 64, 1)
    got5 = tc_order_of_work(q, paged, starts, plan)
    assert torch.equal(got5, tc_order_of_work(q, paged.gather_dense(), starts, plan))
    _hold(tc_order_of_work(q, case[0], starts, plan), got5, case)


@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_tc_order_of_work_at_w2(dt):
    """The smallest refill window, one 64-row tile with 62 rows of padding."""
    case = _case(dt, 2, False)
    dense, paged, q, starts, _ = case
    plan = tdec.window_plan(4, H, 2, S, DTYPES[dt], 132)
    assert plan == ("tc", 64, 1)
    _hold(tc_order_of_work(q, dense, starts, plan),
          tc_order_of_work(q, paged, starts, plan), case)


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("sm_count,nsplit", [(1, 2), (132, 4)])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_split_order_of_work_matches_plain_and_pallas(dt, sm_count, nsplit, peaked):
    """A decode step at ragged starts (0: one visible position, fewer than
    the ranks; 17; S - 1; parked at S) split 2 and 4 ways, dense and
    paged."""
    case = _case(dt, 1, peaked)
    dense, paged, q, starts, _ = case
    plan = tdec.window_plan(4, H, 1, S, DTYPES[dt], sm_count)
    assert plan == ("split", 1, nsplit)
    got5 = split_order_of_work(q, paged, starts, plan)
    assert torch.equal(got5, split_order_of_work(q, paged.gather_dense(), starts, plan))
    _hold(split_order_of_work(q, dense, starts, plan), got5, case)
