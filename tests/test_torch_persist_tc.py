"""K8's CUDA order of work (``csrc/persistent_attention.cu``), written out in
tensor code on the CPU and held to the plain versions; no JAX.

The kernels walk 64×64 tiles of (b, h, n, d) operands read through their
strides (here the head views of a (b, n, 3·h·d) projection, the main
path's layout). The forward's pass 1 takes each row's (m, l) online over
the k tiles its q tile visits, pass 2 forms p with the final (m, l), rounds
it to bf16 and adds p16·v; the dq kernel's sweep 1 adds o = p16·v into two
halves (each k tile's first and last 32 keys), adds them and forms delta,
sweep 2 adds bf16(p·(dp − delta))·k the same way; the dk/dv kernel takes q
tile by q tile, each in two halves of 32 queries, with the unscaled q in
dk. A q tile visits the k tiles its map row marks (every tile below and on
the diagonal without a table), and every k tile when it holds a row that
sees nothing: that row's p is 1/n at every key, the keys above the diagonal
included.

Tolerances: ``fused_attention.kernel_tolerance`` of the plain versions (the
kernels round the same values to bf16 and sum in another order), and for a
peaked softmax (q × 8) ``fused_attention.flip_tolerance`` over K8's
``rounding_bound``; the row max within 1e-5 of max(1, |m|) and the row sum
within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from dalle_tpu_torch.ops import fused_attention as fa
from dalle_tpu_torch.ops import persistent_attention as pa

T = fa.TILE


def _table(kind, n):
    """None (causal), the transformer's layer table, or "holes": causal
    with row 5 hidden whole."""
    if kind == "none":
        return None
    if kind == "holes":
        tbl = torch.ones(n, n, dtype=torch.int8).tril()
        tbl[5] = 0
        return fa.MaskTable(tbl, pa.tile_map(tbl)[0])
    return fa.layer_table(kind, n)


def _plan(table, n):
    """(visible (n, n) bool, the k tiles q tile qt visits, the q tiles that
    visit k tile kt), by the kernels' rule from the tile map and the
    empty-row flags."""
    nt = -(-n // T)
    if table is None:
        vis = torch.ones(n, n, dtype=torch.bool).tril()
        return vis, (lambda qt: range(qt + 1)), (lambda kt: range(kt, nt))
    tiles, empty = pa.tile_map(table.table)
    used = (tiles != 0) | (empty != 0)[:, None]
    return (table.table != 0, lambda qt: [kt for kt in range(nt) if used[qt, kt]],
            lambda kt: [qt for qt in range(nt) if used[qt, kt]])


def _sl(t, n):
    return slice(t * T, min(t * T + T, n))


def _halves(sl):
    mid = min(sl.start + T // 2, sl.stop)
    return [slice(sl.start, mid), slice(mid, sl.stop)]


def _order_fwd(q, k, v, table, scale):
    """The forward kernel's order of work → (o in q's dtype, m, l); a row
    that sees nothing is written as m = -inf, l = n."""
    b, h, n, d = q.shape
    vis, visits, _ = _plan(table, n)
    qs = (q.to(torch.bfloat16).float() * scale).to(torch.bfloat16).float()
    k16, v16 = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float()
    o = torch.zeros(b, h, n, d)
    m_out, l_out = torch.empty(b, h, n), torch.empty(b, h, n)
    for qt in range(-(-n // T)):
        qsl = _sl(qt, n)

        def scores(kt, fill):
            ksl = _sl(kt, n)
            s = torch.einsum("bhid,bhjd->bhij", qs[:, :, qsl], k16[:, :, ksl])
            return torch.where(vis[qsl, ksl], s, fill[..., None]), ksl

        m = torch.full((b, h, qsl.stop - qsl.start), -torch.inf)
        l = torch.zeros_like(m)
        for kt in visits(qt):                                  # pass 1
            s, _ = scores(kt, torch.full_like(m, -torch.inf))
            m_new = torch.maximum(m, s.amax(-1))
            seen = m_new > -torch.inf
            base = torch.where(seen, m_new, 0.0)
            l = torch.where(seen, l * torch.exp(m - base) + torch.exp(s - base[..., None]).sum(-1),
                            l)
            m = m_new
        blind = m == -torch.inf
        l = torch.where(blind, float(n), l)
        m_out[:, :, qsl], l_out[:, :, qsl] = m, l
        fill = torch.where(blind, 0.0, -torch.inf)
        m = torch.where(blind, 0.0, m)
        for kt in visits(qt):                                  # pass 2
            s, ksl = scores(kt, fill)
            p16 = (torch.exp(s - m[..., None]) / l[..., None]).to(torch.bfloat16).float()
            o[:, :, qsl] += torch.einsum("bhij,bhjd->bhid", p16, v16[:, :, ksl])
    return o.to(q.dtype), m_out, l_out


def _order_bwd(q, k, v, do, m_in, l_in, table, scale):
    """The backward kernels' order of work → (dq, dk, dv) in q's dtype."""
    b, h, n, d = q.shape
    vis, visits, visitors = _plan(table, n)
    q16, k16, v16, do16 = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    qs = (q16 * scale).to(torch.bfloat16).float()
    blind = m_in == -torch.inf
    m = torch.where(blind, 0.0, m_in)
    fill = torch.where(blind, 0.0, -torch.inf)

    def p_ds(qsl, ksl, delta=None):
        s = torch.einsum("bhid,bhjd->bhij", qs[:, :, qsl], k16[:, :, ksl])
        s = torch.where(vis[qsl, ksl], s, fill[:, :, qsl, None])
        p = torch.exp(s - m[:, :, qsl, None]) / l_in[:, :, qsl, None]
        if delta is None:
            return p, None
        dp = torch.einsum("bhid,bhjd->bhij", do16[:, :, qsl], v16[:, :, ksl])
        return p, (p * (dp - delta[:, :, qsl, None])).to(torch.bfloat16).float()

    nt = -(-n // T)
    dq, delta = torch.zeros(b, h, n, d), torch.zeros(b, h, n)
    for qt in range(nt):                                       # the dq kernel
        qsl = _sl(qt, n)
        o = [torch.zeros(b, h, qsl.stop - qsl.start, d) for _ in range(2)]
        for kt in visits(qt):                                  # sweep 1
            for half, hs in enumerate(_halves(_sl(kt, n))):
                p, _ = p_ds(qsl, hs)
                o[half] += torch.einsum("bhij,bhjd->bhid", p.to(torch.bfloat16).float(),
                                        v16[:, :, hs])
        delta[:, :, qsl] = ((o[0] + o[1]) * do16[:, :, qsl]).sum(-1)
        acc = [torch.zeros_like(o[0]) for _ in range(2)]
        for kt in visits(qt):                                  # sweep 2
            for half, hs in enumerate(_halves(_sl(kt, n))):
                _, ds = p_ds(qsl, hs, delta)
                acc[half] += torch.einsum("bhij,bhjd->bhid", ds, k16[:, :, hs])
        dq[:, :, qsl] = (acc[0] + acc[1]) * scale
    dk, dv = torch.zeros(b, h, n, d), torch.zeros(b, h, n, d)
    for kt in range(nt):                                       # the dk/dv kernel
        ksl = _sl(kt, n)
        parts = [[0.0, 0.0], [0.0, 0.0]]                       # [dk, dv][half]
        for qt in visitors(kt):
            for half, hs in enumerate(_halves(_sl(qt, n))):
                p, ds = p_ds(hs, ksl, delta)
                parts[0][half] = parts[0][half] + torch.einsum("bhij,bhid->bhjd", ds, q16[:, :, hs])
                parts[1][half] = parts[1][half] + torch.einsum(
                    "bhij,bhid->bhjd", p.to(torch.bfloat16).float(), do16[:, :, hs])
        dk[:, :, ksl] = (parts[0][0] + parts[0][1]) * scale
        dv[:, :, ksl] = parts[1][0] + parts[1][1]
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _operands(n, dtype, peaked, seed, b=2, h=2, d=32):
    """q, k, v as the head views of one (b, n, 3·h·d) projection, and dO."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    if peaked:
        qkv[..., :h * d] *= 8
    qkv = qkv.to(dtype)
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    do = torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32)).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("peaked", [False, True], ids=["random", "peaked"])
@pytest.mark.parametrize("n,kind,dtype", [(77, "holes", torch.float32),
                                          (77, "conv_like", torch.float32),
                                          (513, "none", torch.bfloat16),
                                          (513, "axial_row", torch.bfloat16)])
def test_order_of_work_matches_the_plain_versions(n, kind, dtype, peaked):
    q, k, v, do = _operands(n, dtype, peaked, seed=n + peaked)
    assert q.stride(2) == 3 * q.shape[1] * q.shape[3]          # a strided view
    table = _table(kind, n)
    scale = q.shape[-1] ** -0.5
    o, m, l = _order_fwd(q, k, v, table, scale)
    grads = _order_bwd(q, k, v, do, m, l, table, scale)
    want = (pa.persist_fwd_plain(q, k, v, table),) + pa.persist_bwd_plain(q, k, v, do, table)
    bounds = pa.rounding_bound(q, k, v, do, table) if peaked else (None,) * 4
    for got, ref, bound in zip((o,) + grads, want, bounds):
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        tol = fa.kernel_tolerance(ref) if bound is None else fa.flip_tolerance(ref, bound)
        share = ((got.float() - ref.float()).abs() / tol).max().item()
        assert share <= 1.0, share
    # (m, l) against the whole row's; a row that sees nothing writes (-inf, n)
    qs = (q.to(torch.bfloat16).float() * scale).to(torch.bfloat16).float()
    s = torch.einsum("bhid,bhjd->bhij", qs, k.to(torch.bfloat16).float())
    vis = _plan(table, n)[0]
    rm = torch.where(vis, s, -torch.inf).amax(-1)
    rl = torch.where(vis, torch.exp(s - rm[..., None]), 0.0).sum(-1)
    blind = ~vis.any(-1)
    rl = torch.where(blind, float(n), rl)
    assert torch.equal(m == -torch.inf, blind.expand_as(m))
    seen = ~blind.expand_as(m)
    assert ((m - rm)[seen].abs() <= 1e-5 * rm[seen].abs().clamp(min=1.0)).all()
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "holes"])
@pytest.mark.parametrize("n", [77, 320, 513])
def test_tile_map_and_empty_row_flags_match_the_dense_table(kind, n):
    """``tile_map``: a tile is marked iff it holds a visible pair, a q tile
    is flagged iff one of its rows sees nothing; the transformer's own map
    (``MaskTable.tiles``) is the same, and it never needs a flag."""
    table = _table(kind, n).table
    tiles, empty = pa.tile_map(table)
    nt = -(-n // T)
    assert tiles.dtype == empty.dtype == torch.int8
    assert tiles.shape == (nt, nt) and empty.shape == (nt,)
    for qt in range(nt):
        rows = table[_sl(qt, n)] != 0
        assert empty[qt] == (~rows.any(-1)).any()
        for kt in range(nt):
            assert tiles[qt, kt] == rows[:, _sl(kt, n)].any()
    if kind == "holes":
        assert empty.tolist() == [1] + [0] * (nt - 1)
    else:
        assert torch.equal(tiles, fa.layer_table(kind, n).tiles) and not empty.any()


def test_a_row_that_sees_nothing_visits_every_tile():
    """Row 5 of "holes" sees nothing: its q tile visits every k tile, every
    k tile is visited by it, and its output is bf16(1/n)·Σ v over all n
    keys, as the plain version (the TPU's -1e9 fill) gives; had its q tile
    kept to the map's tiles, the keys above the diagonal would be missing."""
    n = 200
    q, k, v, do = _operands(n, torch.float32, False, seed=3)
    table = _table("holes", n)
    nt = -(-n // T)
    _, visits, visitors = _plan(table, n)
    assert list(visits(0)) == list(range(nt))
    assert all(0 in visitors(kt) for kt in range(nt))
    assert table.tiles[0].tolist() == [1] + [0] * (nt - 1)
    o, m, l = _order_fwd(q, k, v, table, q.shape[-1] ** -0.5)
    assert (m[:, :, 5] == -torch.inf).all() and (l[:, :, 5] == n).all()
    p16 = torch.tensor(1.0 / n).to(torch.bfloat16).float()
    want = p16 * v.to(torch.bfloat16).float().sum(2)
    torch.testing.assert_close(o[:, :, 5], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o[:, :, 5], pa.persist_fwd_plain(q, k, v, table)[:, :, 5],
                               rtol=1e-6, atol=1e-6)
    grads = _order_bwd(q, k, v, do, m, l, table, q.shape[-1] ** -0.5)
    for got, ref in zip(grads, pa.persist_bwd_plain(q, k, v, do, table)):
        share = ((got - ref).abs() / fa.kernel_tolerance(ref)).max().item()
        assert share <= 1.0, share
