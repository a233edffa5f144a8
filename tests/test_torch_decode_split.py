"""K2's and K7's launch plan and their CUDA order of work, on the CPU.

``decode_attention.decode_plan`` sets a decode launch from the shapes alone:
``nsplit`` CTAs (a thread-block cluster) per (b, h) row, a ring of
``stages`` slots of 64 cache positions (K and V rows) and the shared memory
that takes. The kernels (``csrc/decode_attention.cu``,
``csrc/decode_chunked_attention.cu`` on ``csrc/decode_split.cuh``) run only on
the card, so their order of work is written out here in tensor code:

* K2: the ranks' slices derived from ``length`` (balanced runs of the
  valid range), 64-position stages with an f32 online (m, l, o) per rank,
  then the ranks merged in rank order by exp(m_r - M). Held to the
  function in float64 within 1e-6 of the largest output, as
  ``decode_attend_plain`` is, and so to the plain version within 2e-6.
* K7: ranks of whole ``blk`` blocks; each block's probabilities against its
  own max, rounded to bf16 (bf16 and int8 caches), the blocks merged online
  inside a rank, the ranks in rank order. Held to
  ``decode_attend_chunked_plain`` within ``chunked_tolerance`` and to the
  merge over every block at once within f32 rounding.

No JAX: ``test_torch_decode_attention.py`` and ``test_torch_chunked_decode.py``
hold the plain versions to the Pallas kernels.
"""

import math

import numpy as np
import pytest
import torch

from dalle_tpu_torch.ops import attention as tattn
from dalle_tpu_torch.ops import decode_attention as tdec

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
STAGE = tdec.STAGE
NEG = -math.inf


def _cache(rng, b, h, S, d, dt):
    k = torch.from_numpy(rng.standard_normal((b, h, S, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, S, d)).astype(np.float32))
    return tattn.KVCache.init(b, h, S, d, DTYPES[dt], device="cpu").append(k, v, 0)


def _heads(kv, sl, h, d, part):
    """(b, len, h, d) f32 K (part 0) or V (part 1) rows of the positions sl."""
    b = kv.shape[0]
    return kv[:, sl, part * h * d:(part + 1) * h * d].reshape(b, -1, h, d).float()


def _scores(qs, kv, kv_scale, sl, h, d, valid):
    s = torch.einsum("bhd,bshd->bhs", qs, _heads(kv, sl, h, d, 0))
    if kv_scale is not None:
        s = s * kv_scale[:, :h, sl]
    return torch.where(valid, s, NEG)


def _valid(sl, length, mask_row):
    pos = torch.arange(sl.start, sl.stop)
    valid = pos < length
    if mask_row is not None:
        valid = valid & (mask_row[sl] != 0)
    return valid


def _merge(m, l, o, mb, lb, ob):
    """(m, l, o) merged with (mb, lb, ob): an empty side (m = -inf) weighs 0."""
    big = torch.maximum(m, mb)
    safe = torch.where(big == NEG, 0.0, big)
    w = torch.where(m == NEG, 0.0, torch.exp(m - safe))
    wb = torch.where(mb == NEG, 0.0, torch.exp(mb - safe))
    return big, w * l + wb * lb, w * o + wb * ob


def _rank_order(parts, like):
    """The ranks' (m, l, o) merged in rank 0: M = max m_r, then the weighted
    sums in rank order; 0 where nothing was valid."""
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    safe = torch.where(big == NEG, 0.0, big)
    l = torch.zeros_like(parts[0][1])
    o = torch.zeros_like(parts[0][2])
    for m, lr, orr in parts:
        w = torch.where(m == NEG, 0.0, torch.exp(m - safe))
        l = l + w * lr
        o = o + w * orr
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(like.dtype)[:, :, None]


def k2_slices(length, S, nsplit):
    """Each rank's [p0, end): runs of ceil(L / nsplit) positions of the valid
    range [0, L = min(length, S)), as the kernel derives them."""
    L = max(0, min(length, S))
    per = -(-L // nsplit)
    out = []
    for r in range(nsplit):
        p0 = min(L, r * per)
        out.append((p0, min(L, p0 + per)))
    return out


def k2_split(q, kv, kv_scale, length, nsplit, mask_row=None, rows=STAGE):
    """K2's order of work: per rank, stages of ``rows`` positions with an
    f32 online (m, l, o) (p = exp(s - m') times the V scale, no rounding),
    then the rank-order merge."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    qs = q[:, :, 0].float() * d ** -0.5
    parts = []
    for p0, end in k2_slices(length, S, nsplit):
        m = torch.full((b, h, 1), NEG)
        l = torch.zeros(b, h, 1)
        o = torch.zeros(b, h, d)
        for p in range(p0, end, rows):
            sl = slice(p, min(p + rows, end))
            s = _scores(qs, kv, kv_scale, sl, h, d, _valid(sl, length, mask_row))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            safe = torch.where(m_new == NEG, 0.0, m_new)
            corr = torch.where(m == NEG, 0.0, torch.exp(m - safe))
            pr = torch.where(s == NEG, 0.0, torch.exp(s - safe))
            l = l * corr + pr.sum(-1, keepdim=True)
            if kv_scale is not None:
                pr = pr * kv_scale[:, h:, sl]
            o = o * corr + torch.einsum("bhs,bshd->bhd", pr, _heads(kv, sl, h, d, 1))
            m = m_new
        parts.append((m, l, o))
    return _rank_order(parts, q)


def k7_runs(length, S, blk, nsplit):
    """Each rank's run of whole blocks [ib0, ib0 + nb) below length."""
    L = max(0, min(length, S))
    nblk = -(-L // blk)
    bpr = -(-nblk // nsplit)
    out = []
    for r in range(nsplit):
        ib0 = min(nblk, r * bpr)
        out.append((ib0, min(nblk, ib0 + bpr) - ib0))
    return out


def k7_split(q, kv, kv_scale, length, blk, nsplit, mask_row=None):
    """K7's order of work: per rank, its blocks one by one, each scored
    whole, its p = exp(s - m_b) times the V scale rounded to the product
    type, (m_b, l_b, acc_b) merged online into the rank's (m, l, o); then
    the rank-order merge."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    dot_dt = torch.float32 if kv.dtype == torch.float32 else torch.bfloat16
    qs = (q[:, :, 0].float() * d ** -0.5).to(dot_dt).float()
    L = max(0, min(length, S))
    parts = []
    for ib0, nb in k7_runs(length, S, blk, nsplit):
        m = torch.full((b, h, 1), NEG)
        l = torch.zeros(b, h, 1)
        o = torch.zeros(b, h, d)
        for ib in range(ib0, ib0 + nb):
            sl = slice(ib * blk, min(ib * blk + blk, L))
            s = _scores(qs, kv, kv_scale, sl, h, d, _valid(sl, length, mask_row))
            mb = s.amax(-1, keepdim=True)
            safe = torch.where(mb == NEG, 0.0, mb)
            pr = torch.where(s == NEG, 0.0, torch.exp(s - safe))
            lb = pr.sum(-1, keepdim=True)
            if kv_scale is not None:
                pr = pr * kv_scale[:, h:, sl]
            acc = torch.einsum("bhs,bshd->bhd", pr.to(dot_dt).float(), _heads(kv, sl, h, d, 1))
            m, l, o = _merge(m, l, o, mb, lb, acc)
        parts.append((m, l, o))
    return _rank_order(parts, q)


def _per_block_max(q, kv, kv_scale, length, blk, mask_row=None):
    """Every block's (m_b, l_b, acc_b) merged at once over M = max m_b, in
    block order: the order of the two-kernel port that K7's one kernel
    replaces (``_per_block_max`` of ``test_torch_chunked_decode.py``)."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    dot_dt = torch.float32 if kv.dtype == torch.float32 else torch.bfloat16
    qs = (q[:, :, 0].float() * d ** -0.5).to(dot_dt).float()
    L = max(0, min(length, S))
    parts = []
    for j0 in range(0, L, blk):
        sl = slice(j0, min(j0 + blk, L))
        s = _scores(qs, kv, kv_scale, sl, h, d, _valid(sl, length, mask_row))
        mb = s.amax(-1, keepdim=True)
        pr = torch.where(s == NEG, 0.0, torch.exp(s - torch.where(mb == NEG, 0.0, mb)))
        lb = pr.sum(-1, keepdim=True)
        if kv_scale is not None:
            pr = pr * kv_scale[:, h:, sl]
        parts.append((mb, lb, torch.einsum("bhs,bshd->bhd", pr.to(dot_dt).float(),
                                           _heads(kv, sl, h, d, 1))))
    if not parts:
        return torch.zeros_like(q)
    return _rank_order(parts, q)


def _close(got, want, rel=1e-6):
    """Within ``rel`` of the largest output (at least 1)."""
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * max(1.0, want.double().abs().max().item()), err


def _exact(q, kv, kv_scale, length, mask_row=None):
    """K2's function in float64: the reference both f32 orders round from."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    k = kv[:, :, :h * d].reshape(b, S, h, d).double()
    v = kv[:, :, h * d:].reshape(b, S, h, d).double()
    s = torch.einsum("bhd,bshd->bhs", q[:, :, 0].double() * d ** -0.5, k)
    if kv_scale is not None:
        s = s * kv_scale[:, :h].double()
    valid = torch.arange(S) < length
    if mask_row is not None:
        valid = valid & (mask_row[:S] != 0)
    s = torch.where(valid, s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - torch.where(m == NEG, 0.0, m)), 0.0)
    den = p.sum(-1, keepdim=True)
    if kv_scale is not None:
        p = p * kv_scale[:, h:].double()
    o = torch.einsum("bhs,bshd->bhd", p, v) / torch.where(den > 0, den, 1.0)
    return o[:, :, None]


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_k2_split_matches_plain(dt, nsplit):
    """Full, ragged (inside a stage, on a stage edge) and length-1 rows,
    with and without a mask row: within 1e-6 of the largest output of the
    function in float64, and so within 2e-6 of the plain version, whose own
    f32 sums (another order) round by up to 1e-6 as well."""
    rng = np.random.RandomState(nsplit)
    b, h, S, d = 2, 3, 700, 32
    cache = _cache(rng, b, h, S, d, dt)
    q = torch.from_numpy(2 * rng.standard_normal((b, h, 1, d)).astype(np.float32))
    row = torch.from_numpy((rng.rand(S) > 0.4).astype(np.int32))
    for length, mask in ((S, None), (451, None), (256, None), (1, None), (S, row), (333, row)):
        want = tdec.decode_attend_plain(q, cache.kv, cache.scale, length, mask_row=mask)
        exact = _exact(q, cache.kv, cache.scale, length, mask)
        _close(want, exact)
        for rows in ((STAGE, 16) if length in (S, 333) else (STAGE,)):
            got = k2_split(q, cache.kv, cache.scale, length, nsplit, mask, rows)
            _close(got, exact)
            _close(got, want, 2e-6)


def test_k2_length_one_leaves_every_rank_but_one_empty():
    rng = np.random.RandomState(1)
    cache = _cache(rng, 1, 2, 512, 16, "bf16")
    q = torch.from_numpy(rng.standard_normal((1, 2, 1, 16)).astype(np.float32))
    slices = k2_slices(1, 512, 8)
    assert slices[0] == (0, 1) and all(p0 == end for p0, end in slices[1:])
    want = tdec.decode_attend_plain(q, cache.kv, cache.scale, 1)
    _close(k2_split(q, cache.kv, cache.scale, 1, 8), want)
    # the only position: the output is v_0
    v0 = cache.kv[:, 0, 2 * 16:].reshape(1, 2, 16).float()
    _close(want[:, :, 0], v0)


def test_k2_everything_masked_gives_exact_zeros():
    rng = np.random.RandomState(2)
    cache = _cache(rng, 2, 2, 300, 16, "int8")
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 16)).astype(np.float32))
    row = torch.zeros(300, dtype=torch.int32)
    for nsplit in (1, 4, 8):
        got = k2_split(q, cache.kv, cache.scale, 250, nsplit, row)
        assert torch.equal(got, torch.zeros_like(got))
    assert not tdec.decode_attend_plain(q, cache.kv, cache.scale, 250, mask_row=row).any()
    assert not k2_split(q, cache.kv, cache.scale, 0, 8).any()


def test_k2_slices_cover_the_valid_range_in_balanced_runs():
    """For every length, the ranks' slices tile [0, min(length, S)) in rank
    order, differ in size by less than one rank's share, and hold no more
    stages than the plan's ring was sized for."""
    for S, nsplit, rows in ((512, 8, 64), (512, 4, 32), (4352, 8, 64), (300, 4, 16),
                            (17, 1, 64)):
        bound = -(-(-(-S // nsplit)) // rows)
        for length in range(0, S + 3):
            slices = k2_slices(length, S, nsplit)
            assert slices[0][0] == 0 and slices[-1][1] == max(0, min(length, S))
            for (p0, end), (q0, _) in zip(slices, slices[1:]):
                assert end == q0
            sizes = [end - p0 for p0, end in slices]
            assert max(sizes) == -(-max(0, min(length, S)) // nsplit)
            assert all(-(-n // rows) <= bound for n in sizes)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
@pytest.mark.parametrize("dt, qdt", [("f32", torch.float32), ("bf16", torch.bfloat16),
                                     ("int8", torch.bfloat16), ("int8", torch.float32)])
def test_k7_split_within_chunked_tolerance_and_f32_rounding_of_per_block_max(dt, qdt, nsplit):
    rng = np.random.RandomState(10 + nsplit)
    b, h, S, d, blk = 2, 2, 1280, 32, 256
    cache = _cache(rng, b, h, S, d, dt)
    q = torch.from_numpy(3 * rng.standard_normal((b, h, 1, d)).astype(np.float32)).to(qdt)
    row = torch.from_numpy((rng.rand(S) > 0.3).astype(np.int32))
    for length, mask in ((S, None), (1000, None), (300, row), (257, None)):
        want = tdec.decode_attend_chunked_plain(q, cache.kv, cache.scale, length, blk=blk,
                                                mask_row=mask)
        got = k7_split(q, cache.kv, cache.scale, length, blk, nsplit, mask)
        tol = tdec.chunked_tolerance(q, cache.kv, cache.scale, length, want, mask_row=mask)
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= tol).all()), (diff / tol).max()
        if qdt == torch.float32:
            _close(got, _per_block_max(q, cache.kv, cache.scale, length, blk, mask))


def test_k7_blocks_of_a_rank_are_whole_and_a_masked_block_weighs_nothing():
    rng = np.random.RandomState(3)
    b, h, S, d, blk = 1, 2, 1024, 16, 128
    cache = _cache(rng, b, h, S, d, "bf16")
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d)).astype(np.float32))
    runs = k7_runs(700, S, blk, 4)
    assert runs == [(0, 2), (2, 2), (4, 2), (6, 0)]          # 6 blocks below 700
    row = torch.ones(S, dtype=torch.int32)
    row[128:256] = 0                                          # block 1 sees nothing
    want = _per_block_max(q, cache.kv, cache.scale, 700, blk, row)
    _close(k7_split(q, cache.kv, cache.scale, 700, blk, 4, row), want)
    assert not k7_split(q, cache.kv, cache.scale, 0, blk, 4).any()
    zero = torch.zeros(S, dtype=torch.int32)
    assert torch.equal(k7_split(q, cache.kv, cache.scale, 700, blk, 2, zero),
                       torch.zeros_like(q))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_at_the_served_and_long_caches():
    """DALL·E-1.4B's cache (b=8, h=14, S=512, d=128): four ranks over a
    two-slot ring of 32-position stages in bf16 (16-position in f32; 36 KB,
    six CTAs an SM, 448 CTAs in one wave), eight ranks of one 64-position
    stage in int8: the fastest of every (nsplit, rows, stages) timed on the
    card. The long-sequence model's cache (b=2, h=8, S=4,352, d=64), S =
    65,536 and b=1: eight ranks, two slots."""
    P = tdec.DecodePlan
    assert tdec.decode_plan(8, 14, 512, 128, torch.bfloat16, 132) == P(4, 32, 2, 36048)
    assert tdec.decode_plan(8, 14, 512, 128, torch.float32, 132) == P(4, 16, 2, 35728)
    assert tdec.decode_plan(8, 14, 512, 128, torch.int8, 132) == P(8, 64, 1, 22880)
    assert tdec.decode_plan(1, 14, 512, 128, torch.bfloat16, 132) == P(8, 32, 2, 38128)
    assert tdec.decode_plan(2, 8, 4352, 64, torch.bfloat16, 132) == P(8, 64, 2, 36464)
    assert tdec.decode_plan(2, 8, 4352, 64, torch.int8, 132) == P(8, 64, 2, 21104)
    assert tdec.decode_plan(2, 8, 4352, 64, torch.float32, 132) == P(8, 32, 2, 35824)
    assert tdec.decode_plan(1, 1, 65536, 64, torch.bfloat16, 132) == P(8, 64, 2, 36464)
    # many rows: no split; a short cache: fewer ranks
    assert tdec.decode_plan(64, 14, 512, 128, torch.bfloat16, 132).nsplit == 1
    assert tdec.decode_plan(8, 14, 100, 128, torch.bfloat16, 132).nsplit == 2
    # K7 at the JAX package's bench shapes: ranks of whole 256-blocks
    assert tdec.decode_plan(16, 14, 2560, 128, torch.bfloat16, 132, blk=256) == P(2, 32, 2, 37440)
    assert tdec.decode_plan(64, 8, 1280, 64, torch.bfloat16, 132, blk=256) == P(1, 64, 2, 36144)


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_plan_reads_the_shapes_only_and_fits_shared_memory(dt):
    """The plan has no length argument: one grid and one shared-memory size
    serve every length of a cache. Every plan fits a block's 227 KB, at most
    eight ranks, stages of at most 64 positions, and its shared memory
    never grows past the two-slot ring's, whatever S."""
    for b, h in ((1, 1), (1, 14), (8, 14), (2, 8), (64, 14)):
        for S in (17, 512, 4352, 65536):
            for d in (16, 64, 128, 256):
                for blk in (None, 128, 256):
                    plan = tdec.decode_plan(b, h, S, d, DTYPES[dt], 132, blk=blk)
                    assert 1 <= plan.nsplit <= 8 and 1 <= plan.stages <= 2
                    assert 16 <= plan.rows <= tdec.STAGE and plan.smem <= 227 * 1024
                    assert plan.smem == tdec.decode_smem_bytes(
                        DTYPES[dt], d, plan.rows, plan.stages, blk, plan.nsplit)
                    assert plan.smem <= tdec.decode_smem_bytes(DTYPES[dt], d, plan.rows, 2, blk,
                                                               tdec.MAX_SPLIT)
