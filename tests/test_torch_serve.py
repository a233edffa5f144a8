"""The port's continuous-batching engine ≡ the JAX package's (CPU, the tiny
config of ``tests/test_serve.py``).

JAX's threefry and torch's Philox give different draws from one seed, so
the engine takes a draw source, ``noise_fn(seed, t)``: fed the JAX engine's
own per-row draws (the split chain per token, ``fold_in(key, n_steps)`` for
a full-length row's last), the port's engine gives the JAX engine's tokens
in f32 for bulk and trickle admission, a reversed order, ragged lengths, a
CFG pair, a shared-prefix cohort, chunked prefill, several steps per sync,
and the paged cache with radix hits, COW forks and eviction. With its own
per-slot generators it gives the port's sequential
``generate_images_tokens`` tokens. bf16 and int8 caches: the serve logits
lie within a bf16 bound of the JAX package's, and the paged engine equals
the dense one. The host pieces copied from the JAX package replay a random
sequence of operations in step with the originals.
"""

import copy
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.models.dalle import init_dalle as jinit_dalle
from dalle_tpu.serve import DecodeEngine as JDecodeEngine
from dalle_tpu.serve import paged as jpaged
from dalle_tpu.serve import queue as jqueue
from dalle_tpu.serve import scheduler as jsched
from dalle_tpu.train.train_state import cast_floating
from dalle_tpu_torch import DalleConfig, DalleWithVae, dalle_state_dict
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.serve import DecodeEngine, RequestQueue
from dalle_tpu_torch.serve import paged as tpaged
from dalle_tpu_torch.serve import queue as tqueue
from dalle_tpu_torch.serve import scheduler as tsched

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
TEXTS = [np.array([3, 4, 5, 0, 0, 0], np.int32),
         np.array([7, 8, 0, 0, 0, 0], np.int32),
         np.array([9, 1, 2, 3, 0, 0], np.int32),
         np.array([5, 5, 0, 0, 0, 0], np.int32),
         np.array([1, 2, 3, 4, 5, 6], np.int32)]
N_STEPS = CFG["image_fmap_size"] ** 2
VOCAB = CFG["image_vocab_size"]


@pytest.fixture(scope="module")
def models():
    jm, jp = jinit_dalle(JDalleConfig(**CFG), jax.random.PRNGKey(0), batch=2)
    tm = DALLE(DalleConfig(**CFG))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


@functools.lru_cache(maxsize=None)
def _jax_draws(seed: int) -> np.ndarray:
    """(N_STEPS, VOCAB): the JAX engine's draw for each token of a row with
    this seed."""
    key = k = jax.random.PRNGKey(seed)
    rows = []
    for _ in range(N_STEPS - 1):
        k, sub = jax.random.split(k)
        rows.append(jax.random.gumbel(sub, (VOCAB,), jnp.float32))
    rows.append(jax.random.gumbel(jax.random.fold_in(key, N_STEPS), (VOCAB,), jnp.float32))
    return np.array(jnp.stack(rows))


def jax_noise(seed, t):
    return _jax_draws(seed)[t]


def _sub(i, seed, **kw):
    return dict(text=TEXTS[i % len(TEXTS)], seed=seed, request_id=i, **kw)


def _fill(q, subs, close=True):
    for s in subs:
        q.submit(**s)
    if close:
        q.close()
    return q


def _by_id(done):
    return {c.request_id: c.tokens for c in done}


# (engine kwargs, submissions); the same queue contents go to both engines
CASES = {
    "bulk": (dict(slots=2), [_sub(i, 100 + i) for i in range(5)]),
    "reversed": (dict(slots=2), [dict(_sub(i, 104 - i), text=TEXTS[4 - i])
                                 for i in range(5)]),
    "ragged_trickle": (dict(slots=3), [_sub(i, 80 + i, max_tokens=n)
                                       for i, n in enumerate([16, 3, 9, 1, 12])]),
    "cfg": (dict(slots=4), [_sub(0, 30, cond_scale=2.0), _sub(1, 31, cond_scale=2.0),
                            _sub(2, 99)]),
    "cohort": (dict(slots=4), [_sub(0, 10, group_id=7), _sub(1, 11),
                               dict(_sub(2, 12, group_id=7), text=TEXTS[0]),
                               dict(_sub(3, 13, group_id=7), text=TEXTS[0])]),
    "prefill_chunk": (dict(slots=2, prefill_chunk=3), [_sub(i, 50 + i) for i in range(4)]),
    "steps_per_sync": (dict(slots=3, steps_per_sync=2),
                       [_sub(i, 60 + i, max_tokens=n) for i, n in enumerate([16, 5, 9, 2])]),
    "paged": (dict(slots=2, kv_block_tokens=4, kv_pool_blocks=14),
              [_sub(0, 100), dict(_sub(1, 777), text=TEXTS[0]), _sub(2, 102),
               _sub(3, 103), _sub(4, 104), dict(_sub(5, 778), text=TEXTS[4]),
               _sub(6, 106, cond_scale=2.0)]),
}

RADIX_STATS = ("radix_full_hits", "radix_partial_hits", "radix_misses",
               "prefix_hit_tokens", "cow_forks", "pages_evicted")


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_tokens_equal_the_jax_engine(models, case):
    jm, jp, tm = models
    kw, subs = CASES[case]
    jeng = JDecodeEngine(jm, jp, **kw)
    ref = _by_id(jeng.run(_fill(jqueue.RequestQueue(), subs)))
    eng = DecodeEngine(tm, noise_fn=jax_noise, device="cpu", **kw)
    got = _by_id(eng.run(_fill(RequestQueue(), subs)))
    assert sorted(got) == sorted(ref) == sorted(s["request_id"] for s in subs)
    for rid, toks in ref.items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=f"request {rid}")
    for name in ("steps", "refills", "shared_refills", "prefill_chunks") + RADIX_STATS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    if case == "paged":
        s = eng.stats
        assert s.radix_full_hits >= 1 and s.cow_forks >= 1 and s.pages_evicted > 0
        assert eng.kv_stats() == jeng.kv_stats()
    if case == "cohort":
        assert eng.stats.shared_refills == 1
    if case == "prefill_chunk":
        assert eng.stats.prefill_chunks > 0


def test_engine_streaming_submissions_equal_the_jax_engine(models):
    """A producer thread submits while the engine runs: late requests slot
    into freed rows; every request's tokens are its tokens from the bulk
    JAX run."""
    jm, jp, tm = models
    subs = [_sub(i, 100 + i) for i in range(5)]
    ref = _by_id(JDecodeEngine(jm, jp, slots=2).run(_fill(jqueue.RequestQueue(), subs)))
    q = RequestQueue()
    q.submit(**subs[0])

    def producer():
        for s in subs[1:]:
            time.sleep(0.01)
            q.submit(**s)
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    got = _by_id(DecodeEngine(tm, slots=2, noise_fn=jax_noise, device="cpu").run(q))
    t.join()
    assert sorted(got) == list(range(5))
    for rid, toks in ref.items():
        np.testing.assert_array_equal(got[rid], toks)


@pytest.mark.parametrize("kw", [dict(), dict(kv_block_tokens=4), dict(prefill_chunk=4)],
                         ids=["dense", "paged", "chunked"])
def test_engine_tokens_equal_the_sequential_port(models, kw):
    """Real per-slot generators: each request's tokens equal the port's own
    ``generate_images_tokens(text[None], generator=Generator.manual_seed(seed))``
    (first n of them for a ragged request; CFG through the null-text cache)."""
    _, _, tm = models
    subs = [_sub(0, 5), _sub(1, 6, max_tokens=7), _sub(2, 7, cond_scale=3.0),
            _sub(3, 8), _sub(4, 9, max_tokens=11)]
    got = _by_id(DecodeEngine(tm, slots=3, device="cpu", **kw).run(_fill(RequestQueue(), subs)))
    for s in subs:
        ref = tm.generate_images_tokens(
            torch.from_numpy(s["text"][None]), cond_scale=s.get("cond_scale", 1.0),
            generator=torch.Generator().manual_seed(s["seed"]))[0].numpy()
        n = s.get("max_tokens") or N_STEPS
        np.testing.assert_array_equal(got[s["request_id"]], ref[:n])


# ---------------------------------------------------------------------------
# bf16 and int8 caches
# ---------------------------------------------------------------------------

def _bf16_pair(models):
    jm, jp, tm = models
    return jm, cast_floating(jp, jnp.bfloat16), copy.deepcopy(tm).to(torch.bfloat16)


@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_serve_logits_within_bf16_of_jax(models, dt):
    """``serve_refill`` (rows 0 and 2 admitted, row 1 parked), then four
    teacher-forced ``serve_decode`` steps at ragged offsets: the image-band
    logits stay within 5e-2 of the largest |logit| of the JAX package's. Both
    run bf16 weights; they round at different points (the port's kernel
    keeps scores and sums in f32 where the JAX dense path rounds its bf16
    einsums), 2^-8 per rounding over two layers and the head."""
    jm, jpb, tmb = _bf16_pair(models)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}[dt]
    B = 3
    texts = np.stack([TEXTS[0], TEXTS[1], TEXTS[2]])
    mask = np.array([True, False, True])
    jcache = jm.apply(jpb, B, jdt, method=JDALLE.serve_init_cache)
    tcache = tmb.serve_init_cache(B, tdt)
    nt = tmb.num_text_tokens

    def close(j, t):
        j = np.asarray(jnp.asarray(j, jnp.float32))[:, nt:]
        t = t.float().numpy()[:, nt:]
        scale = np.abs(j).max()
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-2 * scale)

    jl, jcache = jm.apply(jpb, jnp.asarray(texts), jcache, jnp.asarray(mask),
                          method=JDALLE.serve_refill)
    with torch.no_grad():
        tl, tcache = tmb.serve_refill(texts, tcache, mask)
    close(np.asarray(jnp.asarray(jl, jnp.float32))[mask], tl[torch.from_numpy(mask)])
    S, plen = tmb.cfg.total_seq_len, tmb.cfg.text_seq_len + 1
    toks = np.random.RandomState(0).randint(0, VOCAB, (4, B)).astype(np.int32)
    for i in range(4):
        j = np.array([i, 0, i], np.int32)
        offsets = np.where(mask, plen + j, S).astype(np.int32)
        jl, jcache = jm.apply(jpb, jnp.asarray(toks[i]), jnp.asarray(j),
                              jnp.asarray(offsets), jcache, method=JDALLE.serve_decode)
        with torch.no_grad():
            tl, tcache = tmb.serve_decode(torch.from_numpy(toks[i]).long(), j, offsets,
                                          tcache)
        close(np.asarray(jnp.asarray(jl, jnp.float32))[mask], tl[torch.from_numpy(mask)])


@pytest.mark.parametrize("precision", ["bfloat16", "bf16_int8kv"])
def test_paged_engine_equals_dense_engine(models, precision):
    """Through the wrapper: the paged engine (a small pool that evicts,
    repeated prompts that hit the radix cache) gives the dense engine's
    tokens, per request."""
    _, _, tm = models
    wrapper = DalleWithVae(tm, None)
    subs = [_sub(i, 20 + i) for i in range(5)] + [
        dict(_sub(5, 40), text=TEXTS[1]), dict(_sub(6, 41), text=TEXTS[3]),
        _sub(7, 42, cond_scale=2.0)]
    dense = wrapper.serve_engine(slots=2, precision=precision)
    paged = wrapper.serve_engine(slots=2, precision=precision, kv_block_tokens=4,
                                 kv_pool_blocks=14)
    assert dense.cache_dtype == paged.cache_dtype == (
        torch.int8 if precision == "bf16_int8kv" else torch.bfloat16)
    a = _by_id(dense.run(_fill(RequestQueue(), subs)))
    b = _by_id(paged.run(_fill(RequestQueue(), subs)))
    assert sorted(a) == sorted(b) == list(range(8))
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    assert paged.stats.radix_full_hits + paged.stats.radix_partial_hits >= 1


# ---------------------------------------------------------------------------
# the host pieces copied from the JAX package
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return pool._free, pool._ref, pool.cow_copies


def _radix_state(rx):
    return (rx.resident_nodes, rx.lookups, rx.full_hits, rx.partial_hits,
            rx.hit_tokens_total, rx.evictions, rx.evictable_count())


@pytest.mark.parametrize("seed", [0, 1])
def test_block_pool_and_radix_replay_in_step_with_jax(seed):
    rng = np.random.RandomState(seed)
    bt = 3
    pools = (jpaged.BlockPool(24), tpaged.BlockPool(24))
    rxs = (jpaged.RadixCache(bt, pools[0]), tpaged.RadixCache(bt, pools[1]))
    held = []
    for _ in range(300):
        op = rng.randint(4)
        key = tuple(int(x) for x in rng.randint(0, 2, rng.randint(1, 10)))
        if op == 0:
            ms = [rx.match(key) for rx in rxs]
            assert (ms[0].blocks, ms[0].tail_block, ms[0].hit_tokens) == (
                ms[1].blocks, ms[1].tail_block, ms[1].hit_tokens)
        elif op == 1:
            n_full, tail = len(key) // bt, len(key) % bt > 0
            if pools[0].free_count >= n_full + tail:
                blocks = [[p.alloc() for _ in range(n_full + tail)] for p in pools]
                assert blocks[0] == blocks[1]
                for rx, bl in zip(rxs, blocks):
                    rx.insert(key, bl[:n_full], bl[n_full] if tail else None)
                held.extend(blocks[0])
        elif op == 2 and held:
            bid = held.pop(rng.randint(len(held)))
            for p in pools:
                p.release(bid)
        else:
            n = rng.randint(1, 4)
            assert rxs[0].evict(n) == rxs[1].evict(n)
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        assert _radix_state(rxs[0]) == _radix_state(rxs[1])


def test_scheduler_and_queues_replay_in_step_with_jax():
    rng = np.random.RandomState(2)
    mods = ((jqueue, jsched), (tqueue, tsched))
    scheds = [s.SlotScheduler(4) for _, s in mods]
    queues = [q.RequestQueue(maxsize=5) for q, _ in mods]
    policy = [s.PolicyQueue(policy=s.PriorityDeadlinePolicy()) for _, s in mods]
    for i in range(200):
        op = rng.randint(4)
        if op == 0:
            kw = dict(text=np.zeros(6, np.int32), seed=i, max_tokens=int(rng.randint(1, 9)),
                      priority=int(rng.randint(3)))
            outs = []
            for q in queues:
                try:
                    outs.append(q.submit(**kw).request_id)
                except Exception as e:          # noqa: BLE001 - compared below
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
            for q in policy:
                q.submit(**kw)
        elif op == 1:
            n = int(rng.randint(1, 4))
            taken = [[r.request_id for r in q.take(n)] for q in queues]
            assert taken[0] == taken[1]
            taken = [[r.request_id for r in q.take(n)] for q in policy]
            assert taken[0] == taken[1]
        elif op == 2:
            k = min(int(rng.randint(1, 3)), len(scheds[0].free_slots()))
            reqs = [[q.Request(request_id=i * 10 + j, text=np.zeros(4, np.int32), seed=j)
                     for j in range(k)] for q, _ in mods]
            pairs = [s.admit(r) for s, r in zip(scheds, reqs)]
            assert [p[0] for p in pairs[0]] == [p[0] for p in pairs[1]]
        elif scheds[0].active_slots():
            slot = int(rng.choice(scheds[0].active_slots()))
            assert scheds[0].complete(slot).request_id == scheds[1].complete(slot).request_id
        for a, b in ((scheds[0], scheds[1]),):
            assert (a.free_slots(), a.active_slots(), a.admission_order, a.occupancy) == (
                b.free_slots(), b.active_slots(), b.admission_order, b.occupancy)
        assert queues[0].qsize() == queues[1].qsize()


# ---------------------------------------------------------------------------
# what stays out, and where the engine runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(decode_health=True), dict(topk_approx=True)])
def test_unported_engine_options_raise(models, kw):
    _, _, tm = models
    with pytest.raises(NotImplementedError):
        DecodeEngine(tm, slots=2, device="cpu", **kw)


def test_wrapper_serve_engine_defaults_and_int8w(models):
    _, _, tm = models
    wrapper = DalleWithVae(tm, None)
    eng = wrapper.serve_engine(slots=2)
    assert eng.cache_dtype == torch.int8
    assert not hasattr(eng, "install_executables")
    # the default is int8w, as in the JAX package: int8 weights, bf16 compute
    assert eng.model.transformer.attn_0.to_qkv.weight.dtype == torch.int8
    assert eng.model.compute_dtype == torch.bfloat16
    assert wrapper.serve_engine(slots=2, precision="int8w").model is eng.model
    kv = wrapper.serve_engine(slots=2, precision="bf16_int8kv")
    assert next(kv.model.parameters()).dtype == torch.bfloat16 and kv.cache_dtype == torch.int8
    assert kv.model is not eng.model


def test_engine_runs_on_the_card_unless_told(models, monkeypatch):
    _, _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tm, slots=2)
    eng = DecodeEngine(tm, slots=2, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError, match="full attention"):
        DecodeEngine(DALLE(DalleConfig(**CFG, attn_types=("full", "axial_row"))),
                     slots=2, device="cpu")
