"""The serve engine's telemetry ≡ the JAX engine's (CPU, the tiny config of
``tests/test_torch_serve.py``).

Both engines run with tracing and the flight recorder on, the port's fed
the JAX engine's draws through ``noise_fn``. With ``decode_health`` the
port's tokens equal its own with the taps off and the JAX engine's; each
request's ``entropy`` and ``topk_mass`` span args (both rounded to 4
decimals) lie within one unit of the 4th decimal (1e-4) of the JAX
engine's, and ``repeat_ratio`` is equal. On the dense, paged, shared-prefix
and chunked paths the two runs record the same span names (with the same
args and prefill modes, span for span), metric names and event kinds, and
the same counters. ``chunk_widths`` equals the JAX engine's over a grid of
(paged, ``kv_block_tokens``, ``prefill_chunk``, prefix length), and every
width a run dispatches lies in it. The state provider's fields, a
``progress`` that never falls, and a ``slow`` chaos fault at a step.
"""

import collections
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalle_tpu import obs as jobs
from dalle_tpu.config import DalleConfig as JDalleConfig
from dalle_tpu.models.dalle import DALLE as JDALLE
from dalle_tpu.serve import DecodeEngine as JDecodeEngine
from dalle_tpu.serve import queue as jqueue
from dalle_tpu_torch import DalleConfig, chaos, dalle_state_dict
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.serve import DecodeEngine
from dalle_tpu_torch.serve import queue as tqueue

CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2,
           dim_head=16, image_size=16, image_vocab_size=24, image_fmap_size=4)
TEXTS = [np.array([3, 4, 5, 0, 0, 0], np.int32),
         np.array([7, 8, 0, 0, 0, 0], np.int32),
         np.array([9, 1, 2, 3, 0, 0], np.int32),
         np.array([5, 5, 0, 0, 0, 0], np.int32),
         np.array([1, 2, 3, 4, 5, 6], np.int32)]
N_STEPS = CFG["image_fmap_size"] ** 2
VOCAB = CFG["image_vocab_size"]


@functools.lru_cache(maxsize=None)
def _jax_draws(seed: int) -> np.ndarray:
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


PATHS = {
    # a CFG pair (its null row's logits merged into what both rows sample)
    # and a ragged row
    "dense": (dict(slots=3), [_sub(0, 30, cond_scale=2.0), _sub(1, 31),
                              _sub(2, 32, max_tokens=7), _sub(3, 33), _sub(4, 34)]),
    "paged": (dict(slots=3, kv_block_tokens=4, kv_pool_blocks=21),
              [_sub(0, 100), dict(_sub(1, 777), text=TEXTS[0]), _sub(2, 102),
               dict(_sub(3, 103), text=np.array([3, 4, 5, 9, 9, 0], np.int32)),
               _sub(4, 104, cond_scale=2.0)]),
    "shared": (dict(slots=3), [_sub(0, 10, group_id=7), _sub(1, 11),
                               dict(_sub(2, 12, group_id=7), text=TEXTS[0]),
                               dict(_sub(3, 13, group_id=7), text=TEXTS[0])]),
    "chunked": (dict(slots=3, prefill_chunk=3), [_sub(i, 50 + i, max_tokens=12 if i == 1 else None)
                                                 for i in range(5)]),
}


def _fill(mod, subs):
    q = mod.RequestQueue()
    for s in subs:
        q.submit(trace_id=f"trace-{s['request_id']}", **s)
    q.close()
    return q


def _traced_run(o, make, subs, queue_mod, tmp_path, on_rows=None):
    """(completions by id, span tuples, metrics, events) of one traced run."""
    o.disable()
    o.disable_recorder()
    o.configure()
    o.configure_recorder(str(tmp_path))
    try:
        eng = make()
        done = eng.run(_fill(queue_mod, subs), on_rows=on_rows)
        return (eng, {c.request_id: c.tokens for c in done}, o.get_tracer().snapshot_spans(),
                o.metrics_snapshot(), o.get_recorder().snapshot_events())
    finally:
        o.disable()
        o.disable_recorder()


def _random_params(model, seed=0):
    """numpy weights on the flax tree's shapes (no flax init to compile):
    kernels N(0, 1/fan-in), embeddings N(0, 0.5²), norm scales near 1, the
    rest N(0, 0.1²)."""
    args = (jnp.zeros((1, CFG["text_seq_len"]), jnp.int32), jnp.zeros((1, N_STEPS), jnp.int32))
    keys = {"params": jax.random.PRNGKey(0), "cfg": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: model.init(keys, *args, return_loss=True))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        if name == "embedding":
            return x * np.float32(0.5)
        if name == "scale":
            return 1 + np.float32(0.1) * x
        return x * np.float32(0.1)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    jm = JDALLE(JDalleConfig(**CFG))
    jp = _random_params(jm)
    tm = DALLE(DalleConfig(**CFG))
    tm.load_state_dict(dalle_state_dict(jp))
    return jm, jp, tm.eval()


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    jm, jp, _ = models
    out = {}
    for path, (kw, subs) in PATHS.items():
        out[path] = _traced_run(
            jobs, lambda: JDecodeEngine(jm, jp, decode_health=True, **kw), subs, jqueue,
            tmp_path_factory.mktemp(f"j{path}"))
    return out


def _port_run(models, path, tmp_path, **extra):
    _, _, tm = models
    kw, subs = PATHS[path]
    kw = {**kw, **extra}
    return _traced_run(tobs, lambda: DecodeEngine(tm, noise_fn=jax_noise, device="cpu",
                                                  decode_health=True, **kw),
                       subs, tqueue,
                       tmp_path)


def _request_args(spans):
    return {a["request_id"]: a for name, *_, a in spans if name == "serve/request"}


def _names(spans):
    """Span names with their arg keys and prefill modes, counted."""
    return collections.Counter(
        (name, tuple(sorted(a or {})), (a or {}).get("mode")) for name, *_, a in spans)


def _metric_names(metrics):
    return {k.split("{")[0] for k in metrics}


def test_decode_health_keeps_tokens_and_matches_jax(models, jax_runs, tmp_path):
    _, _, tm = models
    kw, subs = PATHS["dense"]
    _, ref, jspans, jmetrics, jevents = jax_runs["dense"]
    _, got, tspans, tmetrics, tevents = _port_run(models, "dense", tmp_path)
    off = {c.request_id: c.tokens for c in DecodeEngine(
        tm, noise_fn=jax_noise, device="cpu", **kw).run(_fill(
            tqueue, subs))}
    # several steps a host read: the stats ride the same read
    _, multi, mspans, *_ = _port_run(models, "dense", tmp_path / "m", steps_per_sync=2)
    assert sorted(got) == sorted(ref) == sorted(off) == sorted(multi) == list(range(5))
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
        np.testing.assert_array_equal(off[rid], ref[rid])
        np.testing.assert_array_equal(multi[rid], ref[rid])
    jargs, targs, margs = _request_args(jspans), _request_args(tspans), _request_args(mspans)
    for rid, want in jargs.items():
        for key in ("entropy", "topk_mass"):
            assert abs(targs[rid][key] - want[key]) <= 1.01e-4, (rid, key)
            assert margs[rid][key] == targs[rid][key]
        assert targs[rid]["repeat_ratio"] == want["repeat_ratio"]
        assert targs[rid]["tokens"] == want["tokens"] == len(ref[rid])
    jq = [e for e in jevents if e["kind"] == "decode_quality"]
    tq = [e for e in tevents if e["kind"] == "decode_quality"]
    assert [e["request_id"] for e in tq] == [e["request_id"] for e in jq]
    for key in ("health.decode_entropy", "health.decode_topk_mass",
                "health.decode_repeat_ratio"):
        assert abs(tmetrics[key] - jmetrics[key]) < 1e-4, key


@pytest.mark.parametrize("path", sorted(PATHS))
def test_telemetry_names_match_the_jax_engine(models, jax_runs, tmp_path, path):
    _, ref, jspans, jmetrics, jevents = jax_runs[path]
    eng, got, tspans, tmetrics, tevents = _port_run(models, path, tmp_path)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert _names(tspans) == _names(jspans)
    assert _metric_names(tmetrics) == _metric_names(jmetrics)
    assert set(tmetrics) == set(jmetrics)
    assert collections.Counter(e["kind"] for e in tevents) == collections.Counter(
        e["kind"] for e in jevents)
    for key in ("serve.tokens_emitted_total", "serve.requests_completed_total",
                "kv.prefix_hit_tokens_total", "kv.pages_free", "kv.pages_used",
                "kv.pages_shared", "kv.pages_cow_copies", "serve.ttft_seconds_count",
                "serve.decode_row_seconds_count", "serve.prefill_chunk_seconds_count"):
        assert tmetrics.get(key) == jmetrics.get(key), key
    trace_ids = {a.get("trace_id") for name, *_, a in tspans if name == "serve/request"}
    assert trace_ids == {f"trace-{rid}" for rid in ref}
    if path == "paged":
        # the kv gauges are the engine's own ledger at its last admission
        assert tmetrics["kv.pages_cow_copies"] == eng.kv_stats()["cow_copies"]
        assert {m for _, _, m in _names(tspans) if m} >= {"paged", "paged-hit"}
    if path == "shared":
        assert any(name == "pipeline/prefill_shared" for name, *_ in tspans)


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_widths_match_jax_over_a_grid(paged):
    grid = itertools.product((1, 2, 3, 4, 5, 7, 8, 16, 64), (0, 1, 3, 4, 6, 7, 64),
                             (1, 4, 7, 8, 9, 257, 300))
    for bt, chunk, prefix in grid:
        ns = types.SimpleNamespace(paged=paged, kv_block_tokens=bt if paged else 0,
                                   prefill_chunk=0 if paged else chunk, prefix_len=prefix)
        assert DecodeEngine.chunk_widths(ns) == JDecodeEngine.chunk_widths(ns), (bt, chunk,
                                                                                prefix)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=3), dict(prefill_chunk=2),
                                dict(kv_block_tokens=4, kv_pool_blocks=21),
                                dict(kv_block_tokens=3, kv_pool_blocks=24), dict()],
                         ids=["chunk3", "chunk2", "paged4", "paged3", "dense"])
def test_dispatched_widths_lie_in_chunk_widths(models, kw, monkeypatch):
    _, _, tm = models
    eng = DecodeEngine(tm, slots=3, noise_fn=jax_noise, device="cpu", **kw)
    widths = []
    real = eng._refill_chunk
    monkeypatch.setattr(eng, "_refill_chunk", lambda ids, *a: widths.append(ids.shape[1])
                        or real(ids, *a))
    _, subs = PATHS["paged"]
    eng.run(_fill(tqueue, subs))
    allowed = eng.chunk_widths()
    assert set(widths) <= set(allowed)
    assert bool(widths) == bool(allowed)


def test_state_provider_progress_and_a_slow_fault(models, tmp_path):
    _, _, tm = models
    tobs.disable()
    tobs.configure()
    tobs.configure_recorder(str(tmp_path))
    chaos.install(chaos.FaultPlan([chaos.Fault(kind="slow", step=3, duration_s=0.01)]))
    eng = DecodeEngine(tm, slots=2, noise_fn=jax_noise, device="cpu", prefill_chunk=3)
    states, progress = [], []

    def on_rows(req, row, toks):
        progress.append(eng.stats.progress)
        states.append(tobs.collect_state())

    try:
        eng.run(_fill(tqueue,
                      PATHS["dense"][1][1:4]), on_rows=on_rows)
        events = tobs.get_recorder().snapshot_events()
        after = tobs.collect_state()
    finally:
        chaos.uninstall()
        tobs.disable()
        tobs.disable_recorder()
    assert progress == sorted(progress) and progress[-1] > progress[0]
    st = eng.stats
    assert st.progress == st.steps + st.refills + st.prefill_chunks
    snap = next(v for s in states for k, v in s.items() if k.startswith("serve.engine["))
    assert set(snap) == {"queue_depth", "slot_occupancy", "steps", "inflight"}
    assert snap["inflight"] and set(snap["inflight"][0]) == {
        "slot", "request_id", "trace_id", "tokens_done"}
    assert not any(k.startswith("serve.engine[") for k in after)       # unregistered
    fault = [e for e in events if e["kind"] == "chaos_fault"]
    assert [(e["fault_kind"], e["at_step"]) for e in fault] == [("slow", 3)]


def test_kv_gauges_equal_kv_stats_at_each_admission(models):
    _, _, tm = models
    kw, subs = PATHS["paged"]
    eng = DecodeEngine(tm, noise_fn=jax_noise, device="cpu", **kw)
    ledgers, real = [], eng._admit_paged

    def admit(placed):
        real(placed)
        m, kv = tobs.metrics_snapshot(), eng.kv_stats()
        ledgers.append(([m[f"kv.pages_{k}"] for k in ("free", "used", "shared", "cow_copies")],
                        [float(kv[k]) for k in ("pages_free", "pages_used", "pages_shared",
                                                "cow_copies")]))
    eng._admit_paged = admit
    tobs.disable()
    tobs.configure()
    try:
        eng.run(_fill(tqueue, subs))
    finally:
        tobs.disable()
    assert len(ledgers) >= 2 and all(g == k for g, k in ledgers)
