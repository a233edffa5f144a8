"""The port's serving gateway ≡ the JAX package's (CPU, tiny sizes).

Admission (``TokenBucket``, ``TenantQuotas``, ``SloEstimator``,
``AdmissionController.decide``) gives the JAX decisions and ``gateway.*``
counters on scripted inputs with an injected clock; ``sse_event`` the same
bytes and ``iter_sse`` the same parse; the two gateways over a fake engine
answer the same HTTP surface alike (status codes, JSON fields, SSE events,
health rows). ``RowPixelDecoder`` decodes through the port's dVAE within
1e-5 of the JAX one on converted weights (one small JAX compile). Over the
port's own engine (f32, where its tokens equal the port's sequential
``generate_images_tokens`` bit for bit; ``tests/test_torch_serve.py``
holds that engine to the JAX engine): rows stream as committed, a
mid-stream failover and a whole-group failover are bitwise the unfailed
run, the group capacity precheck is atomic, a deadline shed ends its
stream, a worker death fails its streams, the loopback HTTP stream with a
quota and health, /v1/images validation before admission, and
``python -m dalle_tpu_torch.cli.serve_gateway --untrained --device cpu``
serving /v1/generate and /v1/images in a subprocess.
"""

import base64
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu import obs as jobs
from dalle_tpu import gateway as jgw
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.models.wrapper import DiscreteVAEAdapter as JAdapter
from dalle_tpu.serve import queue as jqueue
from dalle_tpu_torch import (DalleConfig, DiscreteVAE, DiscreteVAEAdapter, DVAEConfig,
                             dvae_state_dict, init_dalle)
from dalle_tpu_torch import gateway as tgw
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.serve import (DecodeEngine, PriorityDeadlinePolicy, QueueFull,
                                   RequestQueue)
from dalle_tpu_torch.serve import queue as tqueue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_text_tokens=32, text_seq_len=6, dim=32, depth=2, heads=2, dim_head=16,
           image_size=16, image_vocab_size=24, image_fmap_size=4)
TEXTS = [np.array([3, 4, 5, 0, 0, 0], np.int32), np.array([7, 8, 0, 0, 0, 0], np.int32),
         np.array([9, 1, 2, 3, 0, 0], np.int32)]
FMAP = CFG["image_fmap_size"]
DECODER_TOL = 1e-5


@pytest.fixture
def tracers():
    jobs.disable()
    tobs.disable()
    jobs.configure()
    tobs.configure()
    yield
    jobs.disable()
    tobs.disable()


def _gateway_only(snap):
    return {k: v for k, v in snap.items() if k.startswith(("gateway.", "usage.", "slo."))}


# ---------------------------------------------------------------------------
# admission control (host only)
# ---------------------------------------------------------------------------

BUCKET_CASES = {
    "burst_then_refill": ((2.0, 3.0), [(1, 0.0)] * 4 + [(1, 0.5), (1, 0.5), (1, 100.0)]),
    "fractional": ((0.5, 1.0), [(0.5, 0.0), (0.5, 0.0), (0.5, 0.0), (0.25, 0.6), (1, 3.0)]),
    "clock_back": ((4.0, 2.0), [(1, 10.0), (1, 10.0), (1, 5.0), (1, 10.1), (1, 10.3)]),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_token_bucket_matches_jax(case):
    (rate, burst), calls = BUCKET_CASES[case]
    jb, tb = jgw.TokenBucket(rate, burst), tgw.TokenBucket(rate, burst)
    t0 = 1000.0
    for n, dt in calls:
        assert tb.try_acquire(n, now=t0 + dt) == jb.try_acquire(n, now=t0 + dt)
        assert tb.level == jb.level


def test_tenant_quotas_match_jax():
    over = {"gold": (100.0, 50.0), "capped": (0.001, 1.0)}
    jq, tq = jgw.TenantQuotas(0.01, 3.0, over), tgw.TenantQuotas(0.01, 3.0, over)
    for tenant in ["a", "a", "capped", "capped", "gold", "a", "a", "b", "capped"] * 2:
        assert tq.admit(tenant) == jq.admit(tenant)
    for tenant in ("a", "b", "gold", "capped"):
        assert (tq.bucket(tenant).rate, tq.bucket(tenant).burst) == (
            jq.bucket(tenant).rate, jq.bucket(tenant).burst)


def test_slo_estimator_matches_jax(tracers):
    je = jgw.SloEstimator(alpha=0.3, parallelism=4)
    te = tgw.SloEstimator(alpha=0.3, parallelism=4)
    assert te.predict_completion_s(100, 16) is None is je.predict_completion_s(100, 16)
    for tokens, seconds in [(16, 0.5), (0, 1.0), (16, 0.0), (256, 2.0), (8, 0.1)]:
        je.observe(tokens, seconds)
        te.observe(tokens, seconds)
        assert te.tokens_per_s == je.tokens_per_s
        assert te.predict_completion_s(512, 256) == je.predict_completion_s(512, 256)
    for p in (16, 0, 3):
        je.set_parallelism(p)
        te.set_parallelism(p)
        assert te.predict_completion_s(512, 256) == je.predict_completion_s(512, 256)
    assert _gateway_only(tobs.metrics_snapshot()) == _gateway_only(jobs.metrics_snapshot())


def _decide_script():
    """(tenant, request_tokens, queued_tokens, deadline_s) calls; slow
    default rates so the microseconds between two calls refill nothing."""
    calls = []
    for i in range(12):
        calls.append(("acme" if i % 3 else "capped", 16, 64 * i, None if i % 2 else 2.0))
    calls += [("free", 256, 4096, 0.5), ("free", 256, 0, 100.0), ("free", 16, 10 ** 6, 1.0)]
    return calls


@pytest.mark.parametrize("warm", [None, 50.0])
def test_admission_decide_matches_jax(tracers, warm):
    def make(mod):
        return mod.AdmissionController(
            mod.TenantQuotas(0.01, 4.0, {"capped": (0.001, 1.0)}),
            mod.SloEstimator(initial_tokens_per_s=warm, parallelism=2))
    jc, tc = make(jgw), make(tgw)
    for tenant, req, queued, deadline in _decide_script():
        got = tc.decide(tenant, request_tokens=req, queued_tokens=queued,
                        deadline_s=deadline)
        want = jc.decide(tenant, request_tokens=req, queued_tokens=queued,
                         deadline_s=deadline)
        assert (got.admit, got.reason, got.predicted_completion_s, got.retry_after_s) == (
            want.admit, want.reason, want.predicted_completion_s, want.retry_after_s)
    tc.reject("acme", "queue_full")
    jc.reject("acme", "queue_full")
    assert (tc.admitted_total, tc.rejected) == (jc.admitted_total, jc.rejected)
    assert _gateway_only(tobs.metrics_snapshot()) == _gateway_only(jobs.metrics_snapshot())


# ---------------------------------------------------------------------------
# SSE framing
# ---------------------------------------------------------------------------

SSE_PAYLOADS = [
    ("row", {"request_id": 1, "row": 0, "tokens": [5, 6, 7], "trace_id": "ab"}),
    ("done", {"request_id": 1, "tokens": [5, 6, 7], "ttft_s": 0.25, "latency_s": 1.5}),
    ("error", {"request_id": 2, "reason": "deadline_shed", "detail": "é \" \\ x"}),
    ("ranked", {"top_k": [{"candidate": 0, "score": -1.5e-7}], "order": [0], "x": None}),
]


@pytest.mark.parametrize("event,data", SSE_PAYLOADS, ids=[e for e, _ in SSE_PAYLOADS])
def test_sse_event_bytes_match_jax(event, data):
    assert tgw.sse_event(event, data) == jgw.sse_event(event, data)


def test_iter_sse_parses_like_jax():
    frames = b"".join(jgw.sse_event(e, d) for e, d in SSE_PAYLOADS)
    frames += b": keepalive\n\nevent: row\ndata: {\"a\": 1}\n"     # no trailing blank line
    got = list(tgw.iter_sse(io.BytesIO(frames)))
    assert got == list(jgw.iter_sse(io.BytesIO(frames)))
    assert got[-1] == ("row", {"a": 1}) and len(got) == len(SSE_PAYLOADS) + 1


# ---------------------------------------------------------------------------
# RowPixelDecoder: the port's dVAE against the JAX one
# ---------------------------------------------------------------------------

VAE = dict(image_size=16, num_tokens=24, codebook_dim=16, num_layers=2, hidden_dim=8)


class _Capture:
    """A vae that records each decode's f32 images."""

    def __init__(self, vae):
        self.inner, self.images = vae, []

    def decode(self, ids):
        out = self.inner.decode(ids)
        self.images.append(np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor)
                                      else out, np.float32))
        return out


def test_row_pixel_decoder_matches_jax():
    jv = JDiscreteVAE(JDVAEConfig(**VAE))
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: jv.init(keys, jnp.zeros((1, 16, 16, 3)),
                                            return_loss=True))
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32)
        * np.float32(0.5 / max(np.prod(s.shape[:-1]), 1) ** 0.5 + 0.05), shapes)
    tv = DiscreteVAE(DVAEConfig(**VAE))
    tv.load_state_dict(dvae_state_dict(params))
    jcap = _Capture(JAdapter(jv, params))
    tcap = _Capture(DiscreteVAEAdapter(tv.eval()))
    jdec, tdec = jgw.RowPixelDecoder(jcap, FMAP), tgw.RowPixelDecoder(tcap, FMAP)
    toks = np.random.RandomState(4).randint(0, VAE["num_tokens"], (FMAP, FMAP))
    for row in range(FMAP):
        want = jdec.row_event(7, row, toks[row].tolist())
        got = tdec.row_event(7, row, [int(t) for t in toks[row]])
        assert got["pixels_shape"] == want["pixels_shape"] == [16 // FMAP, 16, 3]
        a = np.frombuffer(base64.b64decode(got["pixels_b64"]), np.uint8)
        b = np.frombuffer(base64.b64decode(want["pixels_b64"]), np.uint8)
        # a pixel within 1e-5 of a quantization step may round either way
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_allclose(tcap.images[-1], jcap.images[-1], rtol=0,
                                   atol=DECODER_TOL)
    tdec.finish(7)
    assert 7 not in tdec._rows


# ---------------------------------------------------------------------------
# the two gateways over a fake engine: one HTTP contract
# ---------------------------------------------------------------------------

class FakeEngine:
    """Deterministic tokens, one row at a time, no device: the JAX or the
    port queue module supplies ``CompletedRequest``."""
    N_STEPS, ROW_LEN = 8, 4

    def __init__(self, queue_mod, slots=2):
        self.queue_mod, self.slots = queue_mod, slots
        self.n_steps, self.row_len = self.N_STEPS, self.ROW_LEN

    @staticmethod
    def tokens_for(seed, n=N_STEPS):
        return [(seed * 31 + i) % 97 for i in range(n)]

    def run(self, queue, on_complete=None, on_rows=None):
        while not queue.drained:
            reqs = queue.take(self.slots)
            if not reqs:
                queue.wait_nonempty(timeout=0.02)
                continue
            for req in reqs:
                admitted = time.perf_counter()
                n = min(req.max_tokens or self.n_steps, self.n_steps)
                toks = self.tokens_for(req.seed, n)
                for row in range(-(-n // self.row_len)):
                    on_rows(req, row, toks[row * self.row_len:(row + 1) * self.row_len])
                on_complete(self.queue_mod.CompletedRequest(
                    request_id=req.request_id, tokens=np.asarray(toks, np.int32),
                    seed=req.seed, submitted_at=req.submitted_at, admitted_at=admitted,
                    first_token_at=admitted, completed_at=time.perf_counter()))


def _http(gw, method, path, payload=None):
    host, port = gw.httpd.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request(method, path, None if payload is None else json.dumps(payload))
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), body


def _shape(status, headers, body):
    """What the contract fixes: the status, the content type, the JSON
    keys (or the SSE event names and their keys), the tokens."""
    ctype = headers.get("Content-Type")
    if ctype == "text/event-stream":
        events = list(jgw.iter_sse(io.BytesIO(body)))
        return status, ctype, [(e, sorted(d), d.get("tokens")) for e, d in events]
    doc = json.loads(body) if ctype == "application/json" else body.decode()
    if isinstance(doc, dict):
        keys = sorted(doc)
        doc = {k: doc[k] for k in ("error", "tokens", "candidates", "order", "status")
               if k in doc}
        return status, ctype, keys, doc, "Retry-After" in headers
    return status, ctype, sorted(ln.split(" ")[0] for ln in doc.splitlines()
                                 if ln.startswith("dalle_gateway"))


def _contract_run(gw_mod, queue_mod, obs_mod):
    obs_mod.disable()
    obs_mod.configure()
    rep = gw_mod.Replica(FakeEngine(queue_mod), replica_id="r0", maxsize=4).start()
    gw = gw_mod.Gateway(gw_mod.ReplicaRouter([rep]), gw_mod.AdmissionController(
        gw_mod.TenantQuotas(100.0, 100.0, overrides={"capped": (0.001, 1.0)}))).start()
    base = {"text": [3, 4, 5], "seed": 5}
    out = []
    try:
        for method, path, payload in [
                ("POST", "/v1/generate", base),
                ("POST", "/v1/generate", {**base, "stream": True}),
                ("POST", "/v1/generate", {**base, "max_tokens": 5, "stream": True}),
                ("POST", "/v1/generate", {**base, "tenant": "capped"}),
                ("POST", "/v1/generate", {**base, "tenant": "capped"}),
                ("POST", "/v1/generate", {"seed": 1}),
                ("POST", "/v1/generate", {**base, "seed": 2 ** 31}),
                ("POST", "/v1/generate", {**base, "cond_scale": "nan"}),
                ("POST", "/v1/images", {**base, "n_candidates": 2, "top_k": 1}),
                ("POST", "/v1/images", {**base, "n_candidates": 2, "stream": True}),
                ("POST", "/v1/images", {**base, "n_candidates": 3}),
                ("POST", "/v1/nope", base),
                ("GET", "/healthz", None),
                ("GET", "/nope", None)]:
            out.append(_shape(*_http(gw, method, path, payload)))
        time.sleep(0.2)                # a streamed handler's exit bookkeeping
        out.append(_shape(*_http(gw, "GET", "/metrics")))
        gw.shutdown(drain=True, timeout=30)
        rep2 = gw_mod.Replica(FakeEngine(queue_mod)).start()
        gw2 = gw_mod.Gateway(gw_mod.ReplicaRouter([rep2])).start()
        gw2.router.draining = True
        out.append(_shape(*_http(gw2, "POST", "/v1/generate", base)))
        out.append(_shape(*_http(gw2, "GET", "/healthz")))
        gw2.shutdown(drain=True, timeout=30)
        return out
    finally:
        obs_mod.disable()


def test_gateway_http_contract_matches_jax():
    want = _contract_run(jgw, jqueue, jobs)
    got = _contract_run(tgw, tqueue, tobs)
    assert [g[0] for g in got] == [200, 200, 200, 200, 429, 400, 400, 400, 200, 200, 400,
                                   404, 200, 404, 200, 503, 503]
    assert got == want


# ---------------------------------------------------------------------------
# replicas, router and gateway over the port's engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return init_dalle(DalleConfig(**CFG), seed=0, device="cpu")


@pytest.fixture(scope="module")
def ref(model):
    """The port's sequential generation under a request's seed: the bar."""
    cache = {}

    def get(text, seed):
        key = (tuple(text.tolist()), seed)
        if key not in cache:
            out = model.generate_images_tokens(
                torch.from_numpy(text[None]).long(),
                generator=torch.Generator().manual_seed(seed))
            cache[key] = out[0].tolist()
        return cache[key]
    return get


def _engine(model, **kw):
    return DecodeEngine(model, slots=kw.pop("slots", 2), device="cpu", **kw)


def test_engine_on_rows_streams_committed_rows(model, ref):
    q = RequestQueue()
    q.submit(TEXTS[0], seed=100, request_id=0)
    q.submit(TEXTS[1], seed=101, request_id=1, max_tokens=6)
    q.close()
    rows = {0: [], 1: []}
    done = _engine(model).run(q, on_rows=lambda req, row, toks:
                              rows[req.request_id].append((row, list(toks))))
    assert sorted(c.request_id for c in done) == [0, 1]
    assert [r for r, _ in rows[0]] == list(range(FMAP))
    assert [t for _, ts in rows[0] for t in ts] == ref(TEXTS[0], 100)
    assert [(r, len(t)) for r, t in rows[1]] == [(0, 4), (1, 2)]
    assert [t for _, ts in rows[1] for t in ts] == ref(TEXTS[1], 101)[:6]


def test_replica_failover_midstream_exact(model, ref):
    ra = tgw.Replica(_engine(model), replica_id="ga").start()
    rb = tgw.Replica(_engine(model), replica_id="gb").start()
    router = tgw.ReplicaRouter([ra, rb])
    ra.fail_after_rows(2)
    routed = router.submit(TEXTS[2], 102)
    assert routed.replica_id == "ga"
    rows, done = [], None
    for kind, payload in routed.events(timeout=60):
        if kind == "row":
            rows.append(payload)
            assert all(type(t) is int for t in payload["tokens"])
        elif kind == "done":
            done = payload
    assert [r["row"] for r in rows] == list(range(FMAP))
    assert [t for r in rows for t in r["tokens"]] == ref(TEXTS[2], 102)
    assert done["tokens"] == ref(TEXTS[2], 102)
    assert done["replica"] == "gb" and done["failovers"] == 1
    assert not ra.healthy and rb.healthy and isinstance(ra.failed, tgw.ReplicaFailure)
    router.drain(timeout=30)


def test_replica_group_stream_merged_and_exact(model, ref):
    rep = tgw.Replica(_engine(model), replica_id="grp").start()
    group = rep.submit_group(TEXTS[0], [200, 201])
    assert group.request_ids == [0, 1]
    rows, done = {0: [], 1: []}, {}
    for idx, kind, payload in group.events(timeout=60):
        if kind == "row":
            rows[idx].extend(payload[1])
        elif kind == "done":
            done[idx] = payload
    for i, seed in enumerate((200, 201)):
        assert rows[i] == ref(TEXTS[0], seed) == done[i].tokens.tolist()
    assert rep.engine.stats.shared_refills == 1
    rep.drain(timeout=30)


def test_replica_group_capacity_precheck_atomic(model):
    rep = tgw.Replica(_engine(model), replica_id="cap", maxsize=1).start()
    with pytest.raises(QueueFull):
        rep.submit_group(TEXTS[0], [1, 2])
    assert rep.queue.qsize() == 0 and rep._streams == {}
    rep.drain(timeout=30)


def test_group_failover_midstream_resubmits_whole_group(model, ref):
    ra = tgw.Replica(_engine(model), replica_id="ga2").start()
    rb = tgw.Replica(_engine(model), replica_id="gb2").start()
    router = tgw.ReplicaRouter([ra, rb])
    ra.fail_after_rows(3)
    routed = router.submit_images(TEXTS[1], [300, 301])
    rows, done = {0: [], 1: []}, None
    for kind, payload in routed.events(timeout=60):
        if kind == "row":
            rows[payload["candidate"]].append(payload["row"])
        elif kind == "done":
            done = payload
    assert rows == {0: list(range(FMAP)), 1: list(range(FMAP))}
    assert done["failovers"] == 1 and done["replica"] == "gb2"
    assert done["candidates"] == [ref(TEXTS[1], 300), ref(TEXTS[1], 301)]
    router.drain(timeout=30)


def test_replica_deadline_shed_and_worker_death(model, ref):
    rep = tgw.Replica(_engine(model), policy=PriorityDeadlinePolicy()).start()
    live = [rep.submit(TEXTS[i], 100 + i) for i in range(2)]
    dead = rep.submit(TEXTS[2], 102, deadline_at=time.perf_counter() - 1.0)
    assert [k for k, _ in dead.events(timeout=60)] == ["shed"]
    for i, s in enumerate(live):
        events = list(s.events(timeout=60))
        assert events[-1][0] == "done" and events[-1][1].tokens.tolist() == ref(TEXTS[i],
                                                                               100 + i)
    assert rep.queue.shed_total == 1
    rep.drain(timeout=30)

    # an exception on the engine thread fails every stream and is kept
    def boom(*a, **k):
        raise RuntimeError("device lost")
    eng = _engine(model)
    eng._multi_step = boom
    bad = tgw.Replica(eng, replica_id="bad").start()
    events = list(bad.submit(TEXTS[0], 1).events(timeout=30))
    assert events == [("replica_failed", "RuntimeError('device lost')")]
    assert repr(bad.failed) == "RuntimeError('device lost')" and not bad.healthy
    assert bad.health()["error"] == "RuntimeError('device lost')"
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tgw.Replica(eng, aot_dir="/nonexistent")


def test_gateway_loopback_stream_quota_health(model, ref):
    tobs.disable()
    tobs.configure()
    try:
        rep = tgw.Replica(_engine(model), maxsize=8).start()
        gw = tgw.Gateway(tgw.ReplicaRouter([rep]), tgw.AdmissionController(
            tgw.TenantQuotas(100.0, 100.0, overrides={"capped": (0.001, 1)}))).start()
        status, headers, body = _http(gw, "POST", "/v1/generate",
                                      {"text": TEXTS[0].tolist(), "seed": 100,
                                       "stream": True})
        assert status == 200 and headers["Content-Type"] == "text/event-stream"
        events = list(tgw.iter_sse(io.BytesIO(body)))
        rows = [d for e, d in events if e == "row"]
        done = [d for e, d in events if e == "done"]
        assert [t for r in rows for t in r["tokens"]] == ref(TEXTS[0], 100)
        assert done[0]["tokens"] == ref(TEXTS[0], 100)
        assert all(d["trace_id"] == headers["X-Request-Id"] for _, d in events)
        status, _, body = _http(gw, "POST", "/v1/generate",
                                {"text": TEXTS[1].tolist(), "seed": 101, "tenant": "capped"})
        assert status == 200 and json.loads(body)["tokens"] == ref(TEXTS[1], 101)
        assert (gw.admission.slo.tokens_per_s or 0) > 0
        status, headers, body = _http(gw, "POST", "/v1/generate",
                                      {"text": TEXTS[2].tolist(), "seed": 102,
                                       "tenant": "capped"})
        assert status == 429 and json.loads(body)["error"] == "quota"
        assert float(headers["Retry-After"]) > 0
        status, _, body = _http(gw, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok" and health["replicas"][0]["healthy"]
        deadline = time.time() + 5.0
        while True:
            metrics = _http(gw, "GET", "/metrics")[2].decode()
            if "dalle_gateway_inflight 0" in metrics or time.time() > deadline:
                break
            time.sleep(0.05)
        assert "dalle_gateway_rejected_total" in metrics
        assert "dalle_gateway_inflight 0" in metrics
        gw.shutdown(drain=True, timeout=30)
        assert not rep.healthy
    finally:
        tobs.disable()


def test_gateway_images_validation_rejects_before_admission(model):
    rep = tgw.Replica(_engine(model), maxsize=8).start()
    gw = tgw.Gateway(tgw.ReplicaRouter([rep]), tgw.AdmissionController()).start()
    assert gw.max_candidates == 2
    base = {"text": TEXTS[0].tolist(), "seed": 1}
    for bad in ({**base, "n_candidates": 3}, {**base, "n_candidates": 0},
                {**base, "n_candidates": 2, "top_k": 3}, {**base, "top_k": 0},
                {**base, "n_candidates": 2, "seed": 2 ** 31 - 1},
                {**base, "text": [TEXTS[0].tolist()]}, {**base, "max_tokens": 0},
                {"seed": 1}):
        status, _, body = _http(gw, "POST", "/v1/images", bad)
        assert status == 400 and json.loads(body)["error"] == "bad_request", bad
    assert rep.engine.stats.steps == 0 and gw.admission.admitted_total == 0
    gw.shutdown(drain=True, timeout=30)


def test_serve_gateway_cli_on_the_cpu(tmp_path, ref):
    from dalle_tpu_torch.cli import serve_gateway
    for flag in ("--aot_dir", "--aot_export"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            serve_gateway.main(["--untrained", "--device", "cpu", flag, str(tmp_path)])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dalle_tpu_torch.cli.serve_gateway", "--untrained",
         "--device", "cpu", "--port", "0", "--flight_dir", "off", "--slots", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path),
        env=env)
    try:
        addr = None
        for line in proc.stdout:
            if line.startswith("gateway listening on http://"):
                addr = line.split("http://")[1].split()[0]
                break
        assert addr, "no listening line"
        host, port = addr.rsplit(":", 1)

        def post(path, payload):
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            conn.request("POST", path, json.dumps(payload))
            resp = conn.getresponse()
            out = resp.status, json.loads(resp.read())
            conn.close()
            return out
        status, gen = post("/v1/generate", {"text": [3, 4, 5], "seed": 1})
        assert status == 200 and len(gen["tokens"]) == 16
        status, img = post("/v1/images", {"text": [3, 4, 5], "seed": 1,
                                          "n_candidates": 2, "top_k": 1})
        assert status == 200 and img["candidates"][0] == gen["tokens"]
        assert img["order"] == [0, 1] and not img["reranked"] and len(img["top_k"]) == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "drained; bye" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
