"""The HTTP/SSE gateway: a stdlib network front end for the fleet.

Port of ``dalle_tpu/gateway/server.py``, with the same routes, status
codes, JSON fields, SSE events and ``gateway.*``/``usage.*``/``slo.*``
metrics, so a client of the JAX gateway talks to this one unchanged.
``http.server.ThreadingHTTPServer`` (one thread per connection) sits in
front of admission control (``admission.py``), the replica router
(``router.py``) and the SSE encoder (``sse.py``).

API:

  POST /v1/generate     JSON body: {"text": [token ids...], "seed": int,
                        "max_tokens"?, "tenant"?, "priority"?,
                        "deadline_s"?, "stream"?: bool, "pixels"?: bool,
                        "cond_scale"?: float (classifier-free guidance;
                        != 1.0 admits a cond/uncond slot pair engine-side;
                        /v1/images takes it too, per candidate)}
      stream=false → 200 JSON {request_id, tokens, ttft_s, latency_s, ...}
      stream=true  → 200 text/event-stream of row/done/error events
                     (sse.py's wire format; pixels=true adds dVAE preview
                     bands per row when the gateway has a VAE)
      400 {"error": "bad_request"} (validated before admission)
      429 {"error": "quota" | "slo" | "queue_full"} (+ Retry-After)
      503 {"error": "draining" | "no_replica"}; 504 on a deadline shed
  POST /v1/images       {"text", "seed", "n_candidates"?, "top_k"?, ...}:
                        n candidates (seeds seed..seed+n-1, one shared
                        prefill engine-side) → ``serve.ImagePipeline``
                        (dVAE pixels, CLIP rerank) → the top k
  GET /healthz          200/503 JSON fleet health (per-replica rows)
  GET /metrics          Prometheus text exposition of the obs registry,
                        with a collector the fleet's merged view

Token ids in, token ids and pixels out: tokenization and image encoding
stay client-side.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..obs import (BurnRateSentry, counter_add, dump_recorder,
                   exemplars_snapshot, gauge_set, histogram_observe,
                   metrics_snapshot, record_event, render_textfile, span,
                   trace_context)
from ..obs.collect import TelemetryCollector, UsageLedger
from ..obs.context import new_trace_id
from ..serve.pipeline import CandidateGroup, ImagePipeline
from ..serve.queue import QueueFull
from .admission import AdmissionController
from .router import NoReplicaAvailable, ReplicaRouter
from .sse import RowPixelDecoder, sse_event


def _default_sentry() -> BurnRateSentry:
    def on_breach(verdict):
        counter_add("slo.breaches_total", 1.0)
        dump_recorder("slo_breach", extra={
            "dominating": verdict["dominating"],
            "windows": verdict["windows"]})
    return BurnRateSentry(on_breach=on_breach)


class Gateway:
    """Binds the HTTP server to a router + admission controller. ``port=0``
    picks an ephemeral port (tests/smoke run loopback). ``vae`` enables
    per-row pixel previews for ``"pixels": true`` requests; ``clip`` (a
    ``models.clip.CLIP``, honoured beside a ``vae``) the /v1/images rerank.

    ``slo_sentry`` (obs/slo.py) watches the admission/completion/shed
    stream: every request outcome at this door is one burn-rate
    observation. The default sentry publishes the ``dalle_slo_*`` gauges
    and dumps a flight-recorder bundle on the ok→BURNING transition; pass
    an explicitly configured one to share windows across gateways or wire
    a different breach sink."""

    def __init__(self, router: ReplicaRouter,
                 admission: Optional[AdmissionController] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 vae=None, clip=None, pipeline=None,
                 image_fmap_size: Optional[int] = None,
                 image_seq_len: Optional[int] = None,
                 slo_sentry: Optional[BurnRateSentry] = None,
                 collector: Optional[TelemetryCollector] = None,
                 usage_log: Optional[str] = None):
        # a collector turns GET /metrics into the FLEET view
        # (remote counters summed, gauges labeled {replica=}); without one
        # the endpoint renders the local registry exactly as before.
        self.collector = collector
        # per-tenant metering ledger (append-only JSONL, atomic rotation);
        # None keeps metering as counters only
        self.usage = UsageLedger(usage_log) if usage_log else None
        self.router = router
        self.admission = (admission if admission is not None
                          else AdmissionController())
        self.slo_sentry = (slo_sentry if slo_sentry is not None
                           else _default_sentry())
        self.vae = vae
        self.image_fmap_size = image_fmap_size
        # per-request token demand for SLO math: the full grid unless the
        # request caps max_tokens. A cross-host fleet's replicas carry no
        # local .engine (a fleet RemoteReplica) — the same shape facts
        # then come from the replica's health dict, which the fleet
        # transport forwards from the remote engine.
        eng = getattr(router.replicas[0], "engine", None)
        shape = {} if eng is not None else router.replicas[0].health()
        self.image_seq_len = (
            image_seq_len if image_seq_len is not None
            else eng.n_steps if eng is not None
            else int(shape["image_seq_len"]))
        if self.image_fmap_size is None:
            self.image_fmap_size = (eng.row_len if eng is not None
                                    else int(shape["image_fmap_size"]))
        # /v1/images product loop: candidates of one request
        # fan into engine slots, so the slot count caps n_candidates — a
        # larger fan-out could never share a prefill window and would
        # deadlock a single-replica fleet's admission
        self.max_candidates = (eng.slots if eng is not None
                               else int(shape["slots"]))
        # a pipeline passed in stays the caller's to close (the smoke shares
        # one across gateway phases so its jitted programs stay warm)
        self._owns_pipeline = pipeline is None
        if pipeline is None:
            # post-decode stage graph (serve/pipeline.py): built even
            # without a vae/clip so /v1/images always serves — token-only
            # with zero scores at minimum (rerank needs pixels, so clip is
            # only honored alongside a vae)
            pipeline = ImagePipeline(vae=vae,
                                     clip=clip if vae is not None else None)
        self.pipeline = pipeline
        self._inflight = 0
        self._lock = threading.Lock()
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "Gateway":
        assert self._serve_thread is None
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="gateway-http",
            kwargs={"poll_interval": 0.05}, daemon=True)
        self._serve_thread.start()
        return self

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Graceful by default: refuse new work (503), finish accepted
        work, then stop the listener."""
        self.router.draining = True
        if drain:
            self.router.drain(timeout=timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        if self._owns_pipeline:
            self.pipeline.close(timeout=5)

    # -- accounting --------------------------------------------------------
    def _enter(self):
        with self._lock:
            self._inflight += 1
            gauge_set("gateway.inflight", float(self._inflight))

    def _exit(self):
        with self._lock:
            self._inflight -= 1
            gauge_set("gateway.inflight", float(self._inflight))

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight


def _make_handler(gw: Gateway):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0 + connection close ends the SSE stream at EOF — no
        # chunked-encoding bookkeeping, and every stdlib/curl client
        # handles it
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):   # quiet: obs carries the signal
            pass

        # -- helpers -------------------------------------------------------
        _trace_id: Optional[str] = None

        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._trace_id is not None:
                # the trace identity echoes on EVERY response —
                # including 4xx/5xx — so a client log line always joins
                # against the server timeline
                self.send_header("X-Request-Id", self._trace_id)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        # -- routes --------------------------------------------------------
        def do_GET(self):
            if self.path == "/healthz":
                health = gw.router.health()
                health["inflight"] = gw.inflight
                code = 200 if health["status"] == "ok" else 503
                self._json(code, health)
            elif self.path == "/metrics":
                gauge_set("gateway.inflight", float(gw.inflight))
                snap = metrics_snapshot()
                if gw.collector is not None:
                    # fleet aggregation: refresh every remote
                    # source, then fold its counters/histogram buckets into
                    # the local registry (gauges get {replica=} labels)
                    gw.collector.poll()
                    snap = gw.collector.fleet_metrics(snap)
                body = render_textfile(
                    snap, exemplars=exemplars_snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not_found", "path": self.path})

        def do_POST(self):
            if self.path not in ("/v1/generate", "/v1/images"):
                self._json(404, {"error": "not_found", "path": self.path})
                return
            counter_add("gateway.requests_total", 1.0)
            # the HTTP door mints the request's one identity; binding it as
            # the thread's ambient trace context tags every span this
            # connection thread records (gateway/request, SSE flushes) with
            # the same id the engine threads tag via Request.trace_id
            tid = self._trace_id = new_trace_id()
            with trace_context(tid), span("gateway/request"):
                if self.path == "/v1/images":
                    self._images(tid)
                else:
                    self._generate(tid)

        def _generate(self, tid: str):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                # validate the full request surface HERE: anything invalid
                # must come back as a 400, never escape as an unhandled
                # handler exception (dropped connection) — and absolutely
                # never reach the engine thread, where a bad value (e.g.
                # an out-of-int32 seed) would kill the replica worker and
                # ride failover across the fleet
                text = np.asarray(body["text"], np.int32)
                if text.ndim != 1:
                    raise ValueError(f"text must be a flat list of token "
                                     f"ids, got shape {text.shape}")
                seed = int(body["seed"])
                if not (-2**31 <= seed < 2**31):
                    raise ValueError(f"seed must fit int32, got {seed}")
                max_tokens = body.get("max_tokens")
                if max_tokens is not None:
                    max_tokens = int(max_tokens)
                    if max_tokens < 1:
                        raise ValueError(
                            f"max_tokens must be >= 1, got {max_tokens}")
                deadline_s = body.get("deadline_s")
                if deadline_s is not None:
                    deadline_s = float(deadline_s)
                cond_scale = float(body.get("cond_scale", 1.0))
                if not (cond_scale == cond_scale and
                        abs(cond_scale) < 1e6):
                    raise ValueError(
                        f"cond_scale must be finite, got {cond_scale}")
            except (KeyError, TypeError, ValueError, OverflowError) as exc:
                self._json(400, {"error": "bad_request",
                                 "detail": repr(exc)})
                return
            tenant = str(body.get("tenant", "default"))
            self._usage_ctx = {"tenant": tenant, "kind": "generate",
                               "tokens_in": int(text.shape[0]), "images": 0}
            req_tokens = (int(max_tokens) if max_tokens
                          else gw.image_seq_len)

            decision = gw.admission.decide(
                tenant, request_tokens=req_tokens,
                queued_tokens=gw.router.total_backlog * gw.image_seq_len,
                deadline_s=deadline_s)
            if not decision.admit:
                self._reject(tenant, tid, decision)
                return

            gw._enter()
            try:
                routed = self._submit_or_reject(
                    tenant,
                    lambda: gw.router.submit(
                        text, seed, max_tokens=max_tokens, tenant=tenant,
                        priority=int(body.get("priority", 0)),
                        deadline_s=deadline_s, trace_id=tid,
                        cond_scale=cond_scale))
                if routed is None:
                    return
                record_event("request_submitted", trace_id=tid,
                             tenant=tenant,
                             replica=routed.replica_id)
                if body.get("stream", False):
                    self._stream(routed, bool(body.get("pixels", False)),
                                 deadline_s)
                else:
                    self._blocking(routed, deadline_s)
            finally:
                gw._exit()

        def _reject(self, tenant: str, tid, decision) -> None:
            """Render an admission rejection (shared by /v1/generate and
            /v1/images): one SLO bad event + labeled reject bookkeeping +
            429 with Retry-After when the estimator can predict one."""
            gw.slo_sentry.record(False, decision.reason)
            record_event("request_rejected", trace_id=tid, tenant=tenant,
                         reason=decision.reason)
            headers = []
            if decision.retry_after_s is not None:
                headers.append(("Retry-After",
                                f"{decision.retry_after_s:.3f}"))
            self._json(429, {"error": decision.reason,
                             "tenant": tenant,
                             "predicted_completion_s":
                                 decision.predicted_completion_s},
                       headers)

        def _submit_or_reject(self, tenant: str, submit):
            """Run a router submission, mapping its failures to the shared
            HTTP verdicts: full replica queues → quota-booked 429, an empty
            /draining fleet → 503. Returns the routed stream, or None with
            the response already sent."""
            try:
                return submit()
            except QueueFull as exc:
                gw.admission.reject(tenant, "queue_full")
                gw.slo_sentry.record(False, "queue_full")
                self._json(429, {"error": "queue_full",
                                 "detail": str(exc)},
                           [("Retry-After", "0.5")])
            except NoReplicaAvailable as exc:
                reason = ("draining" if gw.router.draining
                          else "no_replica")
                gw.slo_sentry.record(False, reason)
                self._json(503, {"error": reason, "detail": str(exc)})
            return None

        def _record_outcome(self, kind: str, payload: dict,
                            deadline_s) -> None:
            """One burn-rate observation per finished request: a
            completion that beat its deadline is good; a shed, failover
            exhaustion or deadline overrun is budget burned. Completions
            ALSO feed the admission estimator HERE, at the door — the one
            point every topology's completions pass through, so a
            fully-remote fleet warms the throughput estimate
            exactly like in-process replicas do (the `done` payload
            carries tokens + the replica-measured slot time)."""
            if kind == "done":
                late = (deadline_s is not None
                        and payload.get("latency_s", 0.0) > deadline_s)
                gw.slo_sentry.record(not late,
                                     "deadline_miss" if late else "")
                toks = payload.get("candidates") or payload.get("tokens")
                dec = payload.get("decode_s")
                if toks and dec:
                    # groups: one per-request rate sample at the
                    # per-candidate token count (candidates decode
                    # concurrently — parallelism is the estimator's knob)
                    n = (len(toks[0]) if payload.get("candidates")
                         else len(toks))
                    gw.admission.slo.observe(n, float(dec))
                # every engine-request completion this door
                # observed, counted once per candidate — the fleet
                # invariant gateway_smoke asserts is
                # sum(serve.requests_completed_total over replicas)
                # == gateway.completed_total
                cands = payload.get("candidates")
                completions = float(len(cands)) if cands else 1.0
                counter_add("gateway.completed_total", completions)
                if payload.get("ttft_s") is not None:
                    histogram_observe("gateway.ttft_seconds",
                                      float(payload["ttft_s"]))
                self._meter_usage(payload, completions)
            else:
                gw.slo_sentry.record(False, payload.get("reason", "error"))

        def _meter_usage(self, payload: dict, completions: float) -> None:
            """Per-tenant usage accounting for one completed request:
            live ``usage.*_total{tenant=}`` counters (tenant is a bounded
            label — quota config names the set) plus one ledger line when
            the gateway has a metering log. ``queue_wait_s`` bills the
            pre-decode wall time (queue + prefill: latency minus the
            replica-measured decode slot time)."""
            ctx = getattr(self, "_usage_ctx", None)
            if ctx is None:
                return
            tenant = ctx["tenant"]
            cands = payload.get("candidates")
            tokens_out = (sum(len(c) for c in cands) if cands
                          else len(payload.get("tokens") or ()))
            latency = float(payload.get("latency_s") or 0.0)
            decode_s = float(payload.get("decode_s") or 0.0)
            queue_wait = max(0.0, latency - decode_s)
            labels = {"tenant": tenant}
            counter_add("usage.tokens_in_total",
                        float(ctx["tokens_in"]), labels=labels)
            counter_add("usage.tokens_out_total",
                        float(tokens_out), labels=labels)
            counter_add("usage.queue_wait_s_total", queue_wait,
                        labels=labels)
            if ctx.get("images"):
                counter_add("usage.images_total",
                            float(ctx["images"]), labels=labels)
            if gw.usage is not None:
                gw.usage.append({
                    "ts": time.time(), "tenant": tenant,
                    "kind": ctx["kind"], "trace_id": self._trace_id,
                    "tokens_in": int(ctx["tokens_in"]),
                    "tokens_out": int(tokens_out),
                    "images": int(ctx.get("images", 0)),
                    "queue_wait_s": round(queue_wait, 6),
                    "completions": completions})

        def _blocking(self, routed, deadline_s):
            for kind, payload in routed.events():
                if kind == "done":
                    self._record_outcome(kind, payload, deadline_s)
                    self._json(200, {"request_id": routed.gateway_id,
                                     "trace_id": routed.trace_id,
                                     **payload})
                    return
                if kind == "error":
                    self._record_outcome(kind, payload, deadline_s)
                    code = 504 if payload["reason"] == "deadline_shed" \
                        else 503
                    self._json(code, payload)
                    return
            self._json(500, {"error": "stream_ended_without_result"})

        def _stream(self, routed, pixels: bool, deadline_s):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            if self._trace_id is not None:
                self.send_header("X-Request-Id", self._trace_id)
            self.end_headers()
            decoder = None
            if pixels and gw.vae is not None:
                decoder = RowPixelDecoder(gw.vae, gw.image_fmap_size)
            rid = routed.gateway_id
            try:
                for kind, payload in routed.events():
                    data = {"request_id": rid,
                            "trace_id": routed.trace_id, **payload}
                    if kind == "row" and decoder is not None:
                        # pixel preview decoded HERE, on the connection
                        # thread — never the engine thread
                        data.update(decoder.row_event(
                            rid, payload["row"], payload["tokens"]))
                    if kind in ("done", "error"):
                        self._record_outcome(kind, payload, deadline_s)
                    # the flush is the client-visible commit of a row —
                    # the last segment of the request timeline (tagged via
                    # the ambient trace context bound in do_POST)
                    with span("gateway/sse_flush", event=kind):
                        self.wfile.write(sse_event(kind, data))
                        self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                counter_add("gateway.client_disconnects_total", 1.0)
            finally:
                if decoder is not None:
                    decoder.finish(rid)

        # -- /v1/images: the shared-prefix product loop ----------------
        def _images(self, tid: str):
            """text → N candidate token sequences (ONE shared prompt
            prefill engine-side) → dVAE pixels → CLIP rerank → top-k.
            Validation happens HERE, before admission: a bad n_candidates/
            top_k must come back 400 — never an engine-thread kill that
            fleet failover would replay."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                text = np.asarray(body["text"], np.int32)
                if text.ndim != 1:
                    raise ValueError(f"text must be a flat list of token "
                                     f"ids, got shape {text.shape}")
                seed = int(body["seed"])
                n_cand = int(body.get("n_candidates", 1))
                if not (1 <= n_cand <= gw.max_candidates):
                    raise ValueError(
                        f"n_candidates must be in [1, {gw.max_candidates}] "
                        f"(the per-replica slot budget), got {n_cand}")
                top_k = int(body.get("top_k", n_cand))
                if not (1 <= top_k <= n_cand):
                    raise ValueError(f"top_k must be in [1, n_candidates="
                                     f"{n_cand}], got {top_k}")
                # candidate i samples under seed+i — the whole fan must fit
                # int32 so no candidate's PRNGKey silently wraps
                if not (-2**31 <= seed and seed + n_cand - 1 < 2**31):
                    raise ValueError(f"seeds [{seed}, {seed + n_cand - 1}] "
                                     "must fit int32")
                max_tokens = body.get("max_tokens")
                if max_tokens is not None:
                    max_tokens = int(max_tokens)
                    if max_tokens < 1:
                        raise ValueError(
                            f"max_tokens must be >= 1, got {max_tokens}")
                deadline_s = body.get("deadline_s")
                if deadline_s is not None:
                    deadline_s = float(deadline_s)
                cond_scale = float(body.get("cond_scale", 1.0))
                if not (cond_scale == cond_scale and
                        abs(cond_scale) < 1e6):
                    raise ValueError(
                        f"cond_scale must be finite, got {cond_scale}")
            except (KeyError, TypeError, ValueError, OverflowError) as exc:
                self._json(400, {"error": "bad_request",
                                 "detail": repr(exc)})
                return
            tenant = str(body.get("tenant", "default"))
            self._usage_ctx = {"tenant": tenant, "kind": "images",
                               "tokens_in": int(text.shape[0]),
                               "images": n_cand}
            seeds = [seed + i for i in range(n_cand)]
            per_cand = (int(max_tokens) if max_tokens
                        else gw.image_seq_len)

            counter_add("gateway.images_requests_total", 1.0)
            counter_add("gateway.images_candidates_total", float(n_cand))
            # quota/SLO charge is n_candidates-aware: a 8-candidate request
            # consumes 8 requests' worth of slot time
            decision = gw.admission.decide(
                tenant, request_tokens=n_cand * per_cand,
                queued_tokens=gw.router.total_backlog * gw.image_seq_len,
                deadline_s=deadline_s)
            if not decision.admit:
                self._reject(tenant, tid, decision)
                return

            gw._enter()
            try:
                routed = self._submit_or_reject(
                    tenant,
                    lambda: gw.router.submit_images(
                        text, seeds, max_tokens=max_tokens, tenant=tenant,
                        priority=int(body.get("priority", 0)),
                        deadline_s=deadline_s, trace_id=tid,
                        cond_scale=cond_scale))
                if routed is None:
                    return
                record_event("images_submitted", trace_id=tid,
                             tenant=tenant, candidates=n_cand,
                             replica=routed.replica_id)
                if body.get("stream", False):
                    self._images_stream(routed, text, seeds, top_k,
                                        bool(body.get("pixels", False)),
                                        deadline_s)
                else:
                    self._images_blocking(routed, text, seeds, top_k,
                                          deadline_s)
            finally:
                gw._exit()

        def _ranked_payload(self, routed, text, seeds, top_k, done):
            """Run the finished group through the post-decode pipeline and
            shape the response: top-k entries (pixels when a vae is
            attached), every candidate's token grid, scores, timings."""
            group = CandidateGroup(
                group_id=routed.gateway_id, text=text,
                tokens=np.asarray(done["candidates"], np.int32),
                seeds=seeds, top_k=top_k, trace_id=routed.trace_id)
            try:
                ranked = gw.pipeline.submit(group).result(timeout=120.0)
            except (TimeoutError, RuntimeError) as exc:
                # backlogged/closed pipeline or a wedged stage: the client
                # must still get a status line and the SLO books an outcome
                # (both callers map this to 500 / an SSE error event)
                return None, {"reason": "pipeline_failed",
                              "detail": repr(exc)}
            if ranked.error is not None:
                return None, {"reason": "pipeline_failed",
                              "detail": ranked.error}
            return {"request_id": routed.gateway_id,
                    "trace_id": routed.trace_id,
                    "n_candidates": len(seeds), "seeds": seeds,
                    "reranked": ranked.reranked,
                    "scores": ranked.scores, "order": ranked.order,
                    "top_k": ranked.top_k,
                    "candidates": done["candidates"],
                    "ttft_s": done["ttft_s"],
                    "latency_s": done["latency_s"],
                    "replica": done["replica"],
                    "failovers": done["failovers"]}, None

        def _images_blocking(self, routed, text, seeds, top_k, deadline_s):
            for kind, payload in routed.events():
                if kind == "done":
                    ranked, err = self._ranked_payload(routed, text, seeds,
                                                       top_k, payload)
                    if err is not None:
                        self._record_outcome("error", err, deadline_s)
                        self._json(500, err)
                        return
                    self._record_outcome(kind, payload, deadline_s)
                    self._json(200, ranked)
                    return
                if kind == "error":
                    self._record_outcome(kind, payload, deadline_s)
                    code = 504 if payload["reason"] == "deadline_shed" \
                        else 503
                    self._json(code, payload)
                    return
            self._json(500, {"error": "stream_ended_without_result"})

        def _images_stream(self, routed, text, seeds, top_k, pixels: bool,
                           deadline_s):
            """SSE: per-candidate ``row`` events (with preview pixel bands
            over the row plumbing when requested), then one final ``ranked``
            event carrying the pipeline's product."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            if self._trace_id is not None:
                self.send_header("X-Request-Id", self._trace_id)
            self.end_headers()
            decoder = None
            if pixels and gw.vae is not None:
                decoder = RowPixelDecoder(gw.vae, gw.image_fmap_size)
            rid = routed.gateway_id
            try:
                for kind, payload in routed.events():
                    data = {"request_id": rid,
                            "trace_id": routed.trace_id, **payload}
                    if kind == "row" and decoder is not None:
                        # per-candidate preview band, decoded on the
                        # connection thread; keyed (request, candidate) so
                        # candidates' committed prefixes stay separate
                        data.update(decoder.row_event(
                            (rid, payload["candidate"]), payload["row"],
                            payload["tokens"]))
                    if kind == "done":
                        ranked, err = self._ranked_payload(
                            routed, text, seeds, top_k, payload)
                        if err is not None:
                            kind, data = "error", {
                                "request_id": rid,
                                "trace_id": routed.trace_id, **err}
                            self._record_outcome("error", err, deadline_s)
                        else:
                            kind, data = "ranked", ranked
                            self._record_outcome("done", payload,
                                                 deadline_s)
                    elif kind == "error":
                        self._record_outcome(kind, payload, deadline_s)
                    with span("gateway/sse_flush", event=kind):
                        self.wfile.write(sse_event(kind, data))
                        self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                counter_add("gateway.client_disconnects_total", 1.0)
            finally:
                if decoder is not None:
                    for i in range(len(seeds)):
                        decoder.finish((rid, i))

    return Handler
