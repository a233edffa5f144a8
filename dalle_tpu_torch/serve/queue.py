"""Host-side request queue for the continuous-batching decode engine.

A copy of ``dalle_tpu/serve/queue.py`` (it imports no JAX): the same
``Request``, ``CompletedRequest``, ``RequestQueue`` and ``QueueFull``; a
request without a trace id gets one from ``obs.context.new_trace_id``.

A thread-safe FIFO of generation requests. Producers (an RPC handler, the
offered-load bench) ``submit`` from any thread; the engine loop ``take``s up
to its free-slot count per iteration and blocks on ``wait_nonempty`` only
when every slot is idle. ``close()`` marks the end of the workload: the
engine drains what is queued plus what is in flight, then returns.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np


class QueueFull(RuntimeError):
    """Raised by ``submit`` on a bounded queue at capacity. The gateway maps
    it to HTTP 429: rejecting at admission keeps a traffic spike from
    queueing into TTFT death — a request that would wait seconds for a slot
    is better retried against another replica (or later) than accepted."""


@dataclasses.dataclass
class Request:
    """One generation request: a text prompt (token ids, 0-padded to
    text_seq_len) and the per-request PRNG seed. ``seed`` defines the
    request's whole sampling stream — the engine's output for this request
    equals ``generate_images_tokens(text[None],
    generator=torch.Generator(device).manual_seed(seed))``."""
    request_id: int
    text: np.ndarray            # (text_seq_len,) int32
    seed: int
    # decode only the first ``max_tokens`` of the image grid (None = the
    # full image_seq_len). Partial-grid serving — previews, progressive
    # decode, top-rows-for-inpainting — is what makes per-request service
    # demand ragged; the engine's tokens for a partial request equal the
    # FIRST max_tokens of the full single-request generation.
    max_tokens: Optional[int] = None
    submitted_at: float = dataclasses.field(
        default_factory=time.perf_counter)
    # gateway-layer policy fields (dalle_tpu/gateway): ignored by the FIFO
    # queue and the engine itself, consumed by PolicyQueue ordering and the
    # admission controller. ``deadline_at`` is in the ``submitted_at``
    # timebase (perf_counter seconds).
    tenant: str = "default"
    priority: int = 0           # higher = served sooner under PolicyQueue
    deadline_at: Optional[float] = None
    # trace context: the request's one identity
    # across gateway → router → replica → engine slot — and across a
    # failover resubmission, which reuses the original id. Minted at the
    # HTTP door (gateway/server.py) or by ``submit`` for CLI/bench
    # producers; every span the request touches is tagged with it.
    trace_id: Optional[str] = None
    # shared-prefix candidate groups: candidates of ONE
    # ``/v1/images`` request carry the same ``group_id`` and identical text;
    # members of a group admitted in the same engine pass share one text
    # prefill (DALLE.serve_refill_shared) instead of paying N. Per-candidate
    # seeds keep every candidate's sampling stream independent — tokens stay
    # bitwise what N separate single-candidate requests would produce.
    group_id: Optional[int] = None
    group_size: int = 1
    group_index: int = 0
    # classifier-free guidance: cond_scale != 1.0 makes the
    # engine admit this request as a COHORT of two slots — the conditioned
    # row plus a synthetic null-text row (negative request_id, never
    # surfaced) — merging logits per step exactly like the sequential
    # ``generate_images_tokens(cond_scale=...)`` path. Requires an engine
    # with slots >= 2.
    cond_scale: float = 1.0
    # stamped by the engine
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None


@dataclasses.dataclass
class CompletedRequest:
    request_id: int
    tokens: np.ndarray          # (image_seq_len,) int32
    seed: int
    submitted_at: float
    admitted_at: float
    first_token_at: float
    completed_at: float

    @property
    def ttft_s(self) -> float:
        """Submission → first sampled token (queue wait included — the
        number a caller actually experiences)."""
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> float:
        return self.completed_at - self.submitted_at

    @property
    def decode_s(self) -> float:
        """Admission → completion: the slot-time the request actually
        consumed, queue wait excluded — the SloEstimator's observation
        unit (tokens / decode_s = per-request service rate). Shipped on
        the wire ``done`` frame so REMOTE completions feed the gateway's
        admission estimator exactly like local ones."""
        return self.completed_at - self.admitted_at


class RequestQueue:
    """FIFO with close semantics. All methods are thread-safe.

    ``maxsize`` bounds the backlog: ``submit`` on a full queue raises
    ``QueueFull`` instead of growing without bound (None = unbounded, the
    pre-gateway behavior). The bound counts QUEUED requests only — in-flight
    slots are the engine's capacity, the queue's job is to cap wait."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        self.maxsize = maxsize
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._next_id = 0

    def submit(self, text, seed: int,
               request_id: Optional[int] = None,
               max_tokens: Optional[int] = None,
               tenant: str = "default", priority: int = 0,
               deadline_at: Optional[float] = None,
               trace_id: Optional[str] = None,
               group_id: Optional[int] = None,
               group_size: int = 1,
               group_index: int = 0,
               cond_scale: float = 1.0) -> Request:
        """Enqueue a request; returns it (with its assigned id). An explicit
        ``request_id`` must be fresh: ids at or below the high-water mark of
        previously issued ids are rejected rather than tracked individually,
        so a duplicate can never silently alias another request's results
        (consumers key completions, spans and bench lookups by id)."""
        text = np.asarray(text, np.int32)
        assert text.ndim == 1, f"one prompt per request, got {text.shape}"
        if max_tokens is not None and max_tokens < 1:
            # the engine clamps to [1, image_seq_len]; 0/negative would
            # silently come back as a 1-token generation
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if trace_id is None:
            # the queue is the CLI/bench edge of the system: a producer
            # that didn't propagate a trace context still gets one identity
            # per request (the gateway mints at the HTTP door and passes it)
            from ..obs.context import new_trace_id
            trace_id = new_trace_id()
        with self._cond:
            if self._closed:
                raise RuntimeError("queue is closed")
            if self.maxsize is not None and len(self._q) >= self.maxsize:
                raise QueueFull(
                    f"queue at capacity ({self.maxsize} requests waiting)")
            if request_id is None:
                request_id = self._next_id
            elif request_id < self._next_id:
                raise ValueError(
                    f"request_id {request_id} is not fresh (ids below "
                    f"{self._next_id} may already be in flight); omit "
                    "request_id or pass one above the high-water mark")
            self._next_id = request_id + 1
            req = Request(request_id=request_id, text=text, seed=seed,
                          max_tokens=max_tokens, tenant=tenant,
                          priority=priority, deadline_at=deadline_at,
                          trace_id=trace_id, group_id=group_id,
                          group_size=group_size, group_index=group_index,
                          cond_scale=float(cond_scale))
            self._q.append(req)
            self._cond.notify_all()
        return req

    @property
    def next_request_id(self) -> int:
        """The id the next auto-assigned submission will get. A consumer
        that must index per-request state BEFORE the request becomes
        takeable (the gateway replica registers the result stream first,
        then submits with this explicit id) reads this and passes it to
        ``submit(request_id=...)`` — serializing its own submitters, since
        two concurrent reservations would collide."""
        with self._lock:
            return self._next_id

    def take(self, max_n: int) -> List[Request]:
        """Dequeue up to ``max_n`` requests in FIFO order (non-blocking)."""
        out: List[Request] = []
        with self._lock:
            while self._q and len(out) < max_n:
                out.append(self._q.popleft())
        return out

    def wait_nonempty(self, timeout: Optional[float] = None,
                      _poll_s: float = 0.5) -> bool:
        """Block until a request is queued or the queue is closed. Returns
        True when a request is available.

        Every park is bounded by ``_poll_s`` and re-checks the predicate:
        drain must not rely on close()'s final notify — a producer/closer
        thread that dies before notifying (or a close() the interpreter
        never reaches during teardown) degrades to one poll interval of
        extra latency here, never an unbounded hang."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not (self._q or self._closed):
                remaining = _poll_s
                if deadline is not None:
                    remaining = min(_poll_s, deadline - time.monotonic())
                    if remaining <= 0:
                        break
                self._cond.wait(remaining)
            return bool(self._q)

    def close(self) -> None:
        """No further submissions; the engine drains and returns."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def drained(self) -> bool:
        """Closed AND empty — nothing left to admit."""
        with self._lock:
            return self._closed and not self._q
