"""Admission control: per-tenant token buckets + SLO-aware rejection.

A copy of ``dalle_tpu/gateway/admission.py`` (it imports no JAX), with the
same decisions and the same ``gateway.*`` counters and gauges. The gateway's front door decides, per request, one of three fates before
anything touches a queue: admit, reject for quota (a tenant exceeding its
contracted rate must not degrade neighbors — multi-tenant isolation), or
reject for SLO (when the predicted wait already blows the request's
deadline, queueing it only manufactures a guaranteed miss AND lengthens the
wait for everyone behind it — better to say 429 now and let the client
retry elsewhere; AlpaServe, OSDI '23 makes the same argument at replica
granularity). Everything here is host-side pure Python: admission must cost
microseconds, never a device sync.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

from ..obs import counter_add, gauge_set


class TokenBucket:
    """Classic leaky bucket: ``burst`` capacity refilled at ``rate_per_s``.
    ``try_acquire`` never blocks — the gateway rejects, it doesn't queue at
    the quota layer (queueing is the scheduler's job, and only for admitted
    work)."""

    def __init__(self, rate_per_s: float, burst: float):
        assert rate_per_s > 0 and burst >= 1
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._level = float(burst)
        self._t_last = time.perf_counter()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0,
                    now: Optional[float] = None) -> bool:
        with self._lock:
            t = time.perf_counter() if now is None else now
            # clamp: an injected/earlier clock must not refill negatively
            self._level = min(self.burst, self._level
                              + max(t - self._t_last, 0.0) * self.rate)
            self._t_last = t
            if self._level >= n:
                self._level -= n
                return True
            return False

    @property
    def level(self) -> float:
        with self._lock:
            return self._level


class TenantQuotas:
    """Per-tenant request-rate buckets. Unknown tenants get the default
    (rate_per_s, burst); ``overrides`` maps tenant → (rate_per_s, burst)
    for contracted tiers. A tenant's bucket is created on first sight, so
    the quota table needs no pre-registration."""

    def __init__(self, rate_per_s: float = 10.0, burst: float = 20.0,
                 overrides: Optional[Dict[str, Tuple[float, float]]] = None):
        self.default = (float(rate_per_s), float(burst))
        self.overrides = dict(overrides or {})
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = self.overrides.get(tenant, self.default)
                b = self._buckets[tenant] = TokenBucket(rate, burst)
            return b

    def admit(self, tenant: str) -> bool:
        return self.bucket(tenant).try_acquire(1.0)


class SloEstimator:
    """EWMA of the fleet's observed decode throughput (tokens/s), fed by
    completion records; predicts how long a request arriving NOW would wait
    to finish given the tokens already queued ahead of it. Deliberately
    coarse — a fluid approximation of a batched server — but it only has to
    be right about the order of magnitude to turn "queue into certain SLO
    death" into "reject with Retry-After", and it is measured from the same
    replica fleet it predicts."""

    def __init__(self, alpha: float = 0.2,
                 initial_tokens_per_s: Optional[float] = None,
                 parallelism: int = 1):
        self.alpha = float(alpha)
        self.tokens_per_s = initial_tokens_per_s
        # completions report PER-REQUEST token rate; with B slots decoding
        # concurrently each request sees ~1/B of fleet throughput, so
        # backlog drains at ~rate × parallelism. Without this the
        # prediction overestimates waits by ~B and sheds traffic the fleet
        # would comfortably serve (set to total slots × replicas).
        self.parallelism = max(int(parallelism), 1)
        self._lock = threading.Lock()

    def set_parallelism(self, parallelism: int) -> None:
        """Re-point the fluid model at the CURRENT fleet width (slots ×
        replicas). The fleet controller calls this on every scale/
        drain so backlog predictions track capacity instead of the boot-
        time fleet size — a scaled-up fleet would otherwise keep shedding
        traffic it can now comfortably serve."""
        with self._lock:
            self.parallelism = max(int(parallelism), 1)
            gauge_set("gateway.slo_parallelism", float(self.parallelism))

    def observe(self, tokens: int, seconds: float) -> None:
        if seconds <= 0 or tokens <= 0:
            return
        rate = tokens / seconds
        with self._lock:
            if self.tokens_per_s is None:
                self.tokens_per_s = rate
            else:
                self.tokens_per_s += self.alpha * (rate - self.tokens_per_s)
            gauge_set("gateway.observed_tokens_per_s", self.tokens_per_s)

    def predict_completion_s(self, queued_tokens: int,
                             request_tokens: int) -> Optional[float]:
        """Seconds until a request behind ``queued_tokens`` of backlog would
        finish its own ``request_tokens`` — None before any observation
        (an unwarmed estimator must not reject: admit and learn)."""
        with self._lock:
            rate = self.tokens_per_s
        if rate is None or rate <= 0:
            return None
        return (queued_tokens + request_tokens) / (rate * self.parallelism)


@dataclasses.dataclass(frozen=True)
class Decision:
    admit: bool
    reason: str                      # "ok" | "quota" | "slo" | "draining"
    predicted_completion_s: Optional[float] = None
    retry_after_s: Optional[float] = None


class AdmissionController:
    """Quota gate then SLO gate, with per-tenant reject accounting. The
    obs counters it maintains — the stable unlabeled fleet sum
    ``gateway.rejected_total`` plus the labeled
    ``gateway.rejected_by_total{tenant=...,reason=...}`` series — feed the
    Prometheus textfile/endpoint and obs_report's gateway verdict line."""

    def __init__(self, quotas: Optional[TenantQuotas] = None,
                 slo: Optional[SloEstimator] = None):
        self.quotas = quotas if quotas is not None else TenantQuotas()
        self.slo = slo if slo is not None else SloEstimator()
        self.admitted_total = 0
        self.rejected: Dict[str, int] = {}
        self._lock = threading.Lock()

    def reject(self, tenant: str, reason: str, **kw) -> Decision:
        """Record a rejection (per-tenant book + obs counters) and return
        the Decision. Public because rejects decided OUTSIDE decide() —
        the gateway's queue_full path — must land in the same books."""
        with self._lock:
            self.rejected[tenant] = self.rejected.get(tenant, 0) + 1
        counter_add("gateway.rejected_total", 1.0)
        # dimensions as REAL labels (one family, PromQL `sum by (tenant)`),
        # not mangled into per-tenant/per-reason metric names
        counter_add("gateway.rejected_by_total", 1.0,
                    labels={"tenant": tenant, "reason": reason})
        return Decision(admit=False, reason=reason, **kw)

    def decide(self, tenant: str, *, request_tokens: int,
               queued_tokens: int,
               deadline_s: Optional[float] = None) -> Decision:
        if not self.quotas.admit(tenant):
            bucket = self.quotas.bucket(tenant)
            # one token's worth of refill is the earliest useful retry
            return self.reject(tenant, "quota",
                               retry_after_s=max(1.0 / bucket.rate, 0.05))
        if deadline_s is not None:
            predicted = self.slo.predict_completion_s(queued_tokens,
                                                      request_tokens)
            if predicted is not None and predicted > deadline_s:
                return self.reject(tenant, "slo",
                                   predicted_completion_s=predicted,
                                   retry_after_s=predicted - deadline_s)
        with self._lock:
            self.admitted_total += 1
        return Decision(admit=True, reason="ok")
