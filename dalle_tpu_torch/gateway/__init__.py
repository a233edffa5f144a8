"""The serving gateway: HTTP/SSE front end + replica fleet over ``serve``.

Port of ``dalle_tpu/gateway`` under the same names and the same contract
(routes, status codes, JSON fields, SSE events, metric names):

  * ``server.Gateway``: a stdlib HTTP server; ``/v1/generate`` (blocking,
    or SSE grid rows as the engine commits them), ``/v1/images`` (n
    candidates → dVAE pixels → CLIP rerank → top k), ``/healthz``,
    ``/metrics``;
  * ``admission``: per-tenant token-bucket quotas + SLO-aware rejection
    (a request predicted to miss its deadline gets 429 + Retry-After);
  * ``replica``/``router``: health-checked replicas over the port's
    ``DecodeEngine``, least-backlog dispatch, deterministic mid-stream
    failover, graceful drain, dynamic membership.

``aot.py`` (serialized XLA executables) is not ported: its counterpart is
CUDA-graph capture (``ROADMAP.md`` Queue 1 item 2), and ``Replica(aot_dir=)``
raises.
"""

from .admission import (AdmissionController, Decision, SloEstimator,
                        TenantQuotas, TokenBucket)
from .replica import GroupStream, Replica, ReplicaFailure, ResultStream
from .router import (NoReplicaAvailable, ReplicaRouter, RoutedGroup,
                     RoutedStream)
from .server import Gateway
from .sse import RowPixelDecoder, iter_sse, sse_event

__all__ = [
    "AdmissionController", "Decision", "SloEstimator", "TenantQuotas",
    "TokenBucket", "Replica", "ReplicaFailure", "ResultStream",
    "GroupStream", "NoReplicaAvailable", "ReplicaRouter",
    "RoutedStream", "RoutedGroup", "Gateway", "RowPixelDecoder", "iter_sse",
    "sse_event",
]
