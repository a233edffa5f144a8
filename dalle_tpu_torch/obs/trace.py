"""Spans, counters, gauges and histograms in one process-wide ring.

A copy of ``dalle_tpu/obs/trace.py`` (it imports no JAX), with the same
names, metric spellings and file formats, so the JAX package's
``obs/report.py`` reads the port's files as it reads its own:

  * ``span(name)``: a context manager or decorator timing a named region,
    with thread-local nesting. Off (the default) it costs one global
    ``None`` check; on, two ``perf_counter`` calls and one deque append.
  * a bounded ring of completed spans (overflow is counted) that exports
    JSONL (one span a line) and Chrome ``trace_event`` JSON for Perfetto.
  * process-wide counters, gauges and native histograms (fixed buckets,
    one exemplar a bucket) that flatten into one metrics dict and the
    Prometheus textfile (``obs/prometheus.py``).

Spans timed on the host time the host: a region that launches work on the
card ends before the card does unless its caller synchronises (the model
wrapper does so inside ``decode/generate_tokens`` when tracing is on).
Spans from several threads keep their own stacks; ``open_spans()`` shows
the live stacks.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from .context import current_trace_id

_TLS = threading.local()
_STACKS: dict = {}          # thread ident -> (thread name, open-span stack)
_tracer: Optional["Tracer"] = None

# bucket boundaries are declared at the call site (or defaulted), never
# taken from the data, and capped
MAX_HISTOGRAM_BUCKETS = 32
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt_le(bound: float) -> str:
    return format(bound, "g")


def _bucket_key(key: str, le: str) -> str:
    """Flat registry key of one cumulative bucket: ``name_bucket{le="x"}``,
    the ``le`` merged into a labelled histogram's sorted label block."""
    base, brace, rest = key.partition("{")
    if not brace:
        return f'{base}_bucket{{le="{le}"}}'
    items = rest[:-1].split(",")
    items.append(f'le="{le}"')
    items.sort()
    return f'{base}_bucket{{{",".join(items)}}}'


class _Histogram:
    """One native histogram: fixed boundaries, per-bucket counts, sum and
    count, and the latest (trace_id, value, ts) exemplar a bucket."""

    __slots__ = ("buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.exemplars: dict = {}                     # bucket idx -> exemplar


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = []
        _TLS.stack = s
        _STACKS[threading.get_ident()] = (threading.current_thread().name, s)
    return s


class Tracer:
    """Process-wide span sink: a bounded ring of completed spans plus
    counter, gauge and histogram maps. Span records are tuples
    ``(name, rel_start_s, dur_s, thread_ident, depth, args)`` relative to
    ``t_origin`` (a ``perf_counter`` anchor paired with the wall-clock
    ``epoch_origin``)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.spans: deque = deque(maxlen=capacity)
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}   # labelled name -> _Histogram
        self.dropped = 0          # spans evicted from the ring
        self.total_recorded = 0   # monotonic span count
        self._lock = threading.Lock()
        self.t_origin = time.perf_counter()
        self.epoch_origin = time.time()

    def _record(self, name, t0, dur, depth, args):
        # locked: exports iterate the deque from other threads
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.total_recorded += 1
            self.spans.append((name, t0 - self.t_origin, dur,
                               threading.get_ident(), depth, args))

    def snapshot_spans(self) -> list:
        with self._lock:
            return list(self.spans)

    def spans_since(self, since_seq: int = 0):
        """Incremental read: ``(cursor, rows)``, the span tuples recorded
        after ``since_seq`` and the cursor to pass next time. Spans that
        left the ring before a read are gone (counted in ``dropped``)."""
        with self._lock:
            total = self.total_recorded
            rows = list(self.spans)
        first_seq = total - len(rows) + 1
        skip = max(0, since_seq - first_seq + 1)
        return total, rows[skip:]

    def snapshot_metrics(self) -> dict:
        """Counters, gauges and flattened histograms as one flat dict:
        cumulative ``name_bucket{le="b"}`` counters plus ``name_sum`` and
        ``name_count``, the Prometheus native-histogram spelling."""
        with self._lock:
            out = dict(self.counters)
            out.update(self.gauges)
            for key, h in self.histograms.items():
                running = 0
                for i, bound in enumerate(h.buckets):
                    running += h.counts[i]
                    out[_bucket_key(key, _fmt_le(bound))] = float(running)
                out[_bucket_key(key, "+Inf")] = float(h.count)
                out[f"{key}_sum"] = h.sum
                out[f"{key}_count"] = float(h.count)
        if self.dropped:
            out["obs.spans_dropped"] = self.dropped
            out["obs.spans_dropped_total"] = float(self.dropped)
        return out

    def snapshot_exemplars(self) -> dict:
        """The latest (trace_id, value, unix_ts) exemplar a histogram
        bucket, under the flat bucket key of ``snapshot_metrics``."""
        out = {}
        with self._lock:
            for key, h in self.histograms.items():
                for idx, ex in h.exemplars.items():
                    le = (_fmt_le(h.buckets[idx]) if idx < len(h.buckets)
                          else "+Inf")
                    out[_bucket_key(key, le)] = ex
        return out


class span:
    """Time a named region: ``with span("fit/step"): ...`` or
    ``@span("data/decode")``. Keyword args become the span's args in the
    export; ``sp.set(...)`` adds more from inside. ``sp.duration`` holds
    the seconds after exit (None when tracing was off at entry)."""

    __slots__ = ("name", "args", "duration", "_t0", "_stack")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args or None
        self.duration = None

    def set(self, **args) -> "span":
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self) -> "span":
        if _tracer is None:
            self._t0 = None
            return self
        s = _stack()
        s.append(self)
        self._stack = s
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *_exc) -> bool:
        t1 = time.perf_counter()
        if self._t0 is None:
            return False
        s = self._stack
        if s and s[-1] is self:
            s.pop()
        self.duration = t1 - self._t0
        tr = _tracer
        if tr is not None:
            # a span recorded under a request's trace_context carries its
            # trace_id; an explicit trace_id arg wins
            tid = current_trace_id()
            if tid is not None:
                if self.args is None:
                    self.args = {"trace_id": tid}
                else:
                    self.args.setdefault("trace_id", tid)
            tr._record(self.name, self._t0, self.duration, len(s), self.args)
        return False

    def __call__(self, fn):
        name, args = self.name, self.args

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name, **(args or {})):
                return fn(*a, **kw)

        return wrapped


# ---------------------------------------------------------------------------
# module-level API
# ---------------------------------------------------------------------------

def configure(capacity: int = 65536) -> Tracer:
    """Turn tracing on. A live tracer is kept (its ring accumulates until
    ``disable()``); a changed ``capacity`` resizes the ring in place,
    keeping the newest spans."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(capacity)
    elif capacity != _tracer.capacity:
        with _tracer._lock:
            _tracer.spans = deque(_tracer.spans, maxlen=capacity)
            _tracer.capacity = capacity
    return _tracer


def disable() -> None:
    """Turn tracing off and drop the ring."""
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def _label_escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def labeled_name(name: str, labels: Optional[dict]) -> str:
    """Registry key of a labelled series: ``name{k="v",...}`` with sorted
    keys and escaped values, so equal labels in any order are one series."""
    if not labels:
        return name
    items = ",".join(f'{k}="{_label_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{items}}}"


def counter_add(name: str, value: float = 1.0,
                labels: Optional[dict] = None) -> None:
    tr = _tracer
    if tr is None:
        return
    name = labeled_name(name, labels)
    with tr._lock:
        tr.counters[name] = tr.counters.get(name, 0) + value


def gauge_set(name: str, value: float,
              labels: Optional[dict] = None) -> None:
    tr = _tracer
    if tr is None:
        return
    name = labeled_name(name, labels)
    with tr._lock:
        tr.gauges[name] = float(value)


def histogram_observe(name: str, value: float,
                      buckets: Optional[tuple] = None,
                      labels: Optional[dict] = None,
                      trace_id: Optional[str] = None) -> None:
    """Observe one sample into a native histogram. ``buckets`` fixes the
    boundaries at the first observation (default ``DEFAULT_BUCKETS``;
    sorted, at most ``MAX_HISTOGRAM_BUCKETS``). The sample's trace_id
    (explicit, else the thread's) becomes its bucket's exemplar. No-op when
    tracing is off."""
    tr = _tracer
    if tr is None:
        return
    if trace_id is None:
        trace_id = current_trace_id()
    key = labeled_name(name, labels)
    value = float(value)
    with tr._lock:
        h = tr.histograms.get(key)
        if h is None:
            bounds = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
            if len(bounds) > MAX_HISTOGRAM_BUCKETS:
                raise ValueError(
                    f"histogram {name!r}: {len(bounds)} buckets exceeds "
                    f"MAX_HISTOGRAM_BUCKETS={MAX_HISTOGRAM_BUCKETS}")
            if list(bounds) != sorted(bounds):
                raise ValueError(f"histogram {name!r}: buckets not sorted")
            h = tr.histograms[key] = _Histogram(bounds)
        idx = len(h.buckets)
        for i, bound in enumerate(h.buckets):
            if value <= bound:
                idx = i
                break
        h.counts[idx] += 1
        h.sum += value
        h.count += 1
        if trace_id is not None:
            h.exemplars[idx] = (trace_id, value, time.time())


def metrics_snapshot() -> dict:
    """Current counters, gauges and histograms ({} when tracing is off);
    the flight recorder's ring overflow rides along as
    ``obs.events_dropped_total``."""
    tr = _tracer
    if tr is None:
        return {}
    out = tr.snapshot_metrics()
    from .recorder import get_recorder   # lazy: recorder imports us in dump()
    rec = get_recorder()
    if rec is not None and rec.events_dropped:
        out["obs.events_dropped_total"] = float(rec.events_dropped)
    return out


def exemplars_snapshot() -> dict:
    """Current histogram exemplars ({} when tracing is off)."""
    tr = _tracer
    return tr.snapshot_exemplars() if tr is not None else {}


def record_span(name: str, start_perf_s: float, duration_s: float,
                **args) -> None:
    """Record a completed span after the fact: for regions that overlap
    in one thread (one span per in-flight request) and so cannot keep the
    per-thread stack discipline. ``start_perf_s`` is a
    ``time.perf_counter()`` reading taken at the region's start; the
    record lands in the same ring at depth 0. Inherits the thread's
    trace_id unless one is passed. No-op when tracing is off."""
    tr = _tracer
    if tr is None:
        return
    tid = current_trace_id()
    if tid is not None and "trace_id" not in args:
        args["trace_id"] = tid
    tr._record(name, start_perf_s, duration_s, 0, args or None)


def open_spans() -> dict:
    """Live per-thread open-span stacks, outermost first:
    ``{"MainThread:140..": ["fit/step", "fit/dispatch"], ...}``."""
    out = {}
    for ident, (tname, stack) in list(_STACKS.items()):
        names = [sp.name for sp in list(stack)]
        if names:
            out[f"{tname}:{ident}"] = names
    return out


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def export_spans_jsonl(path: str, tracer: Optional[Tracer] = None) -> int:
    """Write the ring as JSONL, one span a line with absolute ``ts`` (unix
    seconds), ``rel_s``, ``dur_s``, thread id, depth and args. Returns the
    number of spans written."""
    tr = tracer or _tracer
    if tr is None:
        return 0
    rows = tr.snapshot_spans()
    with open(path, "w") as fh:
        for name, rel, dur, tid, depth, args in rows:
            rec = {"name": name, "ts": tr.epoch_origin + rel, "rel_s": rel,
                   "dur_s": dur, "tid": tid, "depth": depth}
            if args:
                rec["args"] = args
            fh.write(json.dumps(rec) + "\n")
    return len(rows)


def export_chrome_trace(path: str, tracer: Optional[Tracer] = None, *,
                        request_tracks: bool = False) -> int:
    """Write the ring as Chrome ``trace_event`` JSON (complete "X" events,
    microsecond timestamps) for Perfetto or chrome://tracing. Returns the
    number of events written.

    ``request_tracks=True`` adds one timeline row per trace_id under a
    synthetic "requests" process, holding that request's spans from every
    thread it crossed, beside the real per-thread rows."""
    tr = tracer or _tracer
    if tr is None:
        return 0
    pid = os.getpid()
    events = []
    rows = tr.snapshot_spans()
    for name, rel, dur, tid, depth, args in rows:
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": rel * 1e6, "dur": dur * 1e6}
        if args:
            ev["args"] = dict(args)
        events.append(ev)
    if request_tracks:
        # synthetic process 1: one virtual tid per trace_id, named after it
        track_ids: dict = {}
        events.append({"ph": "M", "pid": 1, "tid": 0,
                       "name": "process_name",
                       "args": {"name": "requests (graftscope)"}})
        for name, rel, dur, tid, depth, args in rows:
            trace_id = (args or {}).get("trace_id")
            if trace_id is None:
                continue
            vtid = track_ids.get(trace_id)
            if vtid is None:
                vtid = track_ids[trace_id] = len(track_ids) + 1
                events.append({"ph": "M", "pid": 1, "tid": vtid,
                               "name": "thread_name",
                               "args": {"name": f"request {trace_id}"}})
            events.append({"name": name, "ph": "X", "pid": 1, "tid": vtid,
                           "ts": rel * 1e6, "dur": dur * 1e6,
                           "args": dict(args, source_tid=tid)})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": {"epoch_origin": tr.epoch_origin,
                        "spans_dropped": tr.dropped}}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(events)
