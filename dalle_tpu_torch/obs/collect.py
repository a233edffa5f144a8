"""The fleet telemetry plane: one export path per process, one merge point.

A copy of ``dalle_tpu/obs/collect.py`` (it imports no JAX), with the same
file layout, payload fields and metric names, so a port replica's
telemetry and a JAX replica's merge alike:

  * ``TelemetryExporter``: a daemon thread in each replica process that
    atomically rewrites a telemetry dir (``spans.jsonl``, ``metrics.json``,
    ``events.jsonl``, ``meta.json``, each via tmp + ``os.replace``), a valid
    post-mortem even after a SIGKILL.
  * ``telemetry_payload``: the same data over the live socket (the
    ``telemetry`` verb of ``fleet/transport.py``), with a span cursor
    (``since_seq``) so repeated pulls ship only new spans.
  * ``ClockOffsetEstimator``: the remote clock's offset from the RPC
    timestamps each heartbeat already has, bounded by ± RTT/2; the tightest
    sample wins, and a disjoint later sample flags drift.
  * ``TelemetryCollector``: the gateway's merge point. Sources (an RPC
    fetch, a telemetry dir, or both) are polled; spans are mapped into the
    local clock and tagged with their process; ``fleet_metrics()`` sums
    remote counters and histogram buckets into the local snapshot and
    labels remote gauges ``{replica="..."}`` under a cardinality cap.
  * ``UsageLedger``: the per-tenant metering log, append-only JSONL with
    atomic size-based rotation, behind the ``usage.*_total{tenant=}``
    counters.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional

from .recorder import get_recorder

# Gauges from at most this many replicas get their own {replica=} series;
# sources beyond the cap still contribute to summed counters but not to
# labeled gauges — fleet size must never grow scrape cardinality unbounded.
MAX_REPLICA_LABELS = 32

_SPANS_FILE = "spans.jsonl"
_METRICS_FILE = "metrics.json"
_EVENTS_FILE = "events.jsonl"
_META_FILE = "meta.json"


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def _merge_label(key: str, label: str, value: str) -> str:
    """Fold one more ``label="value"`` into a registry key's (possibly
    absent) label block, keeping the sorted-keys canonical spelling."""
    from .trace import _label_escape
    item = f'{label}="{_label_escape(value)}"'
    base, brace, rest = key.partition("{")
    if not brace:
        return f"{base}{{{item}}}"
    items = rest[:-1].split(",")
    items.append(item)
    items.sort()
    return f"{base}{{{','.join(items)}}}"


def _span_rows_to_json(tracer, rows) -> List[dict]:
    out = []
    for name, rel, dur, tid, depth, args in rows:
        rec = {"name": name, "ts": tracer.epoch_origin + rel, "rel_s": rel,
               "dur_s": dur, "tid": tid, "depth": depth}
        if args:
            rec["args"] = args
        out.append(rec)
    return out


def telemetry_payload(since_seq: int = 0, *, events_limit: int = 512) -> dict:
    """Build one telemetry flush for the current process: spans recorded
    after ``since_seq`` (absolute wall-clock ``ts``, sender's clock), the
    full metrics snapshot (histograms arrive pre-flattened), the recorder's
    lifecycle-event ring, and ``server_time`` for clock-offset estimation.
    This is both the ``telemetry`` RPC verb's reply body and the exporter's
    on-disk schema."""
    from . import trace
    tr = trace.get_tracer()
    payload = {
        "ok": True,
        "server_time": time.time(),
        "pid": os.getpid(),
        "seq": since_seq,
        "spans": [],
        "metrics": trace.metrics_snapshot(),
    }
    if tr is not None:
        seq, rows = tr.spans_since(since_seq)
        payload["seq"] = seq
        payload["spans"] = _span_rows_to_json(tr, rows)
        payload["spans_dropped"] = tr.dropped
    rec = get_recorder()
    if rec is not None:
        events = rec.snapshot_events()
        payload["events"] = events[-events_limit:]
        payload["events_dropped"] = rec.events_dropped
    return payload


class ClockOffsetEstimator:
    """Remote-clock offset from RPC request/response timestamp triples.

    One exchange gives ``t0`` (local send), ``server_time`` (remote clock
    somewhere inside the exchange), ``t1`` (local receive): the remote
    reading happened within ``[t0, t1]`` on the local clock, so
    ``offset = server_time - (t0 + t1) / 2`` is wrong by at most
    ``(t1 - t0) / 2``. The estimator keeps the tightest-bound sample as the
    working offset. A later sample whose confidence interval is DISJOINT
    from the best one means the remote clock stepped (or the estimate is
    stale beyond its bound): ``drift_flagged`` latches True and the
    estimator re-anchors on the new sample — merged timelines stay
    honest about their error bar instead of silently lying about order.

    Lock-free on purpose: the single ``_best`` tuple is assigned atomically
    (heartbeat thread writes, collector thread reads a snapshot), so this
    adds no edge to the lock-order graph.
    """

    def __init__(self):
        self.samples = 0
        self.drift_flagged = False
        self._best: Optional[tuple] = None   # (offset_s, bound_s)

    def observe(self, t0: float, server_time: float, t1: float) -> None:
        rtt = t1 - t0
        if rtt < 0:
            return
        offset = server_time - (t0 + t1) / 2.0
        bound = rtt / 2.0
        self.samples += 1
        best = self._best
        if best is not None and abs(offset - best[0]) > bound + best[1]:
            self.drift_flagged = True
            self._best = (offset, bound)     # re-anchor on the step
        elif best is None or bound < best[1]:
            self._best = (offset, bound)

    @property
    def offset(self) -> float:
        """Best estimate of (remote clock - local clock), seconds."""
        best = self._best
        return best[0] if best is not None else 0.0

    @property
    def bound(self) -> Optional[float]:
        """Half-RTT uncertainty of the working offset (None = no samples)."""
        best = self._best
        return best[1] if best is not None else None

    def to_local(self, remote_ts: float) -> float:
        """Map a remote wall-clock timestamp into the local timebase."""
        return remote_ts - self.offset


class TelemetryExporter:
    """Periodic atomic flush of this process's telemetry to a directory.

    Every ``interval_s`` the daemon thread rewrites the whole state
    (full span ring, metrics snapshot, recorder events, meta) — each file
    via tmp + ``os.replace``, so a reader never sees a torn file and a
    SIGKILL between flushes costs at most one interval of telemetry, never
    the whole process's history. That kill-survivability is why the dir
    channel exists alongside the RPC verb.
    """

    def __init__(self, outdir: str, *, interval_s: float = 0.25,
                 proc: str = "", start: bool = True):
        self.outdir = outdir
        self.interval_s = float(interval_s)
        self.proc = proc or f"pid-{os.getpid()}"
        self.flushes = 0
        os.makedirs(outdir, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flush()
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="graftlens-exporter", daemon=True)
            self._thread.start()

    def flush(self) -> None:
        """One atomic rewrite of the telemetry dir (also called on close
        and usable standalone when the thread is not wanted)."""
        payload = telemetry_payload(0)
        spans = "".join(json.dumps(r) + "\n" for r in payload["spans"])
        events = "".join(json.dumps(e) + "\n"
                         for e in payload.get("events", ()))
        meta = {
            "proc": self.proc,
            "pid": payload["pid"],
            "server_time": payload["server_time"],
            "seq": payload["seq"],
            "spans_dropped": payload.get("spans_dropped", 0),
            "events_dropped": payload.get("events_dropped", 0),
            "flushes": self.flushes,
        }
        _atomic_write(os.path.join(self.outdir, _SPANS_FILE), spans)
        _atomic_write(os.path.join(self.outdir, _EVENTS_FILE), events)
        _atomic_write(os.path.join(self.outdir, _METRICS_FILE),
                      json.dumps(payload["metrics"]))
        _atomic_write(os.path.join(self.outdir, _META_FILE),
                      json.dumps(meta))
        self.flushes += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush()
            except OSError:
                # a full/unwritable disk must degrade telemetry, not the
                # process being observed; the next flush retries
                continue

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        try:
            self.flush()
        except OSError:
            pass


def read_telemetry_dir(path: str) -> Optional[dict]:
    """Read one exporter dir back into payload form (None when the dir has
    no meta yet). Atomic per-file replace means each file is internally
    consistent; ``meta`` carries the process identity."""
    meta_path = os.path.join(path, _META_FILE)
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return None
    payload = {"ok": True, "pid": meta.get("pid"),
               "server_time": meta.get("server_time"),
               "seq": meta.get("seq", 0), "meta": meta,
               "spans": [], "events": [], "metrics": {},
               "spans_dropped": meta.get("spans_dropped", 0),
               "events_dropped": meta.get("events_dropped", 0)}
    for name, key in ((_SPANS_FILE, "spans"), (_EVENTS_FILE, "events")):
        try:
            with open(os.path.join(path, name)) as fh:
                payload[key] = [json.loads(line) for line in fh if line.strip()]
        except (OSError, ValueError):
            pass
    try:
        with open(os.path.join(path, _METRICS_FILE)) as fh:
            payload["metrics"] = json.load(fh)
    except (OSError, ValueError):
        pass
    return payload


class _Source:
    __slots__ = ("proc", "fetch", "path", "clock", "seq", "spans",
                 "metrics", "events", "pid", "last_ok", "errors")

    def __init__(self, proc, fetch, path, clock):
        self.proc = proc
        self.fetch = fetch
        self.path = path
        self.clock = clock
        self.seq = 0
        self.spans: List[dict] = []
        self.metrics: dict = {}
        self.events: List[dict] = []
        self.pid = None
        self.last_ok = None
        self.errors = 0


class TelemetryCollector:
    """Gateway-side merge point for per-process telemetry.

    A source is registered per replica process with an RPC ``fetch``
    callable (``RemoteReplica.fetch_telemetry``), a telemetry ``path``
    (the exporter dir — readable after SIGKILL), or both, plus the
    replica's ``ClockOffsetEstimator``. ``poll()`` refreshes every source;
    ``merged_spans()`` returns one offset-corrected, process-tagged,
    wall-clock-sorted span list; ``fleet_metrics()`` folds remote metric
    snapshots into the local one.

    Span-channel rule: a source with a ``path`` takes its spans from the
    dir (the dir is a whole-ring atomic snapshot, so it simply *replaces*
    that source's span set — no dedup bookkeeping, and the SIGKILL case is
    identical to the healthy case); a fetch-only source accumulates spans
    incrementally via the ``since_seq`` cursor. The RPC channel always
    refreshes metrics/events when it is available, since it is fresher
    than the last dir flush.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict = {}

    def add_source(self, proc: str, *,
                   fetch: Optional[Callable] = None,
                   path: Optional[str] = None,
                   clock: Optional[ClockOffsetEstimator] = None) -> None:
        """Register (or re-register, e.g. after a replica restart) one
        process. ``proc`` is the stable display identity (replica id)."""
        with self._lock:
            prev = self._sources.get(proc)
            src = _Source(proc, fetch, path, clock)
            if prev is not None and prev.path == path:
                src.seq, src.spans = prev.seq, prev.spans
                src.metrics, src.events = prev.metrics, prev.events
                src.pid = prev.pid
            self._sources[proc] = src

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def poll(self) -> int:
        """Refresh every source; returns how many answered (RPC) or had a
        readable dir this round. A dead source keeps its last telemetry —
        that retention is the point: the killed replica's spans must still
        appear in the merged timeline."""
        with self._lock:
            sources = list(self._sources.values())
        ok = 0
        for src in sources:
            fresh = False
            if src.fetch is not None:
                try:
                    payload = src.fetch(src.seq)
                except Exception:  # noqa: BLE001 - a telemetry pull from a dying replica must never propagate into serving; the dir channel below still covers it
                    payload = None
                    src.errors += 1
                if payload and payload.get("ok"):
                    src.seq = int(payload.get("seq", src.seq))
                    src.pid = payload.get("pid", src.pid)
                    src.metrics = dict(payload.get("metrics") or {})
                    src.events = list(payload.get("events") or [])
                    if src.path is None:
                        src.spans.extend(payload.get("spans") or [])
                    fresh = True
            if src.path is not None:
                payload = read_telemetry_dir(src.path)
                if payload is not None:
                    src.pid = payload.get("pid", src.pid)
                    src.spans = list(payload.get("spans") or [])
                    if not fresh:   # RPC copy (when live) is fresher
                        src.metrics = dict(payload.get("metrics") or {})
                        src.events = list(payload.get("events") or [])
                    fresh = True
            if fresh:
                ok += 1
                src.last_ok = time.time()
        return ok

    def merged_spans(self, *, include_local: bool = True,
                     local_proc: str = "gateway") -> List[dict]:
        """One wall-clock-ordered span list across every process. Remote
        timestamps are mapped into the local timebase via each source's
        offset estimate; every row gains ``proc``/``pid`` plus
        ``clock_bound_s`` (the offset uncertainty — order between spans
        closer than this is not meaningful) and ``clock_drift`` when the
        estimator saw a step."""
        rows: List[dict] = []
        if include_local:
            from . import trace
            tr = trace.get_tracer()
            if tr is not None:
                for rec in _span_rows_to_json(tr, tr.snapshot_spans()):
                    rec["proc"] = local_proc
                    rec["pid"] = os.getpid()
                    rows.append(rec)
        with self._lock:
            sources = list(self._sources.values())
        for src in sources:
            clock = src.clock
            for rec in src.spans:
                rec = dict(rec)
                rec["proc"] = src.proc
                if src.pid is not None:
                    rec["pid"] = src.pid
                if clock is not None and clock.samples:
                    rec["ts"] = clock.to_local(rec["ts"])
                    rec["clock_bound_s"] = clock.bound
                    if clock.drift_flagged:
                        rec["clock_drift"] = True
                rows.append(rec)
        rows.sort(key=lambda r: r.get("ts", 0.0))
        return rows

    def export_merged_jsonl(self, path: str, **kw) -> int:
        rows = self.merged_spans(**kw)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_write(path, "".join(json.dumps(r) + "\n" for r in rows))
        return len(rows)

    def fleet_metrics(self, local: Optional[dict] = None) -> dict:
        """Fleet-aggregated snapshot: start from the local process's
        metrics, then fold in every source — counter families
        (``*_total``, histogram ``*_bucket``/``*_sum``/``*_count``) are
        SUMMED across processes (which merges native histograms bucket-by-
        bucket for free), gauges get a ``{replica="<proc>"}`` label, capped
        at ``MAX_REPLICA_LABELS`` sources (beyond the cap a replica still
        sums into counters — cardinality stays bounded by construction)."""
        if local is None:
            from . import trace
            local = trace.metrics_snapshot()
        out = dict(local)
        with self._lock:
            sources = [s for s in self._sources.values() if s.metrics]
        sources.sort(key=lambda s: s.proc)
        out["fleet.telemetry_sources"] = float(len(sources))
        for i, src in enumerate(sources):
            label_gauges = i < MAX_REPLICA_LABELS
            for key, value in src.metrics.items():
                if not isinstance(value, (int, float)) \
                        or isinstance(value, bool):
                    continue
                family = key.partition("{")[0]
                if (family.endswith(("_total", "_sum", "_count", "_bucket"))):
                    out[key] = out.get(key, 0) + value
                elif label_gauges:
                    out[_merge_label(key, "replica", src.proc)] = value
        return out


class UsageLedger:
    """Append-only per-tenant metering log with atomic rotation.

    One JSON object per line: ``{"ts": ..., "tenant": ..., "kind":
    "generate"|"images", "trace_id": ..., "tokens_in": ..., "tokens_out":
    ..., "images": ..., "queue_wait_s": ...}``. When the live file would
    exceed ``max_bytes`` it is rotated (``usage.jsonl`` →
    ``usage.jsonl.1`` → ... up to ``keep``) via ``os.replace``, so a
    billing scraper never sees a torn or half-rotated file. The ledger is
    the durable, replayable record; the ``usage.*_total{tenant=}``
    counters next to it are the live aggregate view.
    """

    def __init__(self, path: str, *, max_bytes: int = 4 << 20,
                 keep: int = 3):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self.records = 0
        self.rotations = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    def _rotate(self) -> None:
        for i in range(self.keep - 1, 0, -1):
            older, newer = f"{self.path}.{i + 1}", f"{self.path}.{i}"
            if os.path.exists(newer):
                os.replace(newer, older)
        os.replace(self.path, f"{self.path}.1")
        self._size = 0
        self.rotations += 1

    def append(self, record: dict) -> None:
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._size and self._size + len(line) > self.max_bytes:
                self._rotate()
            with open(self.path, "a") as fh:
                fh.write(line)
            self._size += len(line)
            self.records += 1
