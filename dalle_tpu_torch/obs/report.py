"""Run summaries from the obs layer's output files.

A copy of ``dalle_tpu/obs/report.py`` (it imports no JAX), so the port's
runs are summarised with the JAX package's sections and verdicts;
``cli/obs_report.py`` is its command line. Two inputs, told apart line by
line:

  * span JSONL (``spans.jsonl`` from ``export_spans_jsonl``): lines with
    ``name``/``dur_s``, aggregated per span name (count, total, mean,
    p50/p99/max), plus the slowest individual spans.
  * metrics JSONL (``MetricsLogger`` records): lines with ``step``, the
    step-time histogram (from ``step_time_s`` when present, else the
    records' timestamps), min/p50/p99, the mean data-starvation ratio, the
    last memory gauge and the MODEL-HEALTH verdict when those columns
    exist.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import List, Optional, Tuple


def load_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def split_rows(rows: List[dict]) -> Tuple[List[dict], List[dict]]:
    """(span rows, metrics rows) — span rows carry dur_s, metrics rows step."""
    spans = [r for r in rows if "dur_s" in r and "name" in r]
    metrics = [r for r in rows if "step" in r and "dur_s" not in r]
    return spans, metrics


def percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return math.nan
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def fmt_num(v, spec: str = ".4g", suffix: str = "") -> str:
    """Render a stat or ``n/a`` — a run with zero completed requests /
    zero steps yields empty sample lists whose percentiles are NaN, and a
    report that prints ``nan`` rates reads like a bug in the report. Every
    formatted stat below routes through this guard."""
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "n/a"
    return f"{v:{spec}}{suffix}"


def ascii_histogram(vals: List[float], bins: int = 10, width: int = 40,
                    unit: str = "s") -> List[str]:
    """Fixed-width ASCII histogram lines (empty input → one 'no data' line)."""
    if not vals:
        return ["(no data)"]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        hi = lo + max(abs(lo), 1e-9)
    edges = [lo + (hi - lo) * i / bins for i in range(bins + 1)]
    counts = [0] * bins
    for v in vals:
        i = min(int((v - lo) / (hi - lo) * bins), bins - 1)
        counts[i] += 1
    peak = max(counts)
    lines = []
    for i, c in enumerate(counts):
        bar = "#" * (round(c / peak * width) if peak else 0)
        lines.append(f"  {edges[i]:>10.4g}–{edges[i + 1]:<10.4g}{unit} "
                     f"|{bar:<{width}} {c}")
    return lines


def span_aggregate(spans: List[dict]) -> List[dict]:
    """Per-name stats sorted by total time descending."""
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(float(s["dur_s"]))
    out = []
    for name, durs in by_name.items():
        durs.sort()
        out.append({"name": name, "count": len(durs), "total_s": sum(durs),
                    "mean_s": sum(durs) / len(durs),
                    "p50_s": percentile(durs, 0.50),
                    "p99_s": percentile(durs, 0.99), "max_s": durs[-1]})
    out.sort(key=lambda r: -r["total_s"])
    return out


def top_slowest(spans: List[dict], k: int = 10) -> List[dict]:
    return sorted(spans, key=lambda s: -float(s["dur_s"]))[:k]


def step_times(metrics: List[dict]) -> List[float]:
    """Per-step seconds: prefer the meter's ``step_time_s`` column, else
    derive from record timestamp/step deltas."""
    direct = [float(r["step_time_s"]) for r in metrics if "step_time_s" in r]
    if direct:
        return direct
    out = []
    rows = sorted((r for r in metrics if "time" in r), key=lambda r: r["step"])
    for a, b in zip(rows, rows[1:]):
        dsteps = b["step"] - a["step"]
        if dsteps > 0:
            out.append((b["time"] - a["time"]) / dsteps)
    return out


def checkpoint_accounting(metrics: List[dict]) -> Optional[dict]:
    """Checkpoint/snapshot pauses as their own category (PR3 host-overlap:
    ``t_ckpt_s`` is the blocking cost fit() paid at a save boundary — the
    device→host snapshot under async saves, snapshot+serialize+write under
    sync). Returns ``None`` when no record carries the column; otherwise
    count/total/max plus the fraction of the measured run the pauses took —
    the "checkpoint-bound" verdict input."""
    ckpt = [float(r["t_ckpt_s"]) for r in metrics if "t_ckpt_s" in r]
    if not ckpt:
        return None
    # the run window: sum of per-record dispatch+wait+sync splits when
    # present, else step_time_s — either way the same records the pauses
    # interleave with
    run_s = 0.0
    for r in metrics:
        if "t_dispatch_s" in r:
            run_s += (float(r.get("t_batch_wait_s", 0)) +
                      float(r["t_dispatch_s"]) + float(r.get("t_sync_s", 0)))
        elif "step_time_s" in r:
            run_s += float(r["step_time_s"])
    total = sum(ckpt)
    return {"count": len(ckpt), "total_s": total, "max_s": max(ckpt),
            "fraction": total / (run_s + total) if run_s + total > 0 else 0.0}


def request_timeline(rows: List[dict], request: str) -> List[dict]:
    """Every span belonging to one request, reassembled into a single
    wall-clock-ordered timeline — the graftscope answer to "where did
    request X spend its 2.1 s". ``request`` matches a span's ``trace_id``
    arg (the propagated identity, obs/context.py) or, for engine-only runs,
    its integer ``request_id``. Spans come from every thread the request
    crossed (gateway connection thread, engine worker, the post-failover
    replica); each entry carries start (absolute + relative to the
    request's first span), duration, name, thread and args."""
    sel = []
    for s in rows:
        args = s.get("args") or {}
        if args.get("trace_id") == request or \
                str(args.get("request_id")) == request:
            sel.append(s)
    sel.sort(key=lambda s: s.get("ts", s.get("rel_s", 0.0)))
    if not sel:
        return []
    t0 = sel[0].get("ts", sel[0].get("rel_s", 0.0))
    out = []
    for s in sel:
        ts = s.get("ts", s.get("rel_s", 0.0))
        out.append({"name": s["name"], "t_rel_s": ts - t0,
                    "dur_s": float(s["dur_s"]), "ts": ts,
                    "tid": s.get("tid"), "args": s.get("args"),
                    # graftlens cross-process join: merged spans carry the
                    # source process plus the clock-mapping uncertainty the
                    # collector estimated for it (obs/collect.py)
                    "proc": s.get("proc"),
                    "clock_bound_s": s.get("clock_bound_s"),
                    "clock_drift": s.get("clock_drift")})
    return out


def format_request_timeline(rows: List[dict], request: str) -> str:
    """Human-readable single-track timeline for ``--request``: one line per
    span, time-ordered, with the start offset, duration, thread and name —
    queue-wait → prefill → per-row decode → SSE flush read top to bottom."""
    tl = request_timeline(rows, request)
    if not tl:
        return f"(no spans found for request {request!r})"
    span_total = sum(e["dur_s"] for e in tl)
    end = max(e["t_rel_s"] + e["dur_s"] for e in tl)
    threads = sorted({str(e["tid"]) for e in tl})
    procs = sorted({str(e["proc"]) for e in tl if e.get("proc")})
    head = (f"== request {request}: {len(tl)} spans across "
            f"{len(threads)} thread(s)")
    if procs:
        # the graftlens headline: one timeline spanning gateway thread →
        # remote replica → failover target, joined across process clocks
        head += f" in {len(procs)} process(es)"
    head += f", wall {end:.4g}s (span time {span_total:.4g}s)"
    lines = [head]
    bounds = [e["clock_bound_s"] for e in tl
              if e.get("clock_bound_s") is not None]
    if bounds:
        note = (f"  (cross-process clocks aligned via RPC offset "
                f"estimation; worst offset bound ±{max(bounds):.4g}s — "
                f"ordering within that window is approximate)")
        if any(e.get("clock_drift") for e in tl):
            note += " [CLOCK DRIFT flagged on ≥1 process]"
        lines.append(note)
    proc_col = f" {'proc':>14} " if procs else " "
    lines.append(f"  {'t+ (s)':>10} {'dur (s)':>10}{proc_col}"
                 f"{'tid':>16}  name")
    for e in tl:
        extra = {k: v for k, v in (e["args"] or {}).items()
                 if k not in ("trace_id", "request_id")}
        pcol = f" {str(e.get('proc') or '-'):>14} " if procs else " "
        lines.append(f"  {e['t_rel_s']:>10.4f} {e['dur_s']:>10.4f}"
                     f"{pcol}{str(e['tid']):>16}  {e['name']}"
                     + (f" {extra}" if extra else ""))
    return "\n".join(lines)


_LABELED_REJECT_RE = re.compile(
    r'^gateway\.rejected_by_total\{(?P<labels>.*)\}$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_FAILOVER_REASON_RE = re.compile(
    r'^gateway\.failover_total\{reason="([^"]+)"\}$')
_FLEET_ACTION_RE = re.compile(r'^fleet\.actions_total\{action="([^"]+)"\}$')


_SLO_BURN_RE = re.compile(r'^slo\.burn_rate\{window="([^"]+)"\}$')
_DEGRADE_ACTION_RE = re.compile(
    r'^degrade\.actions_total\{reason="([^"]+)"\}$')
_DEGRADE_PAGE_RE = re.compile(
    r'^degrade\.pages_total\{reason="([^"]+)"\}$')
_HIST_BUCKET_RE = re.compile(
    r'^(?P<base>[\w.]+)_bucket\{(?:[^}]*,)?le="(?P<le>[^"]+)"(?:,[^}]*)?\}$')
_USAGE_RE = re.compile(
    r'^usage\.(?P<what>\w+)_total\{tenant="(?P<tenant>(?:[^"\\]|\\.)*)"\}$')


def _bucket_quantile(bounds: List[float], cums: List[float],
                     q: float) -> Optional[float]:
    """Quantile by linear interpolation over CUMULATIVE bucket counts —
    the Prometheus ``histogram_quantile`` estimate, computed from the
    flattened ``X_bucket{le=}`` series rather than raw samples (raw
    samples never leave the process; the buckets do). ``bounds`` are the
    finite upper bounds in ascending order and ``cums`` the matching
    cumulative counts with the +Inf count appended last."""
    total = cums[-1]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for i, cum in enumerate(cums):
        if cum >= target:
            if i >= len(bounds):       # landed in the +Inf bucket: the
                return prev_bound      # last finite bound is the floor
            bound = bounds[i]
            if cum <= prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_cum = cum
        if i < len(bounds):
            prev_bound = bounds[i]
    return prev_bound


def histogram_accounting(metrics: List[dict]) -> Optional[List[dict]]:
    """graftlens native histograms → quantiles. Scans metrics records for
    flattened ``X_bucket{le="..."}`` families (obs/trace.py emits them
    cumulatively, so the LAST record carrying a family is its final
    state; fleet-merged snapshots sum bucket-by-bucket upstream of here)
    and renders p50/p95 **from the buckets**, never from raw samples.
    Returns ``None`` when no record carries a bucket key — untouched runs
    keep their report byte-identical."""
    fams: dict = {}               # base -> {le_str: count}
    extras: dict = {}             # base -> {"sum": v, "count": v}
    for r in metrics:
        for key, val in r.items():
            m = _HIST_BUCKET_RE.match(key)
            if m:
                fams.setdefault(m.group("base"), {})[m.group("le")] = \
                    float(val)
    if not fams:
        return None
    for r in metrics:
        for base in fams:
            if f"{base}_sum" in r:
                extras.setdefault(base, {})["sum"] = float(r[f"{base}_sum"])
            if f"{base}_count" in r:
                extras.setdefault(base, {})["count"] = \
                    float(r[f"{base}_count"])
    out = []
    for base in sorted(fams):
        les = fams[base]
        bounds = sorted(float(le) for le in les if le != "+Inf")
        cums = [les[k] for k in sorted(
            (k for k in les if k != "+Inf"), key=float)]
        if "+Inf" in les:
            cums.append(les["+Inf"])
        if not cums:
            continue
        count = extras.get(base, {}).get("count", cums[-1])
        total = extras.get(base, {}).get("sum")
        out.append({
            "name": base, "count": count, "sum": total,
            "mean": (total / count) if total is not None and count else None,
            "p50": _bucket_quantile(bounds, cums, 0.50),
            "p95": _bucket_quantile(bounds, cums, 0.95)})
    return out or None


def usage_accounting(metrics: List[dict]) -> Optional[dict]:
    """Per-tenant usage totals from the graftlens metering counters
    (``usage.{tokens_in,tokens_out,images,queue_wait_s}_total{tenant=}``,
    gateway/server.py ``_meter_usage``). Counters are cumulative, so the
    last value seen per key is the total. ``None`` when no record carries
    a usage key."""
    tenants: dict = {}
    for r in metrics:
        for key, val in r.items():
            m = _USAGE_RE.match(key)
            if m:
                t = tenants.setdefault(m.group("tenant"), {})
                t[m.group("what")] = float(val)
    if not tenants:
        return None
    return {"tenants": tenants}


def telemetry_accounting(metrics: List[dict],
                         spans: List[dict]) -> Optional[dict]:
    """graftlens telemetry-plane health: how many processes contributed
    spans to this report, how many sources the collector polled, and —
    the part that must be LOUD — whether any ring overflowed and dropped
    data (``obs.spans_dropped_total`` / ``obs.events_dropped_total``).
    A lossy plane silently understates everything else in the report, so
    the verdict leads with LOSSY. ``None`` when neither a dropped counter
    nor a merged-span ``proc`` tag nor a collector gauge is present."""
    spans_dropped = events_dropped = 0.0
    sources = None
    for r in metrics:
        if "obs.spans_dropped_total" in r:
            spans_dropped = max(spans_dropped,
                                float(r["obs.spans_dropped_total"]))
        if "obs.events_dropped_total" in r:
            events_dropped = max(events_dropped,
                                 float(r["obs.events_dropped_total"]))
        if "fleet.telemetry_sources" in r:
            sources = float(r["fleet.telemetry_sources"])
    procs = sorted({str(s["proc"]) for s in spans if s.get("proc")})
    if not procs and sources is None and not spans_dropped \
            and not events_dropped:
        return None
    lossy = bool(spans_dropped or events_dropped)
    return {"procs": procs, "sources": sources,
            "spans_dropped": spans_dropped,
            "events_dropped": events_dropped, "lossy": lossy,
            "verdict": "LOSSY" if lossy else "complete"}


def degrade_accounting(metrics: List[dict]) -> Optional[dict]:
    """graftward verdict inputs from the degradation-response counters
    both planes emit (``parallel/elastic.py`` straggler/health-page
    drains, ``fleet/controller.py`` wedge/health drains,
    ``degrade.wedged_total`` self-reports). ``None`` when no record
    carries a degrade key — runs without the response layer keep their
    report unchanged. The verdict names what the ladder DID: ``responded``
    (at least one drain/reshape, with its reasons), ``paged`` (detections
    that never escalated), else ``quiet``."""
    rows = [r for r in metrics if any(k.startswith("degrade.") for k in r)]
    if not rows:
        return None
    last = rows[-1]
    actions, pages = {}, {}
    for key, val in last.items():
        m = _DEGRADE_ACTION_RE.match(key)
        if m:
            actions[m.group(1)] = int(val)
            continue
        m = _DEGRADE_PAGE_RE.match(key)
        if m:
            pages[m.group(1)] = int(val)
    wedged = int(last.get("degrade.wedged_total", 0))
    verdict = ("responded" if actions
               else "paged" if pages or wedged else "quiet")
    return {"actions": actions, "pages": pages, "wedged": wedged,
            "verdict": verdict}


def slo_accounting(metrics: List[dict]) -> Optional[dict]:
    """Burn-rate verdict from the ``slo.*`` gauges the sentry (obs/slo.py)
    publishes into metrics records (the window is a ``{window="5m"}``
    label, not a name fragment). BURNING mirrors the sentry's multi-window
    AND; the dominating window is the highest burn/threshold ratio — the
    one to look at first."""
    slo_rows = [r for r in metrics
                if any(k.startswith("slo.burn_rate") for k in r)]
    if not slo_rows:
        return None
    last = slo_rows[-1]
    windows = []
    for key, val in sorted(last.items()):
        m = _SLO_BURN_RE.match(key)
        if not m:
            continue
        label = m.group(1)
        thresh = float(last.get(
            f'slo.burn_threshold{{window="{label}"}}', 1.0))
        windows.append({"window": label, "burn": float(val),
                        "threshold": thresh,
                        "ratio": float(val) / thresh if thresh else 0.0})
    if not windows:
        return None
    dominating = max(windows, key=lambda w: w["ratio"])
    burning = bool(last.get("slo.burning", 0.0))
    return {"windows": windows, "burning": burning,
            "dominating": dominating["window"],
            "budget": last.get("slo.error_budget")}


def health_accounting(metrics: List[dict]) -> Optional[dict]:
    """graftpulse MODEL-HEALTH verdict inputs from the ``health/*`` columns
    the jitted taps emit and the breach columns the anomaly sentry merges
    in (obs/health.py, obs/anomaly.py). ``None`` when no record carries a
    health column — untapped runs keep their report unchanged.

    The verdict: DEGRADED when any sentry breach was recorded — named with
    the offending detector and layer group — else ok. Alongside it, the
    current operating point: the worst grad-norm group, the latest codebook
    perplexity (+ dead-code fraction), and how many taps were live."""
    h_rows = [r for r in metrics
              if any(k.startswith("health/") for k in r)]
    if not h_rows:
        return None
    cols = set()
    breaches = 0
    detector = group = None
    for r in h_rows:
        cols.update(k for k in r if k.startswith("health/"))
        b = r.get("health/breach")
        if b:
            breaches += int(b)
            detector = r.get("health/breach_detector", detector)
            group = r.get("health/breach_group", group)
    last = h_rows[-1]
    worst_grad = None
    for k, v in last.items():
        if k.startswith("health/grad_norm/") and isinstance(v, (int, float)):
            g = k[len("health/grad_norm/"):]
            if worst_grad is None or v > worst_grad[1]:
                worst_grad = (g, float(v))
    # newest perplexity reading across rows (the save cadence may skip it
    # on the final record)
    perp = dead = None
    for r in reversed(h_rows):
        for k, v in r.items():
            if k.endswith("_perplexity") and k.startswith("health/") \
                    and isinstance(v, (int, float)):
                perp = float(v)
                dead = r.get(k.replace("_perplexity", "_dead_frac"))
                break
        if perp is not None:
            break
    return {"taps": len(cols), "records": len(h_rows),
            "breaches": breaches, "detector": detector, "group": group,
            "worst_grad": worst_grad, "perplexity": perp,
            "dead_frac": dead,
            "verdict": "DEGRADED" if breaches else "ok"}


def gateway_accounting(metrics: List[dict],
                       spans: List[dict]) -> Optional[dict]:
    """Gateway admission/serving health from the obs registry snapshot the
    smoke/CLI writes into the metrics JSONL (``gateway.inflight``, the
    reject counters) plus per-request queue-wait spans. ``None`` when no
    record carries a gateway key — training runs keep their report
    unchanged. The verdict: ADMISSION-LIMITED when the gateway turned
    traffic away (rejects/sheds — capacity, quota or SLO pressure),
    admitting otherwise."""
    gw_rows = [r for r in metrics
               if any(k.startswith("gateway.") for k in r)]
    if not gw_rows:
        return None
    last = gw_rows[-1]
    by_tenant: dict = {}
    for key, val in last.items():
        m = _LABELED_REJECT_RE.match(key)
        if m:
            labels = dict(_LABEL_RE.findall(m.group("labels")))
            tenant = labels.get("tenant")
            if tenant:
                by_tenant[tenant] = by_tenant.get(tenant, 0) + int(val)
        elif key.startswith("gateway.") and key.endswith(".rejected_total"):
            # pre-graftscope artifacts mangled the tenant into the name
            tenant = key[len("gateway."):-len(".rejected_total")]
            if tenant:            # "gateway.rejected_total" is the fleet sum
                by_tenant[tenant] = int(val)
    qwaits = sorted(float(s["dur_s"]) for s in spans
                    if s.get("name") == "serve/request_queue_wait")
    rejected = float(last.get("gateway.rejected_total", 0))
    shed = float(last.get("gateway.shed_total", 0))
    # failover attribution (graftfleet): the labeled
    # gateway.failover_total{reason=} family names WHY each failover
    # happened — worker_death / unhealthy_timeout / conn_reset / drain /
    # health_page / decode_degraded /
    # conn_timeout — alongside the stable unlabeled total
    failover_reasons = {}
    for key, val in last.items():
        m = _FAILOVER_REASON_RE.match(key)
        if m:
            failover_reasons[m.group(1)] = int(val)
    return {
        "inflight": float(last.get("gateway.inflight", 0)),
        "rejected": rejected,
        "by_tenant": by_tenant,
        "shed": shed,
        "failovers": float(last.get("gateway.failovers_total", 0)),
        "failover_reasons": failover_reasons,
        "qwait_p50_s": percentile(qwaits, 0.5) if qwaits else None,
        "qwait_p95_s": percentile(qwaits, 0.95) if qwaits else None,
        "verdict": ("ADMISSION-LIMITED" if rejected + shed > 0
                    else "admitting"),
    }


def fleet_accounting(metrics: List[dict]) -> Optional[dict]:
    """graftfleet verdict inputs from the gauges/counters the controller
    publishes every tick (fleet/controller.py): fleet size, warm pool,
    the ``fleet.actions_total{action=}`` decision counters and the
    ``fleet.state`` posture gauge (0 steady / 1 scaling / 2 draining).
    ``None`` when no record carries a fleet key — single-process serving
    keeps its report unchanged."""
    # fleet.telemetry_sources is the graftlens collector's gauge, not a
    # controller signal — alone it must not conjure an empty fleet section
    rows = [r for r in metrics
            if any(k.startswith("fleet.")
                   and k != "fleet.telemetry_sources" for k in r)]
    if not rows:
        return None
    last = rows[-1]
    actions = {}
    for key, val in last.items():
        m = _FLEET_ACTION_RE.match(key)
        if m:
            actions[m.group(1)] = int(val)
    state = float(last.get("fleet.state", 0.0))
    verdict = ("draining" if state == 2.0 else
               "scaling" if state == 1.0 else "steady")
    return {"size": last.get("fleet.size"),
            "warm": last.get("fleet.warm_pool"),
            "actions": actions, "verdict": verdict}


def images_accounting(metrics: List[dict],
                      spans: List[dict]) -> Optional[dict]:
    """graftloom /v1/images product-loop health from the
    ``gateway.images_*`` counters plus the pipeline stage spans. ``None``
    when no record carries an images counter — token-only serving keeps its
    report unchanged. The verdict names whether the rerank stage actually
    ran: candidates decoded but never scored usually means the operator
    forgot ``--clip_path``."""
    img_rows = [r for r in metrics
                if any(k.startswith("gateway.images_") for k in r)]
    if not img_rows:
        return None
    last = img_rows[-1]
    shared = [s for s in spans
              if s.get("name") == "pipeline/prefill_shared"]
    saved = sum(max(int((s.get("args") or {}).get("candidates", 1)) - 1, 0)
                for s in shared)
    dec = sorted(float(s["dur_s"]) for s in spans
                 if s.get("name") == "pipeline/decode_pixels")
    rer = sorted(float(s["dur_s"]) for s in spans
                 if s.get("name") == "pipeline/rerank")
    reranked = float(last.get("gateway.images_reranked_total", 0))
    return {
        "requests": float(last.get("gateway.images_requests_total", 0)),
        "candidates": float(last.get("gateway.images_candidates_total", 0)),
        "reranked": reranked,
        "shared_prefills": len(shared),
        "prefills_saved": saved,
        "decode_p50_s": percentile(dec, 0.5) if dec else None,
        "rerank_p50_s": percentile(rer, 0.5) if rer else None,
        "verdict": ("RERANKING" if reranked > 0 else "tokens-only"),
    }


def paged_kv_accounting(metrics: List[dict],
                        spans: List[dict]) -> Optional[dict]:
    """graftpage paged-KV health from the ``kv.*`` page-pool gauges +
    prefix-hit counter and the mode-tagged ``serve/prefill`` spans. ``None``
    when no record carries a kv key — dense-slab serving keeps its report
    unchanged. The radix hit rate is per ADMISSION (spans tagged paged-hit /
    paged-partial over all paged prefill spans); ``hit_tokens`` is the
    prompt-KV compute the cache actually skipped. The verdict names whether
    the prefix cache earned its pool: prefix-sharing when any admission
    mapped resident blocks, cold otherwise — a persistently cold cache on
    repeated-prompt traffic usually means the pool is sized with zero
    residency headroom (every resident evicted before its repeat arrives)."""
    kv_rows = [r for r in metrics if any(k.startswith("kv.") for k in r)]
    if not kv_rows:
        return None
    last = kv_rows[-1]
    modes = {"paged-hit": 0, "paged-partial": 0, "paged": 0}
    for s in spans:
        mode = (s.get("args") or {}).get("mode")
        if mode in modes:
            modes[mode] += 1
    admissions = sum(modes.values())
    hits = modes["paged-hit"] + modes["paged-partial"]
    hit_tokens = float(last.get("kv.prefix_hit_tokens_total", 0))
    return {
        "pages_free": float(last.get("kv.pages_free", 0)),
        "pages_used": float(last.get("kv.pages_used", 0)),
        "pages_shared": float(last.get("kv.pages_shared", 0)),
        "cow_copies": float(last.get("kv.pages_cow_copies", 0)),
        "hit_tokens": hit_tokens,
        "admissions": admissions,
        "full_hits": modes["paged-hit"],
        "partial_hits": modes["paged-partial"],
        "hit_rate": (hits / admissions) if admissions else None,
        "verdict": ("prefix-sharing" if hit_tokens > 0 else "cold"),
    }


def format_report(rows: List[dict], *, topk: int = 10) -> str:
    spans, metrics = split_rows(rows)
    lines: List[str] = []
    if metrics:
        st = step_times(metrics)
        # per-record wall from the breakdown columns, split into clean steps
        # vs checkpoint-boundary steps (t_ckpt_s > 0) so a handful of save
        # pauses can't smear the whole histogram — "checkpoint-bound" is a
        # verdict, not a mystery tail
        bd = [(float(r.get("t_batch_wait_s", 0)) + float(r["t_dispatch_s"]) +
               float(r.get("t_sync_s", 0)), float(r.get("t_ckpt_s", 0.0)))
              for r in metrics if "t_dispatch_s" in r]
        ckpt_steps = [t + c for t, c in bd if c > 0]
        if ckpt_steps:
            st = [t for t, c in bd if c == 0]
        lines.append(f"== step time ({len(st)} samples over "
                     f"{len(metrics)} metric records"
                     + (f"; {len(ckpt_steps)} checkpoint-boundary steps "
                        f"split out below" if ckpt_steps else "") + ")")
        if st:
            ss = sorted(st)
            lines.append(
                f"  min={fmt_num(ss[0], suffix='s')} "
                f"p50={fmt_num(percentile(ss, .5), suffix='s')} "
                f"p99={fmt_num(percentile(ss, .99), suffix='s')} "
                f"max={fmt_num(ss[-1], suffix='s')}")
        else:
            # zero steps (e.g. a serve-only or empty-metrics run): say so
            # instead of histogramming nothing into NaN stats
            lines.append("  (no step samples — n/a)")
        lines.extend(ascii_histogram(st))
        if ckpt_steps:
            cs = sorted(ckpt_steps)
            lines.append(
                f"== checkpoint-boundary steps (step + blocking save cost): "
                f"n={len(cs)} p50={percentile(cs, .5):.4g}s max={cs[-1]:.4g}s")
        starv = [float(r["data_starvation"]) for r in metrics
                 if "data_starvation" in r]
        if starv:
            mean_starv = sum(starv) / len(starv)
            verdict = ("INPUT-BOUND" if mean_starv > 0.5 else
                       "input-pressured" if mean_starv > 0.2 else
                       "compute-bound")
            lines.append(f"== data starvation: mean={mean_starv:.2%} "
                         f"max={max(starv):.2%} → {verdict}")
        ck = checkpoint_accounting(metrics)
        if ck is not None:
            verdict = ("CHECKPOINT-BOUND" if ck["fraction"] > 0.2 else
                       "checkpoint-pressured" if ck["fraction"] > 0.05 else
                       "checkpoint-overlapped")
            lines.append(
                f"== checkpoint pauses: {ck['count']} saves, "
                f"total={ck['total_s']:.4g}s max={ck['max_s']:.4g}s "
                f"({ck['fraction']:.2%} of measured time) → {verdict}")
        h2d = [float(r["t_h2d_s"]) for r in metrics if "t_h2d_s" in r]
        if any(h2d):
            sh = sorted(h2d)
            lines.append(f"== h2d enqueue: mean={sum(h2d) / len(h2d):.4g}s "
                         f"p99={percentile(sh, .99):.4g}s (overlapped via "
                         f"device prefetch)")
        inflight = [r["ckpt.write_inflight"] for r in metrics
                    if "ckpt.write_inflight" in r]
        if inflight:
            lines.append(f"== async ckpt writes: in-flight gauge last="
                         f"{inflight[-1]:.0f} "
                         f"(records with a write overlapping: "
                         f"{sum(1 for v in inflight if v):d})")
        hbm = [r["hbm_bytes_in_use"] for r in metrics
               if "hbm_bytes_in_use" in r]
        if hbm:
            lines.append(f"== hbm in use: last={hbm[-1] / 2**20:.1f}MiB "
                         f"peak_seen={max(hbm) / 2**20:.1f}MiB")
        rec = [r["recompiles_per_100_steps"] for r in metrics
               if "recompiles_per_100_steps" in r]
        if rec and rec[-1] > 0:
            lines.append(f"== WARNING: still compiling — "
                         f"{rec[-1]:.1f} recompiles/100 steps at last poll")
        if any(r.get("mfu_estimated") for r in metrics):
            lines.append("== NOTE: mfu is ESTIMATED (unknown accelerator "
                         "peak-flops — see train/metrics.py PEAK_TFLOPS)")
        gw = gateway_accounting(metrics, spans)
        if gw is not None:
            lines.append(
                f"== gateway: inflight={gw['inflight']:.0f} "
                f"rejected={gw['rejected']:.0f}"
                + (f" (by tenant: {gw['by_tenant']})" if gw["by_tenant"]
                   else "")
                + (f" shed={gw['shed']:.0f}" if gw["shed"] else "")
                + (f" failovers={gw['failovers']:.0f}" if gw["failovers"]
                   else "")
                + (f" (by reason: {gw['failover_reasons']})"
                   if gw["failover_reasons"] else "")
                + f"; queue wait p50={fmt_num(gw['qwait_p50_s'], suffix='s')}"
                  f" p95={fmt_num(gw['qwait_p95_s'], suffix='s')}"
                + f" → {gw['verdict']}")
        hg = histogram_accounting(metrics)
        if hg is not None:
            lines.append(f"== latency histograms (graftlens): "
                         f"{len(hg)} native families — quantiles from "
                         f"buckets, not raw samples")
            for h in hg:
                lines.append(
                    f"  {h['name']:<28} n={h['count']:<7.0f}"
                    f" mean={fmt_num(h['mean'], suffix='s')}"
                    f" p50={fmt_num(h['p50'], suffix='s')}"
                    f" p95={fmt_num(h['p95'], suffix='s')}")
        us = usage_accounting(metrics)
        if us is not None:
            lines.append(f"== usage metering (graftlens): "
                         f"{len(us['tenants'])} tenant(s) → USAGE: metered")
            lines.append(f"  {'tenant':<16}{'tokens_in':>11}"
                         f"{'tokens_out':>12}{'images':>8}"
                         f"{'queue_wait_s':>14}")
            for tenant in sorted(us["tenants"]):
                t = us["tenants"][tenant]
                lines.append(
                    f"  {tenant:<16}{t.get('tokens_in', 0):>11.0f}"
                    f"{t.get('tokens_out', 0):>12.0f}"
                    f"{t.get('images', 0):>8.0f}"
                    f"{t.get('queue_wait_s', 0):>14.4g}")
        im = images_accounting(metrics, spans)
        if im is not None:
            parts = [f"{im['requests']:.0f} requests, "
                     f"{im['candidates']:.0f} candidates"]
            if im["shared_prefills"]:
                parts.append(f"shared prefills {im['shared_prefills']} "
                             f"(saved {im['prefills_saved']})")
            if im["decode_p50_s"] is not None:
                parts.append("decode p50="
                             + fmt_num(im["decode_p50_s"], suffix="s"))
            if im["rerank_p50_s"] is not None:
                parts.append("rerank p50="
                             + fmt_num(im["rerank_p50_s"], suffix="s"))
            verdict = ("IMAGES: RERANKING" if im["verdict"] == "RERANKING"
                       else "IMAGES: tokens-only (no reranker scored)")
            lines.append("== images product loop (graftloom): "
                         + ", ".join(parts) + f" → {verdict}")
        pk = paged_kv_accounting(metrics, spans)
        if pk is not None:
            parts = [f"pool {pk['pages_used']:.0f} used / "
                     f"{pk['pages_free']:.0f} free"]
            if pk["pages_shared"]:
                parts.append(f"{pk['pages_shared']:.0f} shared")
            if pk["cow_copies"]:
                parts.append(f"{pk['cow_copies']:.0f} COW copies")
            if pk["hit_rate"] is not None:
                parts.append(
                    f"radix hit-rate {pk['hit_rate']:.0%} over "
                    f"{pk['admissions']} admissions "
                    f"({pk['full_hits']} full, {pk['partial_hits']} partial)")
            parts.append(f"{pk['hit_tokens']:.0f} prompt tokens served "
                         "from cache")
            verdict = ("PAGED-KV: prefix-sharing"
                       if pk["verdict"] == "prefix-sharing"
                       else "PAGED-KV: cold (no prefix reuse — check pool "
                            "residency headroom)")
            lines.append("== paged KV (graftpage): " + ", ".join(parts)
                         + f" → {verdict}")
        fl = fleet_accounting(metrics)
        if fl is not None:
            parts = []
            if fl["size"] is not None:
                parts.append(f"size={fl['size']:.0f}")
            if fl["warm"] is not None:
                parts.append(f"warm={fl['warm']:.0f}")
            if fl["actions"]:
                parts.append(f"actions {fl['actions']}")
            lines.append("== fleet (graftfleet): " + ", ".join(parts)
                         + f" → FLEET: {fl['verdict']}")
        dg = degrade_accounting(metrics)
        if dg is not None:
            parts = []
            if dg["pages"]:
                parts.append(f"pages {dg['pages']}")
            if dg["actions"]:
                parts.append(f"actions {dg['actions']}")
            if dg["wedged"]:
                parts.append(f"wedge self-reports {dg['wedged']}")
            verdict = ("DEGRADE: responded "
                       f"({', '.join(sorted(dg['actions']))})"
                       if dg["verdict"] == "responded"
                       else "DEGRADE: paged (no action)"
                       if dg["verdict"] == "paged" else "DEGRADE: quiet")
            lines.append("== degradation response (graftward): "
                         + (", ".join(parts) if parts else "no events")
                         + f" → {verdict}")
        slo = slo_accounting(metrics)
        if slo is not None:
            wtxt = " ".join(f"{w['window']}={w['burn']:.3g}x"
                            f"(thr {w['threshold']:.3g}x)"
                            for w in slo["windows"])
            lines.append(
                f"== slo burn rate: {wtxt} → "
                + (f"BURNING (dominating window {slo['dominating']})"
                   if slo["burning"] else "ok"))
        hl = health_accounting(metrics)
        if hl is not None:
            parts = [f"{hl['taps']} taps over {hl['records']} records"]
            if hl["worst_grad"] is not None:
                parts.append(f"worst grad_norm {hl['worst_grad'][0]}="
                             f"{fmt_num(hl['worst_grad'][1])}")
            if hl["perplexity"] is not None:
                dtxt = (f" (dead {hl['dead_frac']:.0%})"
                        if isinstance(hl["dead_frac"], (int, float)) else "")
                parts.append(
                    f"codebook perplexity {fmt_num(hl['perplexity'])}{dtxt}")
            verdict = ("MODEL-HEALTH: DEGRADED "
                       f"({hl['detector']} in {hl['group']}; "
                       f"{hl['breaches']} breach"
                       f"{'es' if hl['breaches'] != 1 else ''})"
                       if hl["verdict"] == "DEGRADED" else "MODEL-HEALTH: ok")
            lines.append("== model health (graftpulse): "
                         + ", ".join(parts) + f" → {verdict}")
    tel = telemetry_accounting(metrics, spans)
    if tel is not None:
        parts = []
        if tel["procs"]:
            parts.append(f"spans from {len(tel['procs'])} process(es)")
        if tel["sources"] is not None:
            parts.append(f"{tel['sources']:.0f} source(s) polled")
        if tel["lossy"]:
            # a callout that must be impossible to miss: a ring
            # overflowed, so every count above this line is a FLOOR
            lines.append(
                f"== WARNING: TELEMETRY LOSSY — "
                f"spans_dropped={tel['spans_dropped']:.0f} "
                f"events_dropped={tel['events_dropped']:.0f} "
                f"(ring overflow: raise capacity or shorten the flush "
                f"interval; counts in this report are floors)")
        lines.append("== telemetry plane (graftlens): "
                     + (", ".join(parts) if parts else "no sources")
                     + f" → TELEMETRY: {tel['verdict']}")
    if spans:
        lines.append(f"== spans by total time ({len(spans)} spans)")
        lines.append(f"  {'name':<32}{'count':>7}{'total_s':>10}{'mean_s':>10}"
                     f"{'p50_s':>10}{'p99_s':>10}{'max_s':>10}")
        for r in span_aggregate(spans)[:topk]:
            lines.append(f"  {r['name']:<32}{r['count']:>7}"
                         f"{r['total_s']:>10.4g}{r['mean_s']:>10.4g}"
                         f"{r['p50_s']:>10.4g}{r['p99_s']:>10.4g}"
                         f"{r['max_s']:>10.4g}")
        lines.append(f"== top {topk} slowest individual spans")
        for s in top_slowest(spans, topk):
            args = f" {s['args']}" if s.get("args") else ""
            lines.append(f"  {s['dur_s']:>10.4g}s  {s['name']}"
                         f" (tid {s.get('tid', '?')}){args}")
    if not lines:
        lines.append("(no span or metrics records found)")
    return "\n".join(lines)


def summarize_run(path: str, *, topk: int = 10) -> str:
    """Summarize a file or a run directory (picks up ``spans.jsonl`` and
    ``metrics.jsonl``/``*.jsonl`` inside a directory)."""
    paths: List[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".jsonl"):
                paths.append(os.path.join(path, name))
        if not paths:
            return f"(no .jsonl files under {path})"
    else:
        paths = [path]
    rows: List[dict] = []
    for p in paths:
        rows.extend(load_jsonl(p))
    header = "grafttrace report: " + ", ".join(os.path.basename(p)
                                               for p in paths)
    return header + "\n" + format_report(rows, topk=topk)


def span_overhead_s(samples: int = 10000) -> float:
    """Measured per-span cost (enter+exit) with tracing in its CURRENT state
    — the number behind the '<1% of step time' acceptance gate (the CI smoke
    multiplies this by the spans-per-step count)."""
    import time
    from .trace import span
    t0 = time.perf_counter()
    for _ in range(samples):
        with span("obs/overhead_probe"):
            pass
    return (time.perf_counter() - t0) / samples
