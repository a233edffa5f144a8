"""The port's obs layer ≡ the JAX package's (CPU).

The same sequence of calls goes into ``dalle_tpu.obs`` and
``dalle_tpu_torch.obs``: nested spans with args under a trace context,
labelled counters, gauges, histograms with default and custom buckets,
retrospective spans, events, state providers and a flight-recorder bundle.
The metrics snapshots are equal dicts and the Prometheus textfiles equal
bytes (exemplar timestamps pinned); ``spans.jsonl`` rows agree on ``name``,
``depth`` and ``args`` with the same field set; the Chrome traces' events
carry the same fields; the JAX package's ``obs.report.format_report`` gives
the same sections for either run's rows. ``decode_quality`` against the
JAX package's on f32 and bf16 logits and with ``topk`` > V: entropy within
rtol 1e-5, ``topk_mass`` within atol 1e-6.
"""

import json
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu import obs as jobs
from dalle_tpu.obs import report as jreport
from dalle_tpu.obs.health import decode_quality as jdecode_quality
from dalle_tpu_torch import obs as tobs

TRACE_ID = "feedface00000001"


@pytest.fixture
def both():
    for o in (jobs, tobs):
        o.disable()
        o.disable_recorder()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.disable_recorder()
        for name in ("serve.engine[test]", "broken"):
            o.unregister_state_provider(name)


def _drive(o, outdir):
    """One fixed sequence of obs calls; returns what it observed on the way."""
    o.configure(capacity=512)
    o.configure_recorder(str(outdir), capacity=8, min_dump_interval_s=60.0)
    seen = {}
    with o.trace_context(TRACE_ID):
        with o.span("fit/step", step=3) as sp:
            sp.set(extra=1)
            with o.span("fit/dispatch", kind="k"):
                seen["open"] = sorted(v for v in o.open_spans().values())
            sp.set(late=True)
        o.record_span("serve/request", time.perf_counter() - 0.01, 0.01,
                      request_id=1, tokens=4, entropy=1.25)
    o.record_span("serve/request_ttft", time.perf_counter() - 0.02, 0.02,
                  request_id=1, trace_id="abc")

    @o.span("data/decode", shard=2)
    def deco(x):
        return x + 1
    seen["deco"] = deco(1)
    o.counter_add("serve.tokens_emitted_total", 3.0)
    o.counter_add("serve.tokens_emitted_total", 2.0)
    o.counter_add("gateway.rejected_by_total", 1.0,
                  labels={"tenant": "t1", "reason": 'quota "x"\n'})
    o.counter_add("gateway.rejected_by_total", 1.0,
                  labels={"reason": 'quota "x"\n', "tenant": "t1"})
    o.gauge_set("kv.pages_free", 12)
    o.gauge_set("pipeline.queue_depth", 2, labels={"stage": "rerank"})
    o.gauge_set("health.decode_entropy", 3.5)
    for v in (0.0004, 0.02, 0.3, 3.0, 50.0):
        o.histogram_observe("serve.ttft_seconds", v, trace_id="t%g" % v)
    with o.trace_context(TRACE_ID):
        for v in (0.05, 0.5, 5.0):
            o.histogram_observe("serve.decode_row_seconds", v,
                                buckets=(0.1, 1.0), labels={"stage": "x"})
    with pytest.raises(ValueError, match="not sorted"):
        o.histogram_observe("bad.seconds", 1.0, buckets=(1.0, 0.1))
    with pytest.raises(ValueError, match="MAX_HISTOGRAM_BUCKETS"):
        o.histogram_observe("big.seconds", 1.0,
                            buckets=tuple(range(o.MAX_HISTOGRAM_BUCKETS + 1)))
    for i in range(10):                           # 2 past the ring of 8
        o.record_event("request_admitted", slot=i % 2, request_id=i)
    o.register_state_provider("serve.engine[test]", lambda: {"queue_depth": 1, "inflight": []})
    o.register_state_provider("broken", lambda: 1 // 0)
    seen["state"] = o.collect_state()
    seen["bundle"] = o.dump_recorder("test", extra={"why": "parity"}, force=True)
    seen["suppressed"] = o.dump_recorder("test")
    o.counter_add("serve.tokens_emitted_total", 1.0)
    seen["bundle2"] = o.dump_recorder("other")
    o.export_spans_jsonl(str(outdir / "spans.jsonl"))
    o.export_chrome_trace(str(outdir / "trace.json"), request_tracks=True)
    seen["metrics"] = o.metrics_snapshot()
    seen["exemplars"] = o.exemplars_snapshot()
    seen["events"] = o.get_recorder().snapshot_events()
    return seen


def _pinned(exemplars):
    return {k: (tid, v, 0.0) for k, (tid, v, _ts) in exemplars.items()}


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_obs_layer_matches_jax(tmp_path, both):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _drive(jobs, tmp_path / "j")
    t = _drive(tobs, tmp_path / "t")
    assert t["deco"] == j["deco"] == 2
    assert t["open"] == j["open"] == [["fit/step", "fit/dispatch"]]
    assert t["state"] == j["state"]
    assert t["state"]["broken"].startswith("<provider error: ZeroDivisionError")
    assert t["metrics"] == j["metrics"]
    assert t["metrics"]["obs.events_dropped_total"] == 2.0
    assert {k: (a, b) for k, (a, b, _) in t["exemplars"].items()} == {
        k: (a, b) for k, (a, b, _) in j["exemplars"].items()}
    for pin in (False, True):
        jt = jobs.render_textfile(j["metrics"], timestamp=1.0,
                                  exemplars=_pinned(j["exemplars"]) if pin else None)
        tt = tobs.render_textfile(t["metrics"], timestamp=1.0,
                                  exemplars=_pinned(t["exemplars"]) if pin else None)
        assert tt.encode() == jt.encode()
    assert 'le="+Inf"' in tt and '# {trace_id="' in tt
    jw = jobs.write_textfile(str(tmp_path / "j" / "m.prom"), {"a.b_total": 1, "c": 2.5})
    tw = tobs.write_textfile(str(tmp_path / "t" / "m.prom"), {"a.b_total": 1, "c": 2.5})
    assert jw.splitlines()[1:] == tw.splitlines()[1:]
    # events: the same kinds and fields, the oldest two dropped
    assert [{k: v for k, v in e.items() if k != "t"} for e in t["events"]] == [
        {k: v for k, v in e.items() if k != "t"} for e in j["events"]]
    assert t["suppressed"] is None and j["suppressed"] is None
    for name in ("bundle", "bundle2"):
        jb = json.load(open(os.path.join(j[name], "postmortem.json")))
        tb = json.load(open(os.path.join(t[name], "postmortem.json")))
        assert sorted(tb) == sorted(jb)
        for key in ("reason", "events_dropped", "state", "metrics",
                    "metrics_delta_since_last_dump", "extra"):
            assert tb.get(key) == jb.get(key), key
        assert os.path.exists(os.path.join(t[name], "trace.json"))
    assert not [n for n in os.listdir(tmp_path / "t") if n.startswith(".tmp-")]
    # spans.jsonl
    jr, tr = _jsonl(tmp_path / "j" / "spans.jsonl"), _jsonl(tmp_path / "t" / "spans.jsonl")
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    assert [(r["name"], r["depth"], r.get("args")) for r in tr] == [
        (r["name"], r["depth"], r.get("args")) for r in jr]
    assert tr[1]["args"] == {"step": 3, "extra": 1, "late": True, "trace_id": TRACE_ID}
    # the Chrome trace, request tracks included
    je = json.load(open(tmp_path / "j" / "trace.json"))
    te = json.load(open(tmp_path / "t" / "trace.json"))
    assert sorted(te) == sorted(je) and sorted(te["metadata"]) == sorted(je["metadata"])
    assert len(te["traceEvents"]) == len(je["traceEvents"])
    for a, b in zip(te["traceEvents"], je["traceEvents"]):
        assert sorted(a) == sorted(b) and a["ph"] == b["ph"] and a.get("name") == b.get("name")
        strip = lambda d: {k: v for k, v in (d or {}).items() if k != "source_tid"}  # noqa: E731
        assert strip(a.get("args")) == strip(b.get("args"))
    assert any(e["ph"] == "M" and e["args"]["name"] == f"request {TRACE_ID}"
               for e in te["traceEvents"])


def _sections(report: str):
    """The report's section headers, numbers stripped."""
    heads = [ln.split(":")[0].split("(")[0] for ln in report.splitlines()
             if ln.startswith("==")]
    return [re.sub(r"[0-9.]+", "#", h).strip() for h in heads]


def test_report_reads_the_ports_files_like_jax(tmp_path, both):
    """Spans and a metrics record of one serving-shaped sequence, written by
    either layer, give ``format_report`` the same sections."""
    sections = {}
    for name, o in (("j", jobs), ("t", tobs)):
        (tmp_path / name).mkdir()
        _drive(o, tmp_path / name)
        t0 = time.perf_counter()
        for rid in range(3):
            for span_name, extra in (("serve/request_queue_wait", {}),
                                     ("serve/prefill", {"mode": "paged-hit" if rid else "paged"}),
                                     ("serve/decode_row", {"row": 0}),
                                     ("serve/request", {"tokens": 16}),
                                     ("serve/request_ttft", {})):
                o.record_span(span_name, t0 + rid * 0.01, 0.005, request_id=rid,
                              trace_id=f"r{rid}", **extra)
        for v in (0.01, 0.2):
            o.histogram_observe("serve.queue_wait_seconds", v)
        o.counter_add("kv.prefix_hit_tokens_total", 64.0)
        o.gauge_set("kv.pages_used", 5.0)
        path = str(tmp_path / name / "spans.jsonl")
        o.export_spans_jsonl(path)
        rows = jreport.load_jsonl(path)
        rows.append({"step": 1, "time": 0.0, **o.metrics_snapshot()})
        sections[name] = _sections(jreport.format_report(rows))
    assert sections["t"] == sections["j"]
    assert len(sections["t"]) >= 4


def test_disabled_layer_is_a_noop(tmp_path, both):
    with tobs.span("x") as sp:
        pass
    tobs.counter_add("c_total")
    tobs.gauge_set("g", 1.0)
    tobs.histogram_observe("h", 1.0)
    tobs.record_span("r", 0.0, 1.0)
    tobs.record_event("e")
    assert sp.duration is None and tobs.metrics_snapshot() == {}
    assert tobs.dump_recorder("x") is None and tobs.get_tracer() is None
    assert tobs.export_spans_jsonl(str(tmp_path / "s.jsonl")) == 0
    assert not tobs.enabled()
    # a resize keeps the newest spans, as in the JAX package
    tr = tobs.configure(capacity=4)
    for i in range(6):
        with tobs.span(f"s{i}"):
            pass
    tobs.configure(capacity=2)
    assert [r[0] for r in tr.snapshot_spans()] == ["s4", "s5"] and tr.dropped == 2
    assert tobs.split_health_key("health/grad_norm/gen/encoder") == ("grad_norm", "gen/encoder")
    assert tobs.split_health_key("loss") is None


@pytest.mark.parametrize("dtype,topk", [("float32", 32), ("bfloat16", 32), ("float32", 100)],
                         ids=["f32", "bf16", "topk_over_vocab"])
def test_decode_quality_matches_jax(dtype, topk):
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((6, 48)) * 3).astype(np.float32)
    x[1] *= 20                                        # a peaked row
    x[2] = 0.0                                        # a flat row
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jnp.asarray(jx, jnp.float32)), tx.float().numpy())
    want = {k: np.asarray(v) for k, v in jdecode_quality(jx, topk=topk).items()}
    got = {k: v.numpy() for k, v in tobs.decode_quality(tx, topk=topk).items()}
    assert all(v.dtype == np.float32 and v.shape == (6,) for v in got.values())
    np.testing.assert_allclose(got["entropy"], want["entropy"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["topk_mass"], want["topk_mass"], rtol=0, atol=1e-6)
    if topk > 48:
        np.testing.assert_allclose(got["topk_mass"], 1.0, atol=1e-6)
