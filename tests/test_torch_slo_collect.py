"""The port's SLO sentry and fleet telemetry plane ≡ the JAX package's (CPU).

Pure host logic on scripted inputs with an injected clock, no JAX compile:
``BurnRateSentry`` gives the JAX sentry's verdicts and ``slo.*`` gauges on
the same outcome streams; ``window_label`` the same labels;
``ClockOffsetEstimator`` the same offsets, bounds and drift flags;
``TelemetryExporter``'s directory reads back through either package's
``read_telemetry_dir`` alike; ``telemetry_payload``'s span cursor the same
rows; ``TelemetryCollector`` the same merged spans across skewed clocks and
the same ``fleet_metrics``; ``UsageLedger`` the same files and rotations.
Both packages' metrics registries are on for each test and off after.
"""

import json
import os

import pytest

from dalle_tpu import obs as jobs
from dalle_tpu.obs import collect as jcollect
from dalle_tpu.obs import slo as jslo
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.obs import collect as tcollect
from dalle_tpu_torch.obs import slo as tslo


@pytest.fixture
def tracers():
    jobs.disable()
    tobs.disable()
    jt, tt = jobs.configure(capacity=256), tobs.configure(capacity=256)
    yield jt, tt
    jobs.disable()
    tobs.disable()


def _slo_only(snap):
    return {k: v for k, v in snap.items() if k.startswith("slo.")}


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# (seconds between outcomes, outcome) streams: a sudden outage, a slow leak
# below the short window's gate, an outage that ends, too few events for a
# verdict, and custom windows with a labelled outcome mix
SLO_CASES = {
    "outage": dict(kw={}, stream=[(1.0, True)] * 20 + [(0.5, False)] * 30),
    "slow_leak": dict(kw={}, stream=[(10.0, i % 40 != 0) for i in range(400)]),
    "recovered": dict(kw={}, stream=[(0.5, False)] * 30 + [(5.0, True)] * 120),
    "cold": dict(kw={"min_events": 50}, stream=[(0.1, False)] * 20),
    "custom_windows": dict(
        kw={"objective": 0.99, "windows": ((60.0, 2.0), (90.0, 1.5), (7200.0, 3.0))},
        stream=[(0.7, i % 3 != 0) for i in range(200)]),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_burn_rate_sentry_matches_jax(tracers, case):
    spec = SLO_CASES[case]
    breaches = {"jax": [], "torch": []}
    jc, tc = _Clock(), _Clock()
    js = jslo.BurnRateSentry(clock=jc, on_breach=breaches["jax"].append, **spec["kw"])
    ts = tslo.BurnRateSentry(clock=tc, on_breach=breaches["torch"].append, **spec["kw"])
    reasons = ("quota", "deadline_shed", "replica_failed")
    for i, (dt, good) in enumerate(spec["stream"]):
        jc.t += dt
        tc.t += dt
        reason = "" if good else reasons[i % 3]
        js.record(good, reason)
        ts.record(good, reason)
        if i % 7 == 0:
            assert ts.evaluate() == js.evaluate()
    assert ts.evaluate(jc.t + 30.0) == js.evaluate(jc.t + 30.0)
    assert (ts.burning, ts.breaches, ts.good_total, ts.bad_total) == (
        js.burning, js.breaches, js.good_total, js.bad_total)
    assert breaches["torch"] == breaches["jax"]
    assert _slo_only(tobs.metrics_snapshot()) == _slo_only(jobs.metrics_snapshot())


@pytest.mark.parametrize("seconds", [30.0, 60.0, 300.0, 3600.0, 7200.0, 90.0, 5400.0])
def test_window_label_matches_jax(seconds):
    assert tslo.window_label(seconds) == jslo.window_label(seconds)


CLOCK_CASES = {
    "symmetric": [(100.0, 105.0, 100.010)],
    "tightest_kept": [(100.0, 105.0, 100.010), (200.0, 205.0, 200.100)],
    "step_flags_drift": [(100.0, 105.0, 100.010), (300.0, 320.0, 300.010)],
    "negative_rtt": [(100.0, 105.0, 99.0)],
    "tighter_later": [(1.0, 3.0, 1.5), (2.0, 4.1, 2.1), (5.0, 7.05, 5.02)],
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
def test_clock_offset_estimator_matches_jax(case):
    je, te = jcollect.ClockOffsetEstimator(), tcollect.ClockOffsetEstimator()
    for t0, server, t1 in CLOCK_CASES[case]:
        je.observe(t0, server, t1)
        te.observe(t0, server, t1)
        assert (te.samples, te.drift_flagged, te.offset, te.bound) == (
            je.samples, je.drift_flagged, je.offset, je.bound)
        assert te.to_local(1234.5) == je.to_local(1234.5)


def test_exporter_dir_reads_back_alike(tmp_path, tracers):
    """The port's exporter dir through both readers, and the JAX exporter's
    through both: the same payloads (the on-disk schema is shared)."""
    for name in ("a", "b", "c"):
        with tobs.span(f"port/{name}", k=1):
            pass
        with jobs.span(f"jax/{name}", k=1):
            pass
    tobs.counter_add("serve.requests_completed_total", 2.0)
    jobs.counter_add("serve.requests_completed_total", 2.0)
    tobs.configure_recorder(str(tmp_path / "trec"))
    jobs.configure_recorder(str(tmp_path / "jrec"))
    try:
        tobs.record_event("replica_spawned", replica_id="r1")
        jobs.record_event("replica_spawned", replica_id="r1")
        te = tcollect.TelemetryExporter(str(tmp_path / "t"), proc="r1", start=False)
        je = jcollect.TelemetryExporter(str(tmp_path / "j"), proc="r1", start=False)
        te.close()
        je.close()
    finally:
        tobs.disable_recorder()
        jobs.disable_recorder()
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for d in ("t", "j"):
        got = tcollect.read_telemetry_dir(str(tmp_path / d))
        want = jcollect.read_telemetry_dir(str(tmp_path / d))
        assert got == want
    t = tcollect.read_telemetry_dir(str(tmp_path / "t"))
    j = jcollect.read_telemetry_dir(str(tmp_path / "j"))
    assert [s["name"].split("/")[1] for s in t["spans"]] == [
        s["name"].split("/")[1] for s in j["spans"]]
    assert set(t["spans"][0]) == set(j["spans"][0])
    assert t["meta"].keys() == j["meta"].keys() and t["meta"]["flushes"] == 1
    assert [e["kind"] for e in t["events"]] == [e["kind"] for e in j["events"]]
    assert t["metrics"] == j["metrics"]
    assert tcollect.read_telemetry_dir(str(tmp_path / "missing")) is None


def test_telemetry_payload_cursor_matches_jax(tracers):
    for i in range(5):
        tobs.record_span("s", 0.0, 0.1, i=i)
        jobs.record_span("s", 0.0, 0.1, i=i)
    for cursor in (0, 2, 5, 9):
        t, j = tcollect.telemetry_payload(cursor), jcollect.telemetry_payload(cursor)
        assert t.keys() == j.keys() and t["seq"] == j["seq"]
        assert [(s["name"], s["args"]) for s in t["spans"]] == [
            (s["name"], s["args"]) for s in j["spans"]]


def _source_dir(dirpath, proc, spans, metrics=None):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "spans.jsonl"), "w") as fh:
        fh.writelines(json.dumps(s) + "\n" for s in spans)
    with open(os.path.join(dirpath, "metrics.json"), "w") as fh:
        json.dump(metrics or {}, fh)
    open(os.path.join(dirpath, "events.jsonl"), "w").close()
    with open(os.path.join(dirpath, "meta.json"), "w") as fh:
        json.dump({"proc": proc, "pid": 1, "server_time": 0.0, "seq": len(spans),
                   "spans_dropped": 0, "events_dropped": 0, "flushes": 1}, fh)


def _collectors(tmp_path, with_clock):
    """The same three sources (two dirs, one of them 50 s ahead, and one
    RPC fetch) registered with each package's collector."""
    _source_dir(tmp_path / "A", "A", [
        {"name": "a1", "ts": 1000.0, "dur_s": 0.1, "tid": 1, "depth": 0,
         "args": {"trace_id": "t1"}},
        {"name": "a2", "ts": 1000.4, "dur_s": 0.1, "tid": 1, "depth": 0}],
        {"serve.requests_completed_total": 1.0, "serve.queue_depth": 2.0})
    _source_dir(tmp_path / "B", "B", [
        {"name": "b1", "ts": 1050.2, "dur_s": 0.1, "tid": 2, "depth": 0}])

    def fetch(since_seq):
        return {"ok": True, "seq": since_seq + 1, "pid": 7,
                "metrics": {"serve.requests_completed_total": 3.0,
                            'serve.ttft_seconds_bucket{le="0.1"}': 4.0,
                            "serve.queue_depth": 5.0, "label": "skip"},
                "spans": [{"name": f"c{since_seq}", "ts": 1000.3 + since_seq,
                           "dur_s": 0.0, "tid": 3, "depth": 0}]}
    out = []
    for mod in (jcollect, tcollect):
        coll = mod.TelemetryCollector()
        clock = mod.ClockOffsetEstimator()
        clock.observe(999.0, 1049.0005, 999.001)
        coll.add_source("A", path=str(tmp_path / "A"))
        coll.add_source("B", path=str(tmp_path / "B"), clock=clock if with_clock else None)
        coll.add_source("C", fetch=fetch)
        out.append(coll)
    return out


@pytest.mark.parametrize("with_clock", [True, False])
def test_collector_merge_and_fleet_metrics_match_jax(tmp_path, tracers, with_clock):
    jc, tc = _collectors(tmp_path, with_clock)
    for _ in range(2):
        assert tc.poll() == jc.poll() == 3
    assert tc.sources() == jc.sources()
    got = tc.merged_spans(include_local=False)
    assert got == jc.merged_spans(include_local=False)
    assert [r["name"] for r in got][:2] == (["a1", "b1"] if with_clock else ["a1", "c0"])
    tobs.counter_add("serve.requests_completed_total", 1.0)
    tobs.gauge_set("serve.queue_depth", 3.0)
    jobs.counter_add("serve.requests_completed_total", 1.0)
    jobs.gauge_set("serve.queue_depth", 3.0)
    assert tc.fleet_metrics() == jc.fleet_metrics()
    local = {"x_total": 1.0, "g": 2.0}
    assert tc.fleet_metrics(local) == jc.fleet_metrics(local)
    out = str(tmp_path / "merged" / "spans.jsonl")
    assert tc.export_merged_jsonl(out, include_local=False) == len(got)


def test_dead_rpc_source_keeps_its_last_telemetry_alike():
    calls = {"n": 0}

    def flaky(since_seq):
        calls["n"] += 1
        if calls["n"] > 2:
            raise OSError("replica gone")
        return {"ok": True, "seq": calls["n"], "pid": 3, "metrics": {"m_total": 1.0},
                "spans": [{"name": "s", "ts": 1.0, "dur_s": 0.0}]}
    colls = []
    for mod in (jcollect, tcollect):
        calls["n"] = 0
        coll = mod.TelemetryCollector()
        coll.add_source("r", fetch=flaky)
        polls = [coll.poll() for _ in range(2)]
        calls["n"] = 2
        polls.append(coll.poll())
        colls.append((polls, coll.merged_spans(include_local=False),
                      coll.fleet_metrics({})))
    assert colls[1] == colls[0]


@pytest.mark.parametrize("max_bytes,keep", [(256, 2), (512, 3), (1 << 20, 3)])
def test_usage_ledger_matches_jax(tmp_path, max_bytes, keep):
    ledgers = {}
    for name, mod in (("j", jcollect), ("t", tcollect)):
        path = str(tmp_path / name / "usage.jsonl")
        led = mod.UsageLedger(path, max_bytes=max_bytes, keep=keep)
        for i in range(20):
            led.append({"ts": float(i), "tenant": "acme" if i % 2 else "zeta",
                        "kind": "generate", "tokens_in": 6, "tokens_out": 16})
        files = sorted(os.listdir(tmp_path / name))
        ledgers[name] = (led.records, led.rotations, files,
                         [open(tmp_path / name / f).read() for f in files])
    assert ledgers["t"] == ledgers["j"]
