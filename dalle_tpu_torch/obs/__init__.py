"""Spans, metrics, the flight recorder, device gauges, the stall watchdog,
the model-health taps and their sentries, and run reports.

Port of ``dalle_tpu/obs`` under the same names: ``span`` timing regions
into a ring (Perfetto and JSONL exports), counters, gauges and native
histograms (one metrics dict, a Prometheus textfile), the trace context,
the flight recorder with its state providers, ``decode_quality``, the
training taps (``tree_health``, ``codebook_health``, ``gumbel_health``,
``layer_groups``) and the anomaly detectors over them (``HealthSentry``),
the device gauges (``DeviceTelemetry``), the stall watchdog and the run
report (``summarize_run``). Everything is off by default and one global
``None`` check when off: ``configure()`` turns tracing on, ``configure_recorder``
the recorder; the trainers turn the rest on from ``TrainConfig.obs``.

The serving plane's halves: the SLO sentry (``BurnRateSentry``) and the
fleet telemetry plane (``collect.py``: ``TelemetryExporter``,
``TelemetryCollector``, ``ClockOffsetEstimator``, ``UsageLedger``). Two
submodules are imported explicitly, never re-exported, as in the JAX
package: ``obs.lockorder`` records the lock-acquisition order one process
exhibits, ``obs.wiretap`` the wire-frame shapes it sends and receives
(checked against ``contracts/wire.json``).
"""

from .anomaly import (HEALTH_PREFIX, Breach, CodebookCollapseDetector,
                      GradExplosionDetector, HealthSentry, LossSpikeDetector,
                      NaNPrecursorDetector, split_health_key)
from .collect import (ClockOffsetEstimator, TelemetryCollector, TelemetryExporter,
                      UsageLedger, read_telemetry_dir, telemetry_payload)
from .context import current_trace_id, new_trace_id, trace_context
from .device import (CompileCounter, DeviceTelemetry, device_memory_headroom,
                     device_memory_stats, install_compile_counter)
from .health import (GroupTaps, codebook_health, decode_quality, group_norms,
                     gumbel_health, layer_groups, module_tree,
                     nonfinite_fractions, tree_health)
from .prometheus import render_textfile, sanitize_metric_name, write_textfile
from .recorder import (FlightRecorder, collect_state, configure_recorder,
                       disable_recorder, dump_recorder, get_recorder,
                       install_signal_dump, record_event,
                       register_state_provider, unregister_state_provider)
from .trace import (DEFAULT_BUCKETS, MAX_HISTOGRAM_BUCKETS, Tracer,
                    configure, counter_add, disable, enabled,
                    exemplars_snapshot, export_chrome_trace,
                    export_spans_jsonl, gauge_set, get_tracer,
                    histogram_observe, labeled_name, metrics_snapshot,
                    open_spans, record_span, span)
from .report import (format_request_timeline, request_timeline,
                     span_overhead_s, summarize_run)
from .slo import BurnRateSentry
from .watchdog import StallReport, StallWatchdog

__all__ = [
    "HEALTH_PREFIX", "Breach", "CodebookCollapseDetector",
    "GradExplosionDetector", "HealthSentry", "LossSpikeDetector",
    "NaNPrecursorDetector", "split_health_key",
    "ClockOffsetEstimator", "TelemetryCollector", "TelemetryExporter",
    "UsageLedger", "read_telemetry_dir", "telemetry_payload", "BurnRateSentry",
    "current_trace_id", "new_trace_id", "trace_context",
    "CompileCounter", "DeviceTelemetry", "device_memory_headroom",
    "device_memory_stats", "install_compile_counter",
    "GroupTaps", "codebook_health", "decode_quality", "group_norms",
    "gumbel_health", "layer_groups", "module_tree", "nonfinite_fractions",
    "tree_health",
    "render_textfile", "sanitize_metric_name", "write_textfile",
    "FlightRecorder", "collect_state", "configure_recorder",
    "disable_recorder", "dump_recorder", "get_recorder",
    "install_signal_dump", "record_event", "register_state_provider",
    "unregister_state_provider",
    "DEFAULT_BUCKETS", "MAX_HISTOGRAM_BUCKETS", "Tracer",
    "configure", "counter_add", "disable", "enabled", "exemplars_snapshot",
    "export_chrome_trace", "export_spans_jsonl", "gauge_set",
    "get_tracer", "histogram_observe", "labeled_name", "metrics_snapshot",
    "open_spans", "record_span", "span",
    "format_request_timeline", "request_timeline", "span_overhead_s",
    "summarize_run", "StallReport", "StallWatchdog",
]
