"""Spans, metrics, the flight recorder and the decode-quality taps.

Port of the serving path's part of ``dalle_tpu/obs`` under the same names:
``span`` timing regions into a ring (Perfetto and JSONL exports), counters,
gauges and native histograms (one metrics dict, a Prometheus textfile),
the trace context, the flight recorder with its state providers, and
``decode_quality``. Everything is off by default and one global ``None``
check when off: ``configure()`` turns tracing on, ``configure_recorder``
the recorder.

Not ported yet (``ROADMAP.md`` Queue 1 item 12): the training taps and the
anomaly detectors, ``obs/device.py``, the stall watchdog, the SLO sentry,
the report and the fleet collector.
"""

from .context import current_trace_id, new_trace_id, trace_context
from .health import HEALTH_PREFIX, decode_quality, split_health_key
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

__all__ = [
    "current_trace_id", "new_trace_id", "trace_context",
    "HEALTH_PREFIX", "decode_quality", "split_health_key",
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
]
