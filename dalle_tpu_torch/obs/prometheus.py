"""Prometheus textfile writer for the obs metrics.

A copy of ``dalle_tpu/obs/prometheus.py`` (it imports no JAX): the same
bytes for the same metrics. The process rewrites a ``.prom`` file
atomically (``<path>.tmp`` then ``os.replace``) for node-exporter's textfile
collector to read; no client library, no server thread.

Names: dots and slashes become underscores, everything gets a ``dalle_``
prefix; names ending in ``_total`` are typed ``counter``, the rest
``gauge``, and a ``_bucket`` family with its ``_sum`` and ``_count`` is one
``histogram``. A registry key's ``{k="v"}`` label block is kept as
Prometheus labels, each family under one ``# TYPE`` line.
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str, prefix: str = "dalle_") -> str:
    """A registry key as a Prometheus name, its trailing ``{...}`` label
    block kept as it is."""
    labels = ""
    if name.endswith("}") and "{" in name:
        name, _, rest = name.partition("{")
        labels = "{" + rest
    out = _NAME_RE.sub("_", name)
    if not out.startswith(prefix):
        out = prefix + out
    if out[0].isdigit():
        out = "_" + out
    return out + labels


def render_textfile(metrics: dict, *, prefix: str = "dalle_",
                    timestamp: Optional[float] = None,
                    exemplars: Optional[dict] = None) -> str:
    """The Prometheus text exposition of a flat {name: number} dict
    (non-numbers skipped). ``exemplars`` maps a registry bucket key to
    ``(trace_id, value, ts)``, written as an OpenMetrics exemplar suffix
    (``# {trace_id="..."} value ts``) on that bucket's sample."""
    lines = []
    ts = time.time() if timestamp is None else timestamp
    lines.append(f"# grafttrace export, unix_time={ts:.3f}")
    typed = set()
    hist_bases = set()
    for name in sorted(metrics):
        v = metrics[name]
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        pname = sanitize_metric_name(name, prefix)
        family = pname.partition("{")[0]
        if family.endswith("_bucket"):
            base = family[:-len("_bucket")]
            if base not in hist_bases:
                hist_bases.add(base)
                typed.update((family, base + "_sum", base + "_count"))
                lines.append(f"# TYPE {base} histogram")
        if family not in typed:
            # labelled series of one family sort together, so its one TYPE
            # line lands before its first sample
            typed.add(family)
            mtype = "counter" if family.endswith("_total") else "gauge"
            lines.append(f"# TYPE {family} {mtype}")
        sample = f"{pname} {v}"
        ex = exemplars.get(name) if exemplars else None
        if ex is not None:
            trace_id, ex_value, ex_ts = ex
            sample += (f' # {{trace_id="{trace_id}"}} '
                       f"{ex_value} {ex_ts:.3f}")
        lines.append(sample)
    return "\n".join(lines) + "\n"


def write_textfile(path: str, metrics: dict, *, prefix: str = "dalle_") -> str:
    """Rewrite the textfile atomically; returns the rendered content."""
    content = render_textfile(metrics, prefix=prefix)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(content)
    os.replace(tmp, path)
    return content
