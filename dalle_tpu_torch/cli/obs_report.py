"""Summarise a run's telemetry: step-time histogram, span tables, verdicts.

Port of ``scripts/obs_report.py`` over ``obs/report.py``. The input is a
run directory (every ``.jsonl`` inside, e.g. ``<output_dir>/obs/`` or the
output directory itself, with its ``metrics.jsonl``), a ``spans.jsonl`` or
a metrics JSONL. Span rows give the per-name aggregate and the slowest
spans; metrics rows the step-time histogram, the input-bound or
compute-bound verdict from the data-starvation ratio, the memory and
compile callouts and, with the ``health/*`` columns of a ``--health`` run,
the MODEL-HEALTH verdict naming the breaching detector and layer group.

    python -m dalle_tpu_torch.cli.obs_report ./dalle_ckpt/obs
    python -m dalle_tpu_torch.cli.obs_report ./dalle_ckpt/metrics.jsonl --top 20

``--request <id>`` prints one request's spans from every thread as one
timeline (the serving path's ``trace_id``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="run directory or .jsonl file")
    ap.add_argument("--top", type=int, default=10, help="rows in the top-k span tables")
    ap.add_argument("--request", type=str, default=None, metavar="ID",
                    help="one request's cross-thread timeline (its trace_id or the "
                         "engine's request_id)")
    args = ap.parse_args(argv)

    from ..obs.report import format_request_timeline, load_jsonl, summarize_run
    if not os.path.exists(args.path):
        print(f"error: {args.path} does not exist", file=sys.stderr)
        return 2
    if args.request is not None:
        paths = [args.path]
        if os.path.isdir(args.path):
            paths = [os.path.join(args.path, n) for n in sorted(os.listdir(args.path))
                     if n.endswith(".jsonl")]
        rows = []
        for p in paths:
            rows.extend(load_jsonl(p))
        text = format_request_timeline(rows, args.request)
        print(text)
        return 0 if not text.startswith("(no spans") else 1
    print(summarize_run(args.path, topk=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
