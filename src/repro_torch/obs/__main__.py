"""``python -m repro_torch.obs`` — report | export | drift over saved traces.

The counterpart of ``python -m repro.obs``: on the same trace it prints
the same text and JSON and exits with the same codes (``drift --strict``
exits 3 when the verdict is not ok).  File-based so it composes across
processes: point it at a ``repro.serving/trace-v1`` JSON
(``launch/serve.py --trace``, ``ServingEngine.trace_json()``, or the
simulator's engine-format trace) and get a unified summary, a
Chrome-trace export, or a drift verdict.

    python -m repro_torch.obs report --trace /tmp/trace.json
    python -m repro_torch.obs export --trace /tmp/trace.json --out /tmp/chrome.json
    python -m repro_torch.obs drift  --trace /tmp/trace.json --max-drift 0.2
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.drift import (
    DEFAULT_MAX_DRIFT,
    DEFAULT_WARN_DRIFT,
    DriftMonitor,
)
from repro_torch.obs.trace import chrome_trace_from_serving


def _load_trace(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if "events" not in doc:
        raise SystemExit(f"{path}: no 'events' — not a serving trace "
                         f"(schema {doc.get('schema')!r})")
    return doc


def _drift_from_trace(doc: dict, *, warn_drift: float,
                      max_drift: float, min_samples: int) -> dict:
    """Replay a trace's step events through a DriftMonitor: measured
    ``dt`` per step vs the engine's frozen ``predicted_step_s``."""
    mon = DriftMonitor(warn_drift=warn_drift, max_drift=max_drift,
                       min_samples=min_samples)
    predicted = float(doc.get("predicted_step_s") or 0.0)
    key = str(doc.get("machine", "trace"))
    for e in doc.get("events", []):
        if e.get("type") == "step" and "dt" in e:
            mon.observe(predicted, float(e["dt"]), key=key)
    return mon.report()


def cmd_report(args) -> int:
    doc = _load_trace(args.trace)
    events = doc.get("events", [])
    by_type: dict[str, int] = {}
    for e in events:
        by_type[e.get("type", "?")] = by_type.get(e.get("type", "?"), 0) + 1
    steps = [e for e in events if e.get("type") == "step" and "dt" in e]
    dts = sorted(float(e["dt"]) for e in steps)
    out = {
        "schema": "repro.obs/report-v1",
        "trace_schema": doc.get("schema"),
        "events": len(events),
        "events_by_type": by_type,
        "predicted_step_s": doc.get("predicted_step_s"),
        "steps": {
            "count": len(dts),
            "mean_dt_s": (sum(dts) / len(dts)) if dts else None,
            "p95_dt_s": (dts[min(len(dts) - 1,
                                 int(0.95 * (len(dts) - 1) + 0.5))]
                         if dts else None),
        },
        "drift": _drift_from_trace(
            doc, warn_drift=args.warn_drift, max_drift=args.max_drift,
            min_samples=args.min_samples),
    }
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


def cmd_export(args) -> int:
    doc = _load_trace(args.trace)
    chrome = chrome_trace_from_serving(doc)
    with open(args.out, "w") as fh:
        json.dump(chrome, fh)
    print(f"wrote {args.out}: {len(chrome['traceEvents'])} trace events "
          f"({chrome['metadata']['spans']} spans, "
          f"{chrome['metadata']['events']} instants)")
    return 0


def cmd_drift(args) -> int:
    doc = _load_trace(args.trace)
    rep = _drift_from_trace(
        doc, warn_drift=args.warn_drift, max_drift=args.max_drift,
        min_samples=args.min_samples)
    json.dump(rep, sys.stdout, indent=2)
    print()
    return 0 if rep["status"] == "ok" or not args.strict else 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="observability over saved serving traces")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--trace", required=True,
                       help="path to a repro.serving/trace-v1 JSON")
        p.add_argument("--warn-drift", type=float,
                       default=DEFAULT_WARN_DRIFT)
        p.add_argument("--max-drift", type=float, default=DEFAULT_MAX_DRIFT)
        p.add_argument("--min-samples", type=int, default=8)

    p = sub.add_parser("report", help="unified summary of one trace")
    common(p)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("export", help="convert a trace to Chrome-trace JSON")
    p.add_argument("--trace", required=True)
    p.add_argument("--out", required=True,
                   help="output path (open in chrome://tracing / perfetto)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("drift", help="ok/warn/stale verdict for one trace")
    common(p)
    p.add_argument("--strict", action="store_true",
                   help="exit 3 when status is not ok")
    p.set_defaults(fn=cmd_drift)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
