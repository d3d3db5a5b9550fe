"""``repro.obs`` — tracing, metrics, and prediction-drift observability.

One vocabulary across every layer of plan → serve → simulate → calibrate:

* :func:`span` / :func:`add_span` — nestable named intervals recorded by
  a process-local :class:`Recorder`, exported as Chrome-trace/Perfetto
  JSON (:func:`to_chrome_trace`, ``chrome://tracing`` / ui.perfetto.dev).
  Disabled by default; :func:`enable` turns the span channel on.  The
  serving engine's always-on ``repro.serving/trace-v1`` events flow
  through the same recorder, so ``ServingEngine.trace_json()`` is a view
  over it.
* :data:`metrics` — the process :class:`MetricsRegistry`; producers
  (plan cache, sweep, serving, simulator, faults) increment dotted
  counters at the same sites as their legacy report fields, and
  ``obs.metrics.snapshot()`` (schema ``repro.obs/v1``) is the union view.
* :class:`DriftMonitor` — online measured-vs-predicted ratio windows
  keyed by machine geometry fingerprint; surfaces ok/warn/stale in
  ``perf_report()``, ``SimReport`` and the JAX package's
  ``python -m repro.obs drift``.

Overhead contract: with tracing disabled every ``obs.span(...)`` call
site costs one method call returning a shared no-op — the
``obs_overhead`` workload in ``benchmarks/bench_planner.py`` asserts
<2% on the Table-2 sweep.  The port's per-call sites (``gemm.matmul``,
``gemm.grouped_matmul``) test ``recorder.enabled`` first and build no
attributes while it is false.  While enabled, each thread nests its own
spans, spans are mirrored into ``torch.profiler`` while one records, and
Python's collections are ``python.gc`` spans.  See docs/OBSERVABILITY.md,
and ``obs/README.md`` for the port's spans.
"""
from repro_torch.obs.drift import (
    DEFAULT_MAX_DRIFT,
    DEFAULT_WARN_DRIFT,
    DRIFT_SCHEMA,
    STATUS_OK,
    STATUS_STALE,
    STATUS_WARN,
    DriftMonitor,
)
from repro_torch.obs.metrics import METRICS_SCHEMA, MetricsRegistry
from repro_torch.obs.trace import (
    TRACE_EXPORT_SCHEMA,
    Recorder,
    Span,
    chrome_trace_from_serving,
)

#: The process-local recorder every instrumented layer writes to.
recorder = Recorder()

#: The process-local metrics registry every instrumented layer increments.
metrics = MetricsRegistry()


def span(name: str, *, track: str = "wall", **attrs):
    """Open a span on the process recorder (no-op while disabled)."""
    return recorder.span(name, track=track, **attrs)


def add_span(name: str, t0: float, t1: float, *, track: str = "wall",
             **attrs):
    """Record a retrospective span from external timestamps."""
    return recorder.add_span(name, t0, t1, track=track, **attrs)


def enable():
    """Turn the span channel on (events and metrics are always on), with
    the ``python.gc`` hook and the profiler mirroring
    (:meth:`Recorder.enable`)."""
    return recorder.enable()


def disable():
    """Turn the span channel off and remove the ``python.gc`` hook."""
    return recorder.disable()


def enabled() -> bool:
    return recorder.enabled


def clear():
    """Drop recorded spans/events and zero the metrics registry."""
    recorder.clear()
    metrics.reset()


def to_chrome_trace() -> dict:
    """Chrome-trace JSON of everything the process recorder holds."""
    return recorder.to_chrome_trace()


def save_chrome_trace(path) -> dict:
    return recorder.save_chrome_trace(path)


__all__ = [
    "DEFAULT_MAX_DRIFT", "DEFAULT_WARN_DRIFT", "DRIFT_SCHEMA",
    "DriftMonitor", "METRICS_SCHEMA", "MetricsRegistry", "Recorder",
    "Span", "STATUS_OK", "STATUS_STALE", "STATUS_WARN",
    "TRACE_EXPORT_SCHEMA", "add_span", "chrome_trace_from_serving",
    "clear", "disable", "enable", "enabled", "metrics", "recorder",
    "save_chrome_trace", "span", "to_chrome_trace",
]
