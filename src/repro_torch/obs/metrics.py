"""Counter/gauge/histogram registry — one ``snapshot()`` for the process.

Before ``repro.obs`` the repo's operational counts were scattered:
plan-cache hits/misses/dedupes in ``gemm.cache.CacheStats``, sweep
pruned/scored cells inside ``SweepResult.stats``, shed/expired/degraded
requests in ``ServingEngine._resilience_report()``, fault injections in
``SimReport``.  Each producer still owns its legacy surface (those report
fields are byte-compatible); this registry is the *union* view, fed by
the same increment sites, so ``obs.metrics.snapshot()`` always agrees
with the legacy numbers.

Naming convention: dotted ``<layer>.<thing>`` —
``plan_cache.hits``, ``sweep.cells_pruned``, ``serving.shed``,
``sim.faults.throttled_steps``.  The snapshot schema is
``repro.obs/v1`` and is stable: counters/gauges are flat name→number
maps, histograms summarize to count/sum/min/max/mean/p50/p95.
"""
from __future__ import annotations

from typing import Mapping

#: Stable schema tag of :meth:`MetricsRegistry.snapshot`.
METRICS_SCHEMA = "repro.obs/v1"


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class MetricsRegistry:
    """Process-local metrics store.  Always on (increments are dict ops,
    far cheaper than the spans they usually accompany)."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}

    # -- producers -----------------------------------------------------------

    def counter(self, name: str, inc: float = 1) -> float:
        """Increment (and return) a monotonically-growing count."""
        v = self.counters.get(name, 0) + inc
        self.counters[name] = v
        return v

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time value (last write wins)."""
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Add one sample to a histogram."""
        self._hists.setdefault(name, []).append(float(value))

    # -- consumers -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``repro.obs/v1`` view of everything recorded so far."""
        hists = {}
        for name, vals in self._hists.items():
            sv = sorted(vals)
            hists[name] = {
                "count": len(sv), "sum": sum(sv),
                "min": sv[0] if sv else 0.0, "max": sv[-1] if sv else 0.0,
                "mean": (sum(sv) / len(sv)) if sv else 0.0,
                "p50": _percentile(sv, 0.50), "p95": _percentile(sv, 0.95),
            }
        return {
            "schema": METRICS_SCHEMA,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": hists,
        }

    def get(self, name: str, default: float = 0) -> float:
        """Current value of one counter."""
        return self.counters.get(name, default)

    def reset(self) -> "MetricsRegistry":
        """Zero everything — the cross-layer analogue of the plan-cache
        ``reset`` satellite: back-to-back experiments in one process
        should not report cumulative numbers."""
        self.counters.clear()
        self.gauges.clear()
        self._hists.clear()
        return self

    def delta_since(self, before: Mapping[str, float]) -> dict[str, float]:
        """Counter deltas vs a previously-captured ``counters`` map —
        the before/after subtraction pattern ``gemm.sweep`` uses, offered
        here so every consumer applies it consistently."""
        return {name: v - before.get(name, 0)
                for name, v in self.counters.items()
                if v != before.get(name, 0)}
