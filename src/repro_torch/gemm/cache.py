"""Process-level plan cache, persisted through TileTuner's JSON manifest.

Every ``repro.gemm.plan()`` decision is memoised in-process, keyed by
``(problem, backend, machine, policy, options)``.  The persistence layer is
:class:`repro.core.autotune.Manifest` — the same ``{m x n x k:dtype -> tile}``
JSON file TileTuner has always written — so kernels, benchmarks and the perf
log keep agreeing on the tiles used across processes.  A warmed manifest
satisfies tile-backend planning without re-running the search (provenance
``source="manifest"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch import obs
from repro_torch.core.autotune import Manifest, TileDecision
from repro_torch.core.tpu_model import TileConfig, TpuCost
from repro_torch.gemm.api import GemmPlan, GemmProblem


def _freeze(value: Any) -> Any:
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    manifest_hits: int = 0
    # problems dropped by bulk-planning dedupe before any evaluation
    # (repeated QKV/logits shapes across arch configs, sweep grid points).
    deduped: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "manifest_hits": self.manifest_hits,
                "deduped": self.deduped}


class PlanCache:
    """In-memory plan store + manifest warm/persist layer."""

    def __init__(self):
        self._plans: dict[tuple, GemmPlan] = {}
        self._manifest: Manifest | None = None
        self.stats = CacheStats()

    @staticmethod
    def key(problem: GemmProblem, backend: str, machine: str, policy: str,
            options: Mapping) -> tuple:
        return (problem, backend, machine, policy, _freeze(dict(options)))

    def get(self, key: tuple) -> GemmPlan | None:
        plan = self._plans.get(key)
        if plan is None:
            self.stats.misses += 1
            obs.metrics.counter("plan_cache.misses")
        else:
            self.stats.hits += 1
            obs.metrics.counter("plan_cache.hits")
        return plan

    def put(self, key: tuple, plan: GemmPlan) -> None:
        self._plans[key] = plan

    def note_deduped(self, n: int) -> None:
        """Account problems dropped by bulk-planning dedupe (kept next to
        the other counters so the obs mirror stays in lock-step)."""
        if n:
            self.stats.deduped += n
            obs.metrics.counter("plan_cache.deduped", n)

    def reset_stats(self) -> CacheStats:
        """Zero the counters without touching the cached plans — the
        back-to-back-sweeps fix: each experiment snapshots deltas against
        a fresh zero instead of a process-cumulative total."""
        old = self.stats
        self.stats = CacheStats()
        return old

    def clear(self) -> None:
        self._plans.clear()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._plans)

    # -- manifest persistence ------------------------------------------------
    def warm(self, path: str) -> int:
        """Load a TileTuner manifest as the cache's persisted tier; returns
        the number of entries now available for lookup."""
        self._manifest = Manifest(path)
        return len(self._manifest)

    def manifest_tile(self, problem: GemmProblem) -> TileConfig | None:
        if self._manifest is None:
            return None
        tile = self._manifest.lookup(problem.as_shape())
        if tile is not None:
            self.stats.manifest_hits += 1
            obs.metrics.counter("plan_cache.manifest_hits")
        return tile

    def save(self, path: str) -> int:
        """Persist every tile-shaped plan through the Manifest format;
        returns the number of entries written."""
        manifest = Manifest(path)
        for plan in self._plans.values():
            if isinstance(plan.selection, TileConfig) and \
                    isinstance(plan.cost, TpuCost):
                manifest.record(TileDecision(
                    shape=plan.problem.as_shape(), tile=plan.selection,
                    cost=plan.cost,
                    overlap=bool(plan.provenance.get("overlap", True))))
        manifest.save()
        return len(manifest)
