"""``repro_torch.serving`` — continuous batching + memory-aware deployment
planning.

* :class:`ServingEngine` / :class:`Request` — the engine (``engine.py``).
* :func:`footprint` / :class:`Footprint` — the closed-form serving memory
  model: weights + KV/recurrent state + activation workspace per
  ``(model config, batch, dtype)`` (``footprint.py``).
* :func:`plan_deployment` / :class:`DeploymentReport` — rank every
  feasible ``(machine, dtype, batch)`` cell by predicted decode
  throughput, pruning memory-infeasible cells before the GEMM sweep
  (``report.py``); ``python -m repro_torch.serving plan`` prints the
  report without instantiating a model.
* ``buckets.py`` — the prefill length buckets.
* ``resilience.py`` — overload primitives: shed-cause vocabulary,
  :class:`QueueFullError` + :func:`retry_with_backoff` backpressure, and
  the :class:`DegradationRung` ladder.

``ServingEngine.autoconfigure`` is not ported yet (ROADMAP queue 1).  The
engine and the report load lazily, so the config-only modules stay light.
"""
import importlib

from repro_torch.serving.buckets import (PREFILL_BUCKETS, bucket_cover,
                                         bucket_len)
from repro_torch.serving.footprint import Footprint, dtype_bytes, footprint
from repro_torch.serving.resilience import (SHED_CAUSES, SHED_DEADLINE_EXPIRED,
                                            SHED_DEADLINE_UNMEETABLE,
                                            SHED_QUEUE_FULL, DegradationRung,
                                            QueueFullError, default_ladder,
                                            retry_with_backoff)

_LAZY = {
    "DrainTruncatedError": "repro_torch.serving.engine",
    "Request": "repro_torch.serving.engine",
    "ServingEngine": "repro_torch.serving.engine",
    "TRACE_SCHEMA": "repro_torch.serving.engine",
    "CellRejection": "repro_torch.serving.report",
    "DeploymentOption": "repro_torch.serving.report",
    "DeploymentReport": "repro_torch.serving.report",
    "plan_deployment": "repro_torch.serving.report",
}

__all__ = [
    "CellRejection", "DegradationRung", "DeploymentOption",
    "DeploymentReport", "DrainTruncatedError", "Footprint",
    "PREFILL_BUCKETS", "QueueFullError", "Request", "SHED_CAUSES",
    "SHED_DEADLINE_EXPIRED", "SHED_DEADLINE_UNMEETABLE", "SHED_QUEUE_FULL",
    "ServingEngine", "TRACE_SCHEMA", "bucket_cover", "bucket_len",
    "default_ladder", "dtype_bytes", "footprint", "plan_deployment",
    "retry_with_backoff",
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
