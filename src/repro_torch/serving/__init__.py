"""``repro_torch.serving`` — the slot-based continuous-batching engine.

* :class:`ServingEngine` / :class:`Request` — the engine (``engine.py``).
* ``buckets.py`` — the prefill length buckets.
* ``resilience.py`` — overload primitives: shed-cause vocabulary,
  :class:`QueueFullError` + :func:`retry_with_backoff` backpressure, and
  the :class:`DegradationRung` ladder.

``footprint``, ``report`` (deployment planning, ``autoconfigure``) and the
``python -m repro.serving`` CLI are not ported yet (ROADMAP queue 1).  The
engine loads lazily, so the config-only modules stay light.
"""
import importlib

from repro_torch.serving.buckets import (PREFILL_BUCKETS, bucket_cover,
                                         bucket_len)
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
}

__all__ = [
    "DegradationRung", "DrainTruncatedError", "PREFILL_BUCKETS",
    "QueueFullError", "Request", "SHED_CAUSES", "SHED_DEADLINE_EXPIRED",
    "SHED_DEADLINE_UNMEETABLE", "SHED_QUEUE_FULL", "ServingEngine",
    "TRACE_SCHEMA", "bucket_cover", "bucket_len", "default_ladder",
    "retry_with_backoff",
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
