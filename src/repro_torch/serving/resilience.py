"""Resilience primitives shared by the real engine and the simulator.

Three mechanisms, one vocabulary:

* **Load shedding** — a request is *shed* (rejected before holding a
  slot) when serving it is pointless or impossible; the cause constants
  here are the shared vocabulary between ``ServingEngine.perf_report()``,
  the trace-v1 event log, and ``SimReport.shed`` so sim-vs-real
  accounting lines up key for key.
* **Backpressure** — a bounded queue raises :class:`QueueFullError`
  instead of buffering unboundedly; :func:`retry_with_backoff` is the
  matching client-side helper (injectable clock/sleep, so tests run on a
  fake clock).
* **Graceful degradation** — under sustained overload the engine steps
  down a :class:`DegradationRung` ladder (fewer decode slots, then a
  modeled int8 KV cache) instead of dying in ``DrainTruncatedError``.

Kept dependency-free (no engine / simulator imports) so both sides can
import it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

# -- shed causes (shared sim/real vocabulary) --------------------------------
#: the request's deadline had already passed when a slot came up
SHED_DEADLINE_EXPIRED = "deadline_expired"
#: the deadline was still ahead, but the modeled decode time alone
#: (``decision_step_s * max_new_tokens``) would blow it
SHED_DEADLINE_UNMEETABLE = "deadline_unmeetable"
#: the bounded queue was full at arrival
SHED_QUEUE_FULL = "queue_full"

SHED_CAUSES = (SHED_DEADLINE_EXPIRED, SHED_DEADLINE_UNMEETABLE,
               SHED_QUEUE_FULL)


class QueueFullError(RuntimeError):
    """Raised by ``ServingEngine.submit`` when the bounded queue is full.

    Carries enough to make a retry decision: the queue limit and current
    depth.  (The open-loop simulator *drops* instead — an arrival process
    cannot be asked to wait — and records the drop as a ``queue_full``
    shed; same vocabulary, opposite flow control.)
    """

    def __init__(self, *, limit: int, depth: int):
        self.limit = int(limit)
        self.depth = int(depth)
        super().__init__(f"serving queue full ({depth}/{limit}); "
                         "retry with backoff or raise the limit")


def retry_with_backoff(fn: Callable[[], object], *,
                       retries: int = 5, base_delay_s: float = 0.05,
                       multiplier: float = 2.0, max_delay_s: float = 2.0,
                       sleep: Callable[[float], None] | None = None,
                       should_retry: Callable[[Exception], bool]
                       | None = None):
    """Call ``fn`` until it succeeds, sleeping exponentially longer after
    each :class:`QueueFullError` (delays ``base * multiplier**k`` capped
    at ``max_delay_s``).

    Args:
        fn: zero-arg callable — typically ``lambda: engine.submit(...)``.
        retries: attempts *after* the first (so ``retries + 1`` calls max).
        base_delay_s / multiplier / max_delay_s: the backoff schedule.
        sleep: injectable sleep (defaults to ``time.sleep``); tests pass a
            fake-clock recorder.
        should_retry: predicate on the raised exception; defaults to
            retrying exactly :class:`QueueFullError`.

    Returns:
        ``fn()``'s return value on first success.

    Raises:
        The last exception when every attempt failed.
    """
    if sleep is None:
        import time
        sleep = time.sleep
    if should_retry is None:
        def should_retry(exc):
            return isinstance(exc, QueueFullError)
    delay = float(base_delay_s)
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as exc:                 # noqa: BLE001 — predicate
            if attempt >= retries or not should_retry(exc):
                raise
        sleep(min(delay, max_delay_s))
        delay *= multiplier


# -- degradation ladder ------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DegradationRung:
    """One step of the graceful-degradation ladder.

    ``decode_slots`` caps how many slots the engine admits into (fewer
    active sequences = smaller effective batch = shorter modeled step on
    compute-bound parts); ``kv_dtype`` is the modeled KV-cache dtype of
    this rung (``"int8"`` halves the modeled cache footprint — the real
    engine keeps computing in its native dtype; the rung is a *capacity*
    statement the footprint model prices).
    """

    name: str
    decode_slots: int
    kv_dtype: str = "native"

    def __post_init__(self):
        if self.decode_slots < 1:
            raise ValueError(f"a rung needs >= 1 decode slot, "
                             f"got {self.decode_slots}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_ladder(max_batch: int) -> tuple[DegradationRung, ...]:
    """The stock two-rung ladder for a ``max_batch``-slot engine: halve
    the decode slots, then additionally drop the modeled KV cache to
    int8.  Empty for a single-slot engine (nothing to step down to)."""
    if max_batch <= 1:
        return ()
    half = max(1, max_batch // 2)
    return (DegradationRung(name=f"half-batch{half}", decode_slots=half),
            DegradationRung(name=f"half-batch{half}-int8kv",
                            decode_slots=half, kv_dtype="int8"))


def coerce_ladder(spec: Sequence | None,
                  max_batch: int) -> tuple[DegradationRung, ...]:
    """``None`` -> :func:`default_ladder`, dicts -> rungs, pass-through;
    validates every rung fits under ``max_batch``."""
    rungs = default_ladder(max_batch) if spec is None else tuple(
        r if isinstance(r, DegradationRung) else DegradationRung(**r)
        for r in spec)
    for r in rungs:
        if r.decode_slots > max_batch:
            raise ValueError(f"rung {r.name!r} wants {r.decode_slots} slots "
                             f"but the engine has {max_batch}")
    return rungs
