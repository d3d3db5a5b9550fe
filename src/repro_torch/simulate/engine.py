"""Discrete-event core: a monotonic event queue with a seeded RNG.

The engine is deliberately tiny — a heap of ``(time, seq, Event)`` entries
popped in order, a ``now`` clock that only moves forward, and a
``random.Random`` seeded at construction so every run is reproducible.
Everything domain-specific (arrival processes, the slot server) is a
module scheduling callbacks on this queue; the engine knows nothing about
serving.

    sim = Simulator(seed=0)
    sim.schedule(1.5, lambda: print(sim.now))
    sim.run()                      # -> 1.5

Ties break by schedule order (``seq``), so same-time events run in a
deterministic, insertion-ordered sequence — the property the replay
validation relies on.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Any, Callable

from repro_torch import obs


@dataclasses.dataclass
class Event:
    """One scheduled callback.  ``cancel()`` marks it dead in place (lazy
    deletion; the heap drops it when popped)."""

    time: float
    seq: int
    fn: Callable[[], Any]
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


class Simulator:
    """Monotonic event loop.

    Args:
        seed: seeds ``self.rng`` (a ``random.Random``); modules draw all
            their randomness from it (or from their own seeded streams)
            so runs are bit-reproducible.
        horizon: optional hard stop — events scheduled past it are kept
            but never executed by :meth:`run`.
    """

    def __init__(self, *, seed: int = 0, horizon: float | None = None):
        self.now = 0.0
        self.rng = random.Random(seed)
        self.horizon = horizon
        self.events_processed = 0
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()

    def schedule(self, delay: float, fn: Callable[[], Any]) -> Event:
        """Run ``fn`` ``delay`` seconds from now (``delay >= 0``)."""
        return self.schedule_at(self.now + delay, fn)

    def schedule_at(self, time: float, fn: Callable[[], Any]) -> Event:
        """Run ``fn`` at absolute sim time ``time`` (not in the past)."""
        if time < self.now:
            raise ValueError(
                f"cannot schedule at t={time:g} before now={self.now:g}")
        ev = Event(time=time, seq=next(self._seq), fn=fn)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pending(self) -> int:
        """Live (non-cancelled) events still queued."""
        return sum(1 for _, _, e in self._heap if not e.cancelled)

    def run(self, until: float | None = None) -> float:
        """Pop events in time order until the queue drains (or ``until`` /
        the horizon is reached).  Returns the final clock."""
        stop = until if until is not None else self.horizon
        before = self.events_processed
        with obs.span("sim.run", until=stop) as sp:
            while self._heap:
                t, _, ev = self._heap[0]
                if stop is not None and t > stop:
                    self.now = stop
                    break
                heapq.heappop(self._heap)
                if ev.cancelled:
                    continue
                self.now = t
                self.events_processed += 1
                ev.fn()
            sp.set(events_processed=self.events_processed - before,
                   sim_time=self.now)
        obs.metrics.counter("sim.events_processed",
                            self.events_processed - before)
        return self.now
