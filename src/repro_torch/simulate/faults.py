"""Fault-injection scenarios for the serving simulator.

The paper's premise is that edge processors *diverge* from their nominal
rates — DVFS, thermal throttling, co-tenant contention — yet a plain
simulation run executes every step at the calibrated price and delivers
every arrival on schedule.  A :class:`FaultScenario` perturbs one run
three ways, all reproducible from the scenario's own seed:

* **Thermal throttle windows** (:class:`ThrottleWindow`): between
  ``start_s`` and ``start_s + duration_s`` every service time is scaled
  by ``factor`` (1.25 = 25% slower, the classic DVFS step-down).  With
  ``period_s`` set the windows repeat, modelling a duty-cycled thermal
  limit.
* **Transient slot failures** (``slot_mtbf_s``): a slot dies mid-step at
  exponentially-distributed intervals; its request loses that step's
  token, is reset, and re-queued at the *front* (it keeps its arrival
  time, so the latency hit is visible in the tail).
* **Arrival surges** (:class:`ArrivalSurge`): a burst of extra requests
  injected on top of the nominal traffic at a fixed time — the flash
  crowd the admission/shedding policy must survive.

Scenarios serialise (``as_dict`` / ``coerce`` round-trip) so a CLI flag,
a CI smoke, and an autoconfiguration sweep all name the same perturbation;
the named registry (:data:`SCENARIOS`) carries the canonical ones,
``"throttle20"`` being the 20%-duty throttle window the robust
autoconfiguration defaults to.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Iterator, Mapping

FAULTS_SCHEMA = "repro.simulate/faults-v1"


@dataclasses.dataclass(frozen=True)
class ThrottleWindow:
    """One service-time scaling window: ``[start_s, start_s + duration_s)``
    costs ``factor``× the calibrated price."""

    start_s: float
    duration_s: float
    factor: float

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"throttle duration must be positive, "
                             f"got {self.duration_s}")
        if self.factor <= 0:
            raise ValueError(f"throttle factor must be positive, "
                             f"got {self.factor}")

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.start_s + self.duration_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ArrivalSurge:
    """A burst of ``requests`` extra arrivals injected at ``at_s`` (on top
    of the nominal traffic)."""

    at_s: float
    requests: int
    prompt_len: int = 32
    decode_len: int = 16

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError(f"surge needs >= 1 request, got {self.requests}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# rids of surge-injected requests start here, far above any traffic stream
SURGE_RID_BASE = 1_000_000


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """A named, seeded perturbation schedule for one simulation run.

    All randomness (slot-failure times and victims) comes from the
    scenario's own ``random.Random(seed)`` drawn in schedule order, so the
    same scenario perturbs the same run identically every time.
    """

    name: str
    throttles: tuple = ()
    period_s: float | None = None       # repeat throttle windows every period
    slot_mtbf_s: float | None = None    # mean time between slot failures
    surges: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "throttles", tuple(
            t if isinstance(t, ThrottleWindow) else ThrottleWindow(**t)
            for t in self.throttles))
        object.__setattr__(self, "surges", tuple(
            s if isinstance(s, ArrivalSurge) else ArrivalSurge(**s)
            for s in self.surges))
        if self.period_s is not None and self.period_s <= 0:
            raise ValueError(f"period must be positive, got {self.period_s}")
        if self.slot_mtbf_s is not None and self.slot_mtbf_s <= 0:
            raise ValueError(f"slot MTBF must be positive, "
                             f"got {self.slot_mtbf_s}")

    # -- service-time perturbation -------------------------------------------
    def service_scale(self, t: float) -> float:
        """Multiplier on service times at sim time ``t`` (overlapping
        windows compound)."""
        if self.period_s is not None:
            t = t % self.period_s
        scale = 1.0
        for w in self.throttles:
            if w.active(t):
                scale *= w.factor
        return scale

    # -- slot failures -------------------------------------------------------
    def failures(self) -> Iterator[tuple[float, float]]:
        """Infinite stream of ``(gap_s, victim_u)`` pairs: exponential
        inter-failure gaps at the configured MTBF plus a uniform [0,1)
        draw the server maps onto a victim slot.  Empty when no MTBF is
        set.  A fresh, identically-seeded stream per call."""
        if self.slot_mtbf_s is None:
            return
        rng = random.Random(self.seed)
        while True:
            yield rng.expovariate(1.0 / self.slot_mtbf_s), rng.random()

    def surge_requests(self) -> list:
        """The extra arrivals of every surge, as ``SimRequest`` records
        with rids from :data:`SURGE_RID_BASE` up."""
        from repro_torch.simulate.traffic import SimRequest
        out, rid = [], SURGE_RID_BASE
        for s in self.surges:
            for _ in range(s.requests):
                out.append(SimRequest(rid=rid, arrival_s=s.at_s,
                                      prompt_len=s.prompt_len,
                                      decode_len=s.decode_len))
                rid += 1
        return out

    # -- serialisation -------------------------------------------------------
    def as_dict(self) -> dict:
        return {"schema": FAULTS_SCHEMA, "name": self.name,
                "throttles": [w.as_dict() for w in self.throttles],
                "period_s": self.period_s,
                "slot_mtbf_s": self.slot_mtbf_s,
                "surges": [s.as_dict() for s in self.surges],
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultScenario":
        schema = d.get("schema", FAULTS_SCHEMA)
        if schema != FAULTS_SCHEMA:
            raise ValueError(f"unknown fault-scenario schema {schema!r} "
                             f"(want {FAULTS_SCHEMA})")
        kw = {k: d[k] for k in ("name", "throttles", "period_s",
                                "slot_mtbf_s", "surges", "seed") if k in d}
        return cls(**kw)

    @classmethod
    def coerce(cls, spec: Any) -> "FaultScenario":
        """Registry name -> scenario, dict -> :meth:`from_dict`,
        pass-through for instances."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            try:
                return SCENARIOS[spec]
            except KeyError:
                raise ValueError(
                    f"unknown fault scenario {spec!r}; "
                    f"have {sorted(SCENARIOS)}") from None
        if isinstance(spec, Mapping):
            return cls.from_dict(spec)
        raise TypeError(f"cannot interpret {spec!r} as a fault scenario "
                        "(name, dict, or FaultScenario)")


def throttle_scenario(*, factor: float = 2.0, duty: float = 0.2,
                      period_s: float = 10.0, name: str | None = None,
                      seed: int = 0) -> FaultScenario:
    """A duty-cycled thermal throttle: ``duty`` of every ``period_s``
    window runs ``factor``× slower.  The robust-autoconfiguration default
    (``"throttle20"``) is ``factor=2, duty=0.2, period_s=10``."""
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    return FaultScenario(
        name=name or f"throttle{int(round(duty * 100))}",
        throttles=(ThrottleWindow(start_s=0.0, duration_s=duty * period_s,
                                  factor=factor),),
        period_s=period_s, seed=seed)


SCENARIOS: dict[str, FaultScenario] = {
    # the canonical robust-autoconfiguration perturbation: 20% of every
    # 10 s window runs at half speed (one DVFS step down)
    "throttle20": throttle_scenario(factor=2.0, duty=0.2, period_s=10.0),
    # a harsher sustained brown-out: half of every window at half speed
    "throttle50": throttle_scenario(factor=2.0, duty=0.5, period_s=10.0),
    # transient slot failures, one per ~5 s of sim time on average
    "flaky-slots": FaultScenario(name="flaky-slots", slot_mtbf_s=5.0),
    # a flash crowd 2 s in, on top of whatever the nominal traffic sends
    "flash-crowd": FaultScenario(
        name="flash-crowd",
        surges=(ArrivalSurge(at_s=2.0, requests=32),)),
    # everything at once — the CI overload smoke uses this family
    "storm": FaultScenario(
        name="storm",
        throttles=(ThrottleWindow(start_s=0.0, duration_s=2.0, factor=2.0),),
        period_s=10.0, slot_mtbf_s=8.0,
        surges=(ArrivalSurge(at_s=1.0, requests=24),)),
}
