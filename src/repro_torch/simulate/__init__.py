"""``repro_torch.simulate`` — discrete-event serving simulation + traffic.

The planner's numbers are steady-state; this subsystem adds *dynamics*:
request arrivals, queueing, batch formation, and tail latency, priced by
the same calibrated analytic cost models the planner ranks with.

* :class:`Simulator` — monotonic event queue with a seeded RNG
  (``engine.py``).
* :class:`PoissonTraffic` / :class:`UniformTraffic` /
  :class:`BurstyTraffic` / :class:`TraceTraffic` + :func:`make_traffic` —
  open-loop arrival processes with prompt/decode length distributions
  (``traffic.py``).
* :class:`SlotServer` / :class:`ServiceModel` /
  :func:`simulate_serving` — ``ServingEngine`` semantics on the event
  queue, service times from ``GemmPlan.estimate()`` (``server.py``).
* :class:`Metrics` / :class:`SimReport` — p50/p95/p99 latency, TTFT,
  goodput, queue depth, slot utilization, persisted JSON
  (``metrics.py``).
* :func:`replay` / :class:`ReplayReport` — re-enact a real
  ``ServingEngine`` trace, measured- or model-priced, sim-vs-real
  validation (``replay.py``).
* :class:`SLO` / :func:`evaluate_deployment` — SLO-driven
  autoconfiguration over a deployment report (``autoconf.py``); pass
  ``faults=`` for the perturbation-robust mode.
* :class:`FaultScenario` / :data:`SCENARIOS` — seeded fault injection:
  thermal-throttle windows, transient slot failures, arrival surges
  (``faults.py``; see ``docs/RESILIENCE.md``).

Everything here is config-only (no parameters, no tensors): full-size
architectures simulate in milliseconds, so the CLI (``python -m
repro_torch.simulate run|replay|sweep``) is cheap enough for CI.

The counterpart of ``repro.simulate``: the same heap order, random streams
and reports, so the same service prices and traffic give the JAX package's
JSON; ``replay`` reads the port engine's ``repro.serving/trace-v1`` trace,
recorded on the card or on the CPU.
"""
from repro_torch.simulate.autoconf import (
    FAULT_REJECT_PREFIX,
    REJECT_SLO_GOODPUT,
    REJECT_SLO_P99,
    REJECT_SLO_SHED,
    REJECT_SLO_TTFT,
    REJECT_SLO_UNFINISHED,
    SLO,
    SloSelection,
    default_traffic,
    evaluate_deployment,
)
from repro_torch.simulate.engine import Event, Simulator
from repro_torch.simulate.faults import (
    SCENARIOS,
    ArrivalSurge,
    FaultScenario,
    ThrottleWindow,
    throttle_scenario,
)
from repro_torch.simulate.metrics import Metrics, SimReport, StepSample, percentile
from repro_torch.simulate.replay import (
    REPLAY_SCHEMA,
    TRACE_SCHEMA,
    ReplayReport,
    load_trace,
    replay,
    trace_requests,
    trace_traffic,
)
from repro_torch.simulate.server import (
    POLICIES,
    ServiceModel,
    SlotServer,
    simulate_serving,
)
from repro_torch.simulate.traffic import (
    BurstyTraffic,
    LengthDist,
    PoissonTraffic,
    SimRequest,
    TraceTraffic,
    Traffic,
    TrafficScenario,
    UniformTraffic,
    make_traffic,
)

__all__ = [
    "SLO", "ArrivalSurge", "BurstyTraffic", "Event", "FAULT_REJECT_PREFIX",
    "FaultScenario", "LengthDist", "Metrics",
    "POLICIES", "PoissonTraffic", "REJECT_SLO_GOODPUT", "REJECT_SLO_P99",
    "REJECT_SLO_SHED", "REJECT_SLO_TTFT", "REJECT_SLO_UNFINISHED",
    "REPLAY_SCHEMA",
    "ReplayReport", "SCENARIOS", "ServiceModel", "SimReport", "SimRequest",
    "Simulator",
    "SloSelection", "SlotServer", "StepSample", "TRACE_SCHEMA",
    "ThrottleWindow",
    "TraceTraffic", "Traffic", "TrafficScenario", "UniformTraffic",
    "default_traffic", "evaluate_deployment", "load_trace", "make_traffic",
    "percentile", "replay", "simulate_serving", "throttle_scenario",
    "trace_requests", "trace_traffic",
]
