"""Simulation metrics: per-request records -> tail-latency report.

The collector receives lifecycle callbacks from the slot server (arrival,
admission, first token, finish) plus one sample per decode step (duration,
active slots, queue depth), and reduces them to the numbers an SLO is
written against: latency / TTFT / queue-wait percentiles, goodput, slot
utilization and queue depth.  The report persists as JSON
(``repro.simulate/report-v1``) exactly like ``repro_torch.measure``'s validation
reports, so simulated and measured artifacts live side by side.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Mapping

REPORT_SCHEMA = "repro.simulate/report-v1"


def percentile(xs, q: float) -> float:
    """Linear-interpolation percentile (``q`` in [0, 100]) of a sequence;
    NaN on empty input."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return float(xs[0])
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def _dist(xs) -> dict:
    xs = list(xs)
    if not xs:
        return {"count": 0}
    return {
        "count": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": percentile(xs, 50), "p95": percentile(xs, 95),
        "p99": percentile(xs, 99), "max": max(xs),
    }


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps of one simulated request (sim seconds)."""

    rid: int
    arrival_s: float
    prompt_len: int
    decode_len: int
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    tokens: int = 0
    deadline_s: float | None = None
    shed_s: float | None = None
    shed_cause: str | None = None

    @property
    def done(self) -> bool:
        return self.finish_s is not None

    @property
    def shed(self) -> bool:
        return self.shed_cause is not None

    @property
    def deadline_met(self) -> bool | None:
        """Whether the finish beat the deadline; ``None`` without one (or
        without a finish — a shed request never met its deadline)."""
        if self.deadline_s is None:
            return None
        if self.finish_s is None:
            return False if self.shed else None
        return (self.finish_s - self.arrival_s) <= self.deadline_s

    @property
    def wait_s(self) -> float:
        """Queue time: arrival -> admission."""
        return self.admit_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival -> first decode token."""
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        """End-to-end: arrival -> last token."""
        return self.finish_s - self.arrival_s

    @property
    def service_s(self) -> float:
        """Admission -> finish (time actually holding a slot)."""
        return self.finish_s - self.admit_s


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One decode step: when it started, how long it took, and occupancy."""

    t: float
    dt: float
    active: int
    admitted: int
    queue_depth: int


class Metrics:
    """Collector wired into the slot server's lifecycle hooks."""

    def __init__(self):
        self.records: dict[int, RequestRecord] = {}
        self.steps: list[StepSample] = []
        self.finish_order: list[int] = []

    # -- lifecycle hooks ----------------------------------------------------
    def on_arrival(self, rid: int, t: float, prompt_len: int,
                   decode_len: int, deadline_s: float | None = None) -> None:
        self.records[rid] = RequestRecord(
            rid=rid, arrival_s=t, prompt_len=prompt_len,
            decode_len=decode_len, deadline_s=deadline_s)

    def on_shed(self, rid: int, t: float, cause: str) -> None:
        r = self.records[rid]
        r.shed_s = t
        r.shed_cause = cause

    def on_requeue(self, rid: int, t: float) -> None:
        """A slot failure evicted this request: its generated prefix is
        lost (never delivered), so the token/TTFT bookkeeping restarts."""
        r = self.records[rid]
        r.tokens = 0
        r.first_token_s = None
        r.admit_s = None

    def on_admit(self, rid: int, t: float) -> None:
        self.records[rid].admit_s = t

    def on_token(self, rid: int, t: float) -> None:
        r = self.records[rid]
        r.tokens += 1
        if r.first_token_s is None:
            r.first_token_s = t

    def on_finish(self, rid: int, t: float) -> None:
        self.records[rid].finish_s = t
        self.finish_order.append(rid)

    def on_step(self, sample: StepSample) -> None:
        self.steps.append(sample)

    # -- reduction ----------------------------------------------------------
    def report(self, *, config: Mapping[str, Any] | None = None,
               max_batch: int | None = None,
               faults: Mapping[str, Any] | None = None,
               drift: Mapping[str, Any] | None = None) -> "SimReport":
        done = [r for r in self.records.values() if r.done]
        shed = [r for r in self.records.values() if r.shed]
        busy = sum(s.dt for s in self.steps)
        span = max((r.finish_s for r in done), default=0.0)
        util = (sum(s.active * s.dt for s in self.steps)
                / (busy * max_batch)) if busy and max_batch else 0.0
        tokens = sum(r.tokens for r in done)
        causes: dict[str, int] = {}
        for r in shed:
            causes[r.shed_cause] = causes.get(r.shed_cause, 0) + 1
        with_deadline = [r for r in self.records.values()
                         if r.deadline_s is not None]
        deadline = {}
        if with_deadline:
            met = sum(1 for r in with_deadline if r.deadline_met)
            deadline = {"requests": len(with_deadline), "met": met,
                        "violated": len(with_deadline) - met}
        return SimReport(
            config=dict(config or {}),
            requests={"submitted": len(self.records), "finished": len(done),
                      "shed": len(shed),
                      "unfinished":
                          len(self.records) - len(done) - len(shed)},
            shed={"count": len(shed), "causes": causes} if shed else {},
            deadline=deadline,
            faults=dict(faults or {}),
            drift=dict(drift or {}),
            latency=_dist(r.latency_s for r in done),
            ttft=_dist(r.ttft_s for r in done),
            wait=_dist(r.wait_s for r in done),
            goodput_tps=(tokens / span) if span > 0 else 0.0,
            requests_per_s=(len(done) / span) if span > 0 else 0.0,
            queue={"mean_depth": (sum(s.queue_depth * s.dt for s in
                                      self.steps) / busy) if busy else 0.0,
                   "max_depth": max((s.queue_depth for s in self.steps),
                                    default=0)},
            slot_utilization=util,
            steps=len(self.steps),
            busy_s=busy,
            span_s=span,
            finish_order=list(self.finish_order),
            per_request=[dataclasses.asdict(r) for r in
                         sorted(self.records.values(), key=lambda r: r.rid)],
        )


@dataclasses.dataclass
class SimReport:
    """One simulation run, reduced.  ``config`` carries the cell identity
    (machine, dtype, batch, policy, traffic, seed) the run was scored at."""

    config: dict
    requests: dict
    latency: dict
    ttft: dict
    wait: dict
    goodput_tps: float
    requests_per_s: float
    queue: dict
    slot_utilization: float
    steps: int
    busy_s: float
    span_s: float
    shed: dict = dataclasses.field(default_factory=dict)
    deadline: dict = dataclasses.field(default_factory=dict)
    faults: dict = dataclasses.field(default_factory=dict)
    # online prediction-drift verdict (repro_torch.obs DriftMonitor.report()):
    # {} when the run carried no monitor, so older saved reports round-trip.
    drift: dict = dataclasses.field(default_factory=dict)
    finish_order: list[int] = dataclasses.field(default_factory=list)
    per_request: list[dict] = dataclasses.field(default_factory=list)

    @property
    def p99_latency_s(self) -> float:
        return self.latency.get("p99", float("nan"))

    @property
    def shed_count(self) -> int:
        return self.requests.get("shed", self.shed.get("count", 0))

    @property
    def shed_fraction(self) -> float:
        """Shed requests as a fraction of everything submitted."""
        n = self.requests.get("submitted", 0)
        return (self.shed_count / n) if n else 0.0

    @property
    def finite(self) -> bool:
        keys = ("mean", "p50", "p95", "p99", "max")
        return self.requests["finished"] > 0 and all(
            math.isfinite(self.latency[k]) for k in keys)

    def summary(self) -> dict:
        return {
            "config": self.config,
            "requests": self.requests,
            "latency": self.latency, "ttft": self.ttft, "wait": self.wait,
            "goodput_tps": self.goodput_tps,
            "requests_per_s": self.requests_per_s,
            "queue": self.queue,
            "slot_utilization": self.slot_utilization,
            "steps": self.steps, "busy_s": self.busy_s, "span_s": self.span_s,
            "shed": self.shed, "deadline": self.deadline,
            "faults": self.faults, "drift": self.drift,
        }

    def table(self) -> str:
        c = self.config
        lines = [
            f"sim {c.get('machine', '?')} dtype={c.get('dtype', '?')} "
            f"batch={c.get('batch', '?')} policy={c.get('policy', '?')} "
            f"traffic={c.get('traffic', '?')}",
            f"  requests   {self.requests['finished']}/"
            f"{self.requests['submitted']} finished "
            f"({self.requests['unfinished']} unfinished), "
            f"{self.steps} steps over {self.span_s:.4g}s",
            f"  goodput    {self.goodput_tps:.4g} tok/s "
            f"({self.requests_per_s:.4g} req/s), slot utilization "
            f"{self.slot_utilization:.1%}",
        ]
        for label, d in (("latency", self.latency), ("ttft", self.ttft),
                         ("wait", self.wait)):
            if d.get("count"):
                lines.append(
                    f"  {label:<9}  p50 {d['p50']:.4g}s  p95 {d['p95']:.4g}s"
                    f"  p99 {d['p99']:.4g}s  max {d['max']:.4g}s")
        lines.append(f"  queue      mean depth {self.queue['mean_depth']:.2f}"
                     f", max {self.queue['max_depth']}")
        if self.shed.get("count"):
            causes = ", ".join(f"{k}={v}" for k, v in
                               sorted(self.shed["causes"].items()))
            lines.append(f"  shed       {self.shed['count']} "
                         f"({self.shed_fraction:.1%}): {causes}")
        if self.deadline:
            lines.append(f"  deadline   {self.deadline['met']}/"
                         f"{self.deadline['requests']} met "
                         f"({self.deadline['violated']} violated)")
        if self.faults:
            bits = ", ".join(f"{k}={v}" for k, v in
                             sorted(self.faults.items())
                             if not isinstance(v, (dict, list)))
            lines.append(f"  faults     {bits}" if bits else
                         f"  faults     {self.faults.get('scenario', '?')}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"schema": REPORT_SCHEMA, **self.summary(),
                "finish_order": self.finish_order,
                "per_request": self.per_request}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "SimReport":
        if d.get("schema") != REPORT_SCHEMA:
            raise ValueError(f"unknown sim-report schema {d.get('schema')!r}")
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "SimReport":
        with open(path) as f:
            return cls.from_json(json.load(f))
