"""Replay a real ``ServingEngine`` trace through the simulator.

The real engine emits an event trace (``repro.serving/trace-v1``: submits,
admissions, steps with wall-clock durations, finishes).  Replaying it here
closes the loop in the direction the ``repro_torch.measure`` subsystem closes it
for single GEMMs: the simulator re-enacts the recorded arrival stream
through its own queue/slot/step logic and the result is a validation
report — did the sim admit and finish requests in the same order, and how
far off are its latencies?

Two service modes:

* **measured** (``service=None``, the default): step ``k`` costs the real
  trace's ``k``-th recorded step duration.  This validates the *dynamics*
  (queueing, admission, batch formation) in isolation — with correct
  semantics the replayed latencies match the recorded ones almost exactly
  (same step count, same completion order; timestamps agree to the
  sub-step bookkeeping the engine does after stamping, documented at
  <2%).
* **model** (pass a :class:`~repro_torch.simulate.server.ServiceModel`): steps
  cost the analytic price.  Order should still match; the latency MAPE is
  then a statement about the calibrated cost model, directly comparable
  to ``repro_torch.measure``'s per-GEMM MAPE reports.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Any, Mapping

from repro_torch.simulate.engine import Simulator
from repro_torch.simulate.metrics import Metrics
from repro_torch.simulate.server import ServiceModel, SlotServer
from repro_torch.simulate.traffic import SimRequest, TraceTraffic

TRACE_SCHEMA = "repro.serving/trace-v1"
REPLAY_SCHEMA = "repro.simulate/replay-v1"


def load_trace(path: str) -> dict:
    with open(path) as f:
        trace = json.load(f)
    return check_trace(trace)


def check_trace(trace: Mapping[str, Any]) -> dict:
    if trace.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"unknown trace schema {trace.get('schema')!r} "
                         f"(want {TRACE_SCHEMA})")
    return dict(trace)


def _events(trace: Mapping[str, Any], kind: str) -> list[dict]:
    return [e for e in trace["events"] if e["type"] == kind]


def trace_requests(trace: Mapping[str, Any]) -> list[SimRequest]:
    """The recorded arrival stream as :class:`SimRequest` records.

    Arrival times are rebased so the first submit lands at t=0.  The
    decode length is the *actual* generated token count from the finish
    event (EOS and cache-limit stops included); a request the trace never
    finishes falls back to its ``max_new_tokens``.
    """
    submits = _events(trace, "submit")
    if not submits:
        raise ValueError("trace contains no submit events")
    t0 = min(e["t"] for e in submits)
    generated = {e["rid"]: e["tokens"] for e in _events(trace, "finish")}
    # a shed request has no finish event; its decode_len stays at
    # max_new_tokens — exactly what the engine's shedding decision priced
    return [SimRequest(
        rid=e["rid"], arrival_s=e["t"] - t0, prompt_len=e["prompt_len"],
        decode_len=generated.get(e["rid"], e["max_new_tokens"]),
        deadline_s=e.get("deadline_s"),
    ) for e in sorted(submits, key=lambda e: (e["t"], e["rid"]))]


def trace_traffic(trace: Mapping[str, Any]) -> TraceTraffic:
    """The recorded stream as a :class:`TraceTraffic` generator — feed it
    back to :func:`repro_torch.simulate.server.simulate_serving` (round-trips
    the request list bit-exactly)."""
    return TraceTraffic(trace_requests(trace))


def _fallback_service(trace: Mapping[str, Any]) -> ServiceModel:
    """A service model for measured replay's overflow: pure-decode steps
    (no admissions) price the decode step; prefill is unpriced (the
    measured durations normally cover every step, this is a backstop)."""
    steps = _events(trace, "step")
    decode = [e["dt"] for e in steps if not e.get("admitted")]
    dt = statistics.median(decode or [e["dt"] for e in steps] or [0.0])
    return ServiceModel(decode_step_s=dt, prefill_s={})


@dataclasses.dataclass(frozen=True)
class ReplayRow:
    """One request, real vs simulated."""

    rid: int
    real_latency_s: float
    sim_latency_s: float
    real_ttft_s: float | None = None
    sim_ttft_s: float | None = None

    @property
    def rel_err(self) -> float:
        return self.sim_latency_s / self.real_latency_s - 1.0

    @property
    def ape(self) -> float:
        return abs(self.sim_latency_s - self.real_latency_s) \
            / self.real_latency_s

    def as_dict(self) -> dict:
        return {"rid": self.rid, "real_latency_s": self.real_latency_s,
                "sim_latency_s": self.sim_latency_s,
                "real_ttft_s": self.real_ttft_s,
                "sim_ttft_s": self.sim_ttft_s,
                "rel_err": self.rel_err, "ape": self.ape}


@dataclasses.dataclass
class ReplayReport:
    """Sim-vs-real verdict for one trace."""

    mode: str                       # "measured" | "model"
    rows: list[ReplayRow]
    real_order: list[int]
    sim_order: list[int]
    steps_real: int
    steps_sim: int
    config: dict = dataclasses.field(default_factory=dict)
    # rid -> shed cause, both sides (empty when the trace has no deadlines)
    real_shed: dict = dataclasses.field(default_factory=dict)
    sim_shed: dict = dataclasses.field(default_factory=dict)

    @property
    def order_match(self) -> bool:
        return self.real_order == self.sim_order

    @property
    def shed_match(self) -> bool:
        """Did the simulator shed exactly the requests the real engine
        shed (by rid)?  The headline of resilience replay validation."""
        return set(self.real_shed) == set(self.sim_shed)

    @property
    def steps_match(self) -> bool:
        return self.steps_real == self.steps_sim

    @property
    def mape(self) -> float:
        """Mean absolute percentage latency error, in percent."""
        if not self.rows:
            return float("nan")
        return 100.0 * statistics.fmean(r.ape for r in self.rows)

    @property
    def worst(self) -> ReplayRow:
        return max(self.rows, key=lambda r: r.ape)

    def summary(self) -> dict:
        out = {
            "mode": self.mode, "requests": len(self.rows),
            "order_match": self.order_match,
            "steps_real": self.steps_real, "steps_sim": self.steps_sim,
            "mape_pct": self.mape, "config": self.config,
        }
        if self.real_shed or self.sim_shed:
            out["shed"] = {"match": self.shed_match,
                           "real": dict(self.real_shed),
                           "sim": dict(self.sim_shed)}
        if self.rows:
            w = self.worst
            out["worst"] = {"rid": w.rid, "ape_pct": 100.0 * w.ape,
                            "real_latency_s": w.real_latency_s,
                            "sim_latency_s": w.sim_latency_s}
        return out

    def table(self, limit: int | None = None) -> str:
        lines = [f"replay ({self.mode} service): "
                 f"{len(self.rows)} requests, steps real/sim "
                 f"{self.steps_real}/{self.steps_sim}, completion order "
                 + ("MATCH" if self.order_match else
                    f"MISMATCH {self.real_order} vs {self.sim_order}"),
                 "rid   real latency   sim latency     rel err"]
        for r in self.rows[:limit]:
            lines.append(f"{r.rid:<6}{r.real_latency_s:>11.4e} "
                         f"{r.sim_latency_s:>13.4e}{r.rel_err:>+11.2%}")
        if limit is not None and len(self.rows) > limit:
            lines.append(f"... ({len(self.rows) - limit} more rows)")
        lines.append(f"latency MAPE {self.mape:.2f}%")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"schema": REPLAY_SCHEMA, **self.summary(),
                "real_order": self.real_order, "sim_order": self.sim_order,
                "rows": [r.as_dict() for r in self.rows]}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


def replay(trace: Mapping[str, Any], service: ServiceModel | None = None, *,
           policy: str = "greedy") -> ReplayReport:
    """Re-enact a recorded engine trace and compare.

    Args:
        trace: a ``repro.serving/trace-v1`` dict (``ServingEngine.trace_
            json()``) or anything :func:`load_trace` read.
        service: ``None`` replays with the *measured* per-step durations
            (validating the dynamics); a :class:`ServiceModel` prices
            steps analytically (validating the cost model).
        policy: admission policy for the sim side (the real engine is
            ``greedy``).

    Returns:
        A :class:`ReplayReport`; ``order_match`` / ``mape`` are the
        headline verdicts.
    """
    trace = check_trace(trace)
    reqs = trace_requests(trace)
    t0 = min(e["t"] for e in _events(trace, "submit"))
    steps = _events(trace, "step")
    mode = "measured" if service is None else "model"
    step_times = [e["dt"] for e in steps] if service is None else None
    svc = service if service is not None else _fallback_service(trace)
    # the real drain loop starts after every submit; hold the sim's first
    # step to the recorded start so clocks stay aligned
    start_at = (min(e["t"] for e in steps) - t0) if steps else 0.0

    sim = Simulator(seed=0)
    server = SlotServer(sim, svc, max_batch=trace["max_batch"],
                        max_len=trace["max_len"], policy=policy,
                        start_at=start_at, step_times=step_times,
                        decision_step_s=trace.get("predicted_step_s"))
    server.drive(reqs)
    sim.run()

    finishes = {e["rid"]: e for e in _events(trace, "finish")}
    submits = {e["rid"]: e for e in _events(trace, "submit")}
    firsts = {e["rid"]: e["t"] for e in trace["events"]
              if e["type"] == "first_token"}
    rows = []
    for rec in server.metrics.records.values():
        fin = finishes.get(rec.rid)
        if fin is None or not rec.done:
            continue
        real_lat = fin["t"] - submits[rec.rid]["t"]
        real_ttft = (firsts[rec.rid] - submits[rec.rid]["t"]) \
            if rec.rid in firsts else None
        rows.append(ReplayRow(rid=rec.rid, real_latency_s=real_lat,
                              sim_latency_s=rec.latency_s,
                              real_ttft_s=real_ttft,
                              sim_ttft_s=rec.ttft_s))
    rows.sort(key=lambda r: r.rid)
    # the event list is chronological; same-step finishes keep slot order
    # on both sides, so the raw sequence IS the completion order
    real_order = [e["rid"] for e in _events(trace, "finish")]
    real_shed = {e["rid"]: e["cause"] for e in _events(trace, "shed")}
    sim_shed = {r.rid: r.shed_cause
                for r in server.metrics.records.values() if r.shed}
    return ReplayReport(
        mode=mode, rows=rows, real_order=real_order,
        sim_order=list(server.metrics.finish_order),
        steps_real=len(steps), steps_sim=server.steps_run,
        real_shed=real_shed, sim_shed=sim_shed,
        config={"max_batch": trace["max_batch"],
                "max_len": trace["max_len"], "policy": policy})
