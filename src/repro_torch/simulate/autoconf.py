"""SLO-driven deployment selection: pick configs by simulated attainment.

``plan_deployment`` ranks ``(machine, dtype, batch)`` cells by *peak*
decode throughput — a steady-state number that says nothing about
queueing, batch formation, or tails.  This module re-scores the feasible
cells by what actually decides an edge deployment: run each one through
the discrete-event simulator under a concrete traffic scenario and keep
only the cells whose **simulated** p99 latency / TTFT / goodput meet the
:class:`SLO`.  The biggest batch usually wins peak throughput but loses
the tail (every decode step slows down with the pool size); the SLO mode
therefore picks a *smaller* batch whenever the tail demands it — with the
oversized cells recorded as machine-readable rejections
(``slo_p99_latency_exceeded`` et al.) right next to the memory rejections
in the deployment report.

``ServingEngine.autoconfigure(slo=...)`` is the front door; this module
is importable on its own for config-only studies (no params, no tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.simulate.metrics import SimReport
from repro_torch.simulate.server import POLICIES, ServiceModel, simulate_serving
from repro_torch.simulate.traffic import LengthDist, PoissonTraffic, Traffic

#: machine-readable SLO rejection reasons (join the REJECT_* memory codes
#: of ``repro_torch.serving.report`` in ``DeploymentReport.rejected``)
REJECT_SLO_P99 = "slo_p99_latency_exceeded"
REJECT_SLO_TTFT = "slo_p95_ttft_exceeded"
REJECT_SLO_GOODPUT = "slo_goodput_below_min"
REJECT_SLO_UNFINISHED = "slo_unfinished_requests"
REJECT_SLO_SHED = "slo_shed_above_max"

#: rejections recorded under a fault scenario carry this prefix, so a
#: fair-weather-feasible cell that dies under throttle is distinguishable
#: (``fault_slo_p99_latency_exceeded`` vs ``slo_p99_latency_exceeded``)
FAULT_REJECT_PREFIX = "fault_"


@dataclasses.dataclass(frozen=True)
class SLO:
    """A serving service-level objective, checkable against a sim report.

    Unset fields are unconstrained.  ``p99_latency_s`` bounds end-to-end
    request latency at the 99th percentile; ``p95_ttft_s`` bounds time to
    first token at the 95th; ``min_goodput_tps`` floors completed
    tokens/second; ``require_finished`` rejects runs that left requests
    in flight (an unstable queue never meets any tail bound honestly);
    ``max_shed_fraction`` caps load shedding — without it, a deadline-
    shedding run could trivially "attain" any latency bound by serving
    almost nothing.
    """

    p99_latency_s: float | None = None
    p95_ttft_s: float | None = None
    min_goodput_tps: float | None = None
    require_finished: bool = True
    max_shed_fraction: float | None = None

    @classmethod
    def coerce(cls, spec: Any) -> "SLO":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, Mapping):
            return cls(**spec)
        if isinstance(spec, (int, float)):
            return cls(p99_latency_s=float(spec))
        raise TypeError(f"cannot interpret {spec!r} as an SLO (pass an "
                        "SLO, a kwargs dict, or a bare p99 latency bound)")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def check(self, report: SimReport) -> list[dict]:
        """Machine-readable violations of this SLO in one sim report
        (empty list == attained)."""
        out = []

        def add(reason: str, observed: float, limit: float) -> None:
            out.append({"reason": reason, "observed": observed,
                        "limit": limit})

        if self.require_finished and report.requests["unfinished"]:
            add(REJECT_SLO_UNFINISHED, report.requests["unfinished"], 0)
        if self.max_shed_fraction is not None \
                and report.shed_fraction > self.max_shed_fraction:
            add(REJECT_SLO_SHED, report.shed_fraction,
                self.max_shed_fraction)
        if not report.requests["finished"]:
            return out
        if self.p99_latency_s is not None \
                and report.latency["p99"] > self.p99_latency_s:
            add(REJECT_SLO_P99, report.latency["p99"], self.p99_latency_s)
        if self.p95_ttft_s is not None \
                and report.ttft["p95"] > self.p95_ttft_s:
            add(REJECT_SLO_TTFT, report.ttft["p95"], self.p95_ttft_s)
        if self.min_goodput_tps is not None \
                and report.goodput_tps < self.min_goodput_tps:
            add(REJECT_SLO_GOODPUT, report.goodput_tps,
                self.min_goodput_tps)
        return out


def default_traffic(report, *, utilization: float = 0.6,
                    prompt_len: Any = 32, decode_len: Any = 16,
                    seed: int = 0) -> Traffic:
    """A Poisson scenario pinned to the deployment report: arrivals at
    ``utilization`` x the *peak* cell's request throughput (peak tokens/s
    divided by the mean decode length).  Deterministic given the report,
    so ``autoconfigure(slo=...)`` without an explicit traffic argument is
    reproducible."""
    if not report.options:
        raise ValueError("deployment report has no feasible options to "
                         "derive a traffic rate from")
    decode = LengthDist.coerce(decode_len)
    mean_decode = max(1.0, decode.mean_value(report.max_len))
    peak_rps = max(o.tokens_per_second for o in report.options) / mean_decode
    return PoissonTraffic(rate=utilization * peak_rps,
                          prompt_len=prompt_len, decode_len=decode,
                          seed=seed)


@dataclasses.dataclass
class SloSelection:
    """The sim-backed pick plus everything it was picked from."""

    option: Any                         # DeploymentOption
    policy: str
    sim: SimReport
    traffic_name: str
    slo: SLO
    results: list[dict]                 # one summary per (option, policy)
    rejections: list                    # CellRejection, SLO-reason coded
    faults: str | None = None           # fault scenario the cells ran under

    def as_dict(self) -> dict:
        return {
            "machine": self.option.machine, "dtype": self.option.dtype,
            "batch": self.option.batch, "policy": self.policy,
            "traffic": self.traffic_name, "slo": self.slo.as_dict(),
            "faults": self.faults,
            "sim": self.sim.summary(),
            "results": list(self.results),
            "rejected": [r.as_dict() for r in self.rejections],
        }


def evaluate_deployment(cfg, report, *, slo, traffic: Traffic | None = None,
                        policies: Sequence[str] = ("greedy",),
                        requests: int = 200, seed: int = 0,
                        machines: Mapping[str, Any] | None = None,
                        faults=None, deadline_s: float | None = None,
                        queue_limit: int | None = None,
                        attach: bool = True) -> SloSelection:
    """Simulate every feasible option of a deployment report under one
    traffic scenario and select by SLO attainment.

    Args:
        cfg: the model config the report was planned for.
        report: a :class:`repro_torch.serving.report.DeploymentReport`.
        slo: an :class:`SLO` (or anything :meth:`SLO.coerce` takes).
        traffic: the scenario; ``None`` uses :func:`default_traffic`.
        policies: admission policies to cross with the options (see
            ``repro_torch.simulate.server.POLICIES``; the real engine admits
            greedily).
        requests: simulated stream length per cell.
        seed: seeds the default traffic (an explicit ``traffic`` keeps
            its own seed).
        machines: optional ``name -> MachineSpec`` overrides for options
            planned on unregistered (derived) specs.
        faults: a :class:`~repro_torch.simulate.faults.FaultScenario` (or
            registry name / dict): every cell is simulated *under the
            perturbation* — the robust mode.  Cells that only fail under
            the faults are rejected with ``fault_``-prefixed reasons
            (``fault_slo_p99_latency_exceeded`` ...), so the report
            distinguishes fair-weather losers from fault casualties.
        deadline_s / queue_limit: optional shedding knobs forwarded to the
            simulated server (pair ``deadline_s`` with
            ``slo.max_shed_fraction`` so shedding cannot trivially attain
            the tail bound).
        attach: annotate the report in place — sim summaries onto the
            options, SLO rejections into ``report.rejected``, and the
            whole evaluation under ``report.slo``.

    Returns:
        A :class:`SloSelection`.  The winner is the SLO-attaining
        ``(option, policy)`` cell with the best simulated goodput,
        native-dtype cells preferred (mirroring ``report.select()``);
        ties break toward the smaller batch.

    Raises:
        ValueError: when no cell attains the SLO — the error carries every
            per-cell violation, machine-readably mirrored in
            ``report.rejected`` when ``attach`` is set.
    """
    from repro_torch.serving.report import CellRejection
    from repro_torch.simulate.faults import FaultScenario

    slo = SLO.coerce(slo)
    for p in policies:
        if p not in POLICIES:
            raise ValueError(f"unknown admission policy {p!r}; "
                             f"have {POLICIES}")
    if traffic is None:
        traffic = default_traffic(report, seed=seed)
    machines = dict(machines or {})
    scenario = FaultScenario.coerce(faults) if faults is not None else None
    prefix = FAULT_REJECT_PREFIX if scenario is not None else ""

    services: dict[tuple, ServiceModel] = {}
    results: list[dict] = []
    candidates: list[tuple] = []
    rejections: list = []
    sims: dict[int, dict] = {}          # option index -> policy -> summary
    for i, o in enumerate(report.options):
        key = (o.machine, o.dtype, o.batch)
        if key not in services:
            # a mixed-precision what-if cell's dtype is its "AxB->ACC"
            # label; plan its prefill ladder under the PrecisionConfig
            # with the compute dtype as the plannable base tag
            pc = o.precision
            plan_dtype = o.dtype
            if pc is not None:
                from repro_torch.core.precision import PrecisionConfig
                plan_dtype = PrecisionConfig.parse(pc).compute_dtype
            services[key] = ServiceModel.from_plans(
                cfg, batch=o.batch, machine=machines.get(o.machine,
                                                         o.machine),
                dtype=plan_dtype, precision=pc, backend=report.backend,
                max_len=report.max_len, decode_step_s=o.seconds_per_step)
        for policy in policies:
            rep = simulate_serving(
                services[key], traffic, max_batch=o.batch,
                max_len=report.max_len, policy=policy, requests=requests,
                deadline_s=deadline_s, queue_limit=queue_limit,
                faults=scenario,
                config={"machine": o.machine, "dtype": o.dtype})
            violations = slo.check(rep)
            row = {"machine": o.machine, "dtype": o.dtype,
                   "batch": o.batch, "policy": policy,
                   "peak_tokens_per_second": o.tokens_per_second,
                   "goodput_tps": rep.goodput_tps,
                   "p99_latency_s": rep.latency.get("p99"),
                   "p95_ttft_s": rep.ttft.get("p95"),
                   "slo_attained": not violations,
                   "violations": violations}
            if scenario is not None:
                row["faults"] = scenario.name
                row["shed_fraction"] = rep.shed_fraction
            results.append(row)
            sims.setdefault(i, {})[policy] = {
                "goodput_tps": rep.goodput_tps,
                "latency": rep.latency, "ttft": rep.ttft,
                "slo_attained": not violations}
            if violations:
                rejections.append(CellRejection(
                    machine=o.machine, dtype=o.dtype, batch=o.batch,
                    reason=prefix + violations[0]["reason"],
                    footprint_bytes=o.footprint.total_bytes,
                    budget_bytes=o.budget_bytes,
                    detail={"policy": policy, "traffic": traffic.name,
                            **({"faults": scenario.name}
                               if scenario is not None else {}),
                            "violations": violations}))
            elif o.precision is None:
                candidates.append((o, policy, rep))
            # mixed-precision what-if cells are simulated for the results
            # table but never deployed (mirroring report.select(): the
            # engine has no kernels to freeze for them)

    if attach:
        report.options = [
            dataclasses.replace(o, sim=sims.get(i)) if i in sims else o
            for i, o in enumerate(report.options)]
        report.rejected.extend(rejections)

    if not candidates:
        under = traffic.name + (f" + faults {scenario.name}"
                                if scenario is not None else "")
        why = "; ".join(sorted({
            f"{r['machine']}/{r['dtype']}/b{r['batch']}/{r['policy']}: "
            + ",".join(v["reason"] for v in r["violations"])
            for r in results if r["violations"]})) or "no options simulated"
        raise ValueError(
            f"no (machine, dtype, batch, policy) cell attains the SLO "
            f"{slo.as_dict()} under {under}: {why}")

    native = [c for c in candidates if c[0].dtype == report.native_dtype]
    pool = native or candidates
    option, policy, rep = min(
        pool, key=lambda c: (-c[2].goodput_tps, c[0].batch, c[0].machine,
                             c[0].dtype, c[1]))
    selection = SloSelection(
        option=option, policy=policy, sim=rep, traffic_name=traffic.name,
        slo=slo, results=results, rejections=rejections,
        faults=scenario.name if scenario is not None else None)
    if attach:
        report.slo = {
            "slo": slo.as_dict(), "traffic": traffic.name,
            "faults": scenario.name if scenario is not None else None,
            "requests": requests, "policies": list(policies),
            "selected": {"machine": option.machine, "dtype": option.dtype,
                         "batch": option.batch, "policy": policy,
                         "goodput_tps": rep.goodput_tps,
                         "p99_latency_s": rep.latency.get("p99")},
            "results": results,
        }
    return selection
