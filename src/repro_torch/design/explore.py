"""Score generated designs on real workloads and take the Pareto frontier.

``score_designs`` runs each design point through the *existing* engines —
the Table-2 GEMM grid via ``repro_torch.gemm.sweep`` (the batched planners) and,
when a model config is given, decode-GEMM serving throughput via
``repro_torch.serving.plan_deployment`` (which also applies the deployment
memory budget, so a design too small to hold the model is recorded
infeasible rather than scored on fiction).

``pareto`` then reduces the scores to a deterministic frontier over

* ``throughput``  — maximize (tokens/s when a model config is scored,
  else Table-2 grid GOPS),
* ``sram_bytes``  — minimize (on-chip L1+L2 the design must provision),
* ``area_proxy``  — minimize (the template's closed-form area estimate),

with one machine-readable :class:`DominanceRecord` per dominated design
(who dominated it, and by how much per objective).  ``rerank_by_slo``
optionally re-orders the frontier by simulated p99 SLO attainment using
``repro_torch.simulate.evaluate_deployment`` — the frontier says what is
*efficient*; the simulator says what actually *serves*.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

from repro_torch.design.space import DesignPoint, DesignSpace
from repro_torch.design.template import AcceleratorTemplate

#: frontier objectives, in record order: (name, direction)
OBJECTIVES = (("throughput", "max"), ("sram_bytes", "min"),
              ("area_proxy", "min"))


@dataclasses.dataclass(frozen=True)
class DesignScore:
    """One scored design: the objectives plus the evidence behind them."""

    name: str                       # gen/<family>-<digest>
    params: dict                    # axis overrides of the point
    throughput: float               # tokens/s (model) or GOPS (grid)
    throughput_unit: str            # "tokens/s" | "GOPS"
    sram_bytes: int
    area_proxy: float
    feasible: bool = True
    reject_reason: str | None = None
    detail: dict = dataclasses.field(default_factory=dict)

    def objectives(self) -> dict[str, float]:
        return {"throughput": self.throughput,
                "sram_bytes": float(self.sram_bytes),
                "area_proxy": self.area_proxy}

    def as_dict(self) -> dict:
        return {"design": self.name, "params": dict(self.params),
                "throughput": self.throughput,
                "throughput_unit": self.throughput_unit,
                "sram_bytes": int(self.sram_bytes),
                "area_proxy": self.area_proxy,
                "feasible": self.feasible,
                "reject_reason": self.reject_reason,
                "detail": dict(self.detail)}


@dataclasses.dataclass(frozen=True)
class DominanceRecord:
    """Why one design fell off the frontier: its dominator and the
    per-objective margins (dominator value minus this design's value;
    positive throughput delta / negative cost deltas mean "strictly
    better")."""

    design: str
    dominated_by: str
    deltas: dict[str, float]

    def as_dict(self) -> dict:
        return {"design": self.design, "dominated_by": self.dominated_by,
                "deltas": dict(self.deltas)}


@dataclasses.dataclass
class Frontier:
    """A deterministic Pareto frontier plus full dominance accounting."""

    frontier: list[DesignScore]         # throughput desc, area asc, name
    dominated: list[DominanceRecord]    # sorted by design name
    infeasible: list[DesignScore]       # memory-rejected designs, by name
    workload: str

    def __len__(self) -> int:
        return len(self.frontier)

    def as_dict(self) -> dict:
        return {
            "workload": self.workload,
            "objectives": [{"name": n, "direction": d}
                           for n, d in OBJECTIVES],
            "frontier": [s.as_dict() for s in self.frontier],
            "dominated": [r.as_dict() for r in self.dominated],
            "infeasible": [s.as_dict() for s in self.infeasible],
        }

    def table(self) -> str:
        unit = (self.frontier[0].throughput_unit if self.frontier
                else "throughput")
        head = (f"{'design':<28} {unit:>12} {'sram_KiB':>9} "
                f"{'area':>8}  params")
        lines = [head, "-" * len(head)]
        for s in self.frontier:
            lines.append(f"{s.name:<28} {s.throughput:>12.4g} "
                         f"{s.sram_bytes / 1024:>9.0f} "
                         f"{s.area_proxy:>8.1f}  "
                         + " ".join(f"{k}={v}" for k, v in s.params.items()))
        lines.append(f"[{len(self.frontier)} on frontier, "
                     f"{len(self.dominated)} dominated, "
                     f"{len(self.infeasible)} infeasible]")
        return "\n".join(lines)


def _dominates(a: DesignScore, b: DesignScore) -> bool:
    ge = (a.throughput >= b.throughput and a.sram_bytes <= b.sram_bytes
          and a.area_proxy <= b.area_proxy)
    strict = (a.throughput > b.throughput or a.sram_bytes < b.sram_bytes
              or a.area_proxy < b.area_proxy)
    return ge and strict


def pareto(scores: Iterable[DesignScore], *,
           workload: str = "table2") -> Frontier:
    """The non-dominated subset of ``scores`` (see module docstring).

    Deterministic: candidates are examined in sorted-name order and a
    dominated design records its first (lowest-named) dominator, so the
    same scores always produce the identical frontier and records.
    """
    feasible = sorted((s for s in scores if s.feasible),
                      key=lambda s: s.name)
    infeasible = sorted((s for s in scores if not s.feasible),
                        key=lambda s: s.name)
    front: list[DesignScore] = []
    dominated: list[DominanceRecord] = []
    for s in feasible:
        winner = next((o for o in feasible
                       if o.name != s.name and _dominates(o, s)), None)
        if winner is None:
            front.append(s)
        else:
            deltas = {k: winner.objectives()[k] - v
                      for k, v in s.objectives().items()}
            dominated.append(DominanceRecord(
                design=s.name, dominated_by=winner.name, deltas=deltas))
    front.sort(key=lambda s: (-s.throughput, s.area_proxy, s.name))
    return Frontier(frontier=front, dominated=dominated,
                    infeasible=infeasible, workload=workload)


# -- scoring -------------------------------------------------------------------


def _as_points(designs) -> list[DesignPoint]:
    if isinstance(designs, DesignSpace):
        return list(designs.points())
    out = []
    for i, d in enumerate(designs):
        if isinstance(d, DesignPoint):
            out.append(d)
        elif isinstance(d, AcceleratorTemplate):
            out.append(DesignPoint(index=i, params={}, template=d))
        else:
            raise TypeError(f"cannot score {d!r}; pass a DesignSpace, "
                            f"DesignPoints, or AcceleratorTemplates")
    return out


def score_designs(designs, *, cfg=None, grid: str = "table2",
                  dtype: str = "int8", batch: int = 8, max_len: int = 512,
                  backend: str = "analytic-gap8",
                  sample: int | None = None, method: str = "grid",
                  precision=None) -> list[DesignScore]:
    """Score each design of ``designs`` on the workload bundle.

    Args:
        designs: a :class:`DesignSpace` (optionally sub-``sample``-d), or
            an iterable of :class:`DesignPoint` / template objects.
        cfg: optional :class:`~repro_torch.configs.base.ModelConfig`; when given
            the throughput objective is decode tokens/s at ``batch`` from
            ``plan_deployment`` (memory-infeasible designs are recorded,
            not scored) and the Table-2 grid lands in ``detail`` only.
        grid: the GEMM grid for the grid objective (``repro_torch.measure``
            grid names; int8 by default to match the paper's Table 2).
        dtype / batch / max_len / backend: serving-cell knobs, forwarded
            to ``plan_deployment``.
        sample / method: when ``designs`` is a space, score only a
            deterministic ``sample``-point subset ("grid" or "halton").
        precision: optional mixed-precision workload
            (:class:`~repro_torch.core.precision.PrecisionConfig` or key string):
            the grid GEMMs are planned under it (quantize traffic + mixed
            arithmetic rates) and, with ``cfg``, the serving throughput
            comes from that precision's deployment cell.

    Returns:
        One :class:`DesignScore` per design, in input (index) order.
    """
    from repro_torch import gemm
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.measure.campaign import grid_problems

    pc = PrecisionConfig.coerce(precision)
    if isinstance(designs, DesignSpace) and sample is not None:
        points = designs.sample(sample, method=method)
    else:
        points = _as_points(designs)
    problems = grid_problems(grid, dtype=dtype)
    flops = sum(2.0 * p.m * p.n * p.k for p in problems)
    scores: list[DesignScore] = []
    for pt in points:
        spec = pt.spec()
        tpl = pt.template
        res = gemm.sweep(problems, machines=[spec], backends=[backend],
                         precisions=[pc] if pc is not None else None)
        grid_s = sum(r.seconds for r in res.best_per_problem().values())
        detail: dict[str, Any] = {
            "grid": grid, "grid_seconds": grid_s,
            "grid_gops": flops / grid_s / 1e9,
            "label": pt.label(), "index": pt.index,
        }
        if pc is not None:
            detail["precision"] = pc.key()
        throughput, unit = detail["grid_gops"], "GOPS"
        feasible, reason = True, None
        if cfg is not None:
            report = plan_point(spec, cfg, dtype=dtype, batch=batch,
                                max_len=max_len, backend=backend,
                                precision=pc)
            detail["arch"] = cfg.name
            detail["batch"] = batch
            # score the requested precision's cell (the plain dtype cell
            # rides along in the report for reference only)
            want = None if pc is None else pc.key()
            opts = [o for o in report.options if o.precision == want]
            if opts:
                best = opts[0]
                throughput, unit = best.tokens_per_second, "tokens/s"
                detail["tokens_per_second"] = best.tokens_per_second
                detail["footprint_bytes"] = best.footprint.total_bytes
            else:
                feasible = False
                reason = (report.rejected[0].reason if report.rejected
                          else "no_feasible_cell")
                throughput, unit = 0.0, "tokens/s"
        scores.append(DesignScore(
            name=spec.name, params=dict(pt.params), throughput=throughput,
            throughput_unit=unit, sram_bytes=tpl.sram_bytes,
            area_proxy=tpl.area_proxy(), feasible=feasible,
            reject_reason=reason, detail=detail))
    return scores


def plan_point(spec, cfg, *, dtype: str = "int8", batch: int = 8,
               max_len: int = 512, backend: str = "analytic-gap8",
               precision=None):
    """One design's deployment report for one serving cell (a thin
    ``plan_deployment`` wrapper; generated specs pass through unregistered).
    ``precision`` adds that mixed-precision cell next to the dtype cell."""
    from repro_torch.serving.report import plan_deployment

    return plan_deployment(cfg, machines=[spec], dtypes=(dtype,),
                           batches=(batch,), max_len=max_len,
                           backend=backend,
                           precisions=() if precision is None
                           else (precision,))


def rerank_by_slo(frontier: Frontier, designs, cfg, *, slo,
                  dtype: str = "int8", batch: int = 8, max_len: int = 512,
                  backend: str = "analytic-gap8", requests: int = 200,
                  seed: int = 0, traffic=None,
                  utilization: float = 0.6) -> list[dict]:
    """Re-rank a frontier by simulated SLO attainment.

    Every frontier design's serving cell is simulated via
    ``repro_torch.simulate.evaluate_deployment``; the result is a ranked record
    list — attaining designs first (by simulated goodput, then name),
    then the violators (by name) with their violation lists.  The Pareto
    frontier itself is untouched: this is the "which efficient design
    actually serves" view of it.

    Traffic: pass an explicit ``traffic`` (e.g. a ``PoissonTraffic`` at
    the demand the product must serve) to load every design with the
    *same* arrival stream — the design-comparison question.  Without it,
    each design faces the report-default open-loop traffic at
    ``utilization`` x *its own* peak throughput, which compares designs
    at equal relative load (a faster design is also asked to serve
    proportionally more).
    """
    from repro_torch.simulate.autoconf import SLO, default_traffic, \
        evaluate_deployment

    slo = SLO.coerce(slo)
    by_name = {pt.template.name: pt for pt in _as_points(designs)}
    records: list[dict] = []
    for s in frontier.frontier:
        pt = by_name.get(s.name)
        if pt is None:
            continue
        spec = pt.spec()
        report = plan_point(spec, cfg, dtype=dtype, batch=batch,
                            max_len=max_len, backend=backend)
        if not report.options:
            continue
        rec: dict[str, Any] = {"design": s.name, "params": dict(s.params),
                               "area_proxy": s.area_proxy,
                               "sram_bytes": s.sram_bytes}
        cell_traffic = (traffic if traffic is not None
                        else default_traffic(report,
                                             utilization=utilization))
        try:
            sel = evaluate_deployment(cfg, report, slo=slo,
                                      traffic=cell_traffic,
                                      requests=requests, seed=seed,
                                      machines={spec.name: spec},
                                      attach=False)
            sim = sel.sim.summary()
            rec.update(attained=True, policy=sel.policy,
                       goodput_tps=sim["goodput_tps"],
                       p99_latency_s=sim["latency"]["p99"])
        except ValueError as e:
            rec.update(attained=False, error=str(e).splitlines()[0],
                       goodput_tps=0.0, p99_latency_s=float("inf"))
        records.append(rec)
    records.sort(key=lambda r: (not r["attained"], -r["goodput_tps"],
                                r["design"]))
    return records


__all__ = ["DesignScore", "DominanceRecord", "Frontier", "OBJECTIVES",
           "pareto", "plan_point", "rerank_by_slo", "score_designs"]
