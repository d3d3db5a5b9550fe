"""Design-space sweeps: the paper's §4 exploration as one bulk operation.

The paper's whole point is to *search* the algorithmic design space —
variants x micro-kernels x blockings on the GAP8, tile configurations on the
TPU — with a cheap analytic model before implementing anything.  ``sweep``
makes that a table-producing primitive: it crosses a problem list with
machine / backend / dtype / policy (and, for the GAP8 simulator, variant /
micro-kernel) axes, routes every grid point through the batched planning
engine via :func:`repro.gemm.planner.plan_many` (deduped, cached,
vectorized), and returns a :class:`SweepResult` whose rows carry the frozen
plan and its cost breakdown.

    >>> from repro_torch import gemm
    >>> from repro_torch.core.variants import Variant
    >>> res = gemm.sweep([(256, 784, 2304), (64, 3136, 576)],
    ...                  backends=["analytic-gap8"], variants=list(Variant))
    >>> res.best((256, 784, 2304)).selection
    VariantChoice(variant=<Variant.B3A2C0: 'B3A2C0'>, ...)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Sequence

from repro_torch import obs
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.simulator import CostBreakdown
from repro_torch.core.hopper_model import HopperCost
from repro_torch.core.tpu_model import TpuCost
from repro_torch.gemm.api import GemmPlan, GemmProblem
from repro_torch.gemm.planner import plan_cache_stats, plan_many
from repro_torch.machines import MachineSpec, expand_many


@dataclasses.dataclass(frozen=True)
class SweepRow:
    """One grid point: a problem planned under one axis combination."""

    problem: GemmProblem
    backend: str
    machine: str
    policy: str
    variant: str | None
    micro_kernel: str | None
    plan: GemmPlan
    scenario: str | None = None
    # precision-axis tag: the PrecisionConfig key ("int4xint8->int32") this
    # row was planned under, or None for the plain dtype axis.
    precision: str | None = None

    @property
    def selection(self) -> Any:
        return self.plan.selection

    @property
    def seconds(self) -> float:
        return self.plan.predicted_seconds

    def breakdown(self) -> dict[str, float]:
        """Per-component predicted seconds (grouped like the paper's
        figures for the GAP8 simulator; compute/HBM/VMEM for the TPU;
        compute/HBM/L2/host for the Hopper model)."""
        c = self.plan.cost
        if isinstance(c, CostBreakdown):
            return c.grouped()
        if isinstance(c, TpuCost):
            return {"compute": c.t_compute, "hbm": c.t_hbm, "vmem": c.t_vmem}
        if isinstance(c, HopperCost):
            return {"compute": c.t_compute, "hbm": c.t_hbm, "l2": c.t_l2,
                    "host": c.t_call + c.t_launch}
        return {}

    def as_dict(self) -> dict:
        p = self.problem
        return {
            "m": p.m, "n": p.n, "k": p.k, "dtype": p.dtype,
            "backend": self.backend, "machine": self.machine,
            "policy": self.policy, "variant": self.variant,
            "micro_kernel": self.micro_kernel,
            "scenario": self.scenario,
            "precision": self.precision,
            "selection": str(self.selection), "seconds": self.seconds,
            "breakdown": self.breakdown(),
        }


def _problem_matches(row_problem: GemmProblem, query) -> bool:
    if isinstance(query, GemmProblem):
        return row_problem == query
    if isinstance(query, (tuple, list)) and len(query) == 3:
        # bare (m, n, k): dtype-agnostic by design
        return (row_problem.m, row_problem.n, row_problem.k) == tuple(query)
    if (row_problem.m, row_problem.n, row_problem.k) != (
            getattr(query, "m", None), getattr(query, "n", None),
            getattr(query, "k", None)):
        return False
    dtype = getattr(query, "dtype", None)
    return dtype is None or row_problem.dtype == dtype


@dataclasses.dataclass
class SweepResult:
    """The full grid of planned points plus sweep-level bookkeeping.

    ``pruned`` records the ``(backend, machine, dtype)`` axis combinations a
    ``feasible`` mask rejected before any planning work, each with the
    mask's reason string.
    """

    rows: list[SweepRow]
    grid: dict[str, list]
    stats: dict = dataclasses.field(default_factory=dict)
    pruned: list[dict] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def filter(self, **axes) -> list[SweepRow]:
        """Rows matching every given axis value, e.g.
        ``filter(variant="B3A2C0", policy="analytic")``."""
        out = self.rows
        for name, want in axes.items():
            out = [r for r in out if getattr(r, name) == want]
        return out

    def best(self, problem=None) -> SweepRow:
        """The cheapest row overall, or for one problem (a
        :class:`GemmProblem`, ``(m, n, k)`` tuple, or core problem/shape)."""
        rows = self.rows if problem is None else \
            [r for r in self.rows if _problem_matches(r.problem, problem)]
        if not rows:
            raise ValueError(f"no sweep rows match problem {problem!r}")
        return min(rows, key=lambda r: r.seconds)

    def best_per_problem(self) -> dict[GemmProblem, SweepRow]:
        out: dict[GemmProblem, SweepRow] = {}
        for r in self.rows:
            cur = out.get(r.problem)
            if cur is None or r.seconds < cur.seconds:
                out[r.problem] = r
        return out

    def to_json(self) -> dict:
        def tag(v):
            if isinstance(v, MachineSpec):
                return v.name
            name = getattr(v, "name", None)
            return name if isinstance(name, str) else str(v)
        return {
            "grid": {k: [tag(v) for v in vs] for k, vs in self.grid.items()},
            "stats": self.stats,
            "pruned": list(self.pruned),
            "rows": [r.as_dict() for r in self.rows],
        }

    def table(self, limit: int | None = None) -> str:
        """Human-readable grid table (rows sorted as produced)."""
        lines = ["problem                  backend@machine       "
                 "variant/mk     policy    selection                 "
                 "seconds"]
        for r in self.rows[:limit]:
            p = r.problem
            vm = "/".join(x for x in (r.variant, r.micro_kernel) if x) or "-"
            lines.append(
                f"{p.m}x{p.n}x{p.k}:{p.dtype}".ljust(25)
                + f"{r.backend}@{r.machine}".ljust(22)
                + vm.ljust(15) + r.policy.ljust(10)
                + f"{r.selection}".ljust(26) + f"{r.seconds:.6g}")
        if limit is not None and len(self.rows) > limit:
            lines.append(f"... ({len(self.rows) - limit} more rows)")
        return "\n".join(lines)


def _axis(values, default=(None,)) -> list:
    if values is None:
        return list(default)
    if isinstance(values, (str, bytes)):
        return [values]
    return list(values)


def sweep(problems: Iterable, *,
          machines: Sequence | None = None,
          backends: Sequence[str] = ("analytic-tpu",),
          dtypes: Sequence[str] | None = None,
          policies: Sequence[str] = ("analytic",),
          variants: Sequence | None = None,
          micro_kernels: Sequence | None = None,
          scenarios: Sequence | None = None,
          precisions: Sequence | None = None,
          feasible=None,
          cache: bool = True,
          **options) -> SweepResult:
    """Plan every point of the problems x machines x backends x dtypes x
    policies (x variants x micro-kernels) grid as a bulk operation.

    Args:
        problems: GEMM problems (anything :meth:`GemmProblem.coerce`
            accepts); repeated problems are deduped before evaluation.
        machines: machines axis; entries may be registry names, raw
            :class:`MachineSpec` objects, or glob patterns (``"zoo/*"``
            expands to every manifest-backed machine, ``"gap*"``
            fnmatch-globs all registered names).  None means "the backend's
            native default".
        backends: backend-name axis (see ``repro.gemm.backends()``).
        dtypes: dtype-tag axis; None means the problems' own dtypes.
        policies: partial-tile accounting axis of the GAP8 simulator
            (``"analytic"`` | ``"padded"``).
        variants: GAP8-simulator loop-order axis, forwarded as the
            ``variant`` plan option.
        micro_kernels: GAP8-simulator micro-kernel axis (requires a variant
            axis, as with :func:`repro.gemm.plan`).  Backends whose search
            does not consume an axis (``Backend.sweep_axes``) get one grid
            point with that axis collapsed to None, rather than duplicate
            rows stamped with labels that had no effect.
        scenarios: workload-scenario axis.  Each entry is a label whose
            ``name`` attribute (or ``str()``) tags the rows it produced, and
            whose optional ``problems(base)`` hook maps the base problem
            list to the scenario's own — e.g. a
            :class:`repro.simulate.traffic.TrafficScenario` bound via
            ``.bind(cfg, max_len)`` appends the prefill-bucket GEMMs its
            prompt-length distribution can hit, so one sweep plans every
            shape a simulated serving run will price.  ``None`` (the
            default) keeps the classic un-tagged single-scenario grid.
        precisions: mixed-precision axis.  Each entry is a
            :class:`~repro.core.precision.PrecisionConfig` (or its key
            string, e.g. ``"int4xint8->int32"``) applied to every problem of
            the grid point via ``plan_many(..., precision=)``; rows are
            tagged with the config key in ``SweepRow.precision``.  A
            *uniform* entry normalizes to the plain dtype path and plans
            bit-identically to the equivalent ``dtypes`` axis point;
            ``None`` (the default) keeps the problems' own precision.
        feasible: optional feasibility mask ``feasible(machine, dtype) ->
            bool | (bool, reason)`` evaluated once per (machine, dtype)
            combination *before* any planning work; rejected combinations
            produce no rows and are recorded in ``SweepResult.pruned`` (and
            counted in ``stats["pruned"]``).  ``machine`` arrives as the
            expanded axis entry (name, spec, or None), ``dtype`` as the axis
            tag or None.  This is how deployment planning
            (``repro.serving``) prunes memory-infeasible cells without
            paying for their lattice evaluation.
        cache: consult/populate the process-level plan cache (default True).
        **options: forwarded to :func:`plan_many` (e.g. ``overlap=``).

    Returns:
        A :class:`SweepResult`: one :class:`SweepRow` per surviving grid
        point, carrying the frozen plan and its cost breakdown.

    Raises:
        UnknownBackendError: for a backend name absent from the registry.
        KeyError: for a machine name/pattern matching nothing.
    """
    from repro_torch.gemm.registry import get_backend

    problems = list(problems)
    grid = {
        "backends": _axis(backends), "machines": expand_many(machines),
        "dtypes": _axis(dtypes), "policies": _axis(policies),
        "variants": _axis(variants), "micro_kernels": _axis(micro_kernels),
        "scenarios": _axis(scenarios),
        "precisions": [PrecisionConfig.coerce(pc)
                       for pc in _axis(precisions)],
    }
    before = plan_cache_stats()
    rows: list[SweepRow] = []
    pruned: list[dict] = []
    verdicts: dict[tuple, tuple[bool, str | None]] = {}

    def admissible(be: str, ma, dt) -> bool:
        if feasible is None:
            return True
        key = (id(ma) if isinstance(ma, MachineSpec) else ma, dt)
        if key not in verdicts:
            with obs.span("gemm.sweep.prune", dtype=dt,
                          machine=(ma.name if isinstance(ma, MachineSpec)
                                   else ma)):
                verdict = feasible(ma, dt)
            ok, reason = verdict if isinstance(verdict, tuple) \
                else (verdict, None)
            verdicts[key] = (bool(ok), reason)
        ok, reason = verdicts[key]
        if not ok:
            tag = ma.name if isinstance(ma, MachineSpec) else ma
            pruned.append({"backend": be, "machine": tag, "dtype": dt,
                           "reason": reason or "infeasible"})
        return ok

    with obs.span("gemm.sweep", problems=len(problems),
                  backends=len(grid["backends"]),
                  machines=len(grid["machines"])) as sweep_span:
        for sc in grid["scenarios"]:
            sc_tag = None if sc is None else str(getattr(sc, "name", sc))
            sc_problems = problems
            transform = getattr(sc, "problems", None)
            if callable(transform):
                sc_problems = list(transform(problems))
            for be in grid["backends"]:
                axes = get_backend(be).sweep_axes
                vas = grid["variants"] if "variant" in axes else [None]
                mks = grid["micro_kernels"] if "micro_kernel" in axes \
                    else [None]
                for ma, dt in itertools.product(grid["machines"],
                                                grid["dtypes"]):
                    if not admissible(be, ma, dt):
                        continue
                    for po, va, mk, pc in itertools.product(
                            grid["policies"], vas, mks, grid["precisions"]):
                        opts = dict(options)
                        if va is not None:
                            opts["variant"] = va
                        if mk is not None:
                            opts["micro_kernel"] = mk
                        plans = plan_many(sc_problems, backend=be,
                                          machine=ma, dtype=dt, policy=po,
                                          precision=pc,
                                          cache=cache, **opts)
                        va_tag = None if va is None \
                            else str(getattr(va, "value", va))
                        mk_tag = None if mk is None else \
                            (str(mk) if not isinstance(mk, (tuple, list))
                             else f"{mk[0]}x{mk[1]}")
                        pc_tag = None if pc is None else pc.key()
                        rows.extend(SweepRow(
                            problem=p.problem, backend=be, machine=p.machine,
                            policy=po, variant=va_tag, micro_kernel=mk_tag,
                            plan=p, scenario=sc_tag, precision=pc_tag,
                        ) for p in plans)
        after = plan_cache_stats()
        # every counter the cache exposes is reported as a per-call delta
        # (manifest_hits included — it used to be missing, so back-to-back
        # sweeps leaked cumulative numbers into SweepResult.stats).
        stats = {
            "problems": len(problems),
            "grid_points": len(rows),
            "pruned": len(pruned),
            "deduped": after["deduped"] - before["deduped"],
            "cache_hits": after["hits"] - before["hits"],
            "cache_misses": after["misses"] - before["misses"],
            "manifest_hits": after["manifest_hits"]
                             - before["manifest_hits"],
        }
        sweep_span.set(grid_points=len(rows), pruned=len(pruned))
    obs.metrics.counter("sweep.cells_scored", len(rows))
    obs.metrics.counter("sweep.cells_pruned", len(pruned))
    return SweepResult(rows=rows, grid=grid, stats=stats, pruned=pruned)
