"""Zoo-wide deployment planning: rank ``(machine, dtype, batch)`` cells.

``plan_deployment`` turns the paper's predict-before-run loop into a
deployment decision: for every machine of the zoo (or any glob of it) it
crosses the serving dtype and decode-batch axes, prunes the cells whose
modelled memory footprint (``repro_torch.serving.footprint``) exceeds the
machine's deployment-level budget *before* the design-space sweep plans
them (via ``repro_torch.gemm.sweep``'s feasibility mask), and scores the
survivors by predicted decode throughput.  The result is a ranked
:class:`DeploymentReport`: per-machine best configurations with memory
headroom, plus a machine-readable rejection record for every infeasible
cell — the planner answers "where and how should this model serve", not
just "which GEMM is fastest".

Only the model *config* is needed (no parameters are instantiated), so the
report is cheap enough for a CLI: ``python -m repro_torch.serving plan``.
The counterpart of ``repro.serving.report``: the same ranking and the same
JSON on any registered backend; ``backend="cuda"`` prices the cells with
the Hopper tile model on ``h100`` (or a fitted manifest of the card).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

from repro_torch import gemm as gemm_api
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import DTYPE_BITS, PrecisionConfig
from repro_torch.machines import registry as _machines
from repro_torch.serving.footprint import Footprint, footprint

#: machine-readable rejection reasons, in the order they are diagnosed:
#: weights alone blow the budget (no batch can ever fit), the KV/state cache
#: pushes past it (a smaller batch may fit), or the activation workspace
#: tips the total over.  SLO-mode autoconfiguration appends further
#: rejections with ``slo_*`` codes (``repro_torch.simulate.autoconf``) — cells
#: that fit memory but fail their simulated tail-latency/goodput targets.
REJECT_WEIGHTS = "weights_exceed_budget"
REJECT_KV_CACHE = "kv_cache_exceeds_budget"
REJECT_FOOTPRINT = "footprint_exceeds_budget"


@dataclasses.dataclass(frozen=True)
class CellRejection:
    """One rejected ``(machine, dtype, batch)`` cell: memory-pruned before
    the sweep, or SLO-pruned by the simulator (``detail`` then carries the
    observed-vs-limit numbers and the admission policy)."""

    machine: str
    dtype: str
    batch: int
    reason: str             # a REJECT_* or slo_* code
    footprint_bytes: int
    budget_bytes: int
    detail: Any = None      # optional structured context (SLO violations)

    @property
    def deficit_bytes(self) -> int:
        """How far past the budget the modelled footprint lands."""
        return self.footprint_bytes - self.budget_bytes

    def as_dict(self) -> dict:
        out = {
            "machine": self.machine, "dtype": self.dtype,
            "batch": self.batch, "reason": self.reason,
            "footprint_bytes": self.footprint_bytes,
            "budget_bytes": self.budget_bytes,
            "deficit_bytes": self.deficit_bytes,
        }
        if self.detail is not None:
            out["detail"] = self.detail
        return out


@dataclasses.dataclass(frozen=True)
class DeploymentOption:
    """One feasible operating point: frozen plans + memory accounting."""

    machine: str
    dtype: str
    batch: int
    seconds_per_step: float
    tokens_per_second: float
    footprint: Footprint
    budget_bytes: int
    rows: tuple = ()        # the sweep rows (with plans) behind this point
    sim: Any = None         # per-policy simulated metrics (SLO mode)
    # mixed-precision cells: the PrecisionConfig key (None for the plain
    # dtype axis) and the bits-based accuracy proxy the ranking table shows
    # next to throughput (1.0 = full precision, 0.5 = int8, 0.25 = int4).
    precision: str | None = None
    accuracy_proxy: float = 1.0

    @property
    def headroom_bytes(self) -> int:
        return self.budget_bytes - self.footprint.total_bytes

    @property
    def headroom_fraction(self) -> float:
        return self.headroom_bytes / self.budget_bytes if self.budget_bytes \
            else 0.0

    def as_dict(self) -> dict:
        out = {
            "machine": self.machine, "dtype": self.dtype,
            "batch": self.batch,
            "seconds_per_step": self.seconds_per_step,
            "tokens_per_second": self.tokens_per_second,
            "footprint": self.footprint.as_dict(),
            "budget_bytes": self.budget_bytes,
            "headroom_bytes": self.headroom_bytes,
            "headroom_fraction": self.headroom_fraction,
            "precision": self.precision,
            "accuracy_proxy": self.accuracy_proxy,
        }
        if self.sim is not None:
            out["sim"] = self.sim
        return out


def _rank_key(o: DeploymentOption):
    # throughput first; name/dtype/batch tie-breaks keep the zoo-wide pick
    # deterministic across runs and machine-registration orders.
    return (-o.tokens_per_second, o.machine, o.dtype, -o.batch)


@dataclasses.dataclass
class DeploymentReport:
    """Ranked feasible operating points + machine-readable rejections."""

    model: str
    backend: str
    max_len: int
    native_dtype: str
    options: list[DeploymentOption]         # ranked, best first
    rejected: list[CellRejection]
    grid: dict = dataclasses.field(default_factory=dict)
    # populated by SLO-mode autoconfiguration (repro_torch.simulate.autoconf):
    # the traffic scenario, per-cell simulated results, and the selection
    slo: dict | None = None

    def best(self, *, machine: str | None = None,
             dtype: str | None = None) -> DeploymentOption:
        """The highest-ranked option, optionally filtered by machine/dtype.

        Raises:
            ValueError: when no feasible option matches (every cell was
                memory-pruned, or the filters exclude all survivors).
        """
        for o in self.options:
            if machine is not None and o.machine != machine:
                continue
            if dtype is not None and o.dtype != dtype:
                continue
            return o
        if self.options:
            # feasible cells exist — the filters matched none of them, a
            # different condition than everything being memory-pruned.
            raise ValueError(
                f"{len(self.options)} feasible option(s) exist for "
                f"{self.model} but none match machine={machine!r} "
                f"dtype={dtype!r}; feasible machines "
                f"{sorted({o.machine for o in self.options})}, dtypes "
                f"{sorted({o.dtype for o in self.options})}")
        why = "; ".join(sorted({f"{r.machine}/{r.dtype}: {r.reason}"
                                for r in self.rejected})) or "empty grid"
        raise ValueError(
            f"no feasible deployment for {self.model} (machine={machine}, "
            f"dtype={dtype}); rejections: {why}")

    def select(self) -> DeploymentOption:
        """The operating point autoconfigure freezes: best among the
        model's native-dtype options when any survive (the engine really
        decodes in that dtype; what-if dtypes and mixed-precision cells
        inform the ranking only), otherwise best overall."""
        for o in self.options:
            if o.precision is None and o.dtype == self.native_dtype:
                return o
        for o in self.options:
            if o.precision is None:
                return o
        return self.best()

    def per_machine_best(self) -> dict[str, DeploymentOption]:
        """Best option per machine, in rank order (dict preserves it)."""
        out: dict[str, DeploymentOption] = {}
        for o in self.options:
            out.setdefault(o.machine, o)
        return out

    def rejections_for(self, machine: str | None = None,
                       batch: int | None = None) -> list[CellRejection]:
        """Rejected cells, optionally filtered by machine and/or batch."""
        return [r for r in self.rejected
                if (machine is None or r.machine == machine)
                and (batch is None or r.batch == batch)]

    def table(self, limit: int | None = None) -> str:
        """Human-readable ranked table (options, then rejection summary)."""
        gib = 1024.0 ** 3
        lines = ["rank machine            dtype              batch  tok/s "
                 "     acc   footprint   headroom"]
        for i, o in enumerate(self.options[:limit], 1):
            lines.append(
                f"{i:<4} {o.machine:<18} {o.dtype:<18} {o.batch:<6}"
                f"{o.tokens_per_second:<10.3g} "
                f"{o.accuracy_proxy:<5.2f} "
                f"{o.footprint.total_bytes / gib:>8.3f}Gi "
                f"{o.headroom_fraction:>7.1%}")
        if limit is not None and len(self.options) > limit:
            lines.append(f"... ({len(self.options) - limit} more options)")
        if self.rejected:
            by_reason: dict[str, int] = {}
            for r in self.rejected:
                by_reason[r.reason] = by_reason.get(r.reason, 0) + 1
            lines.append(f"rejected {len(self.rejected)} cells: " + ", ".join(
                f"{n}x {reason}" for reason, n in sorted(by_reason.items())))
        return "\n".join(lines)

    def to_json(self) -> dict:
        out = {
            "model": self.model, "backend": self.backend,
            "max_len": self.max_len, "native_dtype": self.native_dtype,
            "grid": dict(self.grid),
            "options": [o.as_dict() for o in self.options],
            "rejected": [r.as_dict() for r in self.rejected],
        }
        if self.slo is not None:
            out["slo"] = self.slo
        return out

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")
        return path


def diagnose_rejection(fp: Footprint, budget: int) -> str:
    """The REJECT_* code for an over-budget footprint (weights alone, then
    weights+KV, then the full total — the first component that breaks)."""
    if fp.weights_bytes > budget:
        return REJECT_WEIGHTS
    if fp.weights_bytes + fp.kv_cache_bytes > budget:
        return REJECT_KV_CACHE
    return REJECT_FOOTPRINT


def plan_deployment(cfg: ModelConfig, *,
                    machines=None,
                    dtypes: Sequence[str] = ("bf16",),
                    batches: Sequence[int] = (1, 2, 4, 8, 16),
                    max_len: int = 512,
                    backend: str = "analytic-tpu",
                    memory: bool = True,
                    kv_dtype: str | None = None,
                    precisions: Sequence = ()) -> DeploymentReport:
    """Rank every feasible ``(machine, dtype, batch)`` serving cell.

    Args:
        cfg: model config; only shape fields are read (no params built).
        machines: machines axis — names, specs, globs (``"zoo/*"`` sweeps
            the whole registry), a list of any of those, or None for the
            backend's native default machine.
        dtypes: serving-dtype axis (weights/activations; the KV dtype
            follows ``kv_dtype``).
        batches: candidate decode-slot counts (``max_batch`` values).
        max_len: per-slot cache length the KV footprint is charged at.
        backend: planning backend for the decode-GEMM sweep.
        memory: enforce the deployment-memory budget (True, the default)
            or score every cell unconstrained (False — the pre-PR
            throughput-only behaviour, kept for what-ifs and tests).
        kv_dtype: KV-cache dtype override, forwarded to
            :func:`repro_torch.serving.footprint.footprint`.
        precisions: extra mixed-precision cells, each a
            :class:`~repro_torch.core.precision.PrecisionConfig` or key string
            (``"int4xint8->int32"``).  Each config adds one column per
            machine/batch next to the plain ``dtypes`` axis: weights are
            footprinted in the config's B (weights) dtype, the KV cache in
            its ``kv_dtype`` (falling back to ``kv_dtype``/serving-dtype
            rules), the decode GEMMs are planned with quantize traffic and
            mixed arithmetic rates, and the option carries the config key
            in ``DeploymentOption.precision`` plus its bits-based
            ``accuracy_proxy`` so the ranking reads as a
            throughput-vs-memory-vs-accuracy frontier.  ``select()`` never
            freezes a mixed cell (they inform the ranking only).

    Returns:
        A :class:`DeploymentReport` with options ranked by predicted decode
        tokens/second (deterministic tie-breaks) and one
        :class:`CellRejection` per memory-pruned cell.  Every option's
        footprint fits its machine's ``memory_budget()`` by construction.

    Raises:
        KeyError: unknown machine name or pattern matching nothing.
        ValueError: empty dtype/batch axes.
    """
    from repro_torch.core.autotune import model_gemm_shapes
    from repro_torch.gemm.backends import dtype_tag
    from repro_torch.gemm.registry import get_backend

    dtypes = list(dtypes)
    batches = sorted(set(int(b) for b in batches))
    if not dtypes or not batches:
        raise ValueError("plan_deployment needs non-empty dtypes and "
                         "batches axes")
    pcs = [PrecisionConfig.coerce(p) for p in precisions]
    native = dtype_tag(cfg.compute_dtype)
    default_machine = get_backend(backend).default_machine
    # expand_many canonicalizes names/globs; MachineSpec entries (possibly
    # unregistered derived machines) pass through and are keyed by name.
    default_name = _machines.resolve(None, default_machine).name

    def tag_of(entry) -> str:
        if isinstance(entry, _machines.MachineSpec):
            return entry.name
        return default_name if entry is None else entry

    # overlapping globs/names (machines=["zoo/*", "tpu-v5e"]) must not plan
    # a machine twice — duplicate rows would double-count seconds_per_step
    # in the by_point merge below.  First occurrence wins.
    entries, seen = [], set()
    for e in _machines.expand_many(machines):
        if tag_of(e) not in seen:
            seen.add(tag_of(e))
            entries.append(e)

    budgets = {tag_of(e): _machines.resolve(e, default_machine)
               .memory_budget() for e in entries}

    options: list[DeploymentOption] = []
    rejected: list[CellRejection] = []
    for batch in batches:
        shapes = model_gemm_shapes(cfg, tokens=batch)
        fps = {dt: footprint(cfg, batch=batch, max_len=max_len, dtype=dt,
                             kv_dtype=kv_dtype) for dt in dtypes}

        def mask(ma, dt, _batch=batch, _fps=fps):
            fp = _fps[dt]
            budget = budgets[tag_of(ma)]
            if fp.fits(budget):
                return True
            return (False, diagnose_rejection(fp, budget))

        res = gemm_api.sweep(shapes, machines=entries, backends=[backend],
                             dtypes=dtypes,
                             feasible=mask if memory else None)
        for pr in res.pruned:
            fp = fps[pr["dtype"]]
            rejected.append(CellRejection(
                machine=tag_of(pr["machine"]), dtype=pr["dtype"],
                batch=batch, reason=pr["reason"],
                footprint_bytes=fp.total_bytes,
                budget_bytes=budgets[tag_of(pr["machine"])]))
        by_point: dict[tuple, list] = {}
        for r in res.rows:
            by_point.setdefault((r.machine, r.problem.dtype), []).append(r)
        for (ma, dt), rows in sorted(by_point.items()):
            step = sum(r.seconds for r in rows)
            options.append(DeploymentOption(
                machine=ma, dtype=dt, batch=batch,
                seconds_per_step=step,
                tokens_per_second=(batch / step) if step else float("inf"),
                footprint=fps[dt], budget_bytes=budgets[ma],
                rows=tuple(rows),
                accuracy_proxy=min(1.0, DTYPE_BITS.get(dt, 16) / 16.0)))

        # mixed-precision cells ride the same machinery: one sweep per
        # config (the precision axis replaces the dtype axis — the config
        # pins every operand dtype itself), footprinted with weights in the
        # B-operand dtype and the cache in the config's kv_dtype.
        for pc in pcs:
            label = pc.key()
            fp = footprint(cfg, batch=batch, max_len=max_len,
                           dtype=pc.b_dtype,
                           kv_dtype=pc.kv_dtype or kv_dtype)

            def pmask(ma, dt, _fp=fp):
                budget = budgets[tag_of(ma)]
                if _fp.fits(budget):
                    return True
                return (False, diagnose_rejection(_fp, budget))

            pres = gemm_api.sweep(shapes, machines=entries,
                                  backends=[backend], precisions=[pc],
                                  feasible=pmask if memory else None)
            for pr in pres.pruned:
                rejected.append(CellRejection(
                    machine=tag_of(pr["machine"]), dtype=label,
                    batch=batch, reason=pr["reason"],
                    footprint_bytes=fp.total_bytes,
                    budget_bytes=budgets[tag_of(pr["machine"])]))
            p_by_machine: dict[str, list] = {}
            for r in pres.rows:
                p_by_machine.setdefault(r.machine, []).append(r)
            for ma, rows in sorted(p_by_machine.items()):
                step = sum(r.seconds for r in rows)
                options.append(DeploymentOption(
                    machine=ma, dtype=label, batch=batch,
                    seconds_per_step=step,
                    tokens_per_second=(batch / step) if step
                    else float("inf"),
                    footprint=fp, budget_bytes=budgets[ma],
                    rows=tuple(rows), precision=label,
                    accuracy_proxy=pc.accuracy_proxy))
    options.sort(key=_rank_key)
    return DeploymentReport(
        model=cfg.name, backend=backend, max_len=max_len,
        native_dtype=native, options=options, rejected=rejected,
        grid={"machines": sorted(budgets), "dtypes": dtypes,
              "batches": batches, "memory": memory,
              "precisions": [pc.key() for pc in pcs]},
    )
