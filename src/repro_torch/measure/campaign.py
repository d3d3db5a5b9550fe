"""Measurement campaigns: sweep-planned grids, measured and fit-ready.

A campaign crosses a named problem grid with a pinned (variant x
micro-kernel) axis through :func:`repro.gemm.sweep` — the same bulk planner
the design-space studies use — and measures every planned grid point with
one timing harness, appending :class:`Sample` records to a
:class:`SampleStore`.  Pinning the selection matters: with an explicit
variant + micro-kernel the derived blocking depends only on the spec's
*geometry*, so the samples stay valid across rate refits (see
``store.py``).

``fit_from_store`` then closes the loop: it pulls a store's samples for a
template spec and hands them to :class:`repro.machines.Calibrator` — exactly
the ``(problem, micro-kernel, seconds)`` triples its vectorized
least-squares fit consumes — making ``python -m repro_torch.measure run`` +
``fit`` the paper's "small collection of experiments" end to end.

Grids:

* ``table2`` / ``mobilenet`` — the 19 MobileNetV1 im2col GEMMs of Table 2
  (``mobilenet`` is the alias; the dims are the paper's workload).
* ``smoke``  — six small shapes that measure in ~2 s on a laptop; used by CI
  and the planner benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.measure.harness import Harness, get_harness
from repro_torch.measure.store import Sample, SampleStore

#: the default micro-kernel axis for calibration campaigns.  Spanning several
#: shapes is load-bearing: under a single micro-kernel the streaming and
#: arithmetic design columns are all proportional to m*n*k and the fit is
#: provably rank-deficient (see Calibrator.design_matrix).
DEFAULT_FIT_MKS = ((4, 24), (8, 12), (12, 8), (16, 4))

_SMOKE_SHAPES = [(48, 96, 64), (96, 48, 80), (64, 160, 32),
                 (128, 64, 96), (32, 32, 256), (80, 112, 48)]


def grid_names() -> list[str]:
    return ["mobilenet", "smoke", "table2"]


def grid_problems(grid: str, dtype: str | None = None) -> list:
    """The problems of a named grid, with an optional dtype override
    (``smoke`` defaults to f32 so the host replay hits BLAS; the Table-2
    grids default to the paper's int8)."""
    from repro_torch.gemm.api import GemmProblem

    if grid in ("table2", "mobilenet"):
        from repro_torch.core.mobilenet import TABLE2
        return [GemmProblem.coerce(row.problem, dtype=dtype)
                for row in TABLE2]
    if grid == "smoke":
        return [GemmProblem.coerce(s, dtype=dtype, default_dtype="f32")
                for s in _SMOKE_SHAPES]
    raise KeyError(f"unknown campaign grid {grid!r}; have {grid_names()}")


@dataclasses.dataclass
class CampaignResult:
    """The measured grid plus bookkeeping."""

    grid: str
    machine: str
    harness: str
    samples: list[Sample]
    sweep_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def measured_seconds(self) -> float:
        return float(sum(s.seconds for s in self.samples))


def run_campaign(grid: str, *, machine="host-cpu", harness="host-numpy",
                 store: SampleStore | str | None = None,
                 dtype: str | None = None, backend: str | None = None,
                 variant=None, micro_kernels=DEFAULT_FIT_MKS,
                 policy: str = "analytic",
                 timing: Mapping[str, Any] | None = None,
                 truth=None, device: str | None = None, seed: int = 0,
                 problems: Sequence | None = None,
                 progress=None) -> CampaignResult:
    """Plan, measure and (optionally) store one campaign.

    ``backend`` defaults per harness: the host replay and the simulated
    oracle measure BLIS-variant plans (``analytic-gap8``); the execute
    harnesses measure their own plans (``cuda`` / ``reference``).  For
    backends with a micro-kernel sweep axis the grid is problems x
    ``micro_kernels`` under one ``variant`` (default B3A2C0); other backends
    get one searched plan per problem.  ``truth`` feeds the simulated
    harness; ``device`` places the execute harnesses' operands (default
    ``cuda``; ``"cpu"`` times the plain versions on the host);
    ``problems`` overrides the named grid's problem list.
    """
    from repro_torch import gemm
    from repro_torch.core.variants import Variant
    from repro_torch.machines import resolve

    spec = resolve(machine)
    if problems is not None:
        probs = list(problems)
        grid = "custom"          # don't stamp samples with a grid they
        # don't belong to — provenance must claim only measured workloads.
    else:
        probs = grid_problems(grid, dtype)
    from repro_torch.gemm.api import GemmProblem
    missing = sorted({p.dtype for p in probs if isinstance(p, GemmProblem)
                      and p.dtype not in spec.arith_rate})
    if missing:
        raise ValueError(
            f"{spec.name} has no arith_rate entry for dtype(s) {missing} "
            f"(have {sorted(spec.arith_rate)}); pass dtype= to the "
            f"campaign (e.g. --dtype {sorted(spec.arith_rate)[0]})")
    if isinstance(store, str):
        store = SampleStore(store)
    if not isinstance(harness, Harness):
        kwargs: dict[str, Any] = {}
        if harness == "simulated":
            if truth is None:
                raise ValueError("the simulated harness needs truth=<the "
                                 "ground-truth machine>")
            kwargs["truth"] = truth
        elif harness in ("cuda", "reference") and device is not None:
            kwargs["device"] = device
        harness = get_harness(harness, **kwargs)
    if harness.supported_dtypes is not None:
        unsup = sorted({p.dtype for p in probs
                        if isinstance(p, GemmProblem)
                        and p.dtype not in harness.supported_dtypes})
        if unsup:
            raise ValueError(
                f"the {harness.name} harness cannot materialise operands "
                f"for dtype(s) {unsup}; it supports "
                f"{sorted(harness.supported_dtypes)}")
    if backend is None:
        backend = {"cuda": "cuda", "reference": "reference"}.get(
            harness.name, "analytic-gap8")
    variant = variant or Variant.B3A2C0

    res = gemm.sweep(probs, backends=[backend], machines=[spec],
                     dtypes=[dtype] if dtype else None,
                     policies=[policy], variants=[variant],
                     micro_kernels=list(micro_kernels), cache=False)
    samples: list[Sample] = []
    for i, row in enumerate(res.rows):
        t = harness.measure(row.plan, timing=timing, seed=seed + i)
        s = Sample.from_measurement(row.plan, t, harness.name, spec,
                                    meta={"grid": grid})
        if store is not None:
            store.append(s)
        samples.append(s)
        if progress is not None:
            progress(s)
    return CampaignResult(grid=grid, machine=spec.name, harness=harness.name,
                          samples=samples, sweep_stats=dict(res.stats))


class CalibrationDriftError(RuntimeError):
    """The store's measurements disagree with the baseline spec beyond the
    drift threshold — the machine (or the store) is not what the spec says
    it is, and fitting would silently bake the disagreement into fresh
    rates.  Machine-readable via :meth:`as_dict`."""

    def __init__(self, *, baseline: str, store: str, samples: int,
                 median_ratio: float, drift: float, max_drift: float):
        self.baseline = baseline
        self.store = store
        self.samples = samples
        self.median_ratio = median_ratio
        self.drift = drift
        self.max_drift = max_drift
        super().__init__(
            f"{store}: measured times disagree with spec {baseline!r} — "
            f"median measured/predicted = {median_ratio:.3f} "
            f"(drift {drift:.1%} > max_drift {max_drift:.1%}).  Either the "
            f"machine has drifted since the baseline was calibrated or the "
            f"store holds someone else's samples; inspect with "
            f"`python -m repro_torch.measure validate`, then refit against a "
            f"trusted baseline or raise max_drift to accept the shift")

    def as_dict(self) -> dict:
        return {"error": "calibration_drift", "baseline": self.baseline,
                "store": self.store, "samples": self.samples,
                "median_ratio": self.median_ratio, "drift": self.drift,
                "max_drift": self.max_drift}


def fit_from_store(store: SampleStore | str, template, *,
                   name: str | None = None, date: str | None = None,
                   policy: str | None = None, per_mk_arith: bool = False,
                   overhead_per_block: bool = False,
                   register: bool = False, manifest_dir: str | None = None,
                   on_nonpositive: str = "raise",
                   weighting: str = "relative",
                   robust: str | None = None, trim_fraction: float = 0.1,
                   max_drift: float | None = None,
                   drift_baseline=None,
                   allow_stale: bool = False):
    """Fit ``template``'s rates from a store's measured samples.

    Pulls the samples whose geometry fingerprint matches the template
    (stale ones raise, see :meth:`SampleStore.for_machine`), groups them
    into the ``(problem, micro-kernel, seconds)`` triples
    :meth:`Calibrator.fit` consumes, and runs the vectorized least-squares
    fit.  Real measurements default to the relative-error solve
    (``weighting="relative"``) so MAPE over a wide-dynamic-range grid is
    what gets minimised; pass ``"absolute"`` for the plain solve.
    Returns ``(spec, FitReport)``.

    Samples of tile plans (a tile, no micro-kernel) are fitted on the tile
    each sample recorded: the ``cuda`` backend's with the Hopper tile model
    it plans with (``model="hopper"``), so the validated prediction is the
    fitted one; other tile backends' with the TPU tile model
    (``"pallas"``).  A store mixing kinds raises.

    ``overhead_per_block=True`` additionally fits a constant cost per
    innermost micro-kernel dispatch (recorded in fit provenance, not in the
    rate tables) so loop overhead on small blocks stops polluting the rates.

    ``robust``/``trim_fraction`` pass through to
    :meth:`repro.machines.Calibrator.fit` — use ``robust="huber"`` (or
    ``"trim"``) on field campaigns where a slice of the samples is
    corrupted (thermal throttling, background load) so the outliers don't
    drag every fitted rate.

    ``max_drift`` arms the drift gate: before fitting, every sample is
    priced by ``drift_baseline`` (default: the template itself) via
    :func:`repro.measure.validate.predict_samples`, and if the *median*
    measured/predicted ratio deviates from 1 by more than ``max_drift``
    the fit refuses with :class:`CalibrationDriftError` — a systematic
    disagreement with the registered spec means the samples describe a
    different machine (or a drifted one) and should be inspected, not
    silently absorbed.  The median is robust to the same outliers
    ``robust=`` handles, so the two compose: outliers don't trip the gate,
    wholesale drift does.
    """
    from repro_torch.core.variants import MicroKernel, Variant
    from repro_torch.machines import resolve
    from repro_torch.machines.calibrate import Calibrator

    if isinstance(store, str):
        store = SampleStore(store)
    spec = resolve(template)
    stored = store.for_machine(spec, allow_stale=allow_stale)
    samples = [s for s in stored if s.micro_kernel is not None]
    tiled = [s for s in stored if s.micro_kernel is None
             and s.tile is not None]
    if samples and tiled:
        raise ValueError(
            f"{store.path}: the store mixes BLIS-model and tile-model "
            f"samples for {spec.name!r}; fit one cost model at a time")
    if tiled:
        # tile plans, priced on each sample's recorded tile so pinned
        # k-outer samples stay k-outer: the cuda backend's on the Hopper
        # tile model it plans with, the others' on the TPU tile model.
        from repro_torch.measure.validate import parse_tile
        samples = tiled
        models = sorted({"hopper" if s.backend == "cuda" else "pallas"
                         for s in samples})
        if len(models) > 1:
            raise ValueError(
                f"{store.path}: the store mixes cuda and other tile-model "
                f"samples for {spec.name!r}; fit one cost model at a time")
        cal = Calibrator(spec, model=models[0])
        selection = {"tiles": [parse_tile(s.tile) for s in samples]}
    elif not samples:
        raise ValueError(
            f"{store.path}: no BLIS-model or tile-model samples for machine "
            f"{spec.name!r} (geometry {spec.geometry_fingerprint()}) — run a "
            f"campaign first (python -m repro_torch.measure run)")
    else:
        variants = sorted({s.variant for s in samples})
        if len(variants) > 1:
            raise ValueError(
                f"samples span variants {variants}; fit one variant at a "
                f"time (filter the store or run separate campaigns)")
        if policy is None:
            policies = sorted({s.policy for s in samples})
            if len(policies) > 1:
                raise ValueError(f"samples span policies {policies}; pass "
                                 f"policy= explicitly")
            policy = policies[0]
        cal = Calibrator(spec, model="blis", variant=Variant(variants[0]),
                         policy=policy)
        selection = {"micro_kernels": [
            MicroKernel(*map(int, s.micro_kernel.split("x")))
            for s in samples]}
    if max_drift is not None:
        import statistics

        from repro_torch.measure.validate import predict_samples
        base = resolve(drift_baseline) if drift_baseline is not None \
            else spec
        predicted = predict_samples(base, samples)
        ratios = [s.seconds / p for s, p in zip(samples, predicted)
                  if p > 0.0]
        median_ratio = statistics.median(ratios)
        drift = abs(median_ratio - 1.0)
        if drift > max_drift:
            raise CalibrationDriftError(
                baseline=base.name, store=store.path, samples=len(ratios),
                median_ratio=median_ratio, drift=drift,
                max_drift=max_drift)
    probs = [s.problem for s in samples]
    seconds = [s.seconds for s in samples]
    harnesses = sorted({s.harness for s in samples})
    return cal.fit(
        probs, seconds, date=date, name=name,
        register=register, manifest_dir=manifest_dir,
        per_mk_arith=per_mk_arith, overhead_per_block=overhead_per_block,
        on_nonpositive=on_nonpositive,
        weighting=weighting, robust=robust, trim_fraction=trim_fraction,
        extra_provenance={"measure": {
            "store": store.path, "harnesses": harnesses,
            "grids": sorted({s.meta.get("grid", "?") for s in samples}),
        }}, **selection)
