"""The calibrate→register→plan pipeline (paper §3.2, made first-class).

The paper builds a machine from a handful of micro-experiments; this module
closes the loop so a calibrated spec feeds the planner instead of vanishing:

1. **measure** — :meth:`Calibrator.measure_host` runs the paper's §3.2
   host micro-experiments (``repro_torch.core.calibrate``); GEMM wall times
   come from ``repro_torch.measure`` campaigns.
2. **fit** — :meth:`Calibrator.fit` refines a spec against measured GEMM
   wall times.  The simulators are *linear in the inverse rates*: a GEMM's
   predicted time is ``sum_r bytes_r / rate_r + flops / arith``, so fitting
   all rates at once is one least-squares solve ``A x = t`` where ``x`` are
   inverse rates and the design matrix ``A`` comes from the **batched**
   engines (``traffic_terms_batch`` for the BLIS-variant model,
   ``estimate_batch`` for the Pallas/TPU model) — no scalar per-sample
   loops.  ``design_matrix_scalar`` replays the same accounting through the
   scalar simulators and is kept as the equivalence oracle for the tests.
3. **register / persist** — the fitted spec lands in the
   :mod:`repro.machines` registry and (optionally) a JSON manifest, carrying
   fit provenance: RMS residual, sample count, and the calibration date
   passed in by the caller.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.machines import registry as _registry
from repro_torch.machines.spec import MachineSpec


def _traced_fit(fn):
    """Wrap :meth:`Calibrator.fit` in an ``obs`` span carrying the fit's
    headline numbers — a refit shows up on the same timeline as the
    sweeps and serving steps it recalibrates."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with obs.span("calibrate.fit", template=self.template.name,
                      model=self.model) as sp:
            spec, report = fn(self, *args, **kwargs)
            sp.set(samples=report.samples, columns=len(report.columns),
                   residual_rms_s=report.residual_rms_s)
            obs.metrics.counter("calibrate.fits")
            return spec, report
    return wrapped

_RATE = "rate:"
_ARITH = "arith:"
#: design columns of per-event costs (Hopper model): ``call:<dtype>`` a
#: wrapper call's host cost, ``call:launch`` one enqueued device operation;
#: the solution is seconds per event, landing in ``call_costs``
_CALL = "call:"
#: design column of the opt-in per-block constant-overhead term
#: (``overhead_per_block=True``): coefficient = micro-kernel invocation
#: count, solution = seconds per innermost dispatch.
OVERHEAD_COL = "overhead:block"

#: rate assigned to design columns the fit marks as effectively free
#: (on_nonpositive="free"): large enough that the term contributes ~nothing,
#: finite so the spec still validates.
FREE_RATE = 1.0e18


@dataclasses.dataclass(frozen=True)
class FitReport:
    """Provenance of one vectorized rate fit."""

    columns: list[str]          # "rate:M->L2" / "arith:int8" design columns
    inverse_rates: np.ndarray   # the lstsq solution x (seconds per byte/op;
                                # NaN for dropped columns)
    residual_rms_s: float       # RMS of (A@x - t) over the samples
    samples: int
    date: str | None
    # columns the measurements could not support (solved non-positive) and
    # that fit(on_nonpositive="drop") eliminated; their template rates stand.
    dropped: list[str] = dataclasses.field(default_factory=list)
    # the robust estimator used ("huber" / "trim"), None for plain lstsq
    robust: str | None = None
    # sample indices the robust solve down-weighted below 0.5 — the rows it
    # treated as outliers; residual_rms_s excludes them when robust is set
    outliers: list[int] = dataclasses.field(default_factory=list)
    # fitted constant cost per innermost micro-kernel dispatch
    # (overhead_per_block=True); None when the column was not requested or
    # was dropped.  Lives in provenance only — the spec's rate tables stay
    # pure rates, and the simulators do not charge it.
    overhead_per_block_s: float | None = None
    # in-sample MAPE of the fitted design-matrix model over the samples the
    # fit trusted (inliers under robust) — comparable across fits with and
    # without the overhead column.
    insample_mape_pct: float | None = None

    def as_provenance(self) -> dict[str, Any]:
        d = {
            "method": "vectorized-lstsq",
            "columns": list(self.columns),
            "residual_rms_s": float(self.residual_rms_s),
            "samples": int(self.samples),
            "date": self.date,
        }
        if self.dropped:
            d["dropped_columns"] = list(self.dropped)
        if self.robust:
            d["robust"] = self.robust
            d["outlier_samples"] = [int(i) for i in self.outliers]
        if self.overhead_per_block_s is not None:
            d["overhead_per_block_s"] = float(self.overhead_per_block_s)
        if self.insample_mape_pct is not None:
            d["insample_mape_pct"] = float(self.insample_mape_pct)
        return d


def _robust_weights(A: np.ndarray, b: np.ndarray, kind: str,
                    trim_fraction: float) -> np.ndarray:
    """Outlier-resistant row weights via IRLS on the full-column system.

    Solve, measure residuals, re-weight, repeat until the weights settle.
    ``"huber"`` gives weight 1 to rows within 1.345 robust standard
    deviations (MAD scale) and ``k*scale/|r|`` beyond — a smooth
    down-weighting; ``"trim"`` is least-trimmed-squares: the worst
    ``trim_fraction`` of rows get weight exactly 0.  The weights live in
    the solve's weighting space, so under ``weighting="relative"`` a
    20x-slow thermal outlier has a 20x residual no matter how small the
    cell — which is exactly what makes it separable from honest noise.
    """
    n, p = A.shape
    w = np.ones(n)
    for _ in range(50):
        sw = np.sqrt(w)
        x, *_ = np.linalg.lstsq(A * sw[:, None], b * sw, rcond=None)
        r = np.abs(b - A @ x)
        if kind == "huber":
            med = float(np.median(r))
            scale = 1.4826 * float(np.median(np.abs(r - med)))
            if scale <= 0.0:
                # majority of rows fit exactly (synthetic data): any scale
                # dominated by the outliers keeps z tiny for the exact rows
                scale = max(float(np.mean(r)), 1e-300)
            z = r / scale
            w_new = np.minimum(1.0, 1.345 / np.maximum(z, 1e-300))
        else:  # trim
            keep_n = int(np.ceil((1.0 - trim_fraction) * n))
            keep_n = min(max(keep_n, p + 1), n)
            thresh = np.partition(r, keep_n - 1)[keep_n - 1]
            w_new = (r <= thresh).astype(np.float64)
        if np.allclose(w_new, w, rtol=0.0, atol=1e-6):
            return w_new
        w = w_new
    return w


class Calibrator:
    """Fit a machine's rate tables from measured GEMM times.

    ``template`` (name or spec) supplies the geometry — levels, capacities,
    register file — and any rates the fit does not exercise.  ``model``
    picks the cost model the design matrix replays: ``"blis"`` (the paper's
    variant simulator; default for int8-style scratchpad machines),
    ``"pallas"`` (the TPU tile model; default when the template declares a
    ``bf16`` rate) or ``"hopper"`` (the H100 tile model the ``cuda``
    backend plans on, ``core/hopper_model.py``: one column per rate, per
    dtype's arithmetic and per per-call cost).
    """

    def __init__(self, template, *, model: str | None = None,
                 variant=None, micro_kernel=None, policy: str = "analytic"):
        from repro_torch.core.variants import Variant, feasible_microkernels

        self.template = _registry.resolve(template)
        if model is None:
            model = "pallas" if "bf16" in self.template.arith_rate else "blis"
        if model not in ("blis", "pallas", "hopper"):
            raise ValueError(f"unknown cost model {model!r}; "
                             f"use 'blis', 'pallas' or 'hopper'")
        self.model = model
        self.policy = policy
        if model == "blis":
            self.variant = variant or Variant.B3A2C0
            cands = feasible_microkernels(self.template, self.variant)
            if micro_kernel is None:
                if not cands:
                    raise ValueError(
                        f"{self.template.name}: no feasible micro-kernel to "
                        f"calibrate with")
                micro_kernel = cands[0]
            self.micro_kernel = micro_kernel
        else:
            self.variant = None
            self.micro_kernel = None

    # -- design matrices ------------------------------------------------------

    def _coerce_problems(self, problems) -> list:
        from repro_torch.gemm.api import GemmProblem
        default = "int8" if self.model == "blis" else "bf16"
        return [GemmProblem.coerce(p, default_dtype=default)
                for p in problems]

    def _coerce_mks(self, probs, micro_kernels) -> list:
        from repro_torch.core.variants import MicroKernel
        if micro_kernels is None:
            return [self.micro_kernel] * len(probs)
        mks = [mk if isinstance(mk, MicroKernel)
               else MicroKernel(int(mk[0]), int(mk[1]))
               for mk in micro_kernels]
        if len(mks) != len(probs):
            raise ValueError(f"{len(probs)} problems vs {len(mks)} "
                             f"micro-kernels")
        return mks

    def design_matrix(self, problems, micro_kernels=None, *,
                      per_mk_arith: bool = False,
                      overhead_per_block: bool = False, tiles=None
                      ) -> tuple[np.ndarray, list[str]]:
        """(samples x columns) coefficients of the inverse rates, built with
        the batched engines — one vectorized evaluation for all samples.

        For the BLIS model, ``micro_kernels`` optionally gives a per-sample
        micro-kernel.  Calibration samples should span several micro-kernel
        shapes: under a single one every register-streaming term and the
        arithmetic term are exactly proportional to ``m*n*k``, which makes
        the system rank-deficient (the paper's calibration likewise varies
        the micro-kernel across its experiments).

        ``per_mk_arith`` splits the arithmetic column per (dtype,
        micro-kernel) — the paper-§4 refinement — so the fit lands an
        ``arith_per_mk`` table instead of one rate per dtype.  Caveat:
        under the *analytic* policy with a single dtype the register
        streaming terms are exactly proportional to ``m*n*k`` within each
        micro-kernel group, i.e. collinear with the per-mk arithmetic
        columns, and :meth:`fit` will correctly refuse the rank-deficient
        system — calibrate per-mk rates from ``padded``-policy samples
        (the ceil trip counts break the proportionality, mirroring a real
        edge-tiled implementation) or measure them directly like the paper.

        ``overhead_per_block`` (BLIS model) appends the carried-over
        constant-cost column :data:`OVERHEAD_COL`: its coefficient is the
        per-sample micro-kernel invocation count, so the solved entry is
        seconds per innermost dispatch — loop bookkeeping the pure rate
        model attributes (wrongly) to traffic on small blocks.

        ``tiles`` (pallas and hopper models) gives each sample's executed
        :class:`TileConfig`; by default every sample is priced on the tile
        the model's search picks for it on the template.
        """
        probs = self._coerce_problems(problems)
        if self.model == "blis":
            return self._design_blis_batch(
                probs, self._coerce_mks(probs, micro_kernels), per_mk_arith,
                overhead_per_block)
        if micro_kernels is not None:
            raise ValueError("micro_kernels only applies to the blis model")
        if per_mk_arith:
            raise ValueError("per_mk_arith only applies to the blis model")
        if overhead_per_block:
            raise ValueError("overhead_per_block only applies to the blis "
                             "model")
        if self.model == "hopper":
            return self._design_hopper_batch(probs, tiles)
        return self._design_pallas_batch(probs, tiles)

    @staticmethod
    def _arith_tag(p) -> str:
        """Arithmetic design-column tag: the PrecisionConfig key for a
        mixed-precision sample (fitted into ``rates_mixed``), the dtype
        otherwise.  Coerced ``GemmProblem``s normalize uniform configs to
        ``precision=None``, so ``precision is not None`` means mixed."""
        return p.precision.key() if p.precision is not None else p.dtype

    @staticmethod
    def _check_mixed(probs, *, per_mk_arith: bool, model: str) -> None:
        if not any(p.precision is not None for p in probs):
            return
        if model == "pallas":
            raise ValueError(
                "mixed-precision calibration samples need the 'blis' cost "
                "model; the pallas design matrix folds quantize traffic "
                "into hbm_bytes and cannot separate a per-config rate")
        if per_mk_arith:
            raise ValueError(
                "per_mk_arith cannot be combined with mixed-precision "
                "samples: rates_mixed is a flat per-config table, not a "
                "per-micro-kernel one")

    def _design_blis_batch(self, probs, mks, per_mk_arith: bool = False,
                           overhead_per_block: bool = False):
        from repro_torch.core.variants import (
            derive_blocking_batch,
            microkernel_invocations_batch,
            quant_ratio_arrays,
            traffic_terms_batch,
        )

        self._check_mixed(probs, per_mk_arith=per_mk_arith, model="blis")
        mach = self.template
        # per-sample (P,) arrays: micro-kernel dims align elementwise with
        # the problems, so every batched closed form broadcasts to (P,).
        rows = np.array([mk.rows for mk in mks], np.int64)
        cols = np.array([mk.cols for mk in mks], np.int64)
        m = np.array([p.m for p in probs], np.int64)
        n = np.array([p.n for p in probs], np.int64)
        k = np.array([p.k for p in probs], np.int64)
        s = np.array([p.elem_bytes for p in probs], np.int64)
        blk = derive_blocking_batch(self.variant, rows, cols, mach,
                                    m, n, k, s)
        # quant ratios come as (P, 1) lattice columns; this design matrix
        # broadcasts everything at (P,), so squeeze them to match.
        qa = quant_ratio_arrays(probs)
        if qa is not None:
            qa = {op: col[:, 0] for op, col in qa.items()}
        terms = traffic_terms_batch(self.variant, rows, cols, blk,
                                    m, n, k, s, policy=self.policy,
                                    quant=qa)
        cols_map: dict[str, np.ndarray] = {}
        for t in terms:
            key = (f"{_RATE}{mach.level(t.origin)}->"
                   f"{mach.level(t.dest)}")
            coeff = np.broadcast_to(t.bytes, (len(probs),)).astype(np.float64)
            if t.chunk is not None:
                # time = bytes / (rate * chunk/ref): fold the chunk scaling
                # into the coefficient of x = 1/rate.
                chunk = np.broadcast_to(np.asarray(t.chunk, np.float64),
                                        (len(probs),))
                coeff = coeff * (mach.reference_chunk / chunk)
            cols_map[key] = cols_map.get(key, 0.0) + coeff
        flops = np.array([p.flops for p in probs], np.float64)
        if per_mk_arith:
            # one column per (dtype, micro-kernel), in first-seen sample
            # order (mirrors the scalar oracle's insertion order).
            for dt, mk_s in dict.fromkeys(
                    (p.dtype, str(mk)) for p, mk in zip(probs, mks)):
                sel = np.array([p.dtype == dt and str(mk) == mk_s
                                for p, mk in zip(probs, mks)], np.float64)
                cols_map[f"{_ARITH}{dt}@{mk_s}"] = sel * flops
        else:
            for dt in sorted({self._arith_tag(p) for p in probs}):
                sel = np.array([self._arith_tag(p) == dt for p in probs],
                               np.float64)
                cols_map[f"{_ARITH}{dt}"] = sel * flops
        if overhead_per_block:
            cols_map[OVERHEAD_COL] = np.broadcast_to(
                microkernel_invocations_batch(
                    self.variant, rows, cols, blk, m, n, k,
                    policy=self.policy),
                (len(probs),)).astype(np.float64)
        names = list(cols_map)
        return np.stack([cols_map[c] for c in names], axis=1), names

    def _design_pallas_batch(self, probs, tiles=None):
        from repro_torch.core.autotune import tune_batch

        self._check_mixed(probs, per_mk_arith=False, model="pallas")
        from repro_torch.core.tpu_model import (
            DTYPE_BYTES,
            GridOrder,
            SUBLANE,
            estimate_batch,
            machine_peak,
        )

        mach = self.template
        shapes = [p.as_shape() for p in probs]
        if tiles is None:
            tiles = [d.tile for d in tune_batch(shapes, machine=mach)]
        elif len(tiles) != len(probs):
            raise ValueError(f"{len(probs)} problems vs {len(tiles)} tiles")
        m = np.array([p.m for p in probs], np.int64)
        n = np.array([p.n for p in probs], np.int64)
        k = np.array([p.k for p in probs], np.int64)
        s = np.array([DTYPE_BYTES[p.dtype] for p in probs], np.int64)
        sub = np.array([SUBLANE[p.dtype] for p in probs], np.int64)
        peak = np.array([machine_peak(mach, p.dtype) for p in probs],
                        np.float64)
        bm = np.array([t.bm for t in tiles], np.int64)
        bn = np.array([t.bn for t in tiles], np.int64)
        bk = np.array([t.bk for t in tiles], np.int64)
        inner = np.array([t.order is GridOrder.K_INNER for t in tiles], bool)
        costs = estimate_batch(m, n, k, s, sub, peak, bm, bn, bk, inner,
                               machine=mach)
        cols_map: dict[str, np.ndarray] = {
            f"{_RATE}{mach.level('M')}->{mach.level('L1')}":
                np.asarray(costs.hbm_bytes, np.float64),
            f"{_RATE}{mach.level('L1')}->{mach.level('R')}":
                np.asarray(costs.vmem_bytes, np.float64),
        }
        # t_compute = flops / (peak * eff) -> coefficient of 1/peak.
        flops = 2.0 * (m * n * k).astype(np.float64)
        for dt in sorted({p.dtype for p in probs}):
            sel = np.array([p.dtype == dt for p in probs], np.float64)
            tag = "bf16" if dt == "f32" else dt
            cols_map[f"{_ARITH}{tag}"] = cols_map.get(
                f"{_ARITH}{tag}", 0.0) + sel * flops / np.asarray(
                    costs.mxu_efficiency, np.float64)
        names = list(cols_map)
        return np.stack([cols_map[c] for c in names], axis=1), names

    def _hopper_columns(self, probs, flops, hbm, l2, calls, launches):
        """The Hopper model's design columns from its cost terms (arrays
        over the samples): rates first, then each dtype's arithmetic, each
        dtype's call cost and the launch cost."""
        mach = self.template
        dts = sorted({p.dtype for p in probs})
        cols: dict[str, Any] = {
            f"{_RATE}{mach.level('M')}->{mach.level('L2')}": hbm,
            f"{_RATE}{mach.level('L2')}->{mach.level('L1')}": l2,
        }
        sel = {dt: np.array([p.dtype == dt for p in probs], np.float64)
               for dt in dts}
        for dt in dts:
            cols[f"{_ARITH}{dt}"] = sel[dt] * flops
        for dt in dts:
            cols[f"{_CALL}{dt}"] = sel[dt] * calls
        cols[f"{_CALL}launch"] = launches
        return cols

    def _design_hopper_batch(self, probs, tiles=None):
        from repro_torch.core import hopper_model

        self._check_mixed(probs, per_mk_arith=False, model="hopper")
        shapes = [p.as_shape() for p in probs]
        if tiles is None:
            tiles = [c.tile for c in hopper_model.tune_batch(
                shapes, self.template)]
        elif len(tiles) != len(probs):
            raise ValueError(f"{len(probs)} problems vs {len(tiles)} tiles")
        c = hopper_model.estimate_batch(
            shapes, hopper_model.TileArrays.of(tiles, [p.dtype
                                                       for p in probs]),
            self.template)
        f64 = np.float64
        cols_map = self._hopper_columns(
            probs, c.flops, c.hbm_bytes, c.l2_bytes,
            c.calls.astype(f64), c.launches.astype(f64))
        names = list(cols_map)
        return np.stack([cols_map[n] for n in names], axis=1), names

    def design_matrix_scalar(self, problems,
                             micro_kernels=None, *,
                             per_mk_arith: bool = False,
                             overhead_per_block: bool = False
                             ) -> tuple[np.ndarray, list[str]]:
        """The per-sample scalar-loop design matrix, kept as the reference
        oracle the vectorized :meth:`design_matrix` must agree with
        (the tests assert exact equality)."""
        probs = self._coerce_problems(problems)
        self._check_mixed(probs, per_mk_arith=per_mk_arith,
                          model=self.model)
        mach = self.template
        cols_map: dict[str, list[float]] = {}
        rows_acc: list[dict[str, float]] = []
        if self.model == "blis":
            from repro_torch.core.variants import (
                derive_blocking,
                microkernel_invocations,
                traffic_terms,
            )
            mks = self._coerce_mks(probs, micro_kernels)
            for p, mk in zip(probs, mks):
                pr = p.as_problem()
                blk = derive_blocking(self.variant, mk, mach, pr)
                row: dict[str, float] = {}
                for t in traffic_terms(self.variant, mk, blk,
                                       pr, policy=self.policy):
                    key = (f"{_RATE}{mach.level(t.origin)}->"
                           f"{mach.level(t.dest)}")
                    coeff = t.bytes
                    if t.chunk is not None:
                        coeff = coeff * (mach.reference_chunk / t.chunk)
                    row[key] = row.get(key, 0.0) + coeff
                arith_key = f"{_ARITH}{p.dtype}@{mk}" if per_mk_arith \
                    else f"{_ARITH}{self._arith_tag(p)}"
                row[arith_key] = pr.flops
                if overhead_per_block:
                    row[OVERHEAD_COL] = microkernel_invocations(
                        self.variant, mk, blk, pr, policy=self.policy)
                rows_acc.append(row)
        elif overhead_per_block:
            raise ValueError("overhead_per_block only applies to the blis "
                             "model")
        elif self.model == "hopper":
            from repro_torch.core import hopper_model
            for p in probs:
                shape = p.as_shape()
                tile = hopper_model.tune_batch([shape], mach)[0].tile
                c = hopper_model.estimate(shape, tile, mach)
                terms = (np.array([float(v)]) for v in (
                    c.flops, c.hbm_bytes, c.l2_bytes, c.calls, c.launches))
                rows_acc.append({key: float(v[0]) for key, v in
                                 self._hopper_columns([p], *terms).items()})
        else:
            from repro_torch.core.autotune import tune_batch
            from repro_torch.core.tpu_model import estimate
            for p in probs:
                shape = p.as_shape()
                tile = tune_batch([shape], machine=mach)[0].tile
                c = estimate(shape, tile, mach)
                tag = "bf16" if p.dtype == "f32" else p.dtype
                rows_acc.append({
                    f"{_RATE}{mach.level('M')}->{mach.level('L1')}":
                        c.hbm_bytes,
                    f"{_RATE}{mach.level('L1')}->{mach.level('R')}":
                        c.vmem_bytes,
                    f"{_ARITH}{tag}": shape.flops / c.mxu_efficiency,
                })
        arith_keys: list[str] = []
        for row in rows_acc:
            for key in row:
                if key == OVERHEAD_COL:     # always the last column, as in
                    continue                # the batched builder
                if key.startswith((_ARITH, _CALL)):
                    if key not in arith_keys:
                        arith_keys.append(key)
                else:
                    cols_map.setdefault(key, [])
        # shared arith columns are sorted by tag in the batched builder;
        # per-mk columns keep first-seen sample order there too.
        # (hopper: each dtype's arithmetic, each dtype's call, the launch)
        if self.model == "hopper":
            arith_keys = [*sorted(k for k in arith_keys
                                  if k.startswith(_ARITH)),
                          *sorted(k for k in arith_keys
                                  if k.startswith(_CALL)
                                  and k != f"{_CALL}launch"),
                          f"{_CALL}launch"]
        elif not per_mk_arith:
            arith_keys = sorted(arith_keys)
        for key in arith_keys:
            cols_map.setdefault(key, [])
        if overhead_per_block:
            cols_map.setdefault(OVERHEAD_COL, [])
        names = list(cols_map)
        A = np.zeros((len(rows_acc), len(names)))
        for i, row in enumerate(rows_acc):
            for j, key in enumerate(names):
                A[i, j] = row.get(key, 0.0)
        return A, names

    def _template_rate(self, col: str) -> float:
        """The template's rate for one design column (what a dropped column
        keeps charging under ``on_nonpositive="drop"``)."""
        if col == OVERHEAD_COL:
            return FREE_RATE        # templates charge no per-block overhead
        if col.startswith(_CALL):   # seconds per event: its inverse
            cost = self.template.call_costs.get(col[len(_CALL):], 0.0)
            return 1.0 / cost if cost > 0.0 else FREE_RATE
        if col.startswith(_RATE):
            o, _, d = col[len(_RATE):].partition("->")
            return self.template.transfer_rates[(o, d)]
        dt, sep, mk_s = col[len(_ARITH):].partition("@")
        if "->" in dt:           # mixed-precision column, key "AxB->ACC"
            from repro_torch.core.precision import PrecisionConfig
            return self.template.arith_rate_mixed(
                dt, PrecisionConfig.parse(dt).compute_dtype)
        return self.template.arith_rate_for(dt, mk_s if sep else None)

    # -- the fit --------------------------------------------------------------

    @_traced_fit
    def fit(self, problems, seconds: Sequence[float], *, date: str | None,
            micro_kernels=None, name: str | None = None,
            register: bool = False, manifest_dir: str | None = None,
            per_mk_arith: bool = False, overhead_per_block: bool = False,
            on_nonpositive: str = "raise",
            weighting: str = "absolute",
            robust: str | None = None, trim_fraction: float = 0.1,
            extra_provenance: Mapping[str, Any] | None = None,
            tiles=None,
            ) -> tuple[MachineSpec, FitReport]:
        """One vectorized least-squares solve over all samples.

        Args:
            problems: measured GEMM problems (anything ``GemmProblem``
                coerces); one per entry of ``seconds``.
            seconds: measured wall times, aligned with ``problems``.
            date: calibration date to record in provenance.  Required —
                pass None *explicitly* to record an undated fit; the
                Calibrator never invents timestamps.
            micro_kernels: per-sample micro-kernels (BLIS model).  Pass a
                set spanning several shapes — a single-mk sample set is
                provably rank-deficient (see :meth:`design_matrix`).
                Samples carrying a mixed :class:`PrecisionConfig` (BLIS
                model only) contribute quantize-traffic coefficients to
                the transfer-rate columns and fit one ``arith:<key>``
                column per config, landing in the spec's ``rates_mixed``
                table; ``per_mk_arith`` cannot be combined with them.
            name: name for the fitted spec (default: template name).
            register: land the fitted spec in the registry (source
                ``"calibrated"``).
            manifest_dir: also persist the spec as ``<dir>/<name>.json``.
            per_mk_arith: fit the paper-§4 per-micro-kernel arithmetic
                table instead of one rate per dtype.
            overhead_per_block: also fit a constant cost per innermost
                micro-kernel dispatch (the :data:`OVERHEAD_COL` design
                column).  The solved value is recorded as
                ``FitReport.overhead_per_block_s`` and in the spec's fit
                provenance; the spec's rate tables are unchanged by it (the
                simulators charge rates only), so it is an *attribution*
                refinement: overhead seconds stop polluting the fitted
                rates of small-block samples.
            on_nonpositive: what to do when a column solves non-positive
                (the measurements assign that cost-model term no, or
                negative, cost).  ``"raise"`` refuses to emit a garbage
                spec; ``"drop"`` eliminates offending columns iteratively
                and keeps the template's rates for them (the term is real
                but these samples cannot see it); ``"free"`` likewise
                eliminates them but sets their rates to :data:`FREE_RATE`
                so the term costs ~nothing (the right attribution for
                machines that overlap that traffic with compute).  Either
                way the drop is recorded in provenance.
            weighting: ``"absolute"`` (default) solves plainly — exact on
                synthetic samples; ``"relative"`` solves in units of
                relative error (each row divided by its measured time) so
                a microsecond cell counts as much as a second cell — the
                right loss when the goal is MAPE over a wide-dynamic-range
                workload.
            robust: ``None`` (default) is the plain solve.  ``"huber"``
                down-weights outlier samples smoothly (IRLS, k=1.345, MAD
                scale); ``"trim"`` zeroes the worst ``trim_fraction`` of
                rows (least-trimmed-squares).  Use on field campaigns where
                a slice of the samples is corrupted — thermal throttling,
                a background process — and would otherwise drag every rate:
                the weights are computed once on the full-column system and
                the flagged rows are recorded in ``FitReport.outliers``.
            trim_fraction: fraction of rows ``robust="trim"`` discards
                (default 0.1); must be in [0, 0.5).
            extra_provenance: merged into the fitted spec's provenance.
            tiles: per-sample executed tiles (pallas model); default: the
                tile TileTuner picks for each sample on the template.

        Returns:
            ``(fitted_spec, fit_report)`` — the spec with refreshed rate
            tables and the :class:`FitReport` recording columns, inverse
            rates, residual RMS and drops.

        Raises:
            ValueError: mismatched problems/seconds lengths, an
                under-determined or rank-deficient design matrix,
                non-positive rates under ``on_nonpositive="raise"``,
                non-positive measured times under relative weighting, or
                an unknown ``on_nonpositive`` / ``weighting`` value.
        """
        if on_nonpositive not in ("raise", "drop", "free"):
            raise ValueError(f"on_nonpositive must be 'raise', 'drop' or "
                             f"'free', got {on_nonpositive!r}")
        if weighting not in ("absolute", "relative"):
            raise ValueError(f"weighting must be 'absolute' or 'relative', "
                             f"got {weighting!r}")
        if robust not in (None, "huber", "trim"):
            raise ValueError(f"robust must be None, 'huber' or 'trim', "
                             f"got {robust!r}")
        if robust == "trim" and not 0.0 <= trim_fraction < 0.5:
            raise ValueError(f"trim_fraction must be in [0, 0.5), "
                             f"got {trim_fraction!r}")
        t = np.asarray(list(seconds), np.float64)
        A, columns = self.design_matrix(problems, micro_kernels,
                                        per_mk_arith=per_mk_arith,
                                        overhead_per_block=overhead_per_block,
                                        tiles=tiles)
        if A.shape[0] != t.shape[0]:
            raise ValueError(f"{A.shape[0]} problems vs {t.shape[0]} "
                             f"measured times")
        if A.shape[0] < A.shape[1]:
            raise ValueError(
                f"under-determined fit: {A.shape[0]} samples for "
                f"{A.shape[1]} rate columns {columns}")
        if weighting == "relative" and np.any(t <= 0.0):
            raise ValueError("relative weighting needs strictly "
                             "positive measured times")
        Aw = A / t[:, None] if weighting == "relative" else A
        keep = list(range(len(columns)))
        dropped: list[int] = []

        def solve_target() -> np.ndarray:
            # under "drop" the emitted spec keeps charging the template rate
            # for dropped terms, so the kept columns must be solved against
            # the measured times *minus* that charge — otherwise the
            # re-solve absorbs the dropped term's time into the kept rates
            # and the spec double-counts it.  "free" terms charge ~nothing.
            adj = t
            if dropped and on_nonpositive == "drop":
                inv = np.array([1.0 / self._template_rate(columns[i])
                                for i in dropped])
                adj = t - A[:, dropped] @ inv
            return adj / t if weighting == "relative" else adj

        # robust row weights, computed once on the full-column system (the
        # outlier verdict should not depend on which columns later drop);
        # applied as sqrt-row-scaling so the lstsq below minimizes the
        # weighted loss.
        rw = np.ones(len(t))
        if robust is not None:
            rw = _robust_weights(Aw, solve_target(), robust, trim_fraction)
        sw = np.sqrt(rw)

        while True:
            x, _, rank, _ = np.linalg.lstsq(Aw[:, keep] * sw[:, None],
                                            solve_target() * sw,
                                            rcond=None)
            if rank < len(keep):
                kept_cols = [columns[i] for i in keep]
                raise ValueError(
                    f"rank-deficient fit (rank {rank} < {len(keep)} columns "
                    f"{kept_cols}): the samples cannot separate the rates — "
                    f"vary the micro-kernels and problem shapes "
                    f"(see design_matrix)")
            bad = [i for i, xi in zip(keep, x) if xi <= 0.0]
            if not bad:
                break
            if on_nonpositive == "raise":
                raise ValueError(
                    f"fit produced non-positive inverse rates for "
                    f"{[columns[i] for i in bad]}; the measured times are "
                    f"inconsistent with the cost model — not registering a "
                    f"garbage spec (pass on_nonpositive='drop' to keep the "
                    f"template's rates for those columns)")
            # NNLS-style: eliminate only the most-negative column per
            # iteration — a near-collinear partner may solve positive once
            # the worst offender is gone.
            worst = min(zip(keep, x), key=lambda kx: kx[1])[0]
            dropped.append(worst)
            keep.remove(worst)
            if not keep:
                raise ValueError(
                    "every design column solved non-positive — the measured "
                    "times are inconsistent with the cost model")
        # the residual is always reported in absolute seconds for the spec
        # actually emitted: dropped columns still contribute at the rate the
        # spec keeps for them (template rate under "drop", ~0 under "free").
        pred = A[:, keep] @ x
        if dropped:
            fallback = 1.0 / FREE_RATE if on_nonpositive == "free" else None
            inv = np.array([fallback if fallback is not None
                            else 1.0 / self._template_rate(columns[i])
                            for i in dropped])
            pred = pred + A[:, dropped] @ inv
        err = pred - t
        trusted = np.ones(len(t), bool)
        outliers: list[int] = []
        if robust is not None:
            # the residual headline describes the fit actually trusted:
            # RMS over the inlier rows, with the flagged rows reported
            outliers = [int(i) for i in np.flatnonzero(rw < 0.5)]
            inliers = rw >= 0.5
            if np.any(inliers):
                err = err[inliers]
                trusted = inliers
        residual = float(np.sqrt(np.mean(err ** 2)))
        ok = trusted & (t > 0.0)
        mape = float(100.0 * np.mean(np.abs(pred[ok] - t[ok]) / t[ok])) \
            if np.any(ok) else None
        overhead_s = None
        if overhead_per_block and OVERHEAD_COL in columns:
            j = columns.index(OVERHEAD_COL)
            if j in keep:
                overhead_s = float(x[keep.index(j)])
        x_full = np.full(len(columns), np.nan)
        x_full[keep] = x
        report = FitReport(columns=columns, inverse_rates=x_full,
                           residual_rms_s=residual, samples=len(t),
                           date=date,
                           dropped=[columns[i] for i in sorted(dropped)],
                           robust=robust, outliers=outliers,
                           overhead_per_block_s=overhead_s,
                           insample_mape_pct=mape)

        rates = dict(self.template.transfer_rates)
        arith = dict(self.template.arith_rate)
        arith_mk = {dt: dict(tab)
                    for dt, tab in self.template.arith_per_mk.items()}
        rates_mixed = dict(self.template.rates_mixed)
        call_costs = dict(self.template.call_costs)

        def assign(col: str, rate: float) -> None:
            if col == OVERHEAD_COL:
                # not a spec rate: the fitted dispatch cost lives in the
                # FitReport / provenance only (simulators charge rates).
                return
            if col.startswith(_RATE):
                o, _, d = col[len(_RATE):].partition("->")
                rates[(o, d)] = rate
            else:
                dt, sep, mk_s = col[len(_ARITH):].partition("@")
                if "->" in dt:      # mixed config key -> rates_mixed
                    rates_mixed[dt] = rate
                elif sep:
                    arith_mk.setdefault(dt, {})[mk_s] = rate
                else:
                    arith[dt] = rate
                    # a refitted shared rate supersedes any per-mk table the
                    # template carried for this dtype — keeping it would make
                    # arith_rate_for shadow the fresh fit with stale rates.
                    arith_mk.pop(dt, None)

        for i, xi in zip(keep, x):
            if columns[i].startswith(_CALL):    # seconds, not a rate
                call_costs[columns[i][len(_CALL):]] = float(xi)
            else:
                assign(columns[i], 1.0 / xi)
        if on_nonpositive == "free":
            for col in report.dropped:
                if col.startswith(_CALL):
                    call_costs[col[len(_CALL):]] = 0.0
                else:
                    assign(col, FREE_RATE)
        prov: dict[str, Any] = {"base": self.template.name,
                                "fit": report.as_provenance()}
        prov["fit"]["template_geometry"] = \
            self.template.geometry_fingerprint()
        prov["fit"]["weighting"] = weighting
        if report.dropped:
            prov["fit"]["nonpositive_policy"] = on_nonpositive
        if self.model == "blis":
            coerced = self._coerce_mks([None] * len(t), micro_kernels)
            mks = sorted({str(mk) for mk in coerced})
            prov["fit"]["cost_model"] = {
                "model": "blis", "variant": self.variant.value,
                "micro_kernels": mks, "policy": self.policy}
        else:
            prov["fit"]["cost_model"] = {"model": self.model}
        if extra_provenance:
            prov.update(extra_provenance)
        spec = dataclasses.replace(
            self.template, name=name or self.template.name,
            transfer_rates=rates, arith_rate=arith, arith_per_mk=arith_mk,
            rates_mixed=rates_mixed, call_costs=call_costs, provenance=prov)
        spec.validate()
        if register:
            _registry.register(spec, overwrite=True, source="calibrated")
        if manifest_dir:
            spec.to_manifest(os.path.join(manifest_dir, f"{spec.name}.json"))
        return spec, report

    # -- the paper's micro-experiments ---------------------------------------

    @classmethod
    def measure_host(cls, name: str = "host-cpu", *, date: str | None = None,
                     register: bool = False,
                     manifest_dir: str | None = None) -> MachineSpec:
        """Run the paper's §3.2 micro-experiments on this host and assemble
        a seed :class:`MachineSpec` (the redesigned ``calibrate_host``).

        The spec keeps the host-cpu template's geometry; the measured
        packing / copy / arithmetic rates replace the placeholder rates,
        with calibration provenance attached.
        """
        from repro_torch.core.calibrate import (
            measure_arith_rate,
            measure_copy_rate,
            measure_packing_rate,
        )

        pack4 = measure_packing_rate(4)
        copy = measure_copy_rate()
        arith = measure_arith_rate()
        template = _registry.get("host-cpu")
        spec = dataclasses.replace(
            template,
            name=name,
            # fresh measured rates supersede any per-mk table the template
            # carried — keeping it would shadow the new arith_rate.
            arith_per_mk={},
            transfer_rates={
                ("M", "M"): pack4,
                ("M", "L2"): pack4,
                ("L2", "M"): pack4,
                ("M", "L1"): copy,
                ("M", "R"): copy,
                ("L1", "R"): copy * 4,
                ("L2", "R"): copy * 2,
            },
            arith_rate={"int8": arith, "f32": arith},
            provenance={
                "base": template.name,
                "calibration": {
                    "method": "micro-experiments (paper 3.2)",
                    "date": date,
                    "measured": {"pack_r4_Bps": pack4, "copy_Bps": copy,
                                 "arith_ops": arith},
                },
            })
        spec.validate()
        if register:
            _registry.register(spec, overwrite=True, source="calibrated")
        if manifest_dir:
            spec.to_manifest(os.path.join(manifest_dir, f"{spec.name}.json"))
        return spec
