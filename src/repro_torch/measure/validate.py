"""Predicted-vs-measured accuracy reports — the paper's claim, runnable.

The paper's headline (§3.2/§4) is that a handful of calibration experiments
make the analytic simulator "deliver highly accurate estimations of the
execution time".  This module turns that into an artifact: re-predict every
measured :class:`Sample` under a spec (same pinned selection, same policy),
and report per-cell relative error, MAPE, the worst cell, and per-dtype /
per-micro-kernel breakdowns, as a table and as persisted JSON.

The per-micro-kernel breakdown is also where the ``arith_per_mk``
refinement (paper §4) shows up: a spec carrying per-mk arithmetic rates is
predicted through them, so fitting the table should flatten the per-mk
error profile.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
from typing import Any, Mapping

from repro_torch.measure.store import Sample, SampleStore

REPORT_SCHEMA = "repro.measure/validation-v1"


def parse_tile(tag: str):
    """A TileConfig from its ``str()`` form, e.g. ``64x128x128:k_inner``."""
    from repro_torch.core.tpu_model import GridOrder, TileConfig
    dims, _, order = tag.partition(":")
    bm, bn, bk = (int(x) for x in dims.split("x"))
    return TileConfig(bm, bn, bk, GridOrder(order or "k_inner"))


def predict_plan(plan, machine) -> float:
    """Re-predict a plan's time under another machine, keeping the pinned
    selection and policy (shared by the simulated harness and the
    validator)."""
    from repro_torch import gemm
    from repro_torch.gemm.api import VariantChoice

    sel = plan.selection
    opts: dict[str, Any] = {}
    if isinstance(sel, VariantChoice):
        opts = {"variant": sel.variant, "micro_kernel": sel.micro_kernel}
    elif sel is not None:
        opts = {"tile": sel}
    p = gemm.plan(plan.problem, backend=plan.backend, machine=machine,
                  policy=str(plan.provenance.get("policy", "analytic")),
                  cache=False, **opts)
    return p.predicted_seconds


def _sample_plan_opts(sample: Sample) -> dict[str, Any]:
    if sample.micro_kernel is not None:
        return {"variant": sample.variant,
                "micro_kernel": tuple(int(x) for x in
                                      sample.micro_kernel.split("x"))}
    if sample.tile is not None:
        return {"tile": parse_tile(sample.tile)}
    return {}


def predict_sample(spec, sample: Sample) -> float:
    """The spec's predicted seconds for one sample's recorded grid cell."""
    return predict_samples(spec, [sample])[0]


def predict_samples(spec, samples) -> list[float]:
    """Predicted seconds for many samples, grouped by (backend, selection,
    policy) so each group is one bulk :func:`repro.gemm.plan_many` call
    through the batched engines rather than a scalar planning loop."""
    from repro_torch import gemm

    samples = list(samples)
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(samples):
        key = (s.backend, s.variant, s.micro_kernel, s.tile, s.policy)
        groups.setdefault(key, []).append(i)
    out: list[float] = [0.0] * len(samples)
    for idxs in groups.values():
        first = samples[idxs[0]]
        plans = gemm.plan_many([samples[i].problem for i in idxs],
                               backend=first.backend, machine=spec,
                               policy=first.policy, cache=False,
                               **_sample_plan_opts(first))
        for i, p in zip(idxs, plans):
            out[i] = p.predicted_seconds
    return out


@dataclasses.dataclass(frozen=True)
class ValidationRow:
    """One grid cell: measured vs predicted."""

    sample: Sample
    predicted_s: float

    @property
    def measured_s(self) -> float:
        return self.sample.seconds

    @property
    def rel_err(self) -> float:
        """Signed relative error: predicted/measured - 1."""
        return self.predicted_s / self.measured_s - 1.0

    @property
    def ape(self) -> float:
        """Absolute percentage error of this cell."""
        return abs(self.predicted_s - self.measured_s) / self.measured_s


@dataclasses.dataclass
class ValidationReport:
    """Accuracy of one spec against one sample set."""

    machine: str
    fingerprint: str
    rows: list[ValidationRow]

    def __post_init__(self):
        if not self.rows:
            raise ValueError("validation needs at least one sample")

    @property
    def mape(self) -> float:
        """Mean absolute percentage error over all cells, in percent."""
        return 100.0 * statistics.fmean(r.ape for r in self.rows)

    @property
    def median_ape(self) -> float:
        return 100.0 * statistics.median(r.ape for r in self.rows)

    @property
    def worst(self) -> ValidationRow:
        return max(self.rows, key=lambda r: r.ape)

    def breakdown(self, field: str) -> dict[str, dict]:
        """Per-group accuracy, grouped by a sample field (``"dtype"``,
        ``"micro_kernel"``, ``"harness"``, ...)."""
        groups: dict[str, list[ValidationRow]] = {}
        for r in self.rows:
            key = str(getattr(r.sample, field))
            groups.setdefault(key, []).append(r)
        return {key: {
            "cells": len(rs),
            "mape_pct": 100.0 * statistics.fmean(r.ape for r in rs),
            "bias_pct": 100.0 * statistics.fmean(r.rel_err for r in rs),
        } for key, rs in sorted(groups.items())}

    def per_dtype(self) -> dict[str, dict]:
        return self.breakdown("dtype")

    def per_micro_kernel(self) -> dict[str, dict]:
        return self.breakdown("micro_kernel")

    def summary(self) -> dict:
        w = self.worst
        return {
            "machine": self.machine,
            "fingerprint": self.fingerprint,
            "cells": len(self.rows),
            "mape_pct": self.mape,
            "median_ape_pct": self.median_ape,
            "worst": {"cell": w.sample.cell, "ape_pct": 100.0 * w.ape,
                      "measured_s": w.measured_s,
                      "predicted_s": w.predicted_s},
        }

    def table(self, limit: int | None = None) -> str:
        lines = ["cell                               measured s   "
                 "predicted s   rel err"]
        for r in self.rows[:limit]:
            lines.append(f"{r.sample.cell:<35}{r.measured_s:>10.3e}"
                         f"{r.predicted_s:>14.3e}{r.rel_err:>+9.2%}")
        if limit is not None and len(self.rows) > limit:
            lines.append(f"... ({len(self.rows) - limit} more cells)")
        lines.append(f"MAPE {self.mape:.2f}% over {len(self.rows)} cells "
                     f"(median {self.median_ape:.2f}%, worst "
                     f"{100.0 * self.worst.ape:.2f}% on "
                     f"{self.worst.sample.cell})")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "schema": REPORT_SCHEMA,
            "summary": self.summary(),
            "per_dtype": self.per_dtype(),
            "per_micro_kernel": self.per_micro_kernel(),
            "rows": [{**r.sample.to_json(),
                      "predicted_s": r.predicted_s,
                      "rel_err": r.rel_err} for r in self.rows],
        }

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "ValidationReport":
        if d.get("schema") != REPORT_SCHEMA:
            raise ValueError(f"unknown validation-report schema "
                             f"{d.get('schema')!r}")
        rows = [ValidationRow(sample=Sample.from_json(r),
                              predicted_s=float(r["predicted_s"]))
                for r in d["rows"]]
        s = d["summary"]
        return cls(machine=s["machine"], fingerprint=s["fingerprint"],
                   rows=rows)

    @classmethod
    def load(cls, path: str) -> "ValidationReport":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @property
    def finite(self) -> bool:
        return math.isfinite(self.mape)


def validate_spec(spec, samples, *,
                  allow_stale: bool = False) -> ValidationReport:
    """Predicted-vs-measured report for ``spec`` over ``samples`` (a
    :class:`SampleStore`, a path, or an explicit sample list).

    Store lookups go through the geometry-fingerprint guard, so a report can
    never silently score a spec against another machine's measurements.
    """
    from repro_torch.machines import resolve

    mspec = resolve(spec)
    if isinstance(samples, str):
        samples = SampleStore(samples)
    if isinstance(samples, SampleStore):
        samples = samples.for_machine(mspec, allow_stale=allow_stale)
    samples = list(samples)
    rows = [ValidationRow(sample=s, predicted_s=p)
            for s, p in zip(samples, predict_samples(mspec, samples))]
    return ValidationReport(machine=mspec.name,
                            fingerprint=mspec.geometry_fingerprint(),
                            rows=rows)
