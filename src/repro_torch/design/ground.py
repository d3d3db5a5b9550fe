"""Ground a paper design in measurements: generated rates -> fitted rates.

A generated spec's rate table is a *derivation* (template parameters
through the rules of ``repro_torch.design.template``); once a frontier design
gets built — silicon, FPGA, or a firmware port — its rates should come
from the machine, not the template.  ``ground`` closes that loop with the
existing calibration machinery: samples from a
:class:`~repro_torch.measure.store.SampleStore` (geometry-fingerprint guarded,
so they provably belong to this design's geometry) feed
``repro_torch.measure.fit_from_store`` / :class:`~repro_torch.machines.Calibrator`,
and the emitted spec carries ``provenance["grounded"] = True`` on top of
the original template parameters — a spec that records both what it was
designed as and what it measured as.

``sample_design`` covers the pre-silicon case: it runs a standard
measurement campaign against a *simulated* ground truth (any spec sharing
the design's geometry — by default a bandwidth/arith-perturbed copy), so
the full expand -> sample -> fit -> validate loop is exercisable today
and tests can assert the fit recovers a known truth.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.design.space import DesignPoint
from repro_torch.design.template import AcceleratorTemplate
from repro_torch.machines import registry as _registry
from repro_torch.machines.spec import MachineSpec


def _as_spec(design) -> MachineSpec:
    if isinstance(design, MachineSpec):
        return design
    if isinstance(design, AcceleratorTemplate):
        return design.expand()
    if isinstance(design, DesignPoint):
        return design.spec()
    if isinstance(design, str):
        return _registry.get(design)
    raise TypeError(f"cannot ground {design!r}; pass a MachineSpec, "
                    f"AcceleratorTemplate, DesignPoint, or registry name")


@dataclasses.dataclass
class GroundingResult:
    """The grounded spec plus the fit and validation evidence."""

    spec: MachineSpec
    fit: Any                    # repro_torch.machines.FitReport
    validation: Any | None      # repro_torch.measure ValidationReport (or None)

    @property
    def mape(self) -> float | None:
        return self.validation.mape if self.validation is not None else None


def synthetic_truth(spec: MachineSpec, *, bw: float = 0.8,
                    arith: float = 0.9) -> MachineSpec:
    """A deterministic "reality" for pre-silicon grounding runs: the
    design's own spec with every bandwidth scaled by ``bw`` and the
    arithmetic rates by ``arith`` — same geometry (the fingerprint the
    sample store keys on), different rates (something for the fit to
    find)."""
    return spec.scaled(arith=arith, bw=bw, name=f"{spec.name}-truth")


def sample_design(design, store, *, grid: str = "table2",
                  dtype: str = "int8", truth: MachineSpec | None = None,
                  policy: str = "padded"):
    """Run a measurement campaign for a (typically unbuilt) design.

    The design's spec plans the campaign; the ``simulated`` harness prices
    each planned GEMM under ``truth`` (default: :func:`synthetic_truth`),
    standing in for the hardware run.  Samples land in ``store`` stamped
    with the design's geometry fingerprint — exactly what a real harness
    would produce on the built machine.  Returns the
    ``repro_torch.measure.CampaignResult``.
    """
    from repro_torch.measure.campaign import run_campaign

    spec = _as_spec(design)
    truth = truth if truth is not None else synthetic_truth(spec)
    return run_campaign(grid, machine=spec, harness="simulated",
                        store=store, dtype=dtype, policy=policy,
                        truth=truth)


def ground(design, store, *, date: str | None, name: str | None = None,
           weighting: str = "relative", on_nonpositive: str = "free",
           overhead_per_block: bool = False, policy: str | None = None,
           register: bool = False, manifest_dir: str | None = None,
           validate: bool = True) -> GroundingResult:
    """Fit a generated design's rate table from measured samples.

    Args:
        design: the design to ground — a generated spec, template,
            :class:`DesignPoint`, or registered ``gen/*`` name.
        store: the :class:`~repro_torch.measure.store.SampleStore` (or path)
            holding the design's measurements.
        date: calibration date for provenance (pass None explicitly for
            an undated fit, as with ``Calibrator.fit``).
        name: name for the grounded spec (default: the design's name —
            the grounded spec *replaces* the derivation under ``gen/``).
        weighting / on_nonpositive / overhead_per_block / policy:
            forwarded to ``repro_torch.measure.fit_from_store``.
        register: land the grounded spec in the registry.
        manifest_dir: also persist it as a manifest.
        validate: price the store's samples under the grounded spec and
            attach the ``ValidationReport`` (its MAPE is the headline
            "how well does the grounded model predict" number).

    Returns:
        A :class:`GroundingResult`; ``result.spec.provenance`` carries
        ``grounded: True``, the original template parameters, and the
        full fit record.
    """
    from repro_torch.measure.campaign import fit_from_store
    from repro_torch.measure.validate import validate_spec

    spec = _as_spec(design)
    fitted, fit = fit_from_store(
        store, spec, name=name or spec.name, date=date, policy=policy,
        weighting=weighting, on_nonpositive=on_nonpositive,
        overhead_per_block=overhead_per_block)
    prov = dict(fitted.provenance)
    prov["grounded"] = True
    for key in ("generator", "template", "design_id"):
        if key in (spec.provenance or {}):
            prov.setdefault(key, spec.provenance[key])
    grounded = dataclasses.replace(fitted, provenance=prov)
    grounded.validate()
    if register:
        _registry.register(grounded, overwrite=True, source="calibrated")
    if manifest_dir:
        import os
        grounded.to_manifest(os.path.join(manifest_dir,
                                          f"{grounded.name}.json"))
    report = validate_spec(grounded, store) if validate else None
    return GroundingResult(spec=grounded, fit=fit, validation=report)


__all__ = ["GroundingResult", "ground", "sample_design", "synthetic_truth"]
