"""``repro_torch.design`` — parametric accelerator generation + design-space
exploration.

The paper answers "which algorithm wins on this machine?"; this subsystem
inverts the question: *which machine should we build for this workload?*

* :class:`AcceleratorTemplate` (``template.py``) — architecture knobs
  (MAC array, buffer capacities, DMA/NoC bandwidths, frequency) that
  ``expand()`` into a valid ``repro.machines/v1`` spec under the ``gen/``
  registry namespace, so every existing consumer — ``gemm.sweep``,
  ``plan_deployment``, the SLO simulator, the Calibrator — takes
  generated machines unchanged.
* :class:`DesignSpace` (``space.py``) — named axes over a template with
  deterministic grid / Halton sampling and lazy expansion.
* ``score_designs`` / ``pareto`` / ``rerank_by_slo`` (``explore.py``) —
  score designs on the Table-2 grid and model decode GEMMs, reduce to a
  deterministic Pareto frontier over (throughput, SRAM, area proxy) with
  machine-readable dominance records, optionally re-rank by simulated
  p99 SLO attainment.
* ``ground`` / ``sample_design`` (``ground.py``) — fit a built design's
  generated rate table from a measurement ``SampleStore`` with the
  existing Calibrator; the emitted spec is provenance-marked
  ``grounded``.

CLI: ``python -m repro_torch.design expand|sweep|frontier|ground``.

The counterpart of ``repro.design``: the same content-addressed ``gen/``
names, frontiers and grounded provenance on the same inputs.
"""
from repro_torch.design.explore import (
    DesignScore,
    DominanceRecord,
    Frontier,
    OBJECTIVES,
    pareto,
    plan_point,
    rerank_by_slo,
    score_designs,
)
from repro_torch.design.ground import (
    GroundingResult,
    ground,
    sample_design,
    synthetic_truth,
)
from repro_torch.design.space import (
    DesignPoint,
    DesignSpace,
    GEN_PREFIX,
    get_space,
    space_names,
)
from repro_torch.design.template import AcceleratorTemplate, template_of

__all__ = [
    "AcceleratorTemplate", "DesignPoint", "DesignScore", "DesignSpace",
    "DominanceRecord", "Frontier", "GEN_PREFIX", "GroundingResult",
    "OBJECTIVES", "get_space", "ground", "pareto", "plan_point",
    "rerank_by_slo", "sample_design", "score_designs", "space_names",
    "synthetic_truth", "template_of",
]
