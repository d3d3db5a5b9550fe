"""The paper's primary contribution: an analytical performance simulator for
blocked GEMM (GotoBLAS/BLIS family) and its tile adaptation (TileTuner).

Public surface:
  hardware   — legacy shim over repro_torch.machines (the machine zoo)
  variants   — B3A2C0 / C3B2A0 / B3C2A0 loop nests + blocking derivation
  simulator  — the faithful cost model (paper §3) and Table-2 search
  tpu_model  — tile-grid cost model (HBM/VMEM/MXU, ±overlap)
  autotune   — TileTuner: analytical tile selection + manifest
  mobilenet  — the paper's Table-2 workload
  calibrate  — the paper's §3.2 host micro-experiments
  hopper_model — the H100 tile cost model the ``cuda`` backend plans on

(``roofline`` of the JAX package is not ported yet: it reads compiled XLA
artifacts and belongs with the dry-run launchers.)

NOTE: consumers should plan GEMMs through the unified façade
``repro_torch.gemm.plan(...)`` rather than calling ``best_microkernel`` / ``tune``
directly; these remain public as the implementation layer the registered
backends dispatch to.  Machine specs live in ``repro_torch.machines`` (the
declarative zoo); ``GAP8_FC`` / ``TPU_V5E`` / ``get_machine`` are kept as
legacy re-exports resolved from the registry.
"""
from repro_torch.core.hardware import MachineSpec, get_machine
from repro_torch.core.simulator import (
    CostBatch,
    CostBreakdown,
    best_microkernel,
    best_microkernel_batch,
    search_batch,
    simulate,
    simulate_batch,
)
from repro_torch.core.tpu_model import (
    GemmShape,
    GridOrder,
    TileConfig,
    TpuCostBatch,
    estimate,
    estimate_batch,
)
from repro_torch.core.autotune import Manifest, TileDecision, tune, tune_batch
from repro_torch.core.variants import (
    Blocking,
    MicroKernel,
    Problem,
    Variant,
    derive_blocking,
    derive_blocking_batch,
    feasible_microkernels,
)

# Legacy constant names resolve lazily from the zoo registry on every
# access (no import-time snapshot to go stale after a re-registration, and
# no deprecation noise on `import repro_torch.core`; attribute access on
# repro.core.hardware is the surface that warns).
_LAZY_MACHINES = {"GAP8_FC": "gap8-fc", "TPU_V5E": "tpu-v5e"}


def __getattr__(name):
    if name in _LAZY_MACHINES:
        from repro_torch.machines import get as _get_machine
        return _get_machine(_LAZY_MACHINES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "GAP8_FC", "TPU_V5E", "MachineSpec", "get_machine",
    "CostBatch", "CostBreakdown", "best_microkernel",
    "best_microkernel_batch", "search_batch", "simulate", "simulate_batch",
    "GemmShape", "GridOrder", "TileConfig", "TpuCostBatch", "estimate",
    "estimate_batch",
    "Manifest", "TileDecision", "tune", "tune_batch",
    "Blocking", "MicroKernel", "Problem", "Variant",
    "derive_blocking", "derive_blocking_batch", "feasible_microkernels",
]
