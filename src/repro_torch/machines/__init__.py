"""``repro.machines`` — the declarative machine zoo.

The paper models a processor as a handful of calibrated rates (§3.2,
Table 1); this package makes machines first-class API objects on exactly
that premise:

    >>> from repro_torch import machines
    >>> machines.list_machines("zoo/*")
    ['cortex-m7', 'gap8-fc', 'gap9-fc', 'host-cpu', 'tpu-v5e', ...]
    >>> gap8 = machines.get("gap8-fc")          # loaded from its JSON manifest
    >>> fast = gap8.scaled(arith=2.0, name="gap8-fc-2x")   # derived what-if
    >>> machines.register(fast)
    >>> from repro_torch import gemm
    >>> gemm.sweep(problems, backends=["analytic-gap8"],
    ...            machines=["zoo/*"])           # globs expand over the zoo

Calibration feeds the same registry: :class:`Calibrator` wraps the paper's
§3.2 micro-experiments and fits rate tables to measured GEMM times with one
vectorized least-squares solve on the batched simulators, emitting a
registered, manifest-persisted spec with fit provenance.

Every zoo manifest is schema-checked when the registry loads it; the
command line is ``python -m repro_torch.machines validate|list|show|calibrate``.
"""
from repro_torch.machines.spec import (
    CANONICAL_ROLES,
    MachineSpec,
    SpecValidationError,
)
from repro_torch.machines.registry import (
    alias,
    expand,
    expand_many,
    get,
    list_machines,
    load_zoo,
    register,
    resolve,
    source_of,
    unregister,
    unregister_prefix,
    zoo_dir,
)

__all__ = [
    "CANONICAL_ROLES", "Calibrator", "FitReport", "MachineSpec",
    "SpecValidationError", "alias", "expand", "expand_many", "get",
    "list_machines", "load_zoo", "register", "resolve", "source_of",
    "unregister", "unregister_prefix", "zoo_dir",
]


def __getattr__(name):
    # Calibrator pulls in the core simulators (numpy-heavy); import lazily so
    # `repro.machines` stays dependency-light for core.hardware's shim.
    if name in ("Calibrator", "FitReport"):
        from repro_torch.machines import calibrate
        return getattr(calibrate, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
