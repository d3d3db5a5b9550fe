"""Hardware descriptions — now a compatibility shim over ``repro.machines``.

Machine specs used to be hard-coded constants here; they are now JSON
manifests in the declarative machine zoo (``repro/machines/zoo/*.json``)
loaded through the :mod:`repro.machines` registry.  Adding a processor is
dropping a manifest file (or calling ``repro.machines.register``), not
editing code — see the "Machine zoo & calibration" section of the README.

This module keeps the legacy surface importable:

* ``MachineSpec`` — re-exported from :mod:`repro.machines.spec` (the
  canonical home; it gained ``to_json``/``from_json``, validation,
  level-role aliasing and derived-machine transforms).
* ``GAP8_FC`` / ``TPU_V5E`` / ``MACHINES`` — deprecated module attributes
  resolved from the registry on first access.
* ``get_machine`` — deprecated; call ``repro.machines.get`` instead.

The roofline scalars (``V5E_*``) remain plain constants: they parameterize
the TPU cost model's geometry (MXU dimension, VMEM budget), not a machine's
calibrated rates.
"""
from __future__ import annotations

import warnings

from repro_torch.machines import registry as _machines
from repro_torch.machines.spec import MachineSpec

__all__ = [
    "MB", "KiB", "MiB", "GB", "MachineSpec", "get_machine",
    "V5E_PEAK_BF16", "V5E_PEAK_INT8", "V5E_HBM_BW", "V5E_HBM_BYTES",
    "V5E_VMEM_BYTES", "V5E_ICI_BW", "V5E_VMEM_BW", "V5E_MXU",
]

MB = 1.0e6          # the paper reports MBytes/s (decimal)
KiB = 1024
MiB = 1024 * 1024
GB = 1.0e9

# ---------------------------------------------------------------------------
# TPU v5e roofline constants (cost-model geometry; the calibrated machine
# spec itself lives in repro/machines/zoo/tpu-v5e.json).
# ---------------------------------------------------------------------------
V5E_PEAK_BF16 = 197e12            # FLOP/s per chip
V5E_PEAK_INT8 = 394e12            # OP/s per chip
V5E_HBM_BW = 819e9                # bytes/s
V5E_HBM_BYTES = 16 * GB
V5E_VMEM_BYTES = 128 * MiB
V5E_ICI_BW = 50e9                 # bytes/s per link
V5E_VMEM_BW = 22e12               # bytes/s VMEM<->VREG (approximate)
V5E_MXU = 128                     # systolic array dimension

_DEPRECATED = {"GAP8_FC": "gap8-fc", "TPU_V5E": "tpu-v5e"}


def __getattr__(name: str):
    if name in _DEPRECATED:
        warnings.warn(
            f"repro.core.hardware.{name} is deprecated; use "
            f"repro.machines.get({_DEPRECATED[name]!r}) — the spec now "
            f"lives in the machine zoo manifest",
            DeprecationWarning, stacklevel=2)
        return _machines.get(_DEPRECATED[name])
    if name == "MACHINES":
        warnings.warn(
            "repro.core.hardware.MACHINES is deprecated; use "
            "repro.machines.list_machines() / repro.machines.get(name)",
            DeprecationWarning, stacklevel=2)
        return {n: _machines.get(n) for n in _machines.list_machines()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_machine(name: str) -> MachineSpec:
    """Deprecated alias of :func:`repro.machines.get`."""
    warnings.warn(
        "repro.core.hardware.get_machine is deprecated; use "
        "repro.machines.get", DeprecationWarning, stacklevel=2)
    try:
        return _machines.get(name)
    except KeyError as e:
        raise KeyError(f"unknown machine {name!r}; have "
                       f"{_machines.list_machines()}") from e
