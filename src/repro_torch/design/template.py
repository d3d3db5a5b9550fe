"""Parametric accelerator templates: architecture parameters in, cost
models out.

The paper calibrates a *fixed* zoo of edge processors; this module makes
the machines themselves data.  An :class:`AcceleratorTemplate` holds the
architecture-level knobs a designer actually turns — MAC-array dims,
per-level buffer capacities, DMA/NoC bandwidths, clock frequency — and
:meth:`AcceleratorTemplate.expand` deterministically derives a valid
``repro.machines/v1`` :class:`~repro_torch.machines.spec.MachineSpec` from them,
so architecture search is just another sweep: every existing consumer
(``gemm.sweep``, ``plan_deployment``, the SLO simulator, the Calibrator)
takes the generated spec unchanged.

Derivation rules (each is one line of :meth:`expand`; the constants mirror
the structure of the paper's Table 1 rate tables):

* arithmetic — ``arith_rate[dt] = 2 * mac_units * lanes * frequency_hz *
  dtype_rates[dt]`` (a MAC is two ops; ``dtype_rates`` are relative
  throughputs, e.g. f32 at 1/4 of int8 on a lane-packed datapath).
* register streaming — ``L1->R = reg_bytes_per_cycle * frequency_hz``:
  the micro-kernel's operand stream scales with the clock.
* DMA / NoC — ``M->L1 = dma_bw`` and ``L2->R = noc_bw``, straight
  bandwidth parameters in bytes/s.
* packing — ``M->M = pack_bw`` at ``reference_chunk``; the remaining
  strided-copy rates derive via the :data:`PACK_RATIOS` family.  The
  ratios (0.33 / 0.40 / 0.30) are stable across the paper's calibrated
  GAP8 and GAP9 tables, so they are fixed derivation constants rather
  than free axes.
* register file — ``capacity(R) = num_vector_registers * lanes *
  elem_bytes`` (GAP-style: 32 registers x 4 int8 lanes = 128 B).

Generated specs carry their full parameter set in provenance
(``provenance["template"]``) and are named ``gen/<family>-<digest>`` —
the ``gen/`` registry namespace that ``gemm.sweep(machines="gen/*")``
globs and ``machines.unregister_prefix("gen/")`` bulk-drops.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping

from repro_torch.machines import registry as _registry
from repro_torch.machines.spec import MachineSpec

#: generated-machine registry namespace (also the ``source_of`` tag)
GEN_PREFIX = "gen/"

#: strided-packing rate family, relative to the ``M->M`` packing rate at
#: the reference chunk: the paper's calibrated GAP8/GAP9 tables both land
#: within a few percent of these ratios.
PACK_RATIOS: Mapping[tuple[str, str], float] = {
    ("M", "M"): 1.00,       # pack into the L3-resident buffer
    ("M", "L2"): 0.33,      # pack into the L2 scratchpad
    ("L2", "M"): 0.40,      # unpack back to memory
    ("M", "R"): 0.30,       # strided stream straight to registers
}

#: area-proxy coefficients (arbitrary units — only ratios matter to a
#: Pareto frontier): per MAC lane, per KiB of on-chip SRAM (L1+L2), per
#: byte/cycle of DMA+NoC wiring, per register-file byte.
AREA_PER_MAC = 1.0
AREA_PER_SRAM_KIB = 0.25
AREA_PER_WIRE_BPC = 2.0
AREA_PER_REG_BYTE = 0.05


@dataclasses.dataclass(frozen=True)
class AcceleratorTemplate:
    """One point of the generator's parameter space.

    Defaults approximate the calibrated gap9-fc manifest, so
    ``AcceleratorTemplate().expand()`` is a plausible edge machine out of
    the box and named design spaces perturb around it.
    """

    family: str = "edge"
    # -- MAC array / register file -------------------------------------------
    lanes: int = 8                      # SIMD lanes per vector register
    mac_units: int = 2                  # parallel per-lane MAC issue
    num_vector_registers: int = 32
    frequency_hz: float = 370.0e6
    # -- memory hierarchy capacities (bytes) ---------------------------------
    main_bytes: int = 8 << 20
    l2_bytes: int = 1536 << 10
    l1_bytes: int = 64 << 10
    # -- interconnect bandwidths ---------------------------------------------
    dma_bw: float = 1.76e7              # M->L1 block DMA, bytes/s
    noc_bw: float = 1.44e7              # L2->R streaming fabric, bytes/s
    pack_bw: float = 3.24e6             # M->M strided packing, bytes/s
    reg_bytes_per_cycle: float = 0.96   # L1->R register streaming
    # -- dtype-rate derivation rules -----------------------------------------
    reference_chunk: int = 4
    elem_bytes: int = 1
    dtype_rates: tuple = (("int8", 1.0), ("f32", 0.25))
    # -- deployment memory view ----------------------------------------------
    deployment_level: str = "M"
    memory_reserved_fraction: float = 0.0
    # -- optional energy proxy (pJ per int8 op; None = unmodelled) -----------
    energy_per_op_pj: float | None = None

    def __post_init__(self) -> None:
        for field in ("lanes", "mac_units", "num_vector_registers",
                      "main_bytes", "l2_bytes", "l1_bytes",
                      "reference_chunk", "elem_bytes"):
            if int(getattr(self, field)) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)!r}")
        for field in ("frequency_hz", "dma_bw", "noc_bw", "pack_bw",
                      "reg_bytes_per_cycle"):
            if not float(getattr(self, field)) > 0.0:
                raise ValueError(f"{field} must be positive, got "
                                 f"{getattr(self, field)!r}")
        if not self.dtype_rates:
            raise ValueError("dtype_rates must name at least one dtype")

    # -- identity -------------------------------------------------------------

    def params(self) -> dict[str, Any]:
        """The full parameter set, JSON-ready (tuples become lists)."""
        d = dataclasses.asdict(self)
        d["dtype_rates"] = [list(p) for p in self.dtype_rates]
        return d

    def design_id(self) -> str:
        """Deterministic content identity: the family plus a digest of the
        canonical parameter JSON.  Same parameters, same id — across
        processes and sessions."""
        payload = json.dumps(self.params(), sort_keys=True)
        return (f"{self.family}-"
                f"{hashlib.sha1(payload.encode()).hexdigest()[:10]}")

    @property
    def name(self) -> str:
        """The registry name :meth:`expand` gives the generated spec."""
        return f"{GEN_PREFIX}{self.design_id()}"

    @classmethod
    def from_params(cls, params: Mapping[str, Any]) -> "AcceleratorTemplate":
        """Rebuild a template from :meth:`params` output (e.g. a generated
        spec's ``provenance["template"]``)."""
        d = dict(params)
        d["dtype_rates"] = tuple((str(t), float(r))
                                 for t, r in d["dtype_rates"])
        return cls(**d)

    def with_params(self, **overrides) -> "AcceleratorTemplate":
        """A derived template with some parameters replaced."""
        return dataclasses.replace(self, **overrides)

    def scaled_bandwidth(self, factor: float) -> "AcceleratorTemplate":
        """Every interconnect bandwidth scaled by ``factor`` (DMA, NoC,
        packing, register streaming); compute and capacities unchanged."""
        return dataclasses.replace(
            self, dma_bw=self.dma_bw * factor, noc_bw=self.noc_bw * factor,
            pack_bw=self.pack_bw * factor,
            reg_bytes_per_cycle=self.reg_bytes_per_cycle * factor)

    # -- proxies ---------------------------------------------------------------

    @property
    def sram_bytes(self) -> int:
        """On-chip SRAM a silicon implementation must provision (L1 + L2) —
        the memory-cost objective of the Pareto frontier.  Main memory is
        off-chip and excluded."""
        return int(self.l1_bytes) + int(self.l2_bytes)

    def area_proxy(self) -> float:
        """Closed-form area estimate in arbitrary units: MAC lanes + SRAM
        + interconnect wiring + register file.  A proxy for frontier
        trade-offs, not a floorplan."""
        macs = self.mac_units * self.lanes
        sram_kib = self.sram_bytes / 1024.0
        wire_bpc = (self.dma_bw + self.noc_bw) / self.frequency_hz
        reg_bytes = self.num_vector_registers * self.lanes * self.elem_bytes
        return (AREA_PER_MAC * macs
                + AREA_PER_SRAM_KIB * sram_kib
                + AREA_PER_WIRE_BPC * wire_bpc
                + AREA_PER_REG_BYTE * reg_bytes)

    def energy_proxy_j(self, ops: float) -> float | None:
        """Energy for ``ops`` operations under the optional per-op proxy."""
        if self.energy_per_op_pj is None:
            return None
        return self.energy_per_op_pj * 1e-12 * ops

    # -- expansion -------------------------------------------------------------

    def expand(self, *, name: str | None = None,
               register: bool = False) -> MachineSpec:
        """Derive the ``repro.machines/v1`` spec for this design point.

        Deterministic: the same template always emits the same spec (same
        name, same rates, same fingerprint).  ``register=True`` lands it in
        the registry under its ``gen/`` name (source ``"generated"``,
        overwrite-safe since the name is content-addressed).
        """
        arith = {dt: 2.0 * self.mac_units * self.lanes * self.frequency_hz
                 * float(rel) for dt, rel in self.dtype_rates}
        rates = {pair: self.pack_bw * ratio
                 for pair, ratio in PACK_RATIOS.items()}
        rates[("M", "L1")] = float(self.dma_bw)
        rates[("L2", "R")] = float(self.noc_bw)
        rates[("L1", "R")] = self.reg_bytes_per_cycle * self.frequency_hz
        reg_bytes = (self.num_vector_registers * self.lanes
                     * self.elem_bytes)
        prov: dict[str, Any] = {
            "generator": "repro.design/v1",
            "template": self.params(),
            "design_id": self.design_id(),
            "area_proxy": self.area_proxy(),
        }
        spec = MachineSpec(
            name=name or self.name,
            levels=("M", "L2", "L1", "R"),
            capacities={"M": int(self.main_bytes),
                        "L2": int(self.l2_bytes),
                        "L1": int(self.l1_bytes),
                        "R": int(reg_bytes)},
            transfer_rates=rates,
            arith_rate=arith,
            reference_chunk=int(self.reference_chunk),
            elem_bytes=int(self.elem_bytes),
            num_vector_registers=int(self.num_vector_registers),
            register_lanes=int(self.lanes),
            deployment_level=self.deployment_level,
            memory_reserved_fraction=float(self.memory_reserved_fraction),
            provenance=prov,
        ).validate()
        if register:
            _registry.register(spec, overwrite=True, source="generated")
        return spec


def template_of(spec: MachineSpec) -> AcceleratorTemplate:
    """Recover the generating template from a generated spec's provenance.

    Raises ``ValueError`` for specs that did not come out of
    :meth:`AcceleratorTemplate.expand` (nothing to recover)."""
    params = (spec.provenance or {}).get("template")
    if not params:
        raise ValueError(f"{spec.name}: no template provenance — not a "
                         f"generated spec")
    return AcceleratorTemplate.from_params(params)
