"""TPU adaptation of the paper's simulator: a cost model for Pallas GEMM.

The paper's memory model (software-managed scratchpads, programmed DMA, no
caches) *is* the TPU memory model: HBM -> VMEM -> VREG with Pallas
``BlockSpec`` controlling every transfer.  The paper's algorithmic family
(loop orders deciding which operand is resident vs. streamed) maps onto the
**grid iteration order** of a Pallas kernel:

* ``k`` innermost (grid ``(i, j, k)``)  — the C block stays in a VMEM
  accumulator while A/B blocks stream: the **B3A2C0 analogue**
  (output-stationary; C written once).
* ``k`` outermost (grid ``(k, i, j)``) — the C block is revisited (read +
  written) on every k step: the **C3B2A0/B3C2A0 analogue** (C streamed).

The cost model mirrors the paper's: traffic per level x calibrated rate plus
a flat arithmetic term, with *two* composition rules — the paper's
no-overlap sum (§3.1 assumption) and the double-buffered ``max`` that Pallas'
pipeline actually achieves (the paper's future-work item).
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from repro_torch.core.hardware import MachineSpec, V5E_MXU  # noqa: F401
from repro_torch.core.precision import PrecisionConfig
from repro_torch.machines import registry as _machines

# int4 is modelled at one byte (unpacked panels — see core/precision.py);
# its advantage over int8 is purely the arithmetic rate.
DTYPE_BYTES = {"int4": 1, "int8": 1, "bf16": 2, "f32": 4}
# minimal TPU tile (sublane, lane) per dtype — misaligned blocks get padded.
SUBLANE = {"int4": 32, "int8": 32, "bf16": 16, "f32": 8}
LANE = 128


class GridOrder(str, enum.Enum):
    """Pallas grid iteration order == the paper's loop-order variant."""
    K_INNER = "k_inner"     # B3A2C0 analogue: C resident, written once
    K_OUTER = "k_outer"     # C3B2A0/B3C2A0 analogue: C revisited every k step


@dataclasses.dataclass(frozen=True)
class TileConfig:
    bm: int
    bn: int
    bk: int
    order: GridOrder = GridOrder.K_INNER

    def __str__(self) -> str:
        return f"{self.bm}x{self.bn}x{self.bk}:{self.order.value}"


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    n: int
    k: int
    dtype: str = "bf16"
    accumulate: bool = False   # C += A.B (paper semantics) vs C = A.B
    # per-operand dtypes for mixed-precision GEMM; None (or a uniform
    # config) is the plain single-dtype path.  ``dtype`` stays the compute
    # (narrower-operand) dtype — the MXU path the arithmetic runs on.
    precision: PrecisionConfig | None = None

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def mixed_precision(self) -> PrecisionConfig | None:
        """The shape's precision config when it is genuinely mixed (uniform
        configs are the plain dtype path and return None)."""
        pc = self.precision
        return pc if pc is not None and not pc.is_uniform else None


@dataclasses.dataclass(frozen=True)
class TpuCost:
    """Cost estimate for one Pallas GEMM tile configuration."""
    shape: GemmShape
    tile: TileConfig
    hbm_bytes: float          # HBM <-> VMEM traffic
    vmem_bytes: float         # VMEM <-> VREG traffic (usually negligible)
    vmem_peak: int            # peak VMEM working set (double-buffered)
    t_compute: float
    t_hbm: float
    t_vmem: float
    mxu_efficiency: float     # useful fraction of MXU-padded FLOPs
    # quantize/dequantize HBM traffic of a mixed-precision shape (already
    # included in hbm_bytes; kept separate for attribution/explain).
    quant_bytes: float = 0.0

    @property
    def total_no_overlap(self) -> float:
        """Paper-faithful composition: transfers are not overlapped (§3.1)."""
        return self.t_compute + self.t_hbm + self.t_vmem

    @property
    def total_overlapped(self) -> float:
        """Double-buffered Pallas pipeline: bound by the slowest resource,
        plus one pipeline fill of the first block pair."""
        startup = self.t_hbm / max(1.0, self._grid_steps())
        return max(self.t_compute, self.t_hbm, self.t_vmem) + startup

    def _grid_steps(self) -> float:
        s, t = self.shape, self.tile
        return (math.ceil(s.m / t.bm) * math.ceil(s.n / t.bn)
                * math.ceil(s.k / t.bk))

    def total(self, overlap: bool = True) -> float:
        return self.total_overlapped if overlap else self.total_no_overlap

    def roofline_fraction(self, overlap: bool = True) -> float:
        """Fraction of the pure-compute roofline this config achieves."""
        ideal = self.shape.flops / _peak(self.shape.dtype)
        return ideal / self.total(overlap)


def _default_machine() -> MachineSpec:
    return _machines.get("tpu-v5e")


def machine_peak(machine: MachineSpec, dtype: str) -> float:
    """Per-dtype arithmetic peak of a machine's rate table.

    ``f32`` computes through the bf16 MXU path (same convention the model
    has always used); machines whose table lacks the requested tag fall
    back to their fastest declared rate, so analytic what-ifs on foreign
    machines (e.g. the GAP8 spec through the TPU model) stay well-defined.
    """
    tag = "bf16" if dtype == "f32" else dtype
    rate = machine.arith_rate.get(tag)
    return rate if rate is not None else max(machine.arith_rate.values())


def machine_peak_mixed(machine: MachineSpec,
                       precision: PrecisionConfig) -> float:
    """Arithmetic peak for a mixed-precision config: the spec's
    ``rates_mixed`` entry for the config key when calibrated, else
    :func:`machine_peak` of the compute (narrower-operand) dtype."""
    rate = machine.rates_mixed.get(precision.key())
    return rate if rate is not None \
        else machine_peak(machine, precision.compute_dtype)


def shape_peak(machine: MachineSpec, shape: GemmShape) -> float:
    """Per-shape arithmetic peak honouring an attached mixed precision."""
    pc = shape.mixed_precision
    return machine_peak_mixed(machine, pc) if pc is not None \
        else machine_peak(machine, shape.dtype)


def _peak(dtype: str) -> float:
    return machine_peak(_default_machine(), dtype)


def _pad(x: int, mult: int) -> int:
    return mult * math.ceil(x / mult)


def vmem_required(shape: GemmShape, tile: TileConfig,
                  double_buffer: bool = True) -> int:
    """Peak VMEM bytes: A and B blocks (x2 when double-buffered by the
    pipeline) plus the f32 accumulator and the output block."""
    s = DTYPE_BYTES[shape.dtype]
    buf = 2 if double_buffer else 1
    a = tile.bm * tile.bk * s
    b = tile.bk * tile.bn * s
    acc = tile.bm * tile.bn * 4              # f32 accumulator
    out = tile.bm * tile.bn * s
    return buf * (a + b) + acc + buf * out


def mxu_efficiency(shape: GemmShape, tile: TileConfig) -> float:
    """Useful-FLOP fraction after padding block dims to hardware tiles.

    The paper's basic simulator assumes arithmetic rate independent of the
    micro-kernel; its §4 discussion flags per-micro-kernel rates as needed
    refinement — on TPU the MXU gives a crisp version of that refinement:
    blocks pay padding to (sublane, lane) tiles and the 128x128 systolic
    array.
    """
    sub = SUBLANE[shape.dtype]
    bm_eff = min(tile.bm, shape.m)
    bn_eff = min(tile.bn, shape.n)
    bk_eff = min(tile.bk, shape.k)
    pm = _pad(bm_eff, sub)
    pn = _pad(bn_eff, LANE)
    pk = _pad(bk_eff, LANE)
    return (bm_eff * bn_eff * bk_eff) / float(pm * pn * pk)


def estimate(shape: GemmShape, tile: TileConfig,
             machine: MachineSpec | None = None) -> TpuCost:
    """Traffic-based cost estimate of a tiled Pallas GEMM (one chip).

    ``machine`` is any registry spec (default: ``tpu-v5e`` from the zoo);
    rates resolve through the spec's level aliases, so every transfer/peak
    term is machine-parametric.

    HBM->VMEM traffic follows the paper's revisit accounting:
      A block (bm x bk): fetched once per (i, k) per j-sweep  -> M.K.(N/bn)
      B block (bk x bn): fetched once per (k, j) per i-sweep  -> K.N.(M/bm)
      C block (bm x bn): K_INNER  -> written once (+read if accumulate);
                         K_OUTER  -> read+written every k step (K/bk).
    """
    machine = machine or _default_machine()
    s = DTYPE_BYTES[shape.dtype]
    m, n, k = shape.m, shape.n, shape.k
    gm, gn, gk = (math.ceil(m / tile.bm), math.ceil(n / tile.bn),
                  math.ceil(k / tile.bk))
    a_bytes = s * m * k * gn
    b_bytes = s * k * n * gm
    if tile.order is GridOrder.K_INNER:
        c_writes = s * m * n
        c_reads = s * m * n if shape.accumulate else 0.0
    else:
        c_writes = s * m * n * gk
        c_reads = s * m * n * gk
    hbm = a_bytes + b_bytes + c_writes + c_reads

    # Mixed-precision shapes pay quantize/dequantize traffic at the HBM
    # boundary: wider-than-compute operands move extra bytes proportional
    # to their width ratio (core/precision.py).  Uniform shapes take the
    # pre-existing path untouched.
    pc = shape.mixed_precision
    quant_bytes = 0.0
    if pc is not None:
        ra, rb, rc = pc.quant_ratios(s)
        quant_bytes = (a_bytes * ra + b_bytes * rb
                       + (c_writes + c_reads) * rc)
        hbm = hbm + quant_bytes

    # VMEM->VREG streaming inside the kernel: each resident A/B block is read
    # once per block-matmul, plus the f32 accumulator read+written per k step.
    vmem_stream = a_bytes + b_bytes + 8.0 * m * n * gk

    eff = mxu_efficiency(shape, tile)
    t_compute = shape.flops / (shape_peak(machine, shape) * eff)
    t_hbm = hbm / machine.rate("M", "L1")
    t_vmem = vmem_stream / machine.rate("L1", "R")
    return TpuCost(
        shape=shape, tile=tile, hbm_bytes=hbm, vmem_bytes=vmem_stream,
        vmem_peak=vmem_required(shape, tile),
        t_compute=t_compute, t_hbm=t_hbm, t_vmem=t_vmem, mxu_efficiency=eff,
        quant_bytes=quant_bytes,
    )


def arithmetic_intensity(shape: GemmShape, tile: TileConfig) -> float:
    c = estimate(shape, tile)
    return shape.flops / max(c.hbm_bytes, 1.0)


# ---------------------------------------------------------------------------
# Batched evaluation engine: ``estimate`` as a NumPy array program.
#
# The design-space sweep (autotune over ~810 candidate tiles x many shapes)
# is the framework's hottest non-JAX path; scoring candidates one Python call
# at a time makes planning O(shapes x tiles) interpreter work.  The batch
# engine scores the whole (problem x candidate) lattice in a handful of
# vectorized operations.  Every formula replays ``estimate`` elementwise with
# the same operations in the same order, so totals are bit-identical with the
# scalar simulator and argmin tile selections agree exactly (all integer
# intermediates stay below 2^53 and convert to float64 without rounding).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuCostBatch:
    """Structure-of-arrays :class:`TpuCost` over a (problem x candidate)
    lattice.  Fields broadcast to a common ``(P, C)`` shape."""

    hbm_bytes: np.ndarray
    vmem_bytes: np.ndarray
    vmem_peak: np.ndarray
    t_compute: np.ndarray
    t_hbm: np.ndarray
    t_vmem: np.ndarray
    mxu_efficiency: np.ndarray
    grid_steps: np.ndarray

    @property
    def total_no_overlap(self) -> np.ndarray:
        return self.t_compute + self.t_hbm + self.t_vmem

    @property
    def total_overlapped(self) -> np.ndarray:
        startup = self.t_hbm / np.maximum(1.0, self.grid_steps)
        return (np.maximum(np.maximum(self.t_compute, self.t_hbm),
                           self.t_vmem) + startup)

    def total(self, overlap: bool = True) -> np.ndarray:
        return self.total_overlapped if overlap else self.total_no_overlap


def peak_rate(dtype: str) -> float:
    """Public alias of the per-dtype peak used by the cost model."""
    return _peak(dtype)


def vmem_required_batch(bm, bn, bk, elem_bytes) -> np.ndarray:
    """Vectorized :func:`vmem_required` (double-buffered) over tile arrays."""
    bm, bn, bk = (np.asarray(x, np.int64) for x in (bm, bn, bk))
    s = np.asarray(elem_bytes, np.int64)
    a = bm * bk * s
    b = bk * bn * s
    acc = bm * bn * 4
    out = bm * bn * s
    return 2 * (a + b) + acc + 2 * out


def estimate_batch(m, n, k, elem_bytes, sublane, peak, bm, bn, bk, k_inner,
                   accumulate=False,
                   machine: MachineSpec | None = None,
                   quant=None) -> TpuCostBatch:
    """Vectorized :func:`estimate` over problem arrays x tile arrays.

    Problem-side arrays (``m``, ``n``, ``k``, ``elem_bytes``, ``sublane``,
    ``peak``, ``accumulate``) and tile-side arrays (``bm``, ``bn``, ``bk``,
    ``k_inner``) must broadcast against each other — the canonical layout is
    problems as ``(P, 1)`` columns against flat ``(C,)`` candidate rows.
    ``peak`` is the per-problem arithmetic rate (use :func:`machine_peak` /
    :func:`shape_peak` so non-default machines keep their own dtype tables).
    ``quant`` is an optional ``(ra, rb, rc)`` triple of per-problem
    quantize-ratio arrays (see ``PrecisionConfig.quant_ratios``); None is
    exactly the pre-mixed-precision path.
    """
    machine = machine or _default_machine()
    m, n, k = (np.asarray(x, np.int64) for x in (m, n, k))
    s = np.asarray(elem_bytes, np.int64)
    sub = np.asarray(sublane, np.int64)
    peak = np.asarray(peak, np.float64)
    bm, bn, bk = (np.asarray(x, np.int64) for x in (bm, bn, bk))
    k_inner = np.asarray(k_inner, bool)
    accumulate = np.asarray(accumulate, bool)

    gm = -(-m // bm)
    gn = -(-n // bn)
    gk = -(-k // bk)
    a_bytes = (s * m * k * gn).astype(np.float64)
    b_bytes = (s * k * n * gm).astype(np.float64)
    c_once = (s * m * n).astype(np.float64)
    c_revisit = (s * m * n * gk).astype(np.float64)
    c_writes = np.where(k_inner, c_once, c_revisit)
    c_reads = np.where(k_inner, np.where(accumulate, c_once, 0.0), c_revisit)
    hbm = a_bytes + b_bytes + c_writes + c_reads

    if quant is not None:
        ra, rb, rc = (np.asarray(q, np.float64) for q in quant)
        quant_bytes = (a_bytes * ra + b_bytes * rb
                       + (c_writes + c_reads) * rc)
        hbm = hbm + quant_bytes

    vmem_stream = a_bytes + b_bytes + 8.0 * m * n * gk

    bm_eff = np.minimum(bm, m)
    bn_eff = np.minimum(bn, n)
    bk_eff = np.minimum(bk, k)
    pm = sub * -(-bm_eff // sub)
    pn = LANE * -(-bn_eff // LANE)
    pk = LANE * -(-bk_eff // LANE)
    eff = (bm_eff * bn_eff * bk_eff) / (pm * pn * pk).astype(np.float64)

    flops = 2.0 * m * n * k
    t_compute = flops / (peak * eff)
    t_hbm = hbm / machine.rate("M", "L1")
    t_vmem = vmem_stream / machine.rate("L1", "R")
    return TpuCostBatch(
        hbm_bytes=hbm, vmem_bytes=vmem_stream,
        vmem_peak=vmem_required_batch(bm, bn, bk, s),
        t_compute=t_compute, t_hbm=t_hbm, t_vmem=t_vmem,
        mxu_efficiency=eff,
        grid_steps=(gm * gn * gk).astype(np.float64),
    )
