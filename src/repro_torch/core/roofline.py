"""Three-term roofline analysis of a dry-run cell, priced on the H100.

The counterpart of ``repro.core.roofline``.  For each (architecture x
input shape x mesh) dry-run cell (``launch/dryrun.py``):

    compute term    = flops      / peak FLOP/s
    memory term     = bytes      / HBM bytes/s
    collective term = coll_bytes / interconnect bytes/s

all per rank.  The JAX package reads the first two from XLA's
``cost_analysis()`` and parses the optimized HLO text for the third.  The
port has no HLO: the dry run runs the port's own code eagerly on fake
tensors and counts its floating-point operations
(``torch.utils.flop_counter``), the bytes of its operations, and its
collectives (``runtime.sharding.COLLECTIVES``, which
:func:`collective_bytes` sums in place of the HLO parse).

The rates are the ``h100`` manifest's (``machines/zoo/h100.json``: bf16
989 TFLOP/s, HBM 3.35 TB/s, data-sheet placeholders).  The manifest has
no interconnect rate, so the collective term's is a constant here,
uncalibrated: :data:`IB_NDR_BW`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

#: bytes/s a collective moves per card over an axis that spans more than
#: one 8-card HGX node: one InfiniBand NDR port, 400 Gb/s (NVIDIA
#: ConnectX-7 data sheet).  Every axis of the 16x16 and 2x16x16 meshes
#: spans nodes.  Uncalibrated: no collective has been timed across nodes.
IB_NDR_BW = 50e9
#: NVLink 4, 450 GB/s per direction (H100 SXM5 data sheet): what an axis
#: inside one node would see.  Not priced: no production axis stays in one.
NVLINK4_BW = 450e9

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``COLLECTIVES``' op names -> XLA's.  A pipeline send is a
#: collective-permute's operand; its receive moves the same bytes into
#: the other rank and is not counted again.
_XLA_OP = {"all_gather": "all-gather", "all_reduce": "all-reduce",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "send": "collective-permute"}


@dataclasses.dataclass(frozen=True)
class Rates:
    """Per-card rates the terms divide by: FLOP/s, HBM bytes/s and
    interconnect bytes/s."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


@functools.lru_cache(maxsize=None)
def card_rates(machine: str = "h100") -> Rates:
    """The manifest's bf16 rate and HBM rate (``M->L2``), with
    :data:`IB_NDR_BW`."""
    from repro_torch.machines import registry

    spec = registry.get(machine)
    return Rates(peak_flops=spec.arith_rate["bf16"],
                 hbm_bw=spec.rate("M", "L2"), link_bw=IB_NDR_BW)


def collective_bytes(collectives: Mapping) -> dict[str, float]:
    """Sum the *operand* bytes of every collective in a
    ``runtime.sharding.COLLECTIVES`` snapshot (``{(op, axis): {"calls",
    "bytes"}}``), by XLA's op names.

    ``COLLECTIVES`` counts the payload a rank hands in: an all-gather's
    local shard, a reduce-scatter's full input, an all-reduce's and an
    all-to-all's tensor, a send's buffer.  Those are XLA's operand bytes,
    which the JAX package derives from each op's result shape.  Returns
    the reference's keys: one per op, ``_total`` and ``_count``."""
    totals: dict[str, float] = {op: 0.0 for op in COLLECTIVE_OPS}
    counts: dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
    for (op, _axis), rec in collectives.items():
        if op not in _XLA_OP:          # a receive
            continue
        totals[_XLA_OP[op]] += rec["bytes"]
        counts[_XLA_OP[op]] += rec["calls"]
    totals["_total"] = sum(totals[o] for o in COLLECTIVE_OPS)
    totals["_count"] = float(sum(counts.values()))
    return totals


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """Roofline terms of one dry-run cell.

    The dry run counts one rank's program, so the assignment's ``X /
    (chips x rate)`` is realised as ``X_per_rank / rate``, as in the JAX
    package.  The count fields keep the reference's names (``hlo_*``)
    though nothing here is HLO: ``hlo_flops`` are the rank's counted
    floating-point operations, ``hlo_bytes`` the operand and result bytes
    of its eager operations (unfused, so more than XLA's fused count).
    ``model_flops`` stays global and is divided by chips for the ideal.
    """
    arch: str
    shape_name: str
    mesh: str
    chips: int
    hlo_flops: float              # per rank
    hlo_bytes: float              # per rank
    coll_bytes: float             # per rank
    model_flops: float            # GLOBAL: 6 N D (dense) / 6 N_active D (MoE)
    coll_detail: Mapping[str, float]
    rates: Rates = dataclasses.field(default_factory=card_rates)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.rates.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.rates.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.rates.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: overlapped resources -> max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the step at the dominant bottleneck:
        MODEL_FLOPs-at-peak over the bound step time."""
        ideal = self.model_flops / (self.chips * self.rates.peak_flops)
        return ideal / self.step_time if self.step_time > 0 else 0.0

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundant compute."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape_name, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.coll_bytes / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_record(record: Mapping, model_flops: float) -> RooflineReport:
    """A report from a dry-run record (``launch.dryrun.run_cell``): its
    per-rank flops, bytes and collectives."""
    coll = collective_bytes({tuple(k.split(" over ")): v for k, v in
                             record["collectives"].items()})
    return RooflineReport(
        arch=record["arch"], shape_name=record["shape"],
        mesh=record["mesh"], chips=record["chips"],
        hlo_flops=float(record["flops"]),
        hlo_bytes=float(record["bytes_accessed"]),
        coll_bytes=coll["_total"], model_flops=model_flops, coll_detail=coll)
