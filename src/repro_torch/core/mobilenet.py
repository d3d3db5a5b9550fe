"""MobileNetV1 GEMM workload (paper Table 2).

Applying the lowering (im2col) approach to MobileNetV1's convolutions yields
one GEMM per layer; the paper evaluates the three algorithmic variants on all
of them and reports the optimal micro-kernel per (layer, variant).  We encode
the table verbatim as the reproduction oracle; ``benchmarks/bench_table2.py``
re-derives the optima with our simulator and reports the agreement matrix.

Layer #28 is skipped by the paper (not a convolution).  Rows that the paper
groups ("5,7", "14,16,18,20,22", ...) are expanded to the first layer id of
the group (the GEMM dims are identical).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.variants import MicroKernel, Problem


@dataclasses.dataclass(frozen=True)
class Table2Row:
    layer: str
    m: int
    n: int
    k: int
    best: dict  # variant name -> paper's optimal micro-kernel

    @property
    def problem(self) -> Problem:
        return Problem(m=self.m, n=self.n, k=self.k, elem_bytes=1, dtype="int8")


def _mk(s: str) -> MicroKernel:
    r, c = s.split("x")
    return MicroKernel(int(r), int(c))


TABLE2: list[Table2Row] = [
    Table2Row("1", 32, 12544, 27,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("8x12")}),
    Table2Row("2", 32, 12544, 288,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("8x12"), "B3C2A0": _mk("4x24")}),
    Table2Row("3", 64, 12544, 32,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("12x8")}),
    Table2Row("4", 64, 3136, 576,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("5,7", 128, 3136, 128,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("4x24")}),
    Table2Row("6", 128, 3136, 1152,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("8", 128, 784, 1152,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("9", 256, 784, 128,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("8x12")}),
    Table2Row("10", 256, 784, 2304,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("11", 256, 784, 256,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x20")}),
    Table2Row("12", 256, 196, 2304,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("13", 512, 196, 256,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("4x24")}),
    Table2Row("14,16,18,20,22", 512, 196, 4608,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("15,17,19,21,23", 512, 196, 512,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("24", 512, 49, 4608,
              {"B3A2C0": _mk("8x12"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("25", 1024, 49, 512,
              {"B3A2C0": _mk("8x12"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("26", 1024, 49, 9216,
              {"B3A2C0": _mk("8x12"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("27", 1024, 49, 1024,
              {"B3A2C0": _mk("8x12"), "C3B2A0": _mk("12x8"), "B3C2A0": _mk("4x24")}),
    Table2Row("29", 1024, 1000, 1,
              {"B3A2C0": _mk("4x24"), "C3B2A0": _mk("24x4"), "B3C2A0": _mk("24x4")}),
]

# The validation GEMM of §3.2 / Fig. 4-5 (MobileNetV1 layer #10).
LAYER10 = TABLE2[8].problem
assert (LAYER10.m, LAYER10.n, LAYER10.k) == (256, 784, 2304)
