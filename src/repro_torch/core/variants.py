"""The GotoBLAS/BLIS family of blocked GEMM algorithms modelled by the paper.

Notation (paper §2, ref. [9]): ``X3Y2Z0`` means operand ``X``'s packed buffer
lives at the L3 level of the model, ``Y``'s at L2, and ``Z`` is resident in
the processor registers inside the micro-kernel.

Modelled variants (paper §2.2 — the A/B-swapped mirrors are performance
equivalent and not modelled):

* ``B3A2C0`` — the GotoBLAS2/BLIS/OpenBLAS baseline.  Micro-kernel is an
  ``m_r x n_r`` outer-product update of a C micro-tile held in registers.
* ``C3B2A0`` — C packed at L3, B at L2, A streamed into registers; the
  micro-kernel performs ``m_r x k_r`` matrix-vector products.
* ``B3C2A0`` — B packed at L3, C at L2 (requires an explicit *unpack* of
  C_c back to C), A in registers.

Each variant carries its loop nest (trip counts), the packing/copy/stream
traffic terms, and the scratchpad-occupancy rule used to derive
``(m_c, n_c, k_c)`` from the micro-kernel dimensions (paper §3.2: "set the
configuration parameters so that the buffers maximise the occupancy of the
L1/L2 memory areas").

Level names here are canonical *roles* (``M``/``L2``/``L1``/``R``), not
physical levels: ``machine.capacity("L2")`` and the traffic terms' rate
lookups resolve through the spec's ``level_aliases`` (see
``repro.machines.spec``), so a machine without a distinct L2 area simply
aliases the role onto another level and the same occupancy rules apply.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable

import numpy as np

from repro_torch.core.hardware import MachineSpec
from repro_torch.core.precision import PrecisionConfig


class Variant(str, enum.Enum):
    B3A2C0 = "B3A2C0"
    C3B2A0 = "C3B2A0"
    B3C2A0 = "B3C2A0"

    @property
    def register_operand(self) -> str:
        return {"B3A2C0": "C", "C3B2A0": "A", "B3C2A0": "A"}[self.value]

    @property
    def micro_dims(self) -> tuple[str, str]:
        """Names of the two micro-kernel dimensions (paper: m_r x n_r for the
        baseline, m_r x k_r for the A-resident variants)."""
        return ("m_r", "n_r") if self is Variant.B3A2C0 else ("m_r", "k_r")


@dataclasses.dataclass(frozen=True)
class Problem:
    """A GEMM ``C (m x n) += A (m x k) . B (k x n)``."""
    m: int
    n: int
    k: int
    elem_bytes: int = 1       # INT8 on the GAP8
    dtype: str = "int8"
    # per-operand dtypes for mixed-precision GEMM; None (or a uniform
    # config) is the plain single-dtype path with zero extra terms.
    # ``dtype``/``elem_bytes`` stay the *compute* dtype — the narrower
    # input operand the micro-kernel arithmetic runs at.
    precision: PrecisionConfig | None = None

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def abytes(self) -> float:
        return float(self.m * self.k * self.elem_bytes)

    @property
    def bbytes(self) -> float:
        return float(self.k * self.n * self.elem_bytes)

    @property
    def cbytes(self) -> float:
        return float(self.m * self.n * self.elem_bytes)


@dataclasses.dataclass(frozen=True)
class MicroKernel:
    """Micro-kernel dimensions.  ``rows`` is always m_r; ``cols`` is n_r for
    B3A2C0 and k_r for the A-resident variants."""
    rows: int
    cols: int

    def __str__(self) -> str:  # e.g. "4x24"
        return f"{self.rows}x{self.cols}"


@dataclasses.dataclass(frozen=True)
class Blocking:
    m_c: int
    n_c: int
    k_c: int


def registers_needed(variant: Variant, mk: MicroKernel, lanes: int) -> float:
    """Vector registers needed by the micro-kernel (paper §3.1/§4).

    B3A2C0 holds the ``m_r x n_r`` C micro-tile plus one column of A and one
    row of B; the A-resident variants hold the ``m_r x k_r`` A micro-tile
    plus one column of C and one column of B.  Register width = ``lanes``
    elements (GAP8: 4 INT8 lanes per 32-bit register).
    """
    r, c = mk.rows, mk.cols
    return (r * c) / lanes + r / lanes + c / lanes


def feasible_microkernels(
    machine: MachineSpec,
    variant: Variant,
    step: int | None = None,
    max_dim: int | None = None,
) -> list[MicroKernel]:
    """Enumerate register-feasible micro-kernels.

    The paper's search space (§4): dimensions that are multiples of the SIMD
    width (4 for the GAP8) such that the register working set fits the 32
    vector registers.  This yields exactly the set seen in Figs. 4-6 /
    Table 2: 4x{4..24}, 8x{4..12}, 12x{4,8}, {16,20,24}x4.
    """
    lanes = machine.register_lanes
    step = step or lanes
    max_dim = max_dim or (machine.num_vector_registers * lanes)
    out = []
    for r in range(step, max_dim + 1, step):
        for c in range(step, max_dim + 1, step):
            if registers_needed(variant, MicroKernel(r, c), lanes) <= machine.num_vector_registers:
                out.append(MicroKernel(r, c))
    return out


def _align_down(x: int, a: int) -> int:
    return max(a, (x // a) * a)


def derive_blocking(
    variant: Variant, mk: MicroKernel, machine: MachineSpec, prob: Problem
) -> Blocking:
    """Derive (m_c, n_c, k_c) maximising L1/L2 occupancy (paper §3.2).

    * B3A2C0: B_r (k_c x n_r) fills L1  ->  k_c = C_L1 / n_r;
              A_c (m_c x k_c) fills L2  ->  m_c = C_L2 / k_c;
              B_c lives at the model's L3 (= M on the GAP8) -> n_c = n.
    * C3B2A0: C_r (m_r x n_c) fills L1  ->  n_c = C_L1 / m_r;
              B_c (k_c x n_c) fills L2  ->  k_c = C_L2 / n_c;
              C_c at L3 -> m_c = m.
    * B3C2A0: B_r (k_r x n_c) fills L1  ->  n_c = C_L1 / k_r;
              C_c (m_c x n_c) fills L2  ->  m_c = C_L2 / n_c;
              B_c at L3 -> k_c = k.

    All block dims are capped by the problem dims and aligned down to the
    micro-kernel multiple where the loop structure requires it.
    """
    s = prob.elem_bytes
    l1 = machine.capacity("L1") // s
    l2 = machine.capacity("L2") // s
    if variant is Variant.B3A2C0:
        n_r, m_r = mk.cols, mk.rows
        k_c = min(max(1, l1 // n_r), prob.k)
        m_c = min(_align_down(max(m_r, l2 // max(1, k_c)), m_r), max(m_r, _align_down(prob.m, 1)))
        m_c = min(m_c, prob.m) if prob.m >= m_r else prob.m
        n_c = prob.n
        return Blocking(m_c=max(1, m_c), n_c=n_c, k_c=k_c)
    if variant is Variant.C3B2A0:
        m_r, k_r = mk.rows, mk.cols
        n_c = min(max(1, l1 // m_r), prob.n)
        k_c = min(max(1, l2 // max(1, n_c)), prob.k)
        m_c = prob.m
        return Blocking(m_c=m_c, n_c=n_c, k_c=k_c)
    if variant is Variant.B3C2A0:
        m_r, k_r = mk.rows, mk.cols
        n_c = min(max(1, l1 // k_r), prob.n)
        m_c = min(_align_down(max(m_r, l2 // max(1, n_c)), m_r), prob.m) if prob.m >= m_r else prob.m
        k_c = prob.k
        return Blocking(m_c=max(1, m_c), n_c=n_c, k_c=k_c)
    raise ValueError(variant)


# ---------------------------------------------------------------------------
# Traffic terms.  Each term is (bytes, origin, dest, chunk_elems_or_None);
# chunk=None means the calibrated rate applies unscaled (streaming / straight
# panel copies); chunk=r means the packing rate scales by r/reference_chunk
# (paper §3.2).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficTerm:
    name: str         # e.g. "pack_B", "stream_C"
    bytes: float
    origin: str
    dest: str
    chunk: int | None  # packing chunk size in elements, or None
    note: str = ""


# Which traffic terms touch an *original* operand array (A, B or the C
# accumulator in external memory), per variant.  Mixed-precision configs
# charge quantize/dequantize traffic exactly at these boundaries: a
# wider-than-compute operand is converted while being packed/streamed, so
# the term moves extra bytes proportional to the width ratio.  Inner packed
# buffers (A_c, B_c, C_c, B_r, C_r) already hold compute-width panels and
# carry no extra charge.
_QUANT_OPERANDS = {
    Variant.B3A2C0: {"pack_A": "A", "pack_B": "B", "stream_C": "C"},
    Variant.C3B2A0: {"stream_A": "A", "pack_B": "B",
                     "pack_C": "C", "unpack_C": "C"},
    Variant.B3C2A0: {"stream_A": "A", "pack_B": "B",
                     "pack_C": "C", "unpack_C": "C"},
}


def quant_ratio_map(prob: Problem) -> dict[str, float] | None:
    """Per-operand quantize-traffic ratios of one problem, or None when the
    problem is single-dtype / uniform / all-zero (no extra terms)."""
    pc = prob.precision
    if pc is None or pc.is_uniform:
        return None
    ra, rb, rc = pc.quant_ratios(prob.elem_bytes)
    ratios = {"A": ra, "B": rb, "C": rc}
    return ratios if any(r > 0.0 for r in ratios.values()) else None


def _with_quant(variant: Variant, terms: list[TrafficTerm],
                prob: Problem) -> list[TrafficTerm]:
    """Append ``quant_<term>`` charges for wider-than-compute operands.

    Each charge replays its base term's route and chunk, scaled by the
    operand's width ratio, so the extra time is exactly ``ratio x`` the
    base term's time — the property the mixed-precision tests assert."""
    ratios = quant_ratio_map(prob)
    if not ratios:
        return terms
    ops = _QUANT_OPERANDS[variant]
    extra = []
    for t in terms:
        op = ops.get(t.name)
        if op is None:
            continue
        r = ratios[op]
        if r <= 0.0:
            continue
        extra.append(TrafficTerm(
            f"quant_{t.name}", t.bytes * r, t.origin, t.dest, t.chunk,
            note=f"{op} requantize ({r:g}x {t.name})"))
    return terms + extra


def _trips(x: int, b: int, policy: str) -> float:
    """Trip count of a blocked loop: exact ratio ("analytic", the paper's
    closed-form accounting) or ceil ("padded", mimicking edge tiles at full
    cost)."""
    if policy == "analytic":
        return x / b
    if policy == "padded":
        return float(math.ceil(x / b))
    raise ValueError(policy)


def traffic_terms(
    variant: Variant,
    mk: MicroKernel,
    blk: Blocking,
    prob: Problem,
    policy: str = "analytic",
) -> list[TrafficTerm]:
    """All data-movement terms of one GEMM under the given variant.

    Derived by walking the loop nests of Fig. 1 / Fig. 3 and counting, for
    every packed buffer / panel copy / micro-kernel stream, how many times
    each byte crosses each level boundary.  See DESIGN.md §1 for the
    derivation; tests/test_simulator.py checks the closed forms against a
    literal loop-nest walker.
    """
    m, n, k, s = prob.m, prob.n, prob.k, prob.elem_bytes
    t = lambda x, b: _trips(x, b, policy)  # noqa: E731
    terms: list[TrafficTerm] = []
    add = lambda *a, **kw: terms.append(TrafficTerm(*a, **kw))  # noqa: E731

    if variant is Variant.B3A2C0:
        m_r, n_r = mk.rows, mk.cols
        # L1 jc / L2 pc: pack B(k_c x n_c) -> B_c once per (jc,pc): covers B once.
        add("pack_B", s * k * n, "M", "M", n_r, note="B->B_c (L3 buffer)")
        # L3 ic: pack A(m_c x k_c) -> A_c once per (jc,pc,ic).
        add("pack_A", s * m * k * t(n, blk.n_c), "M", "L2", m_r, note="A->A_c")
        # L4 jr: copy B_r (k_c x n_r) panel into L1 once per (jc,pc,ic,jr).
        add("copy_Br", s * k * n * t(m, blk.m_c), "M", "L1", None, note="B_c->B_r")
        # micro-kernel: C micro-tile loaded+stored once per call (k/k_c passes
        # over the full C).
        add("stream_C", 2.0 * s * m * n * t(k, blk.k_c), "M", "R", None,
            note="C<->regs, amortised over k_c")
        # micro-kernel: A_c micro-panel (m_r x k_c) read once per jr iter.
        add("stream_A", s * m * k * t(n, n_r), "L2", "R", None, note="A_c->regs")
        # micro-kernel: B_r (k_c x n_r) read once per ir iter.
        add("stream_B", s * k * n * t(m, m_r), "L1", "R", None, note="B_r->regs")
        return _with_quant(variant, terms, prob)

    if variant is Variant.C3B2A0:
        m_r, k_r = mk.rows, mk.cols
        # L2 ic: pack C -> C_c (L3 buffer) once per (jc,ic); unpack at end.
        add("pack_C", s * m * n, "M", "M", m_r, note="C->C_c (L3 buffer)")
        add("unpack_C", s * m * n, "M", "M", m_r, note="C_c->C")
        # L3 pc: pack B(k_c x n_c) -> B_c once per (jc,ic,pc).
        add("pack_B", s * k * n * t(m, blk.m_c), "M", "L2", k_r, note="B->B_c")
        # C_r (m_r x n_c) copied L1-ward and back once per (jc,ic,pc,ir).
        add("copy_Cr", 2.0 * s * m * n * t(k, blk.k_c), "M", "L1", None,
            note="C_c<->C_r")
        # micro-kernel: A micro-tile (m_r x k_r) streamed from memory.
        add("stream_A", s * m * k * t(n, blk.n_c), "M", "R", None, note="A->regs")
        # micro-kernel: B_c column (k_r) per jr iteration.
        add("stream_B", s * k * n * t(m, m_r), "L2", "R", None, note="B_c->regs")
        # micro-kernel: C_r column (m_r) loaded+stored per jr iteration.
        add("stream_C", 2.0 * s * m * n * t(k, k_r), "L1", "R", None,
            note="C_r<->regs")
        return _with_quant(variant, terms, prob)

    if variant is Variant.B3C2A0:
        m_r, k_r = mk.rows, mk.cols
        # L2 pc: pack B(k_c x n_c) -> B_c (L3 buffer) once per (jc,pc).
        add("pack_B", s * k * n, "M", "M", k_r, note="B->B_c (L3 buffer)")
        # L3 ic: pack C(m_c x n_c) -> C_c (L2) once per (jc,pc,ic); unpack too.
        add("pack_C", s * m * n * t(k, blk.k_c), "M", "L2", m_r, note="C->C_c")
        add("unpack_C", s * m * n * t(k, blk.k_c), "L2", "M", m_r, note="C_c->C")
        # L4 pr: copy B_r (k_r x n_c) into L1 once per (jc,pc,ic,pr).
        add("copy_Br", s * k * n * t(m, blk.m_c), "M", "L1", None, note="B_c->B_r")
        # micro-kernel: A micro-tile streamed from memory.
        add("stream_A", s * m * k * t(n, blk.n_c), "M", "R", None, note="A->regs")
        # micro-kernel: C_c column (m_r) loaded+stored per jr iteration.
        add("stream_C", 2.0 * s * m * n * t(k, k_r), "L2", "R", None,
            note="C_c<->regs")
        # micro-kernel: B_r column (k_r) per jr iteration.
        add("stream_B", s * k * n * t(m, m_r), "L1", "R", None, note="B_r->regs")
        return _with_quant(variant, terms, prob)

    raise ValueError(variant)


# ---------------------------------------------------------------------------
# Batched closed forms.  The same §3.2 occupancy rules and Fig. 1/Fig. 3
# traffic terms as above, expressed as NumPy array programs over a
# (problems x micro-kernels) lattice: problem dims arrive as (P, 1) columns,
# micro-kernel dims as flat (C,) rows.  Every expression replays the scalar
# functions' integer/float operations in the same order, so the batched
# simulator's totals are bit-identical with ``simulate`` and argmin
# selections agree exactly.
# ---------------------------------------------------------------------------


def derive_blocking_batch(
    variant: Variant, rows: np.ndarray, cols: np.ndarray,
    machine: MachineSpec, m: np.ndarray, n: np.ndarray, k: np.ndarray,
    elem_bytes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized :func:`derive_blocking`: (m_c, n_c, k_c) arrays broadcast
    to the full (P, C) lattice."""
    l1 = machine.capacity("L1") // elem_bytes
    l2 = machine.capacity("L2") // elem_bytes
    if variant is Variant.B3A2C0:
        m_r, n_r = rows, cols
        k_c = np.minimum(np.maximum(1, l1 // n_r), k)
        grown = np.maximum(m_r, l2 // np.maximum(1, k_c))
        aligned = np.maximum(m_r, (grown // m_r) * m_r)
        m_c = np.minimum(aligned, np.maximum(m_r, m))
        m_c = np.where(m >= m_r, np.minimum(m_c, m), m + 0 * m_r)
        m_c = np.maximum(1, m_c)
        n_c = n + 0 * cols
    elif variant is Variant.C3B2A0:
        m_r = rows
        n_c = np.minimum(np.maximum(1, l1 // m_r), n)
        k_c = np.minimum(np.maximum(1, l2 // np.maximum(1, n_c)), k)
        m_c = m + 0 * rows
    elif variant is Variant.B3C2A0:
        m_r, k_r = rows, cols
        n_c = np.minimum(np.maximum(1, l1 // k_r), n)
        grown = np.maximum(m_r, l2 // np.maximum(1, n_c))
        aligned = np.maximum(m_r, (grown // m_r) * m_r)
        m_c = np.where(m >= m_r, np.minimum(aligned, m), m + 0 * m_r)
        m_c = np.maximum(1, m_c)
        k_c = k + 0 * cols
    else:
        raise ValueError(variant)
    return np.broadcast_arrays(m_c, n_c, k_c)


@dataclasses.dataclass(frozen=True)
class TrafficTermBatch:
    """One traffic term over the whole lattice: ``bytes`` broadcasts to
    (P, C); ``chunk`` is the per-candidate packing chunk array or None."""
    name: str
    bytes: np.ndarray
    origin: str
    dest: str
    chunk: np.ndarray | None


def _trips_batch(x, b, policy: str) -> np.ndarray:
    if policy == "analytic":
        return x / b
    if policy == "padded":
        return np.ceil(x / b)
    raise ValueError(policy)


def quant_ratio_arrays(probs) -> dict[str, np.ndarray] | None:
    """(P, 1) quantize-ratio columns per operand for a problem batch, or
    None when no problem carries a mixed precision (the plain path).

    The arrays feed :func:`traffic_terms_batch`: uniform problems get 0.0
    rows, whose term contributions are exactly 0.0 — adding them preserves
    bit-identity with the scalar path, which skips zero-ratio terms."""
    rows = []
    mixed = False
    for p in probs:
        ratios = quant_ratio_map(p)
        if ratios is None:
            rows.append((0.0, 0.0, 0.0))
        else:
            mixed = True
            rows.append((ratios["A"], ratios["B"], ratios["C"]))
    if not mixed:
        return None
    arr = np.array(rows, np.float64)
    return {"A": arr[:, 0:1], "B": arr[:, 1:2], "C": arr[:, 2:3]}


def _with_quant_batch(variant: Variant, terms: list[TrafficTermBatch],
                      quant: dict[str, np.ndarray] | None
                      ) -> list[TrafficTermBatch]:
    """Vectorized :func:`_with_quant` over the (P, C) lattice."""
    if quant is None:
        return terms
    ops = _QUANT_OPERANDS[variant]
    extra = []
    for t in terms:
        op = ops.get(t.name)
        if op is None:
            continue
        extra.append(TrafficTermBatch(
            f"quant_{t.name}", t.bytes * quant[op], t.origin, t.dest,
            t.chunk))
    return terms + extra


def traffic_terms_batch(
    variant: Variant, rows: np.ndarray, cols: np.ndarray,
    blocking: tuple[np.ndarray, np.ndarray, np.ndarray],
    m: np.ndarray, n: np.ndarray, k: np.ndarray, elem_bytes: np.ndarray,
    policy: str = "analytic",
    quant: dict[str, np.ndarray] | None = None,
) -> list[TrafficTermBatch]:
    """Vectorized :func:`traffic_terms`, in the scalar term order.

    ``quant`` is the optional per-operand quantize-ratio column dict from
    :func:`quant_ratio_arrays`; when given, ``quant_*`` terms are appended
    in the scalar order (zero rows for uniform problems)."""
    m_c, n_c, k_c = blocking
    s = elem_bytes
    smn = (s * m * n).astype(np.float64)
    smk = (s * m * k).astype(np.float64)
    skn = (s * k * n).astype(np.float64)
    t = lambda x, b: _trips_batch(x, b, policy)  # noqa: E731
    T = TrafficTermBatch

    if variant is Variant.B3A2C0:
        m_r, n_r = rows, cols
        return _with_quant_batch(variant, [
            T("pack_B", skn, "M", "M", n_r),
            T("pack_A", smk * t(n, n_c), "M", "L2", m_r),
            T("copy_Br", skn * t(m, m_c), "M", "L1", None),
            T("stream_C", 2.0 * smn * t(k, k_c), "M", "R", None),
            T("stream_A", smk * t(n, n_r), "L2", "R", None),
            T("stream_B", skn * t(m, m_r), "L1", "R", None),
        ], quant)
    if variant is Variant.C3B2A0:
        m_r, k_r = rows, cols
        return _with_quant_batch(variant, [
            T("pack_C", smn, "M", "M", m_r),
            T("unpack_C", smn, "M", "M", m_r),
            T("pack_B", skn * t(m, m_c), "M", "L2", k_r),
            T("copy_Cr", 2.0 * smn * t(k, k_c), "M", "L1", None),
            T("stream_A", smk * t(n, n_c), "M", "R", None),
            T("stream_B", skn * t(m, m_r), "L2", "R", None),
            T("stream_C", 2.0 * smn * t(k, k_r), "L1", "R", None),
        ], quant)
    if variant is Variant.B3C2A0:
        m_r, k_r = rows, cols
        return _with_quant_batch(variant, [
            T("pack_B", skn, "M", "M", k_r),
            T("pack_C", smn * t(k, k_c), "M", "L2", m_r),
            T("unpack_C", smn * t(k, k_c), "L2", "M", m_r),
            T("copy_Br", skn * t(m, m_c), "M", "L1", None),
            T("stream_A", smk * t(n, n_c), "M", "R", None),
            T("stream_C", 2.0 * smn * t(k, k_r), "L2", "R", None),
            T("stream_B", skn * t(m, m_r), "L1", "R", None),
        ], quant)
    raise ValueError(variant)


def loop_trip_counts(
    variant: Variant, mk: MicroKernel, blk: Blocking, prob: Problem
) -> dict[str, int]:
    """Integer trip counts of the 5 outer loops (for the literal walker and
    for sanity display)."""
    m, n, k = prob.m, prob.n, prob.k
    c = lambda x, b: int(math.ceil(x / b))  # noqa: E731
    if variant is Variant.B3A2C0:
        return {"jc": c(n, blk.n_c), "pc": c(k, blk.k_c), "ic": c(m, blk.m_c),
                "jr": c(blk.n_c, mk.cols), "ir": c(blk.m_c, mk.rows)}
    if variant is Variant.C3B2A0:
        return {"jc": c(n, blk.n_c), "ic": c(m, blk.m_c), "pc": c(k, blk.k_c),
                "ir": c(blk.m_c, mk.rows), "pr": c(blk.k_c, mk.cols)}
    return {"jc": c(n, blk.n_c), "pc": c(k, blk.k_c), "ic": c(m, blk.m_c),
            "pr": c(blk.k_c, mk.cols), "ir": c(blk.m_c, mk.rows)}


def microkernel_invocations(
    variant: Variant, mk: MicroKernel, blk: Blocking, prob: Problem,
    policy: str = "analytic",
) -> float:
    """Number of innermost micro-kernel calls: the product of all 5 outer
    loop trips under the given edge policy ("analytic" keeps the paper's
    fractional accounting; "padded" matches :func:`loop_trip_counts`).

    This is the coefficient of the Calibrator's opt-in per-block overhead
    column (``overhead_per_block=True``): each micro-kernel dispatch carries
    a constant cost (loop bookkeeping, address setup, function-call
    overhead) that the pure rate model cannot express for small blocks.
    """
    m, n, k = prob.m, prob.n, prob.k
    t = lambda x, b: _trips(x, b, policy)  # noqa: E731
    if variant is Variant.B3A2C0:
        return (t(n, blk.n_c) * t(k, blk.k_c) * t(m, blk.m_c)
                * t(blk.n_c, mk.cols) * t(blk.m_c, mk.rows))
    if variant is Variant.C3B2A0:
        return (t(n, blk.n_c) * t(m, blk.m_c) * t(k, blk.k_c)
                * t(blk.m_c, mk.rows) * t(blk.k_c, mk.cols))
    if variant is Variant.B3C2A0:
        return (t(n, blk.n_c) * t(k, blk.k_c) * t(m, blk.m_c)
                * t(blk.k_c, mk.cols) * t(blk.m_c, mk.rows))
    raise ValueError(variant)


def microkernel_invocations_batch(
    variant: Variant, rows: np.ndarray, cols: np.ndarray,
    blocking: tuple[np.ndarray, np.ndarray, np.ndarray],
    m: np.ndarray, n: np.ndarray, k: np.ndarray,
    policy: str = "analytic",
) -> np.ndarray:
    """Vectorized :func:`microkernel_invocations` over the (P, C) lattice,
    replaying the scalar multiplication order so totals are bit-identical."""
    m_c, n_c, k_c = blocking
    t = lambda x, b: _trips_batch(x, b, policy)  # noqa: E731
    if variant is Variant.B3A2C0:
        return (t(n, n_c) * t(k, k_c) * t(m, m_c)
                * t(n_c, cols) * t(m_c, rows))
    if variant is Variant.C3B2A0:
        return (t(n, n_c) * t(m, m_c) * t(k, k_c)
                * t(m_c, rows) * t(k_c, cols))
    if variant is Variant.B3C2A0:
        return (t(n, n_c) * t(k, k_c) * t(m, m_c)
                * t(k_c, cols) * t(m_c, rows))
    raise ValueError(variant)
