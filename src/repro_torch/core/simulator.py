"""The paper's performance simulator (§3): traffic terms x calibrated rates.

``simulate`` produces a :class:`CostBreakdown` whose components mirror the
stacked bars of Figs. 4-5: packing, unpacking, L1 copies, per-level
micro-kernel streaming, and arithmetic.  The basic model assumes *no overlap*
between data transfers and compute (paper §3.1), so the total is the plain
sum of all components; the arithmetic rate is independent of the micro-kernel
shape (paper §4, a stated simplification of the basic simulator).

Machines come from the ``repro.machines`` zoo.  The simulator addresses the
canonical level roles ``{"M", "L2", "L1", "R"}``; a spec whose physical
hierarchy differs (a two-level Cortex-M-class part, the TPU's HBM/VMEM pair)
declares ``level_aliases`` and every ``machine.rate`` / ``machine.capacity``
call here resolves through them — no per-machine special cases.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.hardware import MachineSpec
from repro_torch.core.variants import (
    Blocking,
    MicroKernel,
    Problem,
    TrafficTerm,
    Variant,
    derive_blocking,
    derive_blocking_batch,
    feasible_microkernels,
    quant_ratio_arrays,
    traffic_terms,
    traffic_terms_batch,
)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Execution-time decomposition (seconds) of one GEMM."""

    variant: Variant
    micro_kernel: MicroKernel
    blocking: Blocking
    problem: Problem
    # name -> seconds for every traffic term, plus "arith".
    components: Mapping[str, float]
    # name -> bytes moved, for roofline-style reporting.
    traffic_bytes: Mapping[str, float]
    # name -> origin memory level (for grouping like the paper's figures).
    origins: Mapping[str, str]

    @property
    def total(self) -> float:
        return float(sum(self.components.values()))

    @property
    def arith(self) -> float:
        return self.components["arith"]

    @property
    def transfer(self) -> float:
        return self.total - self.arith

    def grouped(self) -> dict[str, float]:
        """Group components the way the paper's figures do."""
        g = {"packing": 0.0, "unpacking": 0.0, "copy": 0.0,
             "stream_M": 0.0, "stream_L1": 0.0, "stream_L2": 0.0,
             "arith": 0.0, "quantize": 0.0}
        for name, secs in self.components.items():
            if name.startswith("quant_"):
                g["quantize"] += secs
            elif name.startswith("pack"):
                g["packing"] += secs
            elif name.startswith("unpack"):
                g["unpacking"] += secs
            elif name.startswith("copy"):
                g["copy"] += secs
            elif name == "arith":
                g["arith"] += secs
            else:  # stream_X
                g[f"stream_{self.origins[name]}"] += secs
        return g


def simulate(
    machine: MachineSpec,
    variant: Variant,
    mk: MicroKernel,
    prob: Problem,
    blocking: Blocking | None = None,
    policy: str = "analytic",
) -> CostBreakdown:
    """Estimate the execution time of ``C += A.B`` on ``machine``.

    ``policy`` selects the partial-tile accounting: "analytic" uses exact
    byte ratios (closed-form; the paper's 2%-accurate regime), "padded"
    charges edge tiles at full-tile cost (a real implementation's upper
    bound).  EXPERIMENTS.md reports Table-2 agreement for both.
    """
    blk = blocking or derive_blocking(variant, mk, machine, prob)
    terms = traffic_terms(variant, mk, blk, prob, policy=policy)

    components: dict[str, float] = {}
    traffic: dict[str, float] = {}
    origins: dict[str, str] = {}
    for t in terms:
        if t.chunk is None:
            rate = machine.rate(t.origin, t.dest)
        else:
            rate = machine.packing_rate(t.origin, t.dest, t.chunk)
        components[t.name] = t.bytes / rate
        traffic[t.name] = t.bytes
        origins[t.name] = t.origin

    # per-micro-kernel refinement (paper §4) when the spec carries a table;
    # otherwise exactly arith_rate[dtype].  Mixed-precision problems look
    # up the machine's rates_mixed table by config key, falling back to the
    # uniform rate of the compute dtype.
    pc = prob.precision
    if pc is not None and not pc.is_uniform:
        arith_rate = machine.arith_rate_mixed(pc.key(), prob.dtype, mk)
    else:
        arith_rate = machine.arith_rate_for(prob.dtype, mk)
    components["arith"] = prob.flops / arith_rate

    return CostBreakdown(
        variant=variant, micro_kernel=mk, blocking=blk, problem=prob,
        components=components, traffic_bytes=traffic, origins=origins,
    )


def best_microkernel(
    machine: MachineSpec,
    variant: Variant,
    prob: Problem,
    candidates: list[MicroKernel] | None = None,
    policy: str = "analytic",
) -> CostBreakdown:
    """Exhaustive search over the register-feasible micro-kernel set —
    the paper's Table-2 procedure (thin wrapper over the batched engine)."""
    return best_microkernel_batch(machine, variant, [prob],
                                  candidates=candidates, policy=policy)[0]


def best_microkernel_scalar(
    machine: MachineSpec,
    variant: Variant,
    prob: Problem,
    candidates: list[MicroKernel] | None = None,
    policy: str = "analytic",
) -> CostBreakdown:
    """The pre-batching scalar search loop, preserved verbatim as the
    reference oracle for the equivalence tests and the planner benchmark.
    Do not optimise or route through the batch engine — its whole value is
    being an independent implementation the batch path must agree with."""
    cands = candidates or feasible_microkernels(machine, variant)
    best: CostBreakdown | None = None
    for mk in cands:
        cb = simulate(machine, variant, mk, prob, policy=policy)
        if best is None or cb.total < best.total:
            best = cb
    assert best is not None, "no feasible micro-kernel"
    return best


# ---------------------------------------------------------------------------
# Batched evaluation engine: score every (micro-kernel, problem) pair of a
# variant in a handful of vectorized operations.  The per-candidate totals
# replay ``simulate``'s arithmetic elementwise in the same order (see
# core/variants.py), so they are bit-identical with the scalar simulator and
# argmin micro-kernel selections agree exactly; winners are rehydrated into
# full :class:`CostBreakdown` objects by one scalar ``simulate`` call each.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostBatch:
    """Structure-of-arrays cost lattice for one variant: ``total`` has shape
    (problems, micro-kernels), in the candidate order of ``micro_kernels``."""

    variant: Variant
    micro_kernels: list[MicroKernel]
    total: np.ndarray
    arith: np.ndarray
    blocking: tuple[np.ndarray, np.ndarray, np.ndarray]


def _problem_arrays(probs: Sequence[Problem]):
    m = np.array([p.m for p in probs], np.int64)[:, None]
    n = np.array([p.n for p in probs], np.int64)[:, None]
    k = np.array([p.k for p in probs], np.int64)[:, None]
    s = np.array([p.elem_bytes for p in probs], np.int64)[:, None]
    return m, n, k, s


def simulate_batch(
    machine: MachineSpec,
    probs: Sequence[Problem],
    variant: Variant,
    candidates: Sequence[MicroKernel] | None = None,
    policy: str = "analytic",
) -> CostBatch:
    """Vectorized ``simulate`` over problems x micro-kernels (one variant).

    Blockings are derived per lattice point with the closed-form occupancy
    rules; the traffic terms come from ``traffic_terms_batch`` and are
    divided by the calibrated rates exactly like the scalar path.
    """
    probs = list(probs)
    cands = list(candidates or feasible_microkernels(machine, variant))
    rows = np.array([mk.rows for mk in cands], np.int64)
    cols = np.array([mk.cols for mk in cands], np.int64)
    m, n, k, s = _problem_arrays(probs)
    blk = derive_blocking_batch(variant, rows, cols, machine, m, n, k, s)
    terms = traffic_terms_batch(variant, rows, cols, blk, m, n, k, s,
                                policy=policy,
                                quant=quant_ratio_arrays(probs))
    total = None
    for t in terms:
        base = machine.rate(t.origin, t.dest)
        if t.chunk is None:
            rate = base
        else:
            rate = base * (t.chunk / float(machine.reference_chunk))
        comp = t.bytes / rate
        total = comp if total is None else total + comp
    dtypes = [p.dtype for p in probs]
    # arithmetic rates mirror the scalar lookup chain per problem: mixed
    # configs via rates_mixed (constant across candidates on a table hit,
    # per-mk refined through the uniform fallback otherwise), uniform
    # problems exactly as before.
    def _mixed_of(p):
        pc = p.precision
        return pc if pc is not None and not pc.is_uniform else None
    if machine.arith_per_mk and any(dt in machine.arith_per_mk
                                    for dt in dtypes):
        # per-candidate rates: (P, C) lattice of the paper-§4 refinement,
        # one lookup row per (precision, dtype) pair, broadcast over
        # problems.
        rows_by_key: dict[tuple, np.ndarray] = {}
        rate_rows = []
        for p in probs:
            pc = _mixed_of(p)
            key = (pc.key() if pc else None, p.dtype)
            row = rows_by_key.get(key)
            if row is None:
                if pc is not None:
                    row = np.array(
                        [machine.arith_rate_mixed(pc.key(), p.dtype, mk)
                         for mk in cands], np.float64)
                else:
                    row = np.array([machine.arith_rate_for(p.dtype, mk)
                                    for mk in cands], np.float64)
                rows_by_key[key] = row
            rate_rows.append(row)
        arith_rate = np.stack(rate_rows, axis=0)
    else:
        arith_rate = np.array(
            [machine.arith_rate_mixed(pc.key(), p.dtype)
             if (pc := _mixed_of(p)) is not None
             else machine.arith_rate[p.dtype]
             for p in probs], np.float64)[:, None]
    arith = 2.0 * (m * n * k).astype(np.float64) / arith_rate
    total = np.broadcast_to(total + arith, (len(probs), len(cands)))
    return CostBatch(variant=variant, micro_kernels=cands, total=total,
                     arith=arith, blocking=blk)


def best_microkernel_batch(
    machine: MachineSpec,
    variant: Variant,
    probs: Sequence[Problem],
    candidates: Sequence[MicroKernel] | None = None,
    policy: str = "analytic",
) -> list[CostBreakdown]:
    """Batched Table-2 procedure: one argmin row per problem."""
    probs = list(probs)
    if not probs:
        return []
    batch = simulate_batch(machine, probs, variant, candidates, policy)
    assert batch.micro_kernels, "no feasible micro-kernel"
    idx = np.argmin(batch.total, axis=1)
    return [simulate(machine, variant, batch.micro_kernels[int(i)], p,
                     policy=policy)
            for i, p in zip(idx, probs)]


def search_batch(
    machine: MachineSpec,
    probs: Sequence[Problem],
    variants: Sequence[Variant] | None = None,
    policy: str = "analytic",
) -> list[CostBreakdown]:
    """Full design-space argmin over variant x micro-kernel for many
    problems at once — equivalent to (but much faster than) taking the
    cheapest ``best_microkernel`` across variants per problem."""
    probs = list(probs)
    if not probs:
        return []
    variants = list(variants or Variant)
    batches = [simulate_batch(machine, probs, v, policy=policy)
               for v in variants]
    totals = np.concatenate([b.total for b in batches], axis=1)
    if totals.shape[1] == 0:
        raise ValueError(
            f"{machine.name}: no register-feasible micro-kernel for any of "
            f"{[v.value for v in variants]} ({machine.num_vector_registers} "
            f"regs x {machine.register_lanes} lanes)")
    idx = np.argmin(totals, axis=1)
    offsets = np.cumsum([0] + [len(b.micro_kernels) for b in batches])
    out = []
    for p, i in zip(probs, idx):
        b = int(np.searchsorted(offsets, i, side="right") - 1)
        mk = batches[b].micro_kernels[int(i - offsets[b])]
        out.append(simulate(machine, batches[b].variant, mk, p,
                            policy=policy))
    return out
