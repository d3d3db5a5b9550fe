"""TileTuner — the paper's design-space exploration as a framework service.

The paper's stated goal is to *experiment with algorithmic alternatives prior
to implementing them* (§1, §4).  TileTuner does exactly that for every
GEMM-shaped operation in the framework: given a :class:`GemmShape` it ranks
Pallas ``(bm, bn, bk, grid-order)`` candidates with the analytical TPU model
(``core.tpu_model``) and returns the winner; decisions are memoised in a
JSON manifest so kernels, benchmarks and the perf log all agree on the tiles
used.

For the GAP8 instance the equivalent entry point is
:func:`repro.core.simulator.best_microkernel` (Table 2's procedure).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.hardware import MachineSpec, V5E_VMEM_BYTES
from repro_torch.core.tpu_model import (
    DTYPE_BYTES,
    SUBLANE,
    GemmShape,
    GridOrder,
    TileConfig,
    TpuCost,
    estimate,
    estimate_batch,
    machine_peak,  # noqa: F401  (re-exported; shape_peak supersedes it here)
    shape_peak,
    vmem_required,
    vmem_required_batch,
)
from repro_torch.machines import registry as _machines

# Candidate block dims: MXU-aligned multiples of 128 plus small sublane
# multiples for skinny shapes.
_CAND_MN = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
_CAND_K = (128, 256, 512, 1024, 2048)
# Fraction of VMEM the kernel may claim (leave headroom for Mosaic spills,
# semaphores and the scalar prefetch working set).
VMEM_BUDGET_FRACTION = 0.75


def candidate_tiles(
    shape: GemmShape,
    orders: Sequence[GridOrder] = (GridOrder.K_INNER, GridOrder.K_OUTER),
    vmem_bytes: int = int(V5E_VMEM_BYTES),
) -> list[TileConfig]:
    budget = int(vmem_bytes * VMEM_BUDGET_FRACTION)
    out = []
    for bm in _CAND_MN:
        if bm > shape.m and bm > 8:
            # allow one size past the dim for padding, then stop
            if bm // 2 >= shape.m:
                continue
        for bn in _CAND_MN:
            if bn > shape.n and bn > 128 and bn // 2 >= shape.n:
                continue
            for bk in _CAND_K:
                if bk > shape.k and bk > 128 and bk // 2 >= shape.k:
                    continue
                for order in orders:
                    t = TileConfig(bm, bn, bk, order)
                    if vmem_required(shape, t) <= budget:
                        out.append(t)
    return out


@dataclasses.dataclass(frozen=True)
class TileDecision:
    shape: GemmShape
    tile: TileConfig
    cost: TpuCost
    overlap: bool

    @property
    def seconds(self) -> float:
        return self.cost.total(self.overlap)

    def to_json(self) -> dict:
        return {
            "m": self.shape.m, "n": self.shape.n, "k": self.shape.k,
            "dtype": self.shape.dtype,
            "bm": self.tile.bm, "bn": self.tile.bn, "bk": self.tile.bk,
            "order": self.tile.order.value,
            "seconds": self.seconds,
            "roofline_fraction": self.cost.roofline_fraction(self.overlap),
            "hbm_bytes": self.cost.hbm_bytes,
            "vmem_peak": self.cost.vmem_peak,
        }


# ---------------------------------------------------------------------------
# Batched engine.  The full candidate lattice (every (bm, bn, bk, order)
# cross product, feasibility expressed as a mask) is materialized once as
# flat arrays; scoring many shapes is then a single ``estimate_batch`` call
# over a (P, C) broadcast plus one argmin per row.  Selections are
# bit-identical with the scalar loop: the lattice preserves
# ``candidate_tiles``'s enumeration order and ``np.argmin`` keeps the first
# minimum, exactly like the loop's strict ``<`` update.
# ---------------------------------------------------------------------------

_FALLBACK_TILE = TileConfig(8, 128, 128, GridOrder.K_INNER)


@functools.lru_cache(maxsize=None)
def _lattice() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flat (bm, bn, bk, k_inner) arrays in ``candidate_tiles`` order."""
    bms, bns, bks, inner = [], [], [], []
    for bm in _CAND_MN:
        for bn in _CAND_MN:
            for bk in _CAND_K:
                for order in (GridOrder.K_INNER, GridOrder.K_OUTER):
                    bms.append(bm)
                    bns.append(bn)
                    bks.append(bk)
                    inner.append(order is GridOrder.K_INNER)
    return (np.array(bms, np.int64), np.array(bns, np.int64),
            np.array(bks, np.int64), np.array(inner, bool))


def _feasible_mask(m, n, k, elem_bytes, vmem_bytes: int) -> np.ndarray:
    """(P, C) candidate-feasibility mask replaying ``candidate_tiles``'s
    skip rules: one size past a short dim is allowed for padding, and the
    double-buffered working set must fit the VMEM budget."""
    bm, bn, bk, _ = _lattice()
    budget = int(vmem_bytes * VMEM_BUDGET_FRACTION)
    skip_m = (bm > m) & (bm > 8) & (bm // 2 >= m)
    skip_n = (bn > n) & (bn > 128) & (bn // 2 >= n)
    skip_k = (bk > k) & (bk > 128) & (bk // 2 >= k)
    fits = vmem_required_batch(bm, bn, bk, elem_bytes) <= budget
    return ~skip_m & ~skip_n & ~skip_k & fits


def _solve_batch(shapes: Sequence[GemmShape], overlap: bool,
                 machine: MachineSpec) -> list[TileDecision]:
    """Score the whole lattice for every shape at once; argmin per shape."""
    m = np.array([s.m for s in shapes], np.int64)[:, None]
    n = np.array([s.n for s in shapes], np.int64)[:, None]
    k = np.array([s.k for s in shapes], np.int64)[:, None]
    s_bytes = np.array([DTYPE_BYTES[s.dtype] for s in shapes],
                       np.int64)[:, None]
    sub = np.array([SUBLANE[s.dtype] for s in shapes], np.int64)[:, None]
    peak = np.array([shape_peak(machine, s) for s in shapes],
                    np.float64)[:, None]
    acc = np.array([s.accumulate for s in shapes], bool)[:, None]
    bm, bn, bk, inner = _lattice()

    # per-shape quantize ratios; None (no mixed shape) keeps the plain path.
    ratios = [s.mixed_precision.quant_ratios(DTYPE_BYTES[s.dtype])
              if s.mixed_precision is not None else (0.0, 0.0, 0.0)
              for s in shapes]
    quant = None
    if any(any(r > 0.0 for r in t) for t in ratios):
        qr = np.array(ratios, np.float64)
        quant = (qr[:, 0:1], qr[:, 1:2], qr[:, 2:3])

    mask = _feasible_mask(m, n, k, s_bytes, machine.capacity("L1"))
    costs = estimate_batch(m, n, k, s_bytes, sub, peak, bm, bn, bk, inner,
                           accumulate=acc, machine=machine, quant=quant)
    totals = np.where(mask, costs.total(overlap), np.inf)
    idx = np.argmin(totals, axis=1)
    feasible = mask.any(axis=1)

    out = []
    for p, shape in enumerate(shapes):
        if feasible[p]:
            i = int(idx[p])
            tile = TileConfig(int(bm[i]), int(bn[i]), int(bk[i]),
                              GridOrder.K_INNER if inner[i]
                              else GridOrder.K_OUTER)
        else:  # degenerate tiny shape: single-block fallback
            tile = _FALLBACK_TILE
        # The winner's TpuCost is rebuilt by the scalar model: one call per
        # shape, and the resulting TileDecision is exactly the scalar one.
        out.append(TileDecision(shape=shape, tile=tile,
                                cost=estimate(shape, tile, machine),
                                overlap=overlap))
    return out


# FIFO-bounded decision memo (same memory bound the old lru_cache enforced).
_TUNE_CACHE: dict[tuple, TileDecision] = {}
_TUNE_CACHE_MAX = 4096


def _cache_key(shape: GemmShape, overlap: bool,
               machine: MachineSpec) -> tuple:
    # cache_token (name@content-fingerprint), not the bare name: same-named
    # machines with different rate tables must not share tile decisions.
    pc = shape.precision
    return (shape.m, shape.n, shape.k, shape.dtype, shape.accumulate,
            None if pc is None else pc.key(), overlap, machine.cache_token)


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()


def tune_batch(shapes: Iterable[GemmShape], overlap: bool = True,
               machine: MachineSpec | None = None,
               cache: bool = True) -> list[TileDecision]:
    """Batched TileTuner: one vectorized lattice evaluation for all shapes.

    Duplicate shapes are deduped before evaluation and decisions are memoised
    process-wide, so repeated QKV/logits shapes across arch configs cost one
    lattice row total.  Returns decisions in input order.  ``machine`` is
    any registry spec (default ``tpu-v5e``).
    """
    machine = machine or _machines.get("tpu-v5e")
    shapes = list(shapes)
    out: list[TileDecision | None] = [None] * len(shapes)
    missing: dict[GemmShape, list[int]] = {}
    for i, s in enumerate(shapes):
        hit = _TUNE_CACHE.get(_cache_key(s, overlap, machine)) if cache \
            else None
        if hit is not None:
            out[i] = hit
        else:
            missing.setdefault(s, []).append(i)
    if missing:
        for s, d in zip(missing, _solve_batch(list(missing), overlap,
                                              machine)):
            if cache:
                if len(_TUNE_CACHE) >= _TUNE_CACHE_MAX:
                    _TUNE_CACHE.pop(next(iter(_TUNE_CACHE)))
                _TUNE_CACHE[_cache_key(s, overlap, machine)] = d
            for i in missing[s]:
                out[i] = d
    return out  # type: ignore[return-value]


def tune(shape: GemmShape, overlap: bool = True) -> TileDecision:
    """Pick the best (bm, bn, bk, order) for one GEMM shape (thin wrapper
    over the batched engine)."""
    return tune_batch([shape], overlap)[0]


def tune_many(shapes: Iterable[GemmShape], overlap: bool = True
              ) -> list[TileDecision]:
    """Batch-tune many shapes (deduped before evaluation)."""
    return tune_batch(shapes, overlap)


def tune_scalar(shape: GemmShape, overlap: bool = True,
                machine: MachineSpec | None = None) -> TileDecision:
    """The pre-batching scalar search loop, preserved verbatim as the
    reference oracle for the equivalence tests and the planner benchmark.
    Do not optimise or route through the batch engine — its whole value is
    being an independent implementation ``tune_batch`` must agree with."""
    machine = machine or _machines.get("tpu-v5e")
    best: TileDecision | None = None
    for t in candidate_tiles(shape, vmem_bytes=machine.capacity("L1")):
        d = TileDecision(shape=shape, tile=t,
                         cost=estimate(shape, t, machine), overlap=overlap)
        if best is None or d.seconds < best.seconds:
            best = d
    if best is None:  # degenerate tiny shape: single-block fallback
        best = TileDecision(shape, _FALLBACK_TILE,
                            estimate(shape, _FALLBACK_TILE, machine), overlap)
    return best


class Manifest:
    """Persisted tile decisions, keyed by (m, n, k, dtype)."""

    def __init__(self, path: str):
        self.path = path
        self._entries: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._entries = json.load(f)

    @staticmethod
    def key(shape: GemmShape) -> str:
        base = f"{shape.m}x{shape.n}x{shape.k}:{shape.dtype}"
        # mixed-precision decisions get their own manifest namespace; plain
        # shapes keep the historical key so existing manifests stay valid.
        pc = shape.precision
        return base if pc is None else f"{base}|{pc.key()}"

    def lookup(self, shape: GemmShape) -> TileConfig | None:
        e = self._entries.get(self.key(shape))
        if e is None:
            return None
        return TileConfig(e["bm"], e["bn"], e["bk"], GridOrder(e["order"]))

    def record(self, decision: TileDecision) -> None:
        self._entries[self.key(decision.shape)] = decision.to_json()

    def save(self) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        return len(self._entries)


def model_gemm_shapes(cfg, tokens: int = 4096) -> list[GemmShape]:
    """Enumerate the GEMM shapes of one transformer architecture config —
    the per-arch workload TileTuner optimises (the MobileNetV1-Table-2
    analogue for our assigned architectures).  ``tokens`` is the per-chip
    token tile (a representative M; serving passes its decode batch)."""
    d = cfg.d_model
    shapes = []
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    shapes.append(GemmShape(tokens, q + 2 * kv, d, dtype="bf16"))   # QKV
    shapes.append(GemmShape(tokens, d, q, dtype="bf16"))            # O proj
    if cfg.d_ff:
        shapes.append(GemmShape(tokens, 2 * cfg.d_ff, d, dtype="bf16"))  # gate+up
        shapes.append(GemmShape(tokens, d, cfg.d_ff, dtype="bf16"))      # down
    if getattr(cfg, "n_experts", 0):
        per_e = max(1, tokens * cfg.experts_per_token // cfg.n_experts)
        shapes.append(GemmShape(per_e, 2 * cfg.moe_d_ff, d, dtype="bf16"))
        shapes.append(GemmShape(per_e, d, cfg.moe_d_ff, dtype="bf16"))
    shapes.append(GemmShape(tokens, cfg.vocab_size, d, dtype="bf16"))    # logits
    return shapes
