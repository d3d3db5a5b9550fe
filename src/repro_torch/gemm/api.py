"""The unified plan/execute GEMM API — the paper's workflow as one façade.

The paper's contribution is *simulate-before-implement*: an analytic cost
model predicts which GEMM variant/tiling wins before anything runs on
hardware.  This module makes that predict→choose→run loop a first-class
citizen:

    plan = repro_torch.gemm.plan((m, n, k), backend="analytic-tpu")
    plan.estimate()            # the predicted TpuCost / CostBreakdown
    plan.execute(a, b)         # NotExecutableError: analytic-only backend

    plan = repro_torch.gemm.plan((m, n, k), backend="cuda", dtype="bf16")
    c = plan.execute(a, b)     # the hand-written CUDA kernel, planned tile

Every backend (``repro.gemm.backends()``) maps a :class:`GemmProblem` to a
frozen :class:`GemmPlan` carrying the chosen variant-or-tile, the predicted
cost, and provenance describing how the choice was made.  Plans are memoised
in a process-level cache (``repro.gemm.cache``) whose persistence layer is
TileTuner's JSON manifest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.hopper_model import HopperCost
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.simulator import CostBreakdown
from repro_torch.core.tpu_model import DTYPE_BYTES, GemmShape, TpuCost
from repro_torch.core.variants import Blocking, MicroKernel, Problem, Variant
from repro_torch.machines import MachineSpec
from repro_torch.machines import resolve as _resolve_machine


class NotExecutableError(RuntimeError):
    """Raised when ``execute`` is called on an analytic-only plan."""


class UnknownBackendError(KeyError):
    """Raised for a backend name absent from the registry."""


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """Canonical description of one GEMM ``C (+)= A (m x k) . B (k x n)``."""

    m: int
    n: int
    k: int
    dtype: str = "bf16"
    accumulate: bool = False
    # per-operand dtype config (PrecisionConfig / key string / None).
    # Normalized on construction: a *uniform* config collapses into the
    # plain ``dtype`` path (precision becomes None — bit-identical plans,
    # same cache identity); a *mixed* config forces ``dtype`` to its
    # compute (narrower-operand) dtype.
    precision: Any = None

    def __post_init__(self):
        if min(self.m, self.n, self.k) < 1:
            raise ValueError(f"degenerate GEMM problem {self}")
        pc = PrecisionConfig.coerce(self.precision)
        if pc is not None:
            if pc.is_uniform:
                object.__setattr__(self, "dtype", pc.a_dtype)
                pc = None
            else:
                object.__setattr__(self, "dtype", pc.compute_dtype)
            object.__setattr__(self, "precision", pc)
        if self.dtype not in DTYPE_BYTES:
            raise ValueError(
                f"unknown dtype {self.dtype!r}; have {sorted(DTYPE_BYTES)}")

    def with_precision(self, precision) -> "GemmProblem":
        """This problem under a per-operand dtype config (None clears it);
        construction re-normalizes ``dtype``/``precision`` as above."""
        pc = PrecisionConfig.coerce(precision)
        if pc is None and self.precision is None:
            return self
        return dataclasses.replace(self, precision=pc)

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def elem_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]

    def as_shape(self) -> GemmShape:
        """The TPU cost-model view of this problem."""
        return GemmShape(m=self.m, n=self.n, k=self.k, dtype=self.dtype,
                         accumulate=self.accumulate,
                         precision=self.precision)

    def as_problem(self) -> Problem:
        """The GAP8 simulator view of this problem."""
        return Problem(m=self.m, n=self.n, k=self.k,
                       elem_bytes=self.elem_bytes, dtype=self.dtype,
                       precision=self.precision)

    @classmethod
    def coerce(cls, obj: Any, dtype: str | None = None,
               default_dtype: str = "bf16") -> "GemmProblem":
        """Accept a GemmProblem, (m, n, k) tuple, core Problem or GemmShape."""
        if isinstance(obj, cls):
            p = obj
        elif isinstance(obj, GemmShape):
            p = cls(obj.m, obj.n, obj.k, dtype=obj.dtype,
                    accumulate=obj.accumulate, precision=obj.precision)
        elif isinstance(obj, Problem):
            p = cls(obj.m, obj.n, obj.k, dtype=obj.dtype,
                    precision=obj.precision)
        elif isinstance(obj, (tuple, list)) and len(obj) == 3:
            p = cls(int(obj[0]), int(obj[1]), int(obj[2]),
                    dtype=dtype or default_dtype)
        else:
            raise TypeError(
                f"cannot interpret {obj!r} as a GEMM problem; pass a "
                "GemmProblem, (m, n, k), core.variants.Problem or GemmShape")
        if dtype is not None and p.dtype != dtype:
            # an explicit dtype override reasserts the uniform path: it
            # replaces any attached mixed config rather than fighting the
            # compute-dtype normalization.
            p = dataclasses.replace(p, dtype=dtype, precision=None)
        return p


@dataclasses.dataclass(frozen=True)
class VariantChoice:
    """The GAP8 backends' selection: loop-order variant + micro-kernel."""
    variant: Variant
    micro_kernel: MicroKernel
    blocking: Blocking

    def __str__(self) -> str:
        return f"{self.variant.value}/{self.micro_kernel}"


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A frozen predict→choose decision for one GEMM problem.

    ``selection`` is backend-specific: a :class:`TileConfig` for the tile
    backends (``analytic-tpu`` and ``cuda``), a :class:`VariantChoice` for
    the GAP8 simulator, ``None`` for the reference backend.  ``cost`` is
    the backend's predicted :class:`TpuCost` / :class:`HopperCost` /
    :class:`CostBreakdown`.  ``provenance`` records how
    the selection was made (search / cache / manifest / explicit override).
    """

    problem: GemmProblem
    backend: str
    machine: str
    selection: Any
    cost: TpuCost | HopperCost | CostBreakdown | None
    provenance: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def estimate(self) -> TpuCost | HopperCost | CostBreakdown:
        """The predicted cost object this plan was chosen by."""
        if self.cost is None:
            raise ValueError(f"plan via {self.backend!r} carries no estimate")
        return self.cost

    @property
    def predicted_seconds(self) -> float:
        """Scalar predicted execution time (backend's headline estimate):
        the overlapped or summed TPU time, the GAP8 simulator's sum, and
        for ``cuda`` plans the Hopper model's sum of terms, the function
        its calibration fits."""
        c = self.estimate()
        if isinstance(c, TpuCost):
            return c.total(bool(self.provenance.get("overlap", True)))
        return c.total

    @property
    def executable(self) -> bool:
        return _backend_of(self.backend).executable

    def execute(self, a, b, c=None):
        """Run ``C (+)= A.B`` with this plan's selection.

        Args:
            a / b / c: tensors matching the planned problem's shapes
                (``c`` only for accumulate semantics).  CUDA tensors run
                the hand-written kernels (``cuda``); CPU tensors run the
                kernels' plain PyTorch versions.

        Returns:
            The product tensor, computed by the CUDA kernels (``cuda``) or
            the plain PyTorch oracle (``reference``).

        Raises:
            NotExecutableError: on analytic-only backends.
            ValueError: when operand shapes do not match the planned
                problem, or the kernel does not take the plan's tile.
        """
        return _backend_of(self.backend).execute(self, a, b, c)

    def blocking_dims(self) -> tuple[int, int, int]:
        """The plan's cache blocking as ``(bm, bn, bk)`` loop-nest trip
        sizes — the uniform view the measurement harness replays as a
        blocked loop nest (``repro.measure.harness``).  GAP8-simulator
        plans map ``(m_c, n_c, k_c)``; tile plans map the TileConfig;
        selection-free plans are a single whole-problem block."""
        sel = self.selection
        if isinstance(sel, VariantChoice):
            b = sel.blocking
            return (int(b.m_c), int(b.n_c), int(b.k_c))
        if sel is not None and hasattr(sel, "bm"):
            return (int(sel.bm), int(sel.bn), int(sel.bk))
        return (self.problem.m, self.problem.n, self.problem.k)

    def describe(self) -> str:
        p, sel = self.problem, self.selection
        cost = (f"{self.predicted_seconds * 1e6:.1f}us"
                if self.cost is not None else "n/a")
        return (f"GemmPlan[{self.backend}@{self.machine}] "
                f"{p.m}x{p.n}x{p.k}:{p.dtype} -> "
                f"{sel if sel is not None else 'as-is'} ({cost}, "
                f"{self.provenance.get('source', 'search')})")

    def explain(self) -> dict:
        """Cost attribution: where does this plan's predicted time go?

        Returns a ``repro.obs/explain-v1`` dict whose ``terms`` decompose
        the estimate per traffic/arithmetic component — which memory
        level, how many bytes, at what effective rate, and what fraction
        of the total — so "why is this cell slow" is answerable from the
        façade without touching the cost-model internals.

        Composition semantics mirror :attr:`predicted_seconds`:

        * GAP8-simulator plans (:class:`CostBreakdown`), no-overlap
          TPU plans and ``cuda`` plans (:class:`HopperCost`: compute, HBM,
          L2, the host call and the launches) compose by plain sum (paper
          §3.1), so the term
          ``fraction`` values sum to 1 and ``seconds`` sum to
          ``estimate().total`` exactly (``composition: "sum"``).
        * Overlapped TPU plans are bound by the slowest resource plus
          pipeline fill (``composition: "overlapped"``); fractions are
          still reported against the no-overlap sum (``sum_s``) so they
          remain a partition, with the headline ``total_s`` carrying the
          overlapped time.
        """
        c = self.estimate()
        terms: list[dict] = []
        if isinstance(c, HopperCost):
            flops = self.problem.flops
            terms = [
                {"name": "compute", "kind": "compute", "level": c.route,
                 "seconds": c.t_compute, "bytes": None,
                 "rate": flops / c.t_compute if c.t_compute else None},
                {"name": "stream_hbm", "kind": "traffic", "level": "HBM",
                 "seconds": c.t_hbm, "bytes": c.hbm_bytes,
                 "rate": c.hbm_bytes / c.t_hbm if c.t_hbm else None},
                {"name": "stream_l2", "kind": "traffic", "level": "L2",
                 "seconds": c.t_l2, "bytes": c.l2_bytes,
                 "rate": c.l2_bytes / c.t_l2 if c.t_l2 else None},
                {"name": "host_call", "kind": "per_call", "level": "host",
                 "seconds": c.t_call, "bytes": None, "rate": None},
                {"name": "launches", "kind": "per_call", "level": "host",
                 "seconds": c.t_launch, "bytes": None, "rate": None},
            ]
            composition = "sum"
        elif isinstance(c, TpuCost):
            overlap = bool(self.provenance.get("overlap", True))
            flops = self.problem.flops
            hbm_rate = c.hbm_bytes / c.t_hbm if c.t_hbm else None
            terms = [
                {"name": "compute", "kind": "compute", "level": "MXU",
                 "seconds": c.t_compute, "bytes": None,
                 "rate": flops / c.t_compute if c.t_compute else None},
                {"name": "stream_hbm", "kind": "traffic", "level": "HBM",
                 "seconds": c.t_hbm, "bytes": c.hbm_bytes,
                 "rate": hbm_rate},
                {"name": "stream_vmem", "kind": "traffic", "level": "VMEM",
                 "seconds": c.t_vmem, "bytes": c.vmem_bytes,
                 "rate": c.vmem_bytes / c.t_vmem if c.t_vmem else None},
            ]
            # mixed-precision shapes: split the quantize/dequantize share
            # out of the HBM stream so the extra traffic is attributed,
            # keeping the terms a partition of the same totals.
            q = getattr(c, "quant_bytes", 0.0)
            if q:
                t_q = c.t_hbm * (q / c.hbm_bytes) if c.hbm_bytes else 0.0
                terms[1]["seconds"] = c.t_hbm - t_q
                terms[1]["bytes"] = c.hbm_bytes - q
                terms.append(
                    {"name": "quantize", "kind": "quantize", "level": "HBM",
                     "seconds": t_q, "bytes": q, "rate": hbm_rate})
            composition = "overlapped" if overlap else "sum"
        else:
            flops = self.problem.flops
            for name, secs in c.components.items():
                if name == "arith":
                    terms.append(
                        {"name": name, "kind": "compute", "level": "R",
                         "seconds": secs, "bytes": None,
                         "rate": flops / secs if secs else None})
                else:
                    nbytes = c.traffic_bytes.get(name)
                    terms.append(
                        {"name": name,
                         "kind": "quantize" if name.startswith("quant_")
                         else "traffic",
                         "level": c.origins.get(name),
                         "seconds": secs, "bytes": nbytes,
                         "rate": (nbytes / secs)
                                 if (secs and nbytes is not None) else None})
            composition = "sum"
        sum_s = float(sum(t["seconds"] for t in terms))
        for t in terms:
            t["fraction"] = (t["seconds"] / sum_s) if sum_s else 0.0
        terms.sort(key=lambda t: -t["seconds"])
        return {
            "schema": "repro.obs/explain-v1",
            "backend": self.backend,
            "machine": self.machine,
            "problem": f"{self.problem.m}x{self.problem.n}x{self.problem.k}"
                       f":{self.problem.dtype}"
                       + (f"|{self.problem.precision.key()}"
                          if self.problem.precision is not None else ""),
            "composition": composition,
            "total_s": self.predicted_seconds,
            "sum_s": sum_s,
            "terms": terms,
        }


def _backend_of(name: str):
    from repro_torch.gemm.registry import get_backend
    return get_backend(name)


def resolve_machine(machine: str | MachineSpec | None,
                    default: str) -> MachineSpec:
    """Resolve a plan's machine argument through the ``repro.machines``
    registry (names and aliases; specs pass through unchanged)."""
    return _resolve_machine(machine, default)
