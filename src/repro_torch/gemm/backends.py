"""The four built-in GEMM backends.

* ``analytic-gap8``  — the paper's calibrated GAP8 simulator (§3, Table 2):
  searches loop-order variants x register-feasible micro-kernels.  Predicts
  only.
* ``analytic-tpu``   — TileTuner's search over ``(bm, bn, bk, grid-order)``
  candidates on the tile cost model.  Predicts only.
* ``cuda``           — searches the tiles the hand-written CUDA kernels take
  (``kernels/csrc/gemm.cu``) on the Hopper tile model
  (``core/hopper_model.py``) and executes the plan with those kernels: the
  plan's ``(bm, bn, bk)`` is the kernel's thread-block tile and its grid
  order picks k-inner or k-outer.  CUDA tensors launch the kernels; CPU
  tensors run their plain PyTorch versions.  There is no silent fallback:
  a CUDA tensor the kernel does not take raises.
* ``reference``      — no tiling decision; executes the plain PyTorch
  oracle.  Its estimate is the whole-array (single-tile) cost — the model's
  lower bound on blocking, useful as a sanity baseline.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import hopper_model
from repro_torch.core.autotune import tune_batch
from repro_torch.core.hardware import MachineSpec
from repro_torch.core.simulator import (
    best_microkernel_batch,
    search_batch,
    simulate,
)
from repro_torch.core.tpu_model import GridOrder, TileConfig, estimate
from repro_torch.core.variants import MicroKernel, Variant
from repro_torch.gemm.api import GemmPlan, GemmProblem, VariantChoice
from repro_torch.gemm.registry import Backend, register_backend

_DTYPE_TAGS = {"bfloat16": "bf16", "float32": "f32", "int8": "int8"}


def dtype_tag(dtype) -> str:
    """Map a torch/numpy dtype (or its name) to the cost models' dtype tag."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    return _DTYPE_TAGS.get(name, "bf16")


def _coerce_variant(v) -> Variant:
    return v if isinstance(v, Variant) else Variant(v)


def _coerce_mk(mk) -> MicroKernel:
    if isinstance(mk, MicroKernel):
        return mk
    return MicroKernel(int(mk[0]), int(mk[1]))


def _check_operands(plan: GemmPlan, a, b) -> None:
    p = plan.problem
    if tuple(a.shape) != (p.m, p.k) or tuple(b.shape) != (p.k, p.n):
        raise ValueError(
            f"operands {tuple(a.shape)} @ {tuple(b.shape)} do not match the "
            f"planned problem {p.m}x{p.n}x{p.k}")


class AnalyticGap8Backend(Backend):
    """The paper's simulator instance: Table-2's exhaustive search.

    Planning is a bulk operation: ``make_plans`` scores the whole
    (problem x variant x micro-kernel) lattice through the batched simulator
    and argmin-selects per problem; ``make_plan`` is the one-problem case.
    """

    name = "analytic-gap8"
    executable = False
    default_machine = "gap8-fc"
    default_dtype = "int8"
    sweep_axes = frozenset({"variant", "micro_kernel"})

    def make_plan(self, problem: GemmProblem, machine: MachineSpec,
                  policy: str, options: Mapping) -> GemmPlan:
        return self.make_plans([problem], machine, policy, options)[0]

    def make_plans(self, problems: Sequence[GemmProblem],
                   machine: MachineSpec, policy: str,
                   options: Mapping) -> list[GemmPlan]:
        variant = options.get("variant")
        mk = options.get("micro_kernel")
        variants = ([_coerce_variant(variant)] if variant is not None
                    else list(Variant))
        probs = [p.as_problem() for p in problems]
        if mk is not None:
            if variant is None:
                raise ValueError(
                    "micro_kernel override requires an explicit variant")
            cbs = [simulate(machine, variants[0], _coerce_mk(mk), pr,
                            policy=policy) for pr in probs]
            source = "explicit"
        elif variant is not None:
            cbs = best_microkernel_batch(machine, variants[0], probs,
                                         policy=policy)
            source = "search"
        else:
            cbs = search_batch(machine, probs, variants, policy=policy)
            source = "search"
        return [GemmPlan(
            problem=p, backend=self.name, machine=machine.name,
            selection=VariantChoice(cb.variant, cb.micro_kernel, cb.blocking),
            cost=cb,
            provenance={"source": source, "method": "best_microkernel",
                        "policy": policy,
                        "variants": [v.value for v in variants]},
        ) for p, cb in zip(problems, cbs)]


class AnalyticTpuBackend(Backend):
    """TileTuner's analytic search over the tile design space."""

    name = "analytic-tpu"
    executable = False
    default_machine = "tpu-v5e"
    default_dtype = "bf16"

    def make_plan(self, problem: GemmProblem, machine: MachineSpec,
                  policy: str, options: Mapping) -> GemmPlan:
        return self.make_plans([problem], machine, policy, options)[0]

    def make_plans(self, problems: Sequence[GemmProblem],
                   machine: MachineSpec, policy: str,
                   options: Mapping) -> list[GemmPlan]:
        overlap = bool(options.get("overlap", True))
        tile = options.get("tile")
        if tile is not None:
            return [self.plan_from_tile(p, machine, policy, tile,
                                        source="explicit", overlap=overlap)
                    for p in problems]
        # TileTuner's batched lattice search (deduped + memoised per machine).
        decisions = tune_batch([p.as_shape() for p in problems],
                               overlap=overlap, machine=machine)
        return [GemmPlan(
            problem=p, backend=self.name, machine=machine.name,
            selection=d.tile, cost=d.cost,
            provenance={"source": "search", "method": "tile_tuner",
                        "overlap": overlap, "policy": policy},
        ) for p, d in zip(problems, decisions)]

    def plan_from_tile(self, problem: GemmProblem, machine: MachineSpec,
                       policy: str, tile: TileConfig, *,
                       source: str = "manifest",
                       overlap: bool = True) -> GemmPlan:
        cost = estimate(problem.as_shape(), tile, machine)
        return GemmPlan(
            problem=problem, backend=self.name, machine=machine.name,
            selection=tile, cost=cost,
            provenance={"source": source, "method": "tile_tuner",
                        "overlap": overlap, "policy": policy},
        )


class CudaBackend(Backend):
    """The Hopper tile model's search + CUDA kernel execution (the full
    paper loop on the card).

    Plans price every lattice tile the kernels take, in both loop orders,
    with ``core/hopper_model.py`` and pick the cheapest; a machine without
    the model's constants (an L2 level, per-call costs) raises.  The
    kernels mask ragged edges themselves (out-of-range loads read zero,
    out-of-range stores are skipped), so any ``(m, n, k)`` runs on the
    plan's tile as-is: no padded copies, no slicing.  Zero K-padding is
    exact, so the result is the function ``PallasBackend.execute`` computes
    by pad-and-slice.
    """

    name = "cuda"
    executable = True
    default_machine = "h100"
    default_dtype = "bf16"

    def make_plan(self, problem: GemmProblem, machine: MachineSpec,
                  policy: str, options: Mapping) -> GemmPlan:
        return self.make_plans([problem], machine, policy, options)[0]

    def make_plans(self, problems: Sequence[GemmProblem],
                   machine: MachineSpec, policy: str,
                   options: Mapping) -> list[GemmPlan]:
        unknown = set(options) - {"tile"}
        if unknown:
            raise ValueError(f"the cuda backend takes tile= only, not "
                             f"{sorted(unknown)}")
        tile = options.get("tile")
        if tile is not None:
            return [self.plan_from_tile(p, machine, policy, tile,
                                        source="explicit")
                    for p in problems]
        costs = hopper_model.tune_batch([p.as_shape() for p in problems],
                                        machine)
        return [self._plan(p, machine, policy, c, "search")
                for p, c in zip(problems, costs)]

    def _plan(self, problem, machine, policy, cost, source) -> GemmPlan:
        return GemmPlan(
            problem=problem, backend=self.name, machine=machine.name,
            selection=cost.tile, cost=cost,
            provenance={"source": source, "method": "hopper_tile_model",
                        "policy": policy})

    def plan_from_tile(self, problem: GemmProblem, machine: MachineSpec,
                       policy: str, tile: TileConfig, *,
                       source: str = "manifest") -> GemmPlan | None:
        """The plan of an explicit tile; a persisted tile the kernels do
        not take (a manifest written by another model) is no plan, and
        the planner searches instead."""
        try:
            cost = hopper_model.estimate(problem.as_shape(), tile, machine)
        except ValueError:
            if source == "manifest":
                return None
            raise
        return self._plan(problem, machine, policy, cost, source)

    def execute(self, plan: GemmPlan, a, b, c=None):
        from repro_torch.kernels import gemm as gemm_kernel

        _check_operands(plan, a, b)
        return gemm_kernel.gemm(a, b, c, tile=plan.selection)


class ReferenceBackend(Backend):
    """Plain PyTorch oracle: always correct, never tiled."""

    name = "reference"
    executable = True
    default_machine = "tpu-v5e"
    default_dtype = "bf16"

    def make_plan(self, problem: GemmProblem, machine: MachineSpec,
                  policy: str, options: Mapping) -> GemmPlan:
        shape = problem.as_shape()
        whole = TileConfig(problem.m, problem.n, problem.k,
                           GridOrder.K_INNER)
        return GemmPlan(
            problem=problem, backend=self.name, machine=machine.name,
            selection=None, cost=estimate(shape, whole, machine),
            provenance={"source": "closed-form", "method": "single-tile",
                        "policy": policy},
        )

    def execute(self, plan: GemmPlan, a, b, c=None):
        from repro_torch.kernels import ref

        _check_operands(plan, a, b)
        return ref.gemm_ref(a, b, c)


def register_builtin_backends() -> None:
    for cls in (AnalyticGap8Backend, AnalyticTpuBackend, CudaBackend,
                ReferenceBackend):
        register_backend(cls(), overwrite=True)
