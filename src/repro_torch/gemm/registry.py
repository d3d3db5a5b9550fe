"""Backend protocol + registry for the unified GEMM API.

A backend owns one point in the "model + kernel + dtype" space: it *plans*
(runs its analytic model / search and freezes the decision into a
:class:`GemmPlan`) and, if it owns real kernels, *executes* a plan.  New
backends (CPU reference BLAS, grouped/batched GEMM, mixed precision) register
by name — consumers never hard-wire a simulator/kernel pair again.
"""
from __future__ import annotations

import abc
from typing import Mapping, Sequence

from repro_torch.gemm.api import (
    GemmPlan,
    GemmProblem,
    NotExecutableError,
    UnknownBackendError,
)


class Backend(abc.ABC):
    """One pluggable (analytic model, kernel) pair."""

    #: registry name, e.g. "analytic-gap8".
    name: str = ""
    #: whether ``GemmPlan.execute`` is supported.
    executable: bool = False
    #: machine-spec name used when ``plan(..., machine=None)``.
    default_machine: str = "tpu-v5e"
    #: dtype assumed when the problem is given as a bare (m, n, k) tuple.
    default_dtype: str = "bf16"
    #: per-grid-point sweep axes this backend's search consumes
    #: (``repro.gemm.sweep`` collapses inapplicable axes to one point per
    #: backend instead of stamping meaningless labels on duplicate rows).
    sweep_axes: frozenset = frozenset()

    @abc.abstractmethod
    def make_plan(self, problem: GemmProblem, machine, policy: str,
                  options: Mapping) -> GemmPlan:
        """Run the backend's analytic model / search and freeze the result."""

    def make_plans(self, problems: Sequence[GemmProblem], machine,
                   policy: str, options: Mapping) -> list[GemmPlan]:
        """Plan many problems in one call.  Backends with a vectorized
        engine override this with a bulk array evaluation; the default just
        loops ``make_plan``.  Must return one plan per problem, in order."""
        return [self.make_plan(p, machine, policy, options)
                for p in problems]

    def plan_from_tile(self, problem: GemmProblem, machine, policy: str,
                       tile) -> GemmPlan | None:
        """Rebuild a plan from a persisted tile decision (manifest hit).
        Backends without a tile-shaped selection return None."""
        return None

    def execute(self, plan: GemmPlan, a, b, c=None):
        raise NotExecutableError(
            f"backend {self.name!r} is analytic-only (it predicts, it does "
            f"not run); plan with backend='cuda' or 'reference' to execute")

    def coerce_problem(self, problem, dtype: str | None) -> GemmProblem:
        return GemmProblem.coerce(problem, dtype=dtype,
                                  default_dtype=self.default_dtype)


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    if not backend.name:
        raise ValueError("backend must carry a non-empty .name")
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown GEMM backend {name!r}; registered: {backend_names()}"
        ) from None


def backend_names() -> list[str]:
    return sorted(_REGISTRY)
