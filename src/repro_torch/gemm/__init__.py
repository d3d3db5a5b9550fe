"""``repro_torch.gemm`` — one façade over the analytic simulators and kernels.

The paper's predict→choose→run loop as a first-class API:

    >>> from repro_torch import gemm
    >>> gemm.backends()
    ['analytic-gap8', 'analytic-tpu', 'cuda', 'reference']
    >>> p = gemm.plan((512, 2048, 1024), backend="cuda", dtype="f32")
    >>> p.estimate().total()        # predicted seconds (tile cost model)
    >>> c = p.execute(a, b)         # the hand-written CUDA kernel

Planning is a bulk operation: ``plan_many`` dedupes problems and routes
misses through the backends' vectorized batch engines, and ``sweep``
crosses problems x machines x backends x dtypes x policies (x variants x
micro-kernels) into one table of planned grid points:

    >>> res = gemm.sweep(problems, backends=["analytic-gap8"],
    ...                  variants=list(Variant))
    >>> res.best(problems[0]).selection

Machines come from the declarative zoo (``repro.machines``): ``plan`` /
``sweep`` accept registry names, raw ``MachineSpec`` objects, or glob
patterns (``machines=["zoo/*"]`` sweeps every manifest-backed machine).

See ``api.py`` for the plan/problem types, ``registry.py`` for the backend
protocol, ``backends.py`` for the built-ins, ``cache.py`` for memoisation +
manifest persistence, ``sweep.py`` for the sweep table.
"""
from repro_torch.core.precision import PrecisionConfig
from repro_torch.gemm.api import (
    GemmPlan,
    GemmProblem,
    NotExecutableError,
    UnknownBackendError,
    VariantChoice,
)
from repro_torch.gemm.backends import dtype_tag
from repro_torch.gemm.planner import (
    backends,
    clear_plan_cache,
    default_execute_backend,
    grouped_matmul,
    matmul,
    plan,
    plan_cache_stats,
    plan_many,
    plan_model_gemms,
    reset_plan_cache_stats,
    save_cache,
    warm_cache,
)
from repro_torch.gemm.registry import Backend, get_backend, register_backend
from repro_torch.gemm.sweep import SweepResult, SweepRow, sweep

__all__ = [
    "Backend", "GemmPlan", "GemmProblem", "NotExecutableError",
    "PrecisionConfig", "SweepResult", "SweepRow", "UnknownBackendError",
    "VariantChoice",
    "backends", "clear_plan_cache", "default_execute_backend", "dtype_tag",
    "get_backend", "grouped_matmul", "matmul", "plan", "plan_cache_stats",
    "plan_many", "plan_model_gemms", "register_backend",
    "reset_plan_cache_stats", "save_cache", "sweep", "warm_cache",
]
