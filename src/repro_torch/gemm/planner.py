"""``plan()`` — the single entry point of the predict→choose→run loop."""
from __future__ import annotations

import math

from repro_torch import obs
from repro_torch.core.precision import PrecisionConfig
from repro_torch.gemm.api import GemmPlan, GemmProblem, resolve_machine
from repro_torch.gemm.backends import dtype_tag, register_builtin_backends
from repro_torch.gemm.cache import PlanCache
from repro_torch.gemm.registry import backend_names, get_backend

register_builtin_backends()

_CACHE = PlanCache()


def plan(problem, *, backend: str = "analytic-tpu", machine=None,
         dtype: str | None = None, policy: str = "analytic",
         precision=None, cache: bool = True, **options) -> GemmPlan:
    """Plan one GEMM: run ``backend``'s analytic model / search and freeze
    the decision.  ``plan`` is the one-problem case of :func:`plan_many`.

    Args:
        problem: a :class:`GemmProblem`, an ``(m, n, k)`` tuple, a
            ``core.variants.Problem`` or a ``core.tpu_model.GemmShape``.
        backend: backend name (see :func:`backends`).
        machine: a registry name or :class:`MachineSpec` (default: the
            backend's native target machine).
        dtype: dtype tag overriding the problem's own.
        precision: a :class:`~repro.core.precision.PrecisionConfig` (or its
            key string, e.g. ``"int4xint8->int32"``) applied to the problem.
            Uniform configs normalize to the plain dtype path and plan
            bit-identically; mixed configs add quantize/dequantize traffic
            and use the machine's ``rates_mixed`` arithmetic table.
        policy: partial-tile accounting of the GAP8 simulator
            (``"analytic"`` — exact byte ratios — or ``"padded"`` — edge
            tiles at full-tile cost).
        cache: consult/populate the process-wide plan cache; False forces
            a fresh search.  A manifest warmed via :func:`warm_cache`
            satisfies tile-backend plans without searching.
        **options: backend-specific.  ``analytic-gap8``: ``variant=``,
            ``micro_kernel=`` pin the search; ``analytic-tpu``:
            ``overlap=`` picks the composition rule; ``analytic-tpu`` and
            ``cuda``: ``tile=`` bypasses the search with an explicit
            TileConfig.

    Returns:
        A frozen :class:`GemmPlan` carrying the chosen selection, the
        predicted cost (``plan.estimate()`` / ``plan.predicted_seconds``)
        and search provenance.

    Raises:
        UnknownBackendError: for an unregistered backend name.
        KeyError: for an unknown machine name.
        ValueError: for a degenerate problem, unknown dtype tag, or a
            ``micro_kernel`` override without an explicit ``variant``.
    """
    return plan_many([problem], backend=backend, machine=machine,
                     dtype=dtype, policy=policy, precision=precision,
                     cache=cache, **options)[0]


def plan_many(problems, *, backend: str = "analytic-tpu", machine=None,
              dtype: str | None = None, policy: str = "analytic",
              precision=None, cache: bool = True,
              **options) -> list[GemmPlan]:
    """Plan many GEMMs in one bulk operation.

    Problems are deduped before any evaluation (the dropped count is
    reported as ``deduped`` in :func:`plan_cache_stats`), cache and manifest
    tiers are consulted per unique problem, and the remaining misses go to
    the backend's batched ``make_plans`` engine as a single vectorized
    lattice evaluation.

    Args:
        problems: iterable of anything :func:`plan`'s ``problem`` accepts.
        backend / machine / dtype / policy / precision / cache / **options:
            exactly as for :func:`plan`, applied to every problem.

    Returns:
        One :class:`GemmPlan` per input problem, in input order; duplicate
        problems share the same plan object.

    Raises:
        Everything :func:`plan` raises, for any problem of the batch.
    """
    b = get_backend(backend)
    mspec = resolve_machine(machine, b.default_machine)
    with obs.span("gemm.plan_many", backend=b.name, machine=mspec.name,
                  problems=len(problems)) as sp:
        probs = [b.coerce_problem(p, dtype) for p in problems]
        if precision is not None:
            pc = PrecisionConfig.coerce(precision)
            probs = [p.with_precision(pc) for p in probs]
        with obs.span("gemm.plan_many.dedupe"):
            unique: dict[GemmProblem, None] = {}
            for p in probs:
                unique.setdefault(p)
            _CACHE.note_deduped(len(probs) - len(unique))
        sp.set(unique=len(unique))
        if not cache:
            with obs.span("gemm.plan_many.batch_score",
                          missing=len(unique)):
                built = dict(zip(unique, b.make_plans(list(unique), mspec,
                                                      policy, options)))
            return [built[p] for p in probs]
        resolved: dict[GemmProblem, GemmPlan] = {}
        missing: list[GemmProblem] = []
        for p in unique:
            # cache_token = name@content-fingerprint: same-named machines
            # with different rate tables (derived specs, re-registered
            # calibrations) must not share plans.
            key = _CACHE.key(p, b.name, mspec.cache_token, policy, options)
            hit = _CACHE.get(key)
            if hit is not None:
                resolved[p] = hit
                continue
            # The manifest persists only the default search (tile selected
            # under overlap=True, no pinned options); requests with explicit
            # options must re-search rather than inherit a tile chosen under
            # different rules.
            built = None
            if not options:
                tile = _CACHE.manifest_tile(p)
                if tile is not None:
                    built = b.plan_from_tile(p, mspec, policy, tile)
            if built is not None:
                _CACHE.put(key, built)
                resolved[p] = built
            else:
                missing.append(p)
        sp.set(missing=len(missing))
        if missing:
            with obs.span("gemm.plan_many.batch_score",
                          missing=len(missing)):
                for p, made in zip(missing, b.make_plans(missing, mspec,
                                                         policy, options)):
                    _CACHE.put(_CACHE.key(p, b.name, mspec.cache_token,
                                          policy, options),
                               made)
                    resolved[p] = made
        return [resolved[p] for p in probs]


def backends() -> list[str]:
    """Names of every registered GEMM backend."""
    return backend_names()


def clear_plan_cache() -> None:
    _CACHE.clear()


def plan_cache_stats(reset: bool = False) -> dict:
    """Counter snapshot of the process plan cache.

    The counters are process-cumulative; ``reset=True`` returns the
    snapshot and then zeros them (cached plans stay), so back-to-back
    experiments in one process each start from zero instead of reporting
    everything since import.  ``sweep()`` additionally reports per-call
    deltas in ``SweepResult.stats`` regardless of resets.
    """
    d = _CACHE.stats.as_dict()
    d["size"] = len(_CACHE)
    if reset:
        _CACHE.reset_stats()
    return d


def reset_plan_cache_stats() -> None:
    """Zero the plan-cache counters without dropping cached plans."""
    _CACHE.reset_stats()


def warm_cache(manifest_path: str) -> int:
    """Attach a TileTuner JSON manifest as the cache's persisted tier."""
    return _CACHE.warm(manifest_path)


def save_cache(manifest_path: str) -> int:
    """Persist the cache's tile decisions to a TileTuner JSON manifest."""
    return _CACHE.save(manifest_path)


# ---------------------------------------------------------------------------
# Convenience execution helpers for in-framework consumers.
# ---------------------------------------------------------------------------


def default_execute_backend() -> str:
    """The executable backend entry points use when the caller names none:
    the hand-written CUDA kernels.  There is no platform-dependent switch to
    the oracle: CPU tensors run the kernels' plain versions because the
    caller put them on the CPU, and a CUDA tensor the kernels do not take
    raises."""
    return "cuda"


def matmul(x, w, *, backend: str | None = None):
    """Planned matmul over arbitrary leading dims: ``(..., k) @ (k, n)``.

    Folds leading dims into M, plans on the executable backend (default
    :func:`default_execute_backend`) and executes the plan — the
    framework-wide route by which every dense layer inherits the paper's
    analytic tile selection.  ``w`` may be the ``.t()`` of a row-major
    matrix (the tied logits head): the bf16 kernels read it in place.
    Differentiable: when autograd records it, the backward products run
    planned on the same backend, on views of the saved operands
    (``gemm/autograd.py``).  While ``obs`` records, each call is a
    ``gemm.matmul`` span (``m``, ``n``, ``k``, ``dtype``) whose child
    ``gemm.plan_many`` is the plan layer's.
    """
    if obs.recorder.enabled:
        with obs.recorder.span("gemm.matmul", m=math.prod(x.shape[:-1]),
                               n=w.shape[-1], k=x.shape[-1],
                               dtype=dtype_tag(x.dtype)):
            return _matmul(x, w, backend)
    return _matmul(x, w, backend)


def _matmul(x, w, backend):
    from repro_torch.gemm import autograd
    lead = x.shape[:-1]
    a2 = x if x.ndim == 2 else x.reshape(-1, x.shape[-1])
    m, k = a2.shape
    n = w.shape[-1]
    backend = backend or default_execute_backend()
    if autograd.wanted(a2, w):
        out = autograd.planned_matmul(a2, w, backend)
    else:
        out = plan((m, n, k), backend=backend,
                   dtype=dtype_tag(x.dtype)).execute(a2, w)
    return out if x.ndim == 2 else out.reshape(*lead, n)


def grouped_matmul(x, w):
    """Grouped (expert-batched) matmul: ``(..., E, C, D) @ (E, D, F)``.

    Routes through ``kernels.ops.grouped_gemm`` (the grouped CUDA kernel;
    its plain version for CPU tensors).  Leading batch dims fold into the
    capacity axis C: rows are independent, so one launch over
    ``(E, lead * C, D)`` computes what the JAX package's ``jax.vmap`` over
    the leading dims does, reading the expert weights once.
    Differentiable: both backward products run on the grouped kernel
    (``gemm/autograd.py``).  While ``obs`` records, each call is a
    ``gemm.grouped_matmul`` span (``m`` an expert's rows, ``n``, ``k``,
    ``groups``, ``dtype``, and ``design``: the bf16 forward's kernel design
    on the card, ``kernels.grouped_gemm.design``; None for f32).
    """
    if obs.recorder.enabled:
        from repro_torch.kernels import grouped_gemm
        with obs.recorder.span("gemm.grouped_matmul",
                               m=math.prod(x.shape[:-3]) * x.shape[-2],
                               n=w.shape[-1], k=x.shape[-1],
                               groups=x.shape[-3], dtype=dtype_tag(x.dtype),
                               design=grouped_gemm.design_of(x, w)):
            return _grouped_matmul(x, w)
    return _grouped_matmul(x, w)


def _grouped_matmul(x, w):
    from repro_torch.gemm import autograd
    from repro_torch.kernels import ops
    run = (autograd.grouped_matmul if autograd.wanted(x, w)
           else ops.grouped_gemm)
    if x.ndim == 3:
        return run(x, w)
    lead, (e, c, d) = x.shape[:-3], x.shape[-3:]
    x3 = x.reshape(-1, e, c, d).transpose(0, 1).reshape(e, -1, d)
    out = run(x3.contiguous(), w)
    out = out.reshape(e, -1, c, out.shape[-1]).transpose(0, 1)
    return out.reshape(*lead, e, c, out.shape[-1])


def plan_model_gemms(cfg, *, tokens: int = 4096,
                     backend: str = "analytic-tpu",
                     **plan_kwargs) -> list[GemmPlan]:
    """Plans for every GEMM shape of one transformer architecture config —
    the per-arch workload view (serving/benchmarks consume this instead of
    calling TileTuner directly).  Routed through :func:`plan_many`: repeated
    shapes are deduped and the misses are planned in one batched lattice
    evaluation."""
    from repro_torch.core.autotune import model_gemm_shapes
    shapes = model_gemm_shapes(cfg, tokens=tokens)
    return plan_many(shapes, backend=backend, **plan_kwargs)
