"""Timing backends behind one protocol.

Everything in this package that needs a wall-clock number goes through
:func:`time_callable`: warmup calls first (first-touch page faults, kernel
builds and lazy initialisation must not be billed to the kernel), then repeated rounds whose
per-round minima are aggregated as a *median of minima* — the min rejects
scheduler noise inside a round, the median rejects an unlucky round — with
the measured ``perf_counter`` bracket overhead subtracted from every call.
Rounds are added (up to ``max_rounds``) until the round minima agree to
``stable_rel``.

A :class:`Harness` turns a frozen :class:`repro_torch.gemm.GemmPlan` into one
measured time:

* ``host-numpy``  — replays the plan's cache blocking as a blocked loop nest
  on the host (one BLAS-backed block update per innermost trip), the closest
  host analogue of the blocked algorithms the simulator models.
* ``cuda`` / ``reference`` — time ``plan.execute()`` on seeded device
  tensors, each call ending in ``torch.cuda.synchronize()``: the
  hand-written CUDA kernels (``cuda``) or the plain PyTorch oracle
  (``reference``).  Operands live on ``cuda`` unless the caller asks for
  ``device="cpu"``.
* ``simulated`` — the closed-loop oracle: "measures" by re-predicting the
  plan under a ground-truth :class:`MachineSpec`.  Times generated by the
  simulator itself, pushed through store→fit→validate, must recover the
  truth rates exactly — the subsystem's self-test.
"""
from __future__ import annotations

import dataclasses
import itertools
import statistics
import time
from typing import Any, Callable, Mapping

import numpy as np

_SECONDS_FLOOR = 1e-9

_CLOCK_OVERHEAD: float | None = None


def clock_overhead() -> float:
    """Median cost of one empty ``perf_counter`` bracket, measured once per
    process and subtracted from every timed call."""
    global _CLOCK_OVERHEAD
    if _CLOCK_OVERHEAD is None:
        deltas = []
        for _ in range(64):
            t0 = time.perf_counter()
            t1 = time.perf_counter()
            deltas.append(t1 - t0)
        _CLOCK_OVERHEAD = statistics.median(deltas)
    return _CLOCK_OVERHEAD


@dataclasses.dataclass(frozen=True)
class TimingResult:
    """One aggregated measurement."""

    seconds: float                    # median of the per-round minima
    rounds: int                       # rounds actually run
    calls: int                        # timed calls (excluding warmup)
    spread: float                     # (max - min) / median of round minima
    round_minima: tuple[float, ...]


def time_callable(fn: Callable[[], Any], *, warmup: int = 1,
                  rounds: int = 3, calls_per_round: int = 1,
                  max_rounds: int = 10,
                  stable_rel: float = 0.10) -> TimingResult:
    """Measure ``fn()``: warmup, then median-of-min over timed rounds.

    The one timing protocol every harness (and ``core.calibrate``) goes
    through, so first-touch faults and clock overhead are never billed to
    a rate.

    Args:
        fn: zero-argument callable to time.
        warmup: untimed leading calls (page faults, jit, cache fill).
        rounds: minimum number of timed rounds; more are added (up to
            ``max_rounds``) while the relative spread of the round minima
            exceeds ``stable_rel``.
        calls_per_round: timed calls per round; a round scores its minimum.
        max_rounds: hard cap on rounds.
        stable_rel: target relative spread ``(max - min) / median`` of the
            round minima.

    Returns:
        A :class:`TimingResult`; ``seconds`` is the median of the per-round
        minima, each timed call having the clock-bracket overhead
        subtracted and floored at 1 ns.
    """
    overhead = clock_overhead()
    for _ in range(max(0, warmup)):
        fn()
    minima: list[float] = []
    calls = 0

    def one_round() -> None:
        nonlocal calls
        best = float("inf")
        for _ in range(max(1, calls_per_round)):
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0 - overhead
            best = min(best, max(dt, _SECONDS_FLOOR))
            calls += 1
        minima.append(best)

    def spread() -> float:
        med = statistics.median(minima)
        return (max(minima) - min(minima)) / med if med > 0 else 0.0

    for _ in range(max(1, rounds)):
        one_round()
    while len(minima) < max_rounds and spread() > stable_rel:
        one_round()
    return TimingResult(seconds=statistics.median(minima), rounds=len(minima),
                        calls=calls, spread=spread(),
                        round_minima=tuple(minima))


# ---------------------------------------------------------------------------
# The harness protocol + built-in backends.
# ---------------------------------------------------------------------------


class Harness:
    """One timing backend: ``measure(plan)`` -> :class:`TimingResult`.

    Built-ins (:func:`get_harness`): ``host-numpy`` replays the plan's
    blocking as the Fig.-1 blocked loop nest, ``cuda`` / ``reference``
    time ``plan.execute()`` to a device synchronize, and ``simulated``
    is the closed-loop oracle predicting under a ground-truth spec.
    """

    name = "?"
    #: dtypes this harness can materialise operands for; None = any.
    supported_dtypes: frozenset | None = None

    def measure(self, plan, *, timing: Mapping[str, Any] | None = None,
                seed: int = 0) -> TimingResult:
        """Time one frozen :class:`repro.gemm.GemmPlan`.

        Args:
            plan: the planned GEMM to measure (the harness reads its
                problem, selection and ``blocking_dims()``).
            timing: keyword overrides forwarded to :func:`time_callable`
                (``warmup=``, ``rounds=``, ...).
            seed: RNG seed for operand materialisation.

        Returns:
            The aggregated :class:`TimingResult`.

        Raises:
            NotImplementedError: on the abstract base.  (Dtype support is
            declared via ``supported_dtypes`` and enforced by the campaign
            layer, which rejects out-of-range grids up front.)
        """
        raise NotImplementedError


_NP_DTYPES = {"int8": np.int8, "bf16": np.float32, "f32": np.float32}


def _host_operands(problem, seed: int):
    """Operand buffers for the host replay.  bf16 maps to f32 — the host
    analogue keeps the element count, not the byte width."""
    rng = np.random.default_rng(seed)
    dt = _NP_DTYPES[problem.dtype]
    if dt is np.int8:
        a = rng.integers(-4, 5, (problem.m, problem.k), dtype=np.int8)
        b = rng.integers(-4, 5, (problem.k, problem.n), dtype=np.int8)
    else:
        a = rng.standard_normal((problem.m, problem.k)).astype(dt)
        b = rng.standard_normal((problem.k, problem.n)).astype(dt)
    c = np.zeros((problem.m, problem.n), dtype=a.dtype)
    return a, b, c


def blocked_loop_nest(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                      bm: int, bn: int, bk: int,
                      order: str = "jpi") -> np.ndarray:
    """``C += A.B`` as a blocked loop nest, one block update per innermost
    trip — the structure the traffic terms count, with the micro-kernel
    level delegated to the host BLAS.  ``order`` is the outer-loop nesting,
    a permutation of ``"jpi"`` (j over n-blocks, p over k-blocks, i over
    m-blocks); Fig. 1's baseline is ``"jpi"``."""
    if sorted(order) != ["i", "j", "p"]:
        raise ValueError(f"order must permute 'jpi', got {order!r}")
    m, k = a.shape
    n = b.shape[1]
    ranges = {"j": range(0, n, bn), "p": range(0, k, bk),
              "i": range(0, m, bm)}
    for point in itertools.product(*(ranges[ax] for ax in order)):
        at = dict(zip(order, point))
        i0, j0, p0 = at["i"], at["j"], at["p"]
        i1, j1, p1 = min(i0 + bm, m), min(j0 + bn, n), min(p0 + bk, k)
        c[i0:i1, j0:j1] += a[i0:i1, p0:p1] @ b[p0:p1, j0:j1]
    return c


def plan_loop_order(plan) -> str:
    """The outer-loop nesting a plan's selection implies (the orders of
    ``core.variants.loop_trip_counts`` collapsed to the block level):
    B3A2C0/B3C2A0 iterate j/p/i, C3B2A0 iterates j/i/p; tile plans map
    K_INNER to p-innermost and K_OUTER to p-outermost."""
    from repro_torch.gemm.api import VariantChoice

    sel = plan.selection
    if isinstance(sel, VariantChoice):
        return {"C3B2A0": "jip"}.get(sel.variant.value, "jpi")
    if sel is not None and hasattr(sel, "order"):
        return "jip" if getattr(sel.order, "value", "") == "k_inner" \
            else "pji"
    return "jpi"


class HostNumpyHarness(Harness):
    """Replay the plan's blocking as a blocked loop nest on this host, in
    the loop order the plan's variant / grid order implies."""

    name = "host-numpy"
    supported_dtypes = frozenset(_NP_DTYPES)

    def measure(self, plan, *, timing=None, seed: int = 0) -> TimingResult:
        a, b, c = _host_operands(plan.problem, seed)
        bm, bn, bk = plan.blocking_dims()
        order = plan_loop_order(plan)
        # accumulate without resetting C: repeated calls do identical work
        # (int8 wraps, f32 grows) and the timing stays comparable.
        return time_callable(
            lambda: blocked_loop_nest(a, b, c, bm, bn, bk, order),
            **(timing or {}))


class ExecuteHarness(Harness):
    """Time ``plan.execute(a, b)`` on ``device`` (default ``cuda``).

    Operands come from ``torch.Generator(device).manual_seed(seed)`` and
    live on the device before timing starts.  The timed callable ends in
    ``torch.cuda.synchronize()``, so a call measures execution and not the
    enqueue.  ``device="cpu"`` times the kernels' plain versions on the
    host (a host number, never a device one); a CUDA device that is not
    there raises instead of falling back.
    """

    supported_dtypes = frozenset({"int8", "bf16", "f32"})

    def __init__(self, name: str, *, device="cuda"):
        from repro_torch.interop import require_device
        self.name = name
        self.device = require_device(device)

    def operands(self, problem, seed: int = 0):
        """The seeded ``(a, b)`` operands of one problem on the device."""
        import torch

        p = problem
        g = torch.Generator(self.device).manual_seed(seed)
        if p.dtype == "int8":
            a = torch.randint(-4, 5, (p.m, p.k), generator=g,
                              device=self.device, dtype=torch.int8)
            b = torch.randint(-4, 5, (p.k, p.n), generator=g,
                              device=self.device, dtype=torch.int8)
        else:
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[p.dtype]
            a = torch.randn((p.m, p.k), generator=g, device=self.device,
                            dtype=dt)
            b = torch.randn((p.k, p.n), generator=g, device=self.device,
                            dtype=dt)
        return a, b

    def measure(self, plan, *, timing=None, seed: int = 0) -> TimingResult:
        import torch

        a, b = self.operands(plan.problem, seed)
        if self.device.type == "cuda":
            sync = lambda: torch.cuda.synchronize(self.device)  # noqa: E731
        else:
            sync = lambda: None                                 # noqa: E731
        sync()

        def fn():
            plan.execute(a, b)
            sync()
        return time_callable(fn, **(timing or {}))


class SimulatedHarness(Harness):
    """Closed-loop oracle: the "measurement" is the analytic prediction under
    a ground-truth machine (same pinned selection, same policy)."""

    name = "simulated"

    def __init__(self, truth):
        from repro_torch.machines import resolve
        self.truth = resolve(truth)

    def measure(self, plan, *, timing=None, seed: int = 0) -> TimingResult:
        from repro_torch.measure.validate import predict_plan
        seconds = predict_plan(plan, self.truth)
        return TimingResult(seconds=seconds, rounds=1, calls=1, spread=0.0,
                            round_minima=(seconds,))


_HARNESSES: dict[str, Callable[..., Harness]] = {
    "host-numpy": HostNumpyHarness,
    "cuda": lambda **kw: ExecuteHarness("cuda", **kw),
    "reference": lambda **kw: ExecuteHarness("reference", **kw),
    "simulated": SimulatedHarness,
}


def harness_names() -> list[str]:
    return sorted(_HARNESSES)


def get_harness(name, **kwargs) -> Harness:
    """Resolve a harness name (instances pass through).  ``kwargs`` go to
    the harness constructor (``truth=`` for simulated, ``device=`` for
    the execute harnesses)."""
    if isinstance(name, Harness):
        return name
    try:
        factory = _HARNESSES[name]
    except KeyError:
        raise KeyError(f"unknown timing harness {name!r}; "
                       f"have {harness_names()}") from None
    return factory(**kwargs)
