"""Open-loop traffic: arrival processes + request-length distributions.

A traffic generator materialises a deterministic stream of
:class:`SimRequest` records — arrival time, prompt length, decode length —
from its own ``random.Random(seed)``, independent of the server it will
drive (open loop: arrivals do not slow down when the server saturates,
which is exactly how tail latency blows up in production).

Generators:

* :class:`PoissonTraffic` — exponential inter-arrival gaps at ``rate``
  requests/second (the memoryless default).
* :class:`UniformTraffic` — a constant ``1/rate`` gap (the arrival process
  with zero burstiness, the lower bound on queueing).
* :class:`BurstyTraffic` — Poisson-arriving *bursts* of ``burst`` back-to-
  back requests; the mean rate still equals ``rate``, but queue depth
  spikes (the adversarial end of the same axis).
* :class:`TraceTraffic` — replays an explicit request list, e.g. one
  recorded from a real :class:`~repro_torch.serving.engine.ServingEngine` trace
  (see :func:`repro_torch.simulate.replay.trace_requests`); round-trips
  bit-exactly.

Lengths are drawn per request from a :class:`LengthDist` — ``fixed``,
``uniform`` over ``[lo, hi]``, or ``geometric`` with a mean (the classic
decode-length model).  A bare int coerces to ``fixed``, a ``(lo, hi)``
tuple to ``uniform``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Iterable, Sequence

from repro_torch.serving.buckets import PREFILL_BUCKETS, bucket_len


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One request of the open-loop stream.  ``deadline_s`` is a relative
    end-to-end latency budget (seconds from arrival); ``None`` means no
    deadline (the server may still impose a default)."""

    rid: int
    arrival_s: float
    prompt_len: int
    decode_len: int
    deadline_s: float | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """A token-length distribution: ``fixed`` | ``uniform`` | ``geometric``.

    ``lo`` is the minimum (and the fixed value); ``hi`` bounds ``uniform``
    draws and clips ``geometric`` ones; ``mean`` parameterises
    ``geometric``.
    """

    kind: str = "fixed"
    lo: int = 8
    hi: int | None = None
    mean: float | None = None

    def __post_init__(self):
        if self.kind not in ("fixed", "uniform", "geometric"):
            raise ValueError(f"unknown length distribution {self.kind!r}")
        if self.kind == "uniform" and (self.hi is None or self.hi < self.lo):
            raise ValueError(f"uniform length needs lo <= hi, got {self}")
        if self.kind == "geometric" and not (self.mean or 0) > 0:
            raise ValueError(f"geometric length needs a positive mean")

    @classmethod
    def coerce(cls, spec: Any) -> "LengthDist":
        """int -> fixed, (lo, hi) -> uniform, dict -> kwargs, pass-through."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, int):
            return cls(kind="fixed", lo=spec)
        if isinstance(spec, (tuple, list)) and len(spec) == 2:
            return cls(kind="uniform", lo=int(spec[0]), hi=int(spec[1]))
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(f"cannot interpret {spec!r} as a length "
                        "distribution (int, (lo, hi), dict, or LengthDist)")

    def sample(self, rng: random.Random) -> int:
        if self.kind == "fixed":
            return self.lo
        if self.kind == "uniform":
            return rng.randint(self.lo, self.hi)
        # geometric with the given mean above lo, via inverse transform
        u = 1.0 - rng.random()                       # (0, 1]
        extra = int(-math.log(u) * (self.mean - self.lo)) \
            if self.mean > self.lo else 0
        n = self.lo + extra
        return min(n, self.hi) if self.hi is not None else n

    def mean_value(self, cap: int) -> float:
        """Expected draw (capped support for geometric tails)."""
        if self.kind == "fixed":
            return float(min(self.lo, cap))
        if self.kind == "uniform":
            lo, hi = self.bounds(cap)
            return (lo + hi) / 2.0
        return float(min(self.mean, cap))

    def bounds(self, cap: int) -> tuple[int, int]:
        """Smallest and largest value a draw can take, capped at ``cap``
        (geometric tails are open-ended; the cap is the serving
        ``max_len``)."""
        if self.kind == "fixed":
            return (min(self.lo, cap),) * 2
        hi = self.hi if self.hi is not None else cap
        return min(self.lo, cap), min(hi, cap)

    def prefill_buckets(self, cap: int,
                        buckets=PREFILL_BUCKETS) -> list[int]:
        """Every prefill bucket a prompt drawn from this distribution can
        land in (lengths capped at ``cap``) — what a service model must
        price."""
        lo, hi = self.bounds(cap)
        lob, hib = bucket_len(lo, buckets), bucket_len(hi, buckets)
        hit = {lob, hib}
        hit.update(b for b in buckets if lob <= b <= hib)
        return sorted(hit)


class Traffic:
    """Base class: subclasses implement ``_gaps(rng)`` yielding successive
    inter-arrival gaps; lengths are drawn per request."""

    kind = "traffic"

    def __init__(self, *, rate: float, prompt_len: Any = 8,
                 decode_len: Any = 16, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        self.rate = float(rate)
        self.prompt_len = LengthDist.coerce(prompt_len)
        self.decode_len = LengthDist.coerce(decode_len)
        self.seed = int(seed)

    @property
    def name(self) -> str:
        return f"{self.kind}@{self.rate:g}rps"

    def _gaps(self, rng: random.Random) -> Iterable[float]:
        raise NotImplementedError

    def requests(self, n: int) -> list[SimRequest]:
        """The first ``n`` requests of the stream.  Deterministic: the
        same ``(generator config, seed, n)`` always yields the same list,
        and a longer stream is a prefix-extension of a shorter one."""
        rng = random.Random(self.seed)
        out, t = [], 0.0
        gaps = iter(self._gaps(rng))
        for rid in range(n):
            t += next(gaps)
            out.append(SimRequest(
                rid=rid, arrival_s=t,
                prompt_len=max(1, self.prompt_len.sample(rng)),
                decode_len=max(1, self.decode_len.sample(rng))))
        return out


class PoissonTraffic(Traffic):
    kind = "poisson"

    def _gaps(self, rng: random.Random) -> Iterable[float]:
        while True:
            yield rng.expovariate(self.rate)


class UniformTraffic(Traffic):
    kind = "uniform"

    def _gaps(self, rng: random.Random) -> Iterable[float]:
        while True:
            yield 1.0 / self.rate


class BurstyTraffic(Traffic):
    """Poisson bursts: every burst brings ``burst`` requests separated by
    ``intra_gap`` seconds; burst starts arrive at ``rate / burst`` so the
    long-run request rate matches ``rate``."""

    kind = "bursty"

    def __init__(self, *, rate: float, burst: int = 8,
                 intra_gap: float = 1e-3, **kw):
        super().__init__(rate=rate, **kw)
        if burst < 1:
            raise ValueError(f"burst size must be >= 1, got {burst}")
        self.burst = int(burst)
        self.intra_gap = float(intra_gap)

    @property
    def name(self) -> str:
        return f"bursty{self.burst}@{self.rate:g}rps"

    def _gaps(self, rng: random.Random) -> Iterable[float]:
        burst_rate = self.rate / self.burst
        while True:
            yield rng.expovariate(burst_rate)
            for _ in range(self.burst - 1):
                yield self.intra_gap


class TraceTraffic(Traffic):
    """Replays an explicit request list (e.g. a recorded engine trace)."""

    kind = "trace"

    def __init__(self, requests: Sequence[SimRequest]):
        self._requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        n = len(self._requests)
        span = self._requests[-1].arrival_s if self._requests else 0.0
        # nominal rate for reporting only; arrivals come from the trace
        self.rate = (n / span) if span > 0 else float(n or 1)
        self.seed = 0

    @property
    def name(self) -> str:
        return f"trace[{len(self._requests)}]"

    def requests(self, n: int | None = None) -> list[SimRequest]:
        if n is not None and n < len(self._requests):
            return list(self._requests[:n])
        return list(self._requests)


TRAFFIC_KINDS = {"poisson": PoissonTraffic, "uniform": UniformTraffic,
                 "bursty": BurstyTraffic}


def make_traffic(kind: str, **kw) -> Traffic:
    """CLI-friendly factory: ``make_traffic("poisson", rate=32, ...)``."""
    try:
        cls = TRAFFIC_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown traffic kind {kind!r}; "
                         f"have {sorted(TRAFFIC_KINDS)}") from None
    return cls(**kw)


@dataclasses.dataclass(frozen=True)
class TrafficScenario:
    """A named traffic configuration — the unit the sweep axes cross.

    ``bind(cfg, max_len)`` turns it into a ``repro_torch.gemm.sweep`` scenario
    axis entry: the bound scenario's ``problems`` hook extends the decode
    workload with the prefill-bucket GEMMs its prompt-length distribution
    can hit, so one sweep call plans every shape the simulation will
    price under this scenario.
    """

    name: str
    traffic: Traffic
    description: str = ""

    def bind(self, cfg, max_len: int = 512) -> "BoundScenario":
        from repro_torch.core.autotune import model_gemm_shapes

        extra = []
        for b in self.traffic.prompt_len.prefill_buckets(max_len):
            extra.extend(model_gemm_shapes(cfg, tokens=b))
        return BoundScenario(name=self.name, extra_problems=tuple(extra))


@dataclasses.dataclass(frozen=True)
class BoundScenario:
    """A scenario bound to one model config: a valid ``gemm.sweep``
    ``scenarios=`` entry (``name`` + ``problems`` transform)."""

    name: str
    extra_problems: tuple = ()

    def problems(self, base: Sequence) -> list:
        out = list(base)
        out.extend(self.extra_problems)
        return out
