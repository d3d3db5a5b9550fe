"""Design spaces: named axes over a base template, lazily expanded.

A :class:`DesignSpace` is a base :class:`AcceleratorTemplate` plus named
axes (template field -> candidate values).  Points are indexed in
row-major order over the axes as given (first axis slowest), so the space
is fully deterministic: point ``i`` is the same template in every process.
Expansion is *lazy* throughout — ``points()`` / ``specs()`` are
generators and ``sample()`` returns index-addressed points, so a
10^4-point space never materializes 10^4 ``MachineSpec`` objects unless
the caller iterates them all.

Sampling is deterministic by construction (no RNG):

* ``"grid"`` — an evenly strided sub-lattice of the flat index range.
* ``"halton"`` — a low-discrepancy Halton sequence (radical-inverse per
  axis with distinct prime bases), mapped onto each axis's value list;
  the classic choice when the axes interact and a strided sub-lattice
  would alias.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Mapping, Sequence

from repro_torch.design.template import AcceleratorTemplate, GEN_PREFIX
from repro_torch.machines.spec import MachineSpec

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _radical_inverse(i: int, base: int) -> float:
    """van der Corput radical inverse of ``i`` in ``base`` — the Halton
    sequence's per-dimension coordinate."""
    inv, denom = 0.0, 1.0
    i += 1                      # skip the degenerate all-zeros point
    while i > 0:
        denom *= base
        i, digit = divmod(i, base)
        inv += digit / denom
    return inv


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One indexed point of a space: the overridden parameters and the
    derived template.  ``spec()`` expands lazily; ``name`` is available
    without expanding."""

    index: int
    params: Mapping[str, object]        # axis overrides only
    template: AcceleratorTemplate

    @property
    def name(self) -> str:
        return self.template.name       # gen/<family>-<digest>, no expand

    def spec(self, *, register: bool = False) -> MachineSpec:
        return self.template.expand(register=register)

    def label(self) -> str:
        """Human-readable axis settings, e.g. ``lanes=8 l1_bytes=65536``."""
        return " ".join(f"{k}={v}" for k, v in self.params.items())


class DesignSpace:
    """Named axes over a base template; see module docstring."""

    def __init__(self, base: AcceleratorTemplate,
                 axes: Mapping[str, Sequence], *, name: str = "custom"):
        fields = {f.name for f in dataclasses.fields(AcceleratorTemplate)}
        self.base = base
        self.name = name
        self.axes: dict[str, tuple] = {}
        for axis, values in axes.items():
            if axis not in fields:
                raise KeyError(f"unknown template field {axis!r}; "
                               f"axes must name AcceleratorTemplate fields")
            values = tuple(values)
            if not values:
                raise ValueError(f"axis {axis!r} has no values")
            self.axes[axis] = values
        if not self.axes:
            raise ValueError("a design space needs at least one axis")

    def __len__(self) -> int:
        return math.prod(len(v) for v in self.axes.values())

    def __repr__(self) -> str:
        dims = " x ".join(f"{k}[{len(v)}]" for k, v in self.axes.items())
        return f"DesignSpace({self.name!r}, {dims} = {len(self)} points)"

    def point(self, index: int) -> DesignPoint:
        """Decode a flat index (row-major, first axis slowest)."""
        n = len(self)
        if not 0 <= index < n:
            raise IndexError(f"point {index} out of range for {n}-point "
                             f"space {self.name!r}")
        rem, params = index, {}
        for axis, values in reversed(self.axes.items()):
            rem, j = divmod(rem, len(values))
            params[axis] = values[j]
        params = dict(reversed(params.items()))
        return DesignPoint(index=index, params=params,
                           template=self.base.with_params(**params))

    def points(self) -> Iterator[DesignPoint]:
        """Every point, lazily, in index order."""
        for i in range(len(self)):
            yield self.point(i)

    def specs(self, *, register: bool = False) -> Iterator[MachineSpec]:
        """Every point's spec, lazily (one expansion per iteration step)."""
        for pt in self.points():
            yield pt.spec(register=register)

    def sample(self, n: int, *, method: str = "grid") -> list[DesignPoint]:
        """``n`` deterministic points (see module docstring for methods).
        ``n >= len(self)`` returns the whole space in index order."""
        total = len(self)
        if n >= total:
            return list(self.points())
        if n < 1:
            raise ValueError(f"sample size must be >= 1, got {n}")
        if method == "grid":
            idx = sorted({(i * total) // n for i in range(n)})
            return [self.point(i) for i in idx]
        if method == "halton":
            seen: dict[int, None] = {}
            sizes = [len(v) for v in self.axes.values()]
            i = 0
            # distinct prime base per axis; collisions (two Halton draws
            # landing on the same lattice cell) are skipped, so this
            # terminates once n distinct cells are found.
            while len(seen) < n and i < 64 * total:
                flat = 0
                for d, size in enumerate(sizes):
                    j = min(int(_radical_inverse(i, _PRIMES[d % len(_PRIMES)])
                                * size), size - 1)
                    flat = flat * size + j
                seen.setdefault(flat, None)
                i += 1
            return [self.point(i) for i in sorted(seen)]
        raise ValueError(f"unknown sampling method {method!r}; "
                         f"use 'grid' or 'halton'")

    def register_all(self, *, limit: int | None = None) -> list[str]:
        """Eagerly expand + register points (first ``limit`` of them) under
        the ``gen/`` namespace; returns the registered names in index
        order.  Pair with ``machines.unregister_prefix("gen/")``."""
        names = []
        for pt in self.points():
            if limit is not None and len(names) >= limit:
                break
            names.append(pt.spec(register=True).name)
        return names


# -- named spaces -------------------------------------------------------------

_KI = 1024


def _gap9ish(**overrides) -> AcceleratorTemplate:
    return AcceleratorTemplate(family="gap9ish").with_params(**overrides)


def _spaces() -> dict[str, DesignSpace]:
    return {
        # CI-sized: 8 points, seconds to score.
        "smoke": DesignSpace(
            _gap9ish(),
            {"lanes": (4, 8),
             "l1_bytes": (32 * _KI, 64 * _KI),
             "dma_bw": (8.8e6, 1.76e7)},
            name="smoke"),
        # the default frontier space: a gap9-like template swept over
        # MAC width x L1 capacity x DMA bandwidth — 4 x 4 x 4 = 64 points.
        "gap9-sweep": DesignSpace(
            _gap9ish(),
            {"lanes": (2, 4, 8, 16),
             "l1_bytes": (16 * _KI, 32 * _KI, 64 * _KI, 128 * _KI),
             "dma_bw": (4.4e6, 8.8e6, 1.76e7, 3.52e7)},
            name="gap9-sweep"),
        # the serving-study space (experiments/design_space_study.py): the
        # same three axes pushed upward, on a 64-entry register file —
        # the stock 32 leaves no register-feasible micro-kernel above 16
        # lanes, and the extra DMA headroom is what buys a sub-0.35s p99.
        "gap9-wide": DesignSpace(
            _gap9ish(num_vector_registers=64),
            {"lanes": (4, 8, 16, 32),
             "l1_bytes": (16 * _KI, 32 * _KI, 64 * _KI, 128 * _KI),
             "dma_bw": (1.76e7, 3.52e7, 7.04e7, 1.408e8)},
            name="gap9-wide"),
        # a 10^4-scale space for lazy-expansion / sampling exercises: never
        # expand it eagerly.
        "wide": DesignSpace(
            _gap9ish(),
            {"lanes": (2, 4, 8, 16),
             "mac_units": (1, 2, 4),
             "l1_bytes": tuple(2 ** e * _KI for e in range(3, 10)),
             "l2_bytes": tuple(2 ** e * _KI for e in range(7, 12)),
             "dma_bw": (2.2e6, 4.4e6, 8.8e6, 1.76e7, 3.52e7),
             "noc_bw": (7.2e6, 1.44e7, 2.88e7),
             "pack_bw": (1.62e6, 3.24e6)},
            name="wide"),
    }


def space_names() -> list[str]:
    return sorted(_spaces())


def get_space(name: str) -> DesignSpace:
    """Look up a named space ("smoke", "gap9-sweep", "gap9-wide", "wide")."""
    spaces = _spaces()
    try:
        return spaces[name]
    except KeyError:
        raise KeyError(f"unknown design space {name!r}; "
                       f"have {sorted(spaces)}") from None


__all__ = ["DesignPoint", "DesignSpace", "GEN_PREFIX", "get_space",
           "space_names"]
