"""Measured-sample records and their append-only JSONL store.

A :class:`Sample` is one measured GEMM wall time together with everything
needed to re-predict it: the problem, the pinned selection (variant +
micro-kernel for the BLIS-variant model, tile for the TPU model), the
partial-tile policy, the harness that produced it, and the *geometry
fingerprint* of the machine spec it was planned against.

The fingerprint is the staleness guard: blockings — and therefore measured
times — depend on a spec's geometry (capacities, levels, register file), not
on its placeholder rates, so a Calibrator refit keeps old samples valid
while any geometry change (or a name that now points at a different machine)
invalidates them.  :meth:`SampleStore.for_machine` refuses to return
mismatching samples rather than silently calibrating a renamed spec.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, Mapping

SAMPLE_SCHEMA = "repro.measure/sample-v1"


class StaleSampleError(ValueError):
    """Samples whose machine geometry no longer matches the spec."""


@dataclasses.dataclass(frozen=True)
class Sample:
    """One measured (problem, selection) -> seconds data point."""

    m: int
    n: int
    k: int
    dtype: str
    seconds: float
    harness: str                    # timing backend that measured it
    machine: str                    # spec name the plan was made against
    machine_fingerprint: str        # MachineSpec.geometry_fingerprint()
    backend: str = "analytic-gap8"  # planning backend
    variant: str | None = None      # BLIS-model selection ...
    micro_kernel: str | None = None  # ... e.g. "4x24"
    tile: str | None = None         # TPU-model selection, TileConfig str
    policy: str = "analytic"
    rounds: int = 1
    calls: int = 1
    spread: float = 0.0
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def problem(self):
        from repro_torch.gemm.api import GemmProblem
        return GemmProblem(self.m, self.n, self.k, dtype=self.dtype)

    @property
    def cell(self) -> str:
        """Human-readable grid-cell tag for reports."""
        sel = self.micro_kernel or self.tile or "-"
        return f"{self.m}x{self.n}x{self.k}:{self.dtype}/{sel}"

    @classmethod
    def from_measurement(cls, plan, result, harness: str, machine_spec,
                         meta: Mapping[str, Any] | None = None) -> "Sample":
        """Build the record for one plan measured by one harness."""
        from repro_torch.gemm.api import VariantChoice

        sel = plan.selection
        variant = micro_kernel = tile = None
        if isinstance(sel, VariantChoice):
            variant = sel.variant.value
            micro_kernel = str(sel.micro_kernel)
        elif sel is not None:
            tile = str(sel)
        p = plan.problem
        return cls(
            m=p.m, n=p.n, k=p.k, dtype=p.dtype,
            seconds=float(result.seconds), harness=harness,
            machine=machine_spec.name,
            machine_fingerprint=machine_spec.geometry_fingerprint(),
            backend=plan.backend, variant=variant,
            micro_kernel=micro_kernel, tile=tile,
            policy=str(plan.provenance.get("policy", "analytic")),
            rounds=int(result.rounds), calls=int(result.calls),
            spread=float(result.spread), meta=dict(meta or {}))

    def to_json(self) -> dict:
        d = {"schema": SAMPLE_SCHEMA}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "meta":
                if v:
                    d["meta"] = dict(v)
            elif v is not None:
                d[f.name] = v
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Sample":
        schema = d.get("schema", SAMPLE_SCHEMA)
        if schema != SAMPLE_SCHEMA:
            raise ValueError(f"unknown sample schema {schema!r} "
                             f"(expected {SAMPLE_SCHEMA!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class SampleStore:
    """Append-only JSONL store of :class:`Sample` records.

    One sample per line; ``append`` opens in append mode and flushes, so
    campaigns can crash mid-run without corrupting earlier samples and
    concurrent readers always see whole records.
    """

    def __init__(self, path: str):
        self.path = str(path)

    def append(self, sample: Sample) -> Sample:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            json.dump(sample.to_json(), f, sort_keys=True)
            f.write("\n")
        return sample

    def extend(self, samples) -> int:
        n = 0
        for s in samples:
            self.append(s)
            n += 1
        return n

    def __iter__(self) -> Iterator[Sample]:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    yield Sample.from_json(json.loads(line))
                except (ValueError, TypeError) as e:
                    raise ValueError(
                        f"{self.path}:{lineno}: bad sample record: {e}"
                    ) from e

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def samples(self, **filters) -> list[Sample]:
        """All samples matching the given field values, e.g.
        ``samples(dtype="int8", harness="host-numpy")``."""
        out = list(self)
        for name, want in filters.items():
            out = [s for s in out if getattr(s, name) == want]
        return out

    @staticmethod
    def _lineage_names(spec) -> set[str]:
        """The machine names whose samples legitimately describe ``spec``:
        its own name, plus — for calibrated specs only — the template it
        was measured/fitted from (``provenance["base"]``).  Transform-derived
        ablations (``scaled`` etc.) do NOT inherit their base's samples: a
        what-if machine must never be calibrated from the real one's data.
        """
        names = {spec.name}
        prov = dict(spec.provenance or {})
        if ("fit" in prov or "calibration" in prov) and prov.get("base"):
            names.add(str(prov["base"]))
        return names

    def for_machine(self, spec, *, allow_stale: bool = False) -> list[Sample]:
        """Samples measured for ``spec``: the recorded machine name must be
        in the spec's calibration lineage (its own name, or the template a
        fit was solved from) AND the recorded geometry fingerprint must
        match.

        Lineage samples whose geometry no longer matches are stale — the
        spec changed since the campaign — and raise
        :class:`StaleSampleError` unless ``allow_stale=True`` skips them.
        Samples of other machines are ignored, even when their geometry
        coincides (a rates-only ablation shares its base's geometry but
        must not silently calibrate from its measurements).
        """
        fp = spec.geometry_fingerprint()
        names = self._lineage_names(spec)
        match, stale = [], []
        for s in self:
            if s.machine not in names:
                continue
            if s.machine_fingerprint == fp:
                match.append(s)
            else:
                stale.append(s)
        if stale and not allow_stale:
            raise StaleSampleError(
                f"{self.path}: {len(stale)} sample(s) named "
                f"{sorted({s.machine for s in stale})} were measured "
                f"against a different geometry (fingerprint != {fp}); "
                f"re-run the campaign into a fresh store path (this one is "
                f"append-only, the stale lines stay) or pass "
                f"allow_stale=True to skip them")
        return match
