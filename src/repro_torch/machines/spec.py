"""The serializable machine schema — a processor as a small set of rates.

The paper's portability claim (§1, §3.2) is that one analytic GEMM simulator
covers a *"highly heterogeneous zoo"* of edge processors because a machine is
nothing but a few calibrated numbers: per-level scratchpad capacities,
point-to-point transfer rates (Table 1), a per-dtype arithmetic-rate table,
and the register-file geometry.  This module makes that literal:
:class:`MachineSpec` is a frozen, JSON-serializable value object with a
validated schema, and every machine the framework knows about is a manifest
under ``repro/machines/zoo/`` — adding a processor is dropping a JSON file,
not editing code.

Level-name indirection: the variant cost models (``core/variants.py``,
``core/simulator.py``) address the canonical role set ``{"M", "L2", "L1",
"R"}``.  A machine whose physical hierarchy differs declares
``level_aliases`` mapping role names onto its real levels (e.g. a two-level
Cortex-M-class part maps the ``"L2"`` role onto ``"L1"``; the TPU maps it
onto VMEM), and :meth:`MachineSpec.capacity` / :meth:`MachineSpec.rate`
resolve through the alias table — the simulators never special-case a
hierarchy again.

Derived machines are first-class: :meth:`scaled`, :meth:`with_capacities`
and :meth:`with_dtype_rates` stamp out hypothetical zoo members (ablations,
what-if parts) with provenance recording the base spec and the transform.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
from typing import Any, Mapping

SCHEMA = "repro.machines/v1"

#: canonical memory-level roles addressed by the variant cost models.
CANONICAL_ROLES = ("M", "L2", "L1", "R")

_DTYPE_TAG = re.compile(r"^[a-z][a-z0-9_]*$")
_MK_TAG = re.compile(r"^[1-9][0-9]*x[1-9][0-9]*$")
_RATE_SEP = "->"

#: dtype tags a rate table may be keyed by.  ``validate()`` rejects tables
#: with keys outside this set (a silently-accepted typo like ``"in8"`` used
#: to make every lookup fall through to KeyError at plan time instead).
KNOWN_DTYPES = frozenset(
    {"int4", "int8", "int16", "int32", "f16", "bf16", "f32", "f64"})
# mixed-rate keys are "AxB->ACC" over known dtype tags, e.g. "int4xint8->int32"
_MIXED_KEY = re.compile(r"^([a-z0-9_]+)x([a-z0-9_]+)->([a-z0-9_]+)$")


class SpecValidationError(ValueError):
    """A manifest / MachineSpec that violates the schema."""


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """A machine for the blocked-GEMM cost model.

    ``transfer_rates`` maps ``(origin, destination)`` level names to bytes/s.
    Level names are free-form but the variant cost models address the
    canonical role set ``{"M", "L2", "L1", "R"}``; machines whose hierarchy
    differs resolve roles through ``level_aliases`` (see module docstring).

    Rates follow the paper's convention: *bytes per second* for transfers and
    *ops per second* for arithmetic (1 MAC = 2 ops), keyed by dtype tag.
    Packing rates are calibrated at ``reference_chunk`` contiguous elements
    and scale linearly with the chunk size (paper §3.2).
    """

    name: str
    # capacities in bytes, by level name (registers expressed in bytes too).
    capacities: Mapping[str, int]
    # (origin, dest) -> bytes/s, calibrated at the reference chunk size.
    transfer_rates: Mapping[tuple[str, str], float]
    # arithmetic throughput, ops/s (1 MAC = 2 ops), by dtype tag.
    arith_rate: Mapping[str, float]
    # optional per-micro-kernel refinement of ``arith_rate`` (paper §4's
    # stated extension of the basic simulator): dtype tag -> {"4x24": ops/s}.
    # Micro-kernels absent from the table fall back to ``arith_rate``.
    arith_per_mk: Mapping[str, Mapping[str, float]] = \
        dataclasses.field(default_factory=dict)
    # chunk size (elements) at which packing rates were calibrated.
    reference_chunk: int = 4
    # element size in bytes for the default dtype.
    elem_bytes: int = 1
    # number of (SIMD) registers and lanes per register, for micro-kernel
    # feasibility checks.
    num_vector_registers: int = 32
    register_lanes: int = 4
    # declared level names, outermost first (derived from capacities when
    # omitted).
    levels: tuple[str, ...] = ()
    # canonical-role -> physical-level indirection (e.g. {"L2": "L1"}).
    level_aliases: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # deployment-memory view (manifest section "memory"): the level whose
    # capacity bounds what a served model may occupy (weights + KV cache +
    # activation workspace) and the fraction of it reserved for the runtime.
    # Empty deployment_level means the canonical "M" role.
    deployment_level: str = ""
    memory_reserved_fraction: float = 0.0
    # where this spec came from: calibration fit, derivation, manifest note.
    provenance: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # mixed-precision arithmetic rates, ops/s, keyed "AxB->ACC" (e.g.
    # "int4xint8->int32").  Keys absent from the table fall back to the
    # uniform ``arith_rate`` entry of the compute (narrower-operand) dtype —
    # see :meth:`arith_rate_mixed`.
    rates_mixed: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # fixed costs, in seconds, that a machine charges per event rather than
    # per byte or op (manifest section "call_costs"): a dtype tag keys the
    # host cost of one GEMM wrapper call in that dtype, "launch" one device
    # operation the wrapper enqueues.  The Hopper tile model
    # (core/hopper_model.py) prices them; the rate models ignore them, and
    # so does the JAX package's reader of the same manifest.
    call_costs: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.levels:
            object.__setattr__(self, "levels", tuple(self.capacities))

    # -- level / rate resolution ---------------------------------------------

    def level(self, role: str) -> str:
        """Resolve a canonical role name to this machine's physical level."""
        return self.level_aliases.get(role, role)

    def rate(self, origin: str, dest: str) -> float:
        o, d = self.level(origin), self.level(dest)
        try:
            return self.transfer_rates[(o, d)]
        except KeyError as e:
            raise KeyError(
                f"{self.name}: no calibrated transfer rate {origin}->{dest}"
            ) from e

    def packing_rate(self, origin: str, dest: str, chunk_elems: int) -> float:
        """Packing rate scaled by the contiguous-chunk size (paper §3.2)."""
        scale = chunk_elems / float(self.reference_chunk)
        return self.rate(origin, dest) * scale

    def capacity(self, level: str) -> int:
        return int(self.capacities[self.level(level)])

    def arith_rate_for(self, dtype: str, micro_kernel=None) -> float:
        """Arithmetic rate (ops/s) for a dtype, refined per micro-kernel when
        the spec carries an ``arith_per_mk`` table (paper §4).  With no table
        entry this returns exactly ``arith_rate[dtype]``, so machines without
        the refinement behave bit-identically."""
        if micro_kernel is not None and self.arith_per_mk:
            rate = self.arith_per_mk.get(dtype, {}).get(str(micro_kernel))
            if rate is not None:
                return rate
        return self.arith_rate[dtype]

    def arith_rate_mixed(self, key: str, fallback_dtype: str | None = None,
                         micro_kernel=None) -> float:
        """Arithmetic rate (ops/s) for a mixed-precision configuration.

        ``key`` is the ``"AxB->ACC"`` form of a ``PrecisionConfig``
        (:meth:`PrecisionConfig.key`).  When the spec carries a calibrated
        ``rates_mixed`` entry for the key it wins; otherwise the rate falls
        back to :meth:`arith_rate_for` on ``fallback_dtype`` — the compute
        (narrower-operand) dtype of the config, defaulting to the key's
        first operand — so every machine remains plannable for every mixed
        config its uniform table covers.
        """
        rate = self.rates_mixed.get(key)
        if rate is not None:
            return rate
        dt = fallback_dtype or key.partition("x")[0]
        return self.arith_rate_for(dt, micro_kernel)

    def memory_budget(self, level: str | None = None) -> int:
        """Usable bytes for a served model at the deployment memory level.

        The paper treats every memory level as a hard capacity the blocked
        algorithm must respect; deployment planning extends the same rule to
        the whole model: weights, KV caches and activation workspace all live
        at the deployment level (HBM on the TPU, main memory on the edge
        parts), so a serving configuration is feasible only when its modelled
        footprint (``repro.serving.footprint``) fits this budget.

        Args:
            level: level name or canonical role to budget; defaults to the
                spec's ``deployment_level`` (itself defaulting to the ``"M"``
                role).

        Returns:
            ``capacity(level)`` minus the ``memory_reserved_fraction`` slice
            held back for the runtime (allocator slack, executables,
            non-model buffers), as an int number of bytes.
        """
        lv = level or self.deployment_level or "M"
        return int(self.capacity(lv) * (1.0 - self.memory_reserved_fraction))

    def fingerprint(self) -> str:
        """Content identity for process-level caches.

        Two specs sharing a registry name can carry different rate tables
        (derived transforms, ``register(overwrite=True)``, a Calibrator
        refit), so plan/tune caches key on ``name@fingerprint`` rather than
        the name alone.  Provenance is excluded — it never affects a
        prediction.
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            payload = {k: v for k, v in self.to_json().items()
                       if k != "provenance"}
            fp = hashlib.sha1(json.dumps(payload, sort_keys=True)
                              .encode()).hexdigest()[:16]
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    @property
    def cache_token(self) -> str:
        """``name@fingerprint`` — the cache-key form of this machine."""
        return f"{self.name}@{self.fingerprint()}"

    #: to_json keys that describe the machine's *geometry* — everything that
    #: shapes a blocked loop nest (blockings, register feasibility) but not
    #: the calibrated rates a fit replaces.
    _GEOMETRY_KEYS = ("levels", "capacities", "level_aliases",
                      "reference_chunk", "elem_bytes",
                      "num_vector_registers", "register_lanes")

    def geometry_fingerprint(self) -> str:
        """Content identity of the geometry alone (capacities, levels,
        aliases, register file — everything except the rate tables, the name
        and provenance).

        Measured GEMM wall times depend on the planned blocking, hence on the
        geometry, but not on a template's placeholder rates; a Calibrator
        refit changes rates only.  ``repro.measure.SampleStore`` keys samples
        on this fingerprint so a campaign survives a refit, while samples
        taken against a spec whose geometry has since changed (or whose name
        now points at a different machine) can never silently calibrate it.
        """
        fp = self.__dict__.get("_geometry_fingerprint")
        if fp is None:
            d = self.to_json()
            payload = {k: d.get(k) for k in self._GEOMETRY_KEYS}
            fp = hashlib.sha1(json.dumps(payload, sort_keys=True)
                              .encode()).hexdigest()[:16]
            object.__setattr__(self, "_geometry_fingerprint", fp)
        return fp

    # -- validation ----------------------------------------------------------

    def validate(self) -> "MachineSpec":
        """Schema-check the spec; raises :class:`SpecValidationError`.

        Checks level-name consistency (every capacity / rate endpoint /
        alias target is a declared level; every canonical role resolves),
        rate-key shape and positivity, and the dtype-rate table.
        """
        err = SpecValidationError
        if not self.name or not isinstance(self.name, str) \
                or self.name != self.name.strip() \
                or self.name.count("/") > 1 \
                or any(not part or part != part.strip()
                       for part in self.name.split("/")):
            raise err(f"bad machine name {self.name!r}")
        levels = tuple(self.levels)
        if not levels or len(set(levels)) != len(levels):
            raise err(f"{self.name}: levels must be non-empty and unique, "
                      f"got {levels!r}")
        if set(self.capacities) != set(levels):
            raise err(f"{self.name}: capacities keys {sorted(self.capacities)}"
                      f" != declared levels {sorted(levels)}")
        for lv, cap in self.capacities.items():
            if int(cap) <= 0:
                raise err(f"{self.name}: capacity[{lv}] must be positive")
        for key, rate in self.transfer_rates.items():
            if not (isinstance(key, tuple) and len(key) == 2):
                raise err(f"{self.name}: transfer-rate key {key!r} is not "
                          f"an (origin, dest) pair")
            o, d = key
            if o not in levels or d not in levels:
                raise err(f"{self.name}: rate key {o}->{d} references an "
                          f"undeclared level (have {levels})")
            if not (isinstance(rate, (int, float)) and math.isfinite(rate)
                    and rate > 0):
                raise err(f"{self.name}: rate {o}->{d} must be a positive "
                          f"finite number, got {rate!r}")
        for role, target in self.level_aliases.items():
            if role in levels:
                raise err(f"{self.name}: alias {role!r} shadows a declared "
                          f"level")
            if target not in levels:
                raise err(f"{self.name}: alias {role}->{target} targets an "
                          f"undeclared level")
        for role in CANONICAL_ROLES:
            if self.level(role) not in levels:
                raise err(f"{self.name}: canonical role {role!r} resolves to "
                          f"no declared level; add it to levels or "
                          f"level_aliases")
        if not self.arith_rate:
            raise err(f"{self.name}: arith_rate table is empty")
        for tag, rate in self.arith_rate.items():
            if not _DTYPE_TAG.match(tag or ""):
                raise err(f"{self.name}: bad dtype tag {tag!r} in arith_rate")
            if tag not in KNOWN_DTYPES:
                raise err(f"{self.name}: unknown dtype tag {tag!r} in "
                          f"arith_rate (known: {sorted(KNOWN_DTYPES)})")
            if not (isinstance(rate, (int, float)) and math.isfinite(rate)
                    and rate > 0):
                raise err(f"{self.name}: arith_rate[{tag}] must be a "
                          f"positive finite number, got {rate!r}")
        for key, rate in self.rates_mixed.items():
            match = _MIXED_KEY.match(key or "")
            if not match:
                raise err(f"{self.name}: bad rates_mixed key {key!r} "
                          f"(expected 'AxB->ACC', e.g. 'int4xint8->int32')")
            for tag in match.groups():
                if tag not in KNOWN_DTYPES:
                    raise err(f"{self.name}: unknown dtype tag {tag!r} in "
                              f"rates_mixed key {key!r} "
                              f"(known: {sorted(KNOWN_DTYPES)})")
            if not (isinstance(rate, (int, float)) and math.isfinite(rate)
                    and rate > 0):
                raise err(f"{self.name}: rates_mixed[{key}] must be a "
                          f"positive finite number, got {rate!r}")
        for key, cost in self.call_costs.items():
            if key != "launch" and key not in KNOWN_DTYPES:
                raise err(f"{self.name}: unknown call_costs key {key!r} "
                          f"(a dtype tag or 'launch')")
            if not (isinstance(cost, (int, float)) and math.isfinite(cost)
                    and cost >= 0):
                raise err(f"{self.name}: call_costs[{key}] must be a "
                          f"non-negative finite number of seconds, got "
                          f"{cost!r}")
        for tag, table in self.arith_per_mk.items():
            if tag not in self.arith_rate:
                raise err(f"{self.name}: arith_per_mk dtype {tag!r} has no "
                          f"arith_rate fallback entry")
            if not table:
                raise err(f"{self.name}: arith_per_mk[{tag}] is empty")
            for mk, rate in table.items():
                if not _MK_TAG.match(mk or ""):
                    raise err(f"{self.name}: bad micro-kernel key {mk!r} in "
                              f"arith_per_mk[{tag}] (expected 'RxC')")
                if not (isinstance(rate, (int, float))
                        and math.isfinite(rate) and rate > 0):
                    raise err(f"{self.name}: arith_per_mk[{tag}][{mk}] must "
                              f"be a positive finite number, got {rate!r}")
        for field, lo in (("reference_chunk", 1), ("elem_bytes", 1),
                          ("num_vector_registers", 1), ("register_lanes", 1)):
            if int(getattr(self, field)) < lo:
                raise err(f"{self.name}: {field} must be >= {lo}")
        if self.deployment_level and \
                self.level(self.deployment_level) not in levels:
            raise err(f"{self.name}: deployment_level "
                      f"{self.deployment_level!r} resolves to no declared "
                      f"level (have {levels})")
        frac = self.memory_reserved_fraction
        if not (isinstance(frac, (int, float)) and math.isfinite(frac)
                and 0.0 <= frac < 1.0):
            raise err(f"{self.name}: memory_reserved_fraction must be in "
                      f"[0, 1), got {frac!r}")
        return self

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """The manifest form; round-trips losslessly through
        :meth:`from_json` (floats serialize at full repr precision)."""
        d: dict[str, Any] = {
            "schema": SCHEMA,
            "name": self.name,
            "levels": list(self.levels),
            "capacities": {k: int(v) for k, v in self.capacities.items()},
            "transfer_rates": {f"{o}{_RATE_SEP}{dst}": float(r)
                               for (o, dst), r in self.transfer_rates.items()},
            "arith_rate": {k: float(v) for k, v in self.arith_rate.items()},
            "reference_chunk": int(self.reference_chunk),
            "elem_bytes": int(self.elem_bytes),
            "num_vector_registers": int(self.num_vector_registers),
            "register_lanes": int(self.register_lanes),
        }
        if self.arith_per_mk:
            d["arith_per_mk"] = {tag: {mk: float(r) for mk, r in tab.items()}
                                 for tag, tab in self.arith_per_mk.items()}
        if self.rates_mixed:
            d["rates_mixed"] = {k: float(v)
                                for k, v in self.rates_mixed.items()}
        if self.call_costs:
            d["call_costs"] = {k: float(v) for k, v in self.call_costs.items()}
        if self.level_aliases:
            d["level_aliases"] = dict(self.level_aliases)
        if self.deployment_level or self.memory_reserved_fraction:
            mem: dict[str, Any] = {}
            if self.deployment_level:
                mem["deployment_level"] = self.deployment_level
            if self.memory_reserved_fraction:
                mem["reserved_fraction"] = float(self.memory_reserved_fraction)
            d["memory"] = mem
        if self.provenance:
            d["provenance"] = dict(self.provenance)
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "MachineSpec":
        schema = d.get("schema", SCHEMA)
        if schema != SCHEMA:
            raise SpecValidationError(
                f"unknown machine-manifest schema {schema!r} "
                f"(expected {SCHEMA!r})")
        try:
            rates = {}
            for key, rate in dict(d["transfer_rates"]).items():
                if _RATE_SEP not in key:
                    raise SpecValidationError(
                        f"bad transfer-rate key {key!r}; expected "
                        f"'ORIGIN{_RATE_SEP}DEST'")
                o, _, dst = key.partition(_RATE_SEP)
                rates[(o, dst)] = float(rate)
            spec = cls(
                name=d["name"],
                capacities={k: int(v) for k, v in d["capacities"].items()},
                transfer_rates=rates,
                arith_rate={k: float(v)
                            for k, v in dict(d["arith_rate"]).items()},
                arith_per_mk={tag: {mk: float(r)
                                    for mk, r in dict(tab).items()}
                              for tag, tab in
                              dict(d.get("arith_per_mk") or {}).items()},
                rates_mixed={k: float(v)
                             for k, v in
                             dict(d.get("rates_mixed") or {}).items()},
                call_costs={k: float(v) for k, v in
                            dict(d.get("call_costs") or {}).items()},
                reference_chunk=int(d.get("reference_chunk", 4)),
                elem_bytes=int(d.get("elem_bytes", 1)),
                num_vector_registers=int(d.get("num_vector_registers", 32)),
                register_lanes=int(d.get("register_lanes", 4)),
                levels=tuple(d.get("levels") or ()),
                level_aliases=dict(d.get("level_aliases") or {}),
                deployment_level=str(
                    dict(d.get("memory") or {}).get("deployment_level", "")),
                memory_reserved_fraction=float(
                    dict(d.get("memory") or {}).get("reserved_fraction", 0.0)),
                provenance=dict(d.get("provenance") or {}),
            )
        except (KeyError, TypeError, ValueError) as e:
            if isinstance(e, SpecValidationError):
                raise
            raise SpecValidationError(
                f"malformed machine manifest {d.get('name', '?')!r}: {e}"
            ) from e
        return spec.validate()

    def to_manifest(self, path: str) -> str:
        """Write the manifest JSON; returns the path written."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def from_manifest(cls, path: str) -> "MachineSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- derived-machine transforms ------------------------------------------

    def _derive(self, name: str | None, default_suffix: str,
                transform: Mapping[str, Any],
                **changes: Any) -> "MachineSpec":
        prov = {"base": self.name, "transform": dict(transform)}
        return dataclasses.replace(
            self, name=name or f"{self.name}{default_suffix}",
            provenance=prov, **changes)

    def scaled(self, *, arith: float = 1.0, bw: float = 1.0,
               name: str | None = None) -> "MachineSpec":
        """A hypothetical machine with every arithmetic rate scaled by
        ``arith`` and every transfer rate scaled by ``bw``."""
        if arith <= 0 or bw <= 0:
            raise ValueError("scale factors must be positive")
        return self._derive(
            name, f"+arith{arith:g}x+bw{bw:g}x",
            {"scaled": {"arith": arith, "bw": bw}},
            transfer_rates={k: r * bw for k, r in self.transfer_rates.items()},
            arith_rate={k: r * arith for k, r in self.arith_rate.items()},
            arith_per_mk={tag: {mk: r * arith for mk, r in tab.items()}
                          for tag, tab in self.arith_per_mk.items()},
            rates_mixed={k: r * arith for k, r in self.rates_mixed.items()},
        )

    def with_capacities(self, name: str | None = None,
                        **caps: int) -> "MachineSpec":
        """Override per-level capacities (bytes), e.g.
        ``spec.with_capacities(L1=32 * 1024)``."""
        unknown = set(caps) - set(self.levels)
        if unknown:
            raise KeyError(f"{self.name}: no such level(s) {sorted(unknown)}; "
                           f"have {list(self.levels)}")
        merged = dict(self.capacities)
        merged.update({k: int(v) for k, v in caps.items()})
        return self._derive(name, "+caps", {"with_capacities": dict(caps)},
                            capacities=merged)

    def with_dtype_rates(self, name: str | None = None,
                         **rates: float) -> "MachineSpec":
        """Merge entries into the per-dtype arithmetic-rate table, e.g.
        ``spec.with_dtype_rates(int4=2 * spec.arith_rate["int8"])``.
        An overridden dtype also sheds any ``arith_per_mk`` refinement it
        carried — the per-mk table was calibrated against the old rate and
        would otherwise shadow the override."""
        merged = dict(self.arith_rate)
        merged.update({k: float(v) for k, v in rates.items()})
        kept_mk = {dt: tab for dt, tab in self.arith_per_mk.items()
                   if dt not in rates}
        return self._derive(name, "+dtypes", {"with_dtype_rates": dict(rates)},
                            arith_rate=merged, arith_per_mk=kept_mk)

    def with_mixed_rates(self, rates: Mapping[str, float],
                         name: str | None = None) -> "MachineSpec":
        """Merge entries into the mixed-precision rate table, e.g.
        ``spec.with_mixed_rates({"int4xint8->int32": 2.0e10})``.  Keys are
        the ``"AxB->ACC"`` form (they contain ``->``, hence a positional
        mapping rather than keyword arguments)."""
        merged = dict(self.rates_mixed)
        merged.update({k: float(v) for k, v in rates.items()})
        return self._derive(name, "+mixed", {"with_mixed_rates": dict(rates)},
                            rates_mixed=merged).validate()

    def with_memory(self, name: str | None = None, *,
                    deployment_level: str | None = None,
                    reserved_fraction: float | None = None) -> "MachineSpec":
        """Override the deployment-memory view (see :meth:`memory_budget`),
        e.g. ``spec.with_memory(reserved_fraction=0.2)`` for a what-if with a
        fifth of the deployment level held back from serving."""
        changes: dict[str, Any] = {}
        if deployment_level is not None:
            changes["deployment_level"] = deployment_level
        if reserved_fraction is not None:
            changes["memory_reserved_fraction"] = float(reserved_fraction)
        return self._derive(name, "+mem", {"with_memory": dict(changes)},
                            **changes).validate()
