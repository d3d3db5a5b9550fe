"""The machine registry: zoo manifests + runtime registration + globs.

The zoo (``repro/machines/zoo/*.json``) is loaded lazily on first access;
every manifest becomes a registered :class:`MachineSpec`.  Calibrated or
derived machines register at runtime (``register``), names can be aliased
(``alias``), and consumers resolve machines by name, by spec object, or by
glob patterns — ``"zoo/*"`` matches every manifest-backed machine,
``"gap*"`` fnmatch-globs all registered names.

Glob expansion is deterministic: patterns always expand over the *sorted*
registry, so repeated sweeps over the same registry contents return rows in
the same order.  Generated machines (``repro.design``) register under a
literal ``gen/`` name prefix — ``"gen/*"`` globs them like any other
pattern, and ``unregister_prefix("gen/")`` bulk-drops them for test/CLI
cleanup.
"""
from __future__ import annotations

import fnmatch
import glob as _glob
import os
from typing import Iterable

from repro_torch.machines.spec import MachineSpec

_REGISTRY: dict[str, MachineSpec] = {}
_ALIASES: dict[str, str] = {}
_SOURCES: dict[str, str] = {}       # name -> "zoo" | "runtime" | "calibrated"
_GLOB_CHARS = ("*", "?", "[")
_zoo_loaded = False


def zoo_dir() -> str:
    """The built-in manifest directory."""
    return os.path.join(os.path.dirname(__file__), "zoo")


def _ensure_zoo() -> None:
    global _zoo_loaded
    if not _zoo_loaded:
        _zoo_loaded = True
        load_zoo()


def load_zoo(directory: str | None = None, *,
             source: str = "zoo") -> list[str]:
    """Register every ``*.json`` manifest in ``directory`` (default: the
    built-in zoo).  Returns the registered names, manifest-path order."""
    global _zoo_loaded
    directory = directory or zoo_dir()
    if os.path.abspath(directory) != os.path.abspath(zoo_dir()):
        # a custom manifest dir *adds to* the registry; it must not stand in
        # for the built-in zoo, which still loads (once) underneath it.
        _ensure_zoo()
    _zoo_loaded = True
    names = []
    for path in sorted(_glob.glob(os.path.join(directory, "*.json"))):
        spec = MachineSpec.from_manifest(path)
        register(spec, overwrite=True, source=source)
        names.append(spec.name)
    return names


def register(spec: MachineSpec, *, overwrite: bool = False,
             source: str = "runtime") -> MachineSpec:
    """Validate + register a spec under its name."""
    _ensure_zoo()
    spec.validate()
    if spec.name in _ALIASES:
        raise ValueError(f"machine name {spec.name!r} is taken by an alias "
                         f"for {_ALIASES[spec.name]!r}")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"machine {spec.name!r} already registered; pass "
                         f"overwrite=True to replace it")
    _REGISTRY[spec.name] = spec
    _SOURCES[spec.name] = source
    return spec


def unregister(name: str) -> None:
    """Drop a machine (and any aliases pointing at it)."""
    _ensure_zoo()
    _REGISTRY.pop(name, None)
    _SOURCES.pop(name, None)
    for a, target in list(_ALIASES.items()):
        if a == name or target == name:
            del _ALIASES[a]


def unregister_prefix(prefix: str) -> list[str]:
    """Drop every registered machine whose name starts with ``prefix``
    (and any aliases pointing at one).  Returns the dropped names, sorted.

    The canonical use is ``unregister_prefix("gen/")`` after a generated
    design-space sweep (`repro.design`), so bulk registration never leaks
    into later sweeps or tests.
    """
    _ensure_zoo()
    if not prefix:
        raise ValueError("refusing to unregister an empty prefix (that "
                         "would drop the whole registry)")
    dropped = sorted(n for n in _REGISTRY if n.startswith(prefix))
    for name in dropped:
        unregister(name)
    return dropped


def get(name: str) -> MachineSpec:
    """Look a machine up by name (alias-aware)."""
    _ensure_zoo()
    name = _ALIASES.get(name, name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown machine {name!r}; registered: "
                       f"{list_machines()}") from None


def alias(name: str, target: str) -> None:
    """Make ``name`` resolve to the registered machine ``target``."""
    _ensure_zoo()
    if name in _REGISTRY:
        raise ValueError(f"alias {name!r} would shadow a registered machine")
    get(target)                     # must exist (and resolves chains eagerly)
    _ALIASES[name] = _ALIASES.get(target, target)


def list_machines(pattern: str | None = None) -> list[str]:
    """Registered machine names, optionally filtered by a glob pattern.
    ``"zoo/<glob>"`` (or bare ``"zoo/*"``) restricts to manifest-backed
    machines; any other pattern fnmatch-globs all names."""
    _ensure_zoo()
    names = sorted(_REGISTRY)
    if pattern is None:
        return names
    if pattern == "zoo" or pattern.startswith("zoo/"):
        sub = pattern[4:] or "*"
        return [n for n in names
                if _SOURCES.get(n) == "zoo" and fnmatch.fnmatch(n, sub)]
    return [n for n in names if fnmatch.fnmatch(n, pattern)]


def expand(entry) -> list:
    """Expand one machines-axis entry for ``repro.gemm.sweep``: a
    :class:`MachineSpec` or None passes through, a glob pattern expands to
    the matching registered names, a plain name is validated and
    canonicalized (aliases resolve)."""
    if entry is None or isinstance(entry, MachineSpec):
        return [entry]
    if not isinstance(entry, str):
        raise TypeError(f"cannot interpret {entry!r} as a machine; pass a "
                        f"name, a MachineSpec, or a glob pattern")
    if entry.startswith("zoo/") or any(c in entry for c in _GLOB_CHARS):
        names = list_machines(entry)
        if not names:
            raise KeyError(f"machine pattern {entry!r} matched nothing; "
                           f"registered: {list_machines()}")
        return names
    return [get(entry).name]


def expand_many(entries: Iterable | str | MachineSpec | None) -> list:
    """Expand a machines axis (None, a single entry, or a sequence)."""
    if entries is None:
        return [None]
    if isinstance(entries, (str, MachineSpec)):
        entries = [entries]
    out: list = []
    for e in entries:
        out.extend(expand(e))
    return out


def resolve(machine, default: str | None = None) -> MachineSpec:
    """Resolve a machine argument (name | spec | None-with-default) to a
    :class:`MachineSpec`."""
    if machine is None:
        if default is None:
            raise ValueError("no machine given and no default to fall back "
                             "to")
        machine = default
    if isinstance(machine, MachineSpec):
        return machine
    return get(machine)


def source_of(name: str) -> str | None:
    """Where a registered machine came from ("zoo" | "runtime" |
    "calibrated"), or None if unknown."""
    _ensure_zoo()
    return _SOURCES.get(_ALIASES.get(name, name))
