"""The harness: finds a cell's parts by name, runs its driver, judges the
outputs against the cell's limits and prints the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's published sizes and, for a GEMM
  pass, its frozen product list;
* ``traffic/<traffic>.json``: the driver kind (``drivers/<kind>.py``) and
  its parameters;
* ``metrics/<metric>.py``: a reader ``read(rec)`` of one per-layer metric
  from what the traced run recorded; it returns None where there is
  nothing to read;
* ``limits/<workload>.json``: each number the comparison with the plain
  reference (``reference/``) gives, with its limit.

A driver's ``run(ctx)`` sets up, measures the window, reads the device's
peak memory, frees the program's state and compares; it returns
``{"e2e", "rec", "checks", "attempted", "failed", "device"}``.  With
``--trace 1`` it runs the same untraced window as a run without it (what
the host-clock metrics read) and then a few more passes or steps under
the profiler (what the device-side metrics read), so that the profiler's
own host cost moves no number read on the host clock.

Set-up ends with one collection of Python's garbage (:func:`end_setup`),
so that the window does not inherit set-up's garbage cycles and the device
memory they hold; the window's own collections are left to Python, as in
a user's process (nothing is frozen).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run's process: the
#: JAX package and JAX itself (compared whole: the port's name begins with
#: the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload with its parts loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if metric_applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if metric_applies(m, name)])


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def metric_reader(name: str):
    """``read(rec)`` of ``metrics/<name>.py`` (the file's name is the
    metric's, dots and all, so it is loaded by path)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    process's loaded modules)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, and
    the process's start on the host clock (set-up runs from it)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    #: seconds from the process's start at the end of each part of set-up
    #: (:meth:`mark`), printed on standard error before the checks
    phases: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        self.phases[name] = time.perf_counter() - self.t_start


def end_setup() -> None:
    """The last act of a run's set-up: collect the garbage that set-up
    left (cycles among its objects can hold device memory that the window
    would otherwise allocate anew)."""
    gc.collect()


def worst(values) -> float:
    """The largest of ``values`` (0 for none), where a NaN counts as the
    worst of all (``inf``): Python's ``max`` keeps its first argument when
    the second is NaN, so it would drop a NaN that is not first."""
    out = 0.0
    for v in values:
        v = float(v)
        if math.isnan(v):
            return math.inf
        out = max(out, v)
    return out


def over_limits(checks: dict, limits: dict) -> bool:
    """Whether any of ``checks`` that the limits hold is over its limit
    (or not a number)."""
    return any(not v <= limits["checks"][k]["limit"]
               for k, v in checks.items() if k in limits["checks"])


def device_info(device) -> dict:
    """The result line's ``device``: the card's name, the count used, the
    peak of allocated memory since the window began, and the power limit
    ``nvidia-smi`` reads."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
            "power_limit": smi_power_limit()}


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number the cell's
    limits name has to be at or under its limit (a number that is missing
    or not finite fails)."""
    out, ok = {}, True
    for name, spec in limits["checks"].items():
        v = checks.get(name)
        finite = v is not None and math.isfinite(v)
        ok = ok and finite and v <= spec["limit"]
        # a number that is not finite is printed as text, so that the
        # result line stays strict JSON
        out[name] = {"value": v if finite or v is None else str(v),
                     "limit": spec["limit"]}
    return ok, out


def smi_power_limit() -> str | None:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        and r.stdout.strip() else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, phases: dict | None = None) -> dict:
    """Drive one run of ``cell`` on ``device`` and build its result line
    (without the device check, which :func:`main` makes); ``phases``, when
    given, receives the times at which set-up's parts ended."""
    ctx = Context(cell, seed, seconds, trace, device, t_start,
                  {} if phases is None else phases)
    out = driver(cell.traffic["driver"]).run(ctx)
    correct, checks = judge(out["checks"], cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(out["rec"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace:
        line["breakdown"] = out["rec"]["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this host has {have}", file=sys.stderr)
        return 2
    phases: dict = {}
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t_start, phases)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run's process holds {bad}: the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 phases.items()), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
