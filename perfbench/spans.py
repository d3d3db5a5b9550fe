"""The program's own spans (``repro_torch.obs``) over one cell, read on
the card: the host time each span takes, and the device and idle time
launched and passed in each.  The benchmark's result line reads none of
them; this tool runs a cell's program as its driver does and prints what
the spans say.

    python3 perfbench/spans.py --workload <cell> --seed <n> [--seconds 2]

from the root of a checkout.  It sets the cell up as its driver does
(``drivers/gemm_pass.py`` or ``drivers/train.py``: the same operands or
model and warm-up, then the one collection that ends set-up), runs three
parts back to back and prints one JSON line:

* ``plain``: ``--seconds`` of passes (``--steps`` steps) with ``obs``
  off, Python's collections timed by a hook of this module's own, which
  keeps no object (:class:`Collections`);
* ``tail``: as long with ``obs`` on and no profiler: the host time by span
  (:func:`program_record`), and the collections as the program records
  them (``python.gc`` spans);
* ``traced``: :data:`TRACE_PASSES` passes (:data:`TRACE_STEPS` steps)
  with ``obs`` on under the profiler: the device and idle time by span
  (:func:`by_span`) and the benchmark's reduction of the same events with
  the spans' ranges left out (``tracing.reduce``).

``plain`` against ``tail`` is what the spans cost while on.  Both parts
also count collections by ``gc.get_stats()``, which holds the hooks to
every collection.  Nothing is compared with a reference here.
"""
from __future__ import annotations

import argparse
import gc
import heapq
import json
import os
import sys
import time

if __name__ == "__main__":
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = _ROOT
    sys.path.insert(1, os.path.join(_ROOT, "src"))

from perfbench import harness, tracing  # noqa: E402

#: passes and steps the traced part runs (the drivers' own counts)
TRACE_PASSES = 20
TRACE_STEPS = 3
#: the spans each driver's traced part is read by (:func:`by_span`)
PREFIXES = {"gemm_pass": ("gemm.", "python.gc"),
            "train": ("train.", "python.gc")}
#: the key of :func:`by_span` for device work launched, and idle time
#: passed, in no program span
NO_SPAN = "(none)"
GC = "python.gc"


class Collections:
    """Python's collections over a part: from ``gc.get_stats()``, their
    count by generation (``stats``); with ``hook``, also from a
    ``gc.callbacks`` hook that keeps no object, their count and seconds by
    generation (``hooked``)."""

    def __init__(self, hook: bool = True):
        self.hook = hook
        self.hooked = {}
        self._t0 = None

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        if self._t0 is None:
            return
        g = str(info["generation"])
        n, s = self.hooked.get(g, (0, 0.0))
        self.hooked[g] = (n + 1, s + time.perf_counter() - self._t0)
        self._t0 = None

    def __enter__(self):
        self._stats = gc.get_stats()
        if self.hook:
            gc.callbacks.append(self._on)
        return self

    def __exit__(self, *exc):
        if self.hook:
            gc.callbacks.remove(self._on)
        after = gc.get_stats()
        self.stats = {str(g): a["collections"] - b["collections"]
                      for g, (a, b) in enumerate(zip(after, self._stats))
                      if a["collections"] > b["collections"]}
        return False

    def record(self) -> dict:
        out = {"stats": self.stats}
        if self.hook:
            out["count"] = {g: n for g, (n, _) in self.hooked.items()}
            out["seconds"] = sum(s for _, s in self.hooked.values())
        return out


class Spans:
    """``obs`` cleared and on over a part; at exit off, its spans read
    (:attr:`names`; :attr:`record`, :func:`program_record`) and cleared,
    so that nothing after it runs with spans on."""

    def __enter__(self):
        from repro_torch import obs
        self.obs = obs
        obs.clear()
        obs.enable()
        return self

    def __exit__(self, *exc):
        self.obs.disable()
        spans = self.obs.recorder.spans
        self.names = {s.name for s in spans}
        self.record = program_record(spans)
        self.obs.clear()
        return False


def program_record(spans) -> dict:
    """``{"spans": {name: {"count", "seconds", "self_s", "gc_s"}}, "gc":
    {"count": {generation: n}, "seconds"}}`` over ``obs``'s closed spans:
    for each name, its spans' host seconds, those less their direct
    children's (``self_s``), and the seconds of the ``python.gc`` spans
    anywhere under them (``gc_s``), so that a collection is counted
    once, in ``gc``, and not in the layer it fell in."""
    by_sid = {s.sid: s for s in spans}
    out: dict[str, dict] = {}
    gc_count: dict[str, int] = {}

    def entry(name):
        return out.setdefault(name, {"count": 0, "seconds": 0.0,
                                     "self_s": 0.0, "gc_s": 0.0})

    for s in spans:
        if s.t1 is None:
            continue
        d, secs = entry(s.name), s.t1 - s.t0
        d["count"] += 1
        d["seconds"] += secs
        d["self_s"] += secs
        parent = by_sid.get(s.parent)
        if parent is not None:
            entry(parent.name)["self_s"] -= secs
        if s.name == GC:
            g = str(s.attrs.get("generation"))
            gc_count[g] = gc_count.get(g, 0) + 1
            while parent is not None:
                entry(parent.name)["gc_s"] += secs
                parent = by_sid.get(parent.parent)
    return {"spans": out,
            "gc": {"count": gc_count,
                   "seconds": out.get(GC, {}).get("seconds", 0.0)}}


def idle_gaps(busy, w0: int, w1: int) -> list[tuple[int, int]]:
    """The gaps of ``[w0, w1)`` between the sorted, disjoint ``busy``
    intervals."""
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    return gaps


def _launch_times(events, prefixes, skip):
    """``(spans, device ops, window)``: the program's spans (host ranges
    named with one of ``prefixes``: ``(start, end, name)``), and each of
    the window's device operations as ``(start, duration, launch)``, its
    launch the start of the CUDA runtime or driver call with its
    correlation id (None where the trace holds none).  Device operations
    named with ``prefixes``, in ``skip`` or by the benchmark's ranges are
    the ranges' mirrors on the device's timeline, not work."""
    w0, w1 = tracing._window(events)
    prefixes, skip = tuple(prefixes), set(skip)
    spans, dev, calls = [], [], {}
    for e in events:
        name, s = e.name(), tracing._start(e)
        if tracing._on_device(e):
            d = tracing._duration(e)
            if not (name.startswith(tracing.RANGE)
                    or name.startswith(prefixes) or name in skip) \
                    and s + d > w0 and s < w1:
                dev.append((s, d, e.correlation_id()))
        elif name.startswith("cu"):
            # the runtime's and driver's calls share the device's
            # correlation ids (other host operations number apart)
            calls[e.correlation_id()] = s
        elif name.startswith(prefixes):
            spans.append((s, s + tracing._duration(e), name))
    return spans, [(s, d, calls.get(c)) for s, d, c in dev], (w0, w1)


def _innermost(spans, times) -> list:
    """For each of ``times`` (sorted), the name of the latest-started of
    ``spans`` running at it (``start <= t < end``, on any thread), or
    None."""
    order = sorted(spans)
    live: list = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            s, e, name = order[i]
            heapq.heappush(live, (-s, e, name))
            i += 1
        while live and live[0][1] <= t:
            heapq.heappop(live)
        out.append(live[0][2] if live else None)
    return out


def by_span(events, prefixes, skip=()) -> dict:
    """``{span name: {"device_s", "idle_s", "device_ops"}}`` over the
    window of a :class:`tracing.Trace`: ``device_s`` sums the device
    operations whose launch falls in the innermost program span (a host
    range named with one of ``prefixes``, from ``obs``'s mirroring)
    enclosing it, on any host thread; ``idle_s`` the device-idle gaps
    whose midpoint lies in that span, with no look-back limit.  What lies
    in no span, or whose launch the trace does not hold, is under
    :data:`NO_SPAN`.  ``skip`` names the program's other spans, whose
    device-side mirrors are no work."""
    spans, launched, (w0, w1) = _launch_times(events, prefixes, skip)
    out: dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name if name is not None else NO_SPAN,
                              {"device_s": 0.0, "idle_s": 0.0,
                               "device_ops": 0})

    # the launches found in time order, then those the trace lacks
    launched.sort(key=lambda r: (r[2] is None, r[2] or 0))
    found = [r[2] for r in launched if r[2] is not None]
    names = _innermost(spans, found) + [None] * (len(launched) - len(found))
    for (_, d, _), name in zip(launched, names):
        row = entry(name)
        row["device_s"] += d * 1e-9
        row["device_ops"] += 1
    gaps = idle_gaps(tracing.merge([(max(s, w0), min(s + d, w1))
                                    for s, d, _ in launched]), w0, w1)
    mids = [(s + e) // 2 for s, e in gaps]
    for (s, e), name in zip(gaps, _innermost(spans, mids)):
        entry(name)["idle_s"] += (e - s) * 1e-9
    return out


def traced_record(tr, spans, kind: str) -> dict:
    """The traced part's record: the benchmark's reduction of its events
    without the spans' ranges, and :func:`by_span` of them."""
    red = tracing.reduce([e for e in tr.events
                          if e.name() not in spans.names])
    red["spans"] = by_span(tr.events, PREFIXES[kind], spans.names)
    return red


def _gemm_cell(ctx) -> dict:
    """The GEMM pass's parts: ``ctx.seconds`` of passes each, the traced
    part :data:`TRACE_PASSES`."""
    from perfbench.drivers import gemm_pass as G
    traffic = ctx.cell.traffic
    products = G.resolve(ctx.cell.config, traffic["tokens"])
    seq = G.order(products)
    inputs, weights = G.make_operands(products, traffic["dtype"], ctx.seed,
                                      ctx.device)
    marks = G.Marks(ctx.device)
    t = time.perf_counter()
    held = [G.run_pass(products, inputs, weights, seq)]
    marks.sync()
    while True:
        outs = G.run_pass(products, inputs, weights, seq)
        marks.sync()
        if time.perf_counter() - t >= traffic["warmup_seconds"]:
            break
    del outs
    harness.end_setup()

    def part(seconds, passes=None) -> dict:
        # each part's first pass lets go of the last one's outputs, as the
        # driver's window does of the warm-up's
        rec, _, last = G.window(products, inputs, weights, seq, seconds,
                                traffic["inflight_passes"], -1, held,
                                marks, passes=passes)
        held.append(last)
        calls = rec["passes"] * len(seq)
        return {"passes": rec["passes"], "calls": calls,
                "wall_s": rec["wall_s"],
                "host_us_per_call": 1e6 * sum(rec["enqueue_s"]) / calls}

    return _parts("gemm_pass", lambda: part(ctx.seconds),
                  lambda: part(0.0, TRACE_PASSES))


def _train_cell(ctx, steps: int) -> dict:
    """The training step's parts: ``steps`` steps each, the traced part
    :data:`TRACE_STEPS`."""
    import torch

    from perfbench.drivers import train as T
    traffic = ctx.cell.traffic
    prog = T.Program(ctx)
    n_check = traffic["check_steps"]
    batches = T.make_batches(prog.a, traffic, ctx.seed, ctx.device,
                             n_check + traffic["window_batches"])
    for batch in batches[:n_check]:
        prog.step(batch)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    harness.end_setup()
    pool, done = batches[n_check:], [0]

    def part(n) -> dict:
        t0 = time.perf_counter()
        for _ in range(n):
            with torch.profiler.record_function("perfbench.step"):
                prog.step(pool[done[0] % len(pool)])
            done[0] += 1
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"steps": n, "wall_s": wall, "step_s": wall / n}

    return _parts("train", lambda: part(steps),
                  lambda: part(TRACE_STEPS))


def _parts(kind: str, plain_part, traced_part) -> dict:
    """``plain``, ``tail`` and ``traced``, in that order (see the module's
    docstring)."""
    with Collections() as col:
        plain = plain_part()
    plain["gc"] = col.record()
    with Collections(hook=False) as col, Spans() as spans:
        tail = plain_part()
    tail.update(spans.record)
    tail["gc"]["stats"] = col.record()["stats"]
    with Spans() as spans, tracing.Trace() as tr:
        traced = traced_part()
    traced.update(traced_record(tr, spans, kind))
    return {"plain": plain, "tail": tail, "traced": traced}


def run(cell, seed: int, seconds: float, steps: int, device) -> dict:
    """The three parts of ``cell`` on ``device`` (see the module's
    docstring)."""
    ctx = harness.Context(cell, seed, seconds, True, device,
                          time.perf_counter())
    out = _train_cell(ctx, steps) if cell.traffic["driver"] == "train" \
        else _gemm_cell(ctx)
    out.update(workload=cell.name, seed=seed,
               device=harness.device_info(device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read the program's spans "
                                 "over one cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="seconds of passes in each of plain and tail")
    ap.add_argument("--steps", type=int, default=6,
                    help="training steps in each of plain and tail")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("perfbench.spans: no CUDA device on this host",
              file=sys.stderr)
        return 2
    out = run(harness.load_cell(args.workload), args.seed, args.seconds,
              args.steps, torch.device("cuda", 0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
