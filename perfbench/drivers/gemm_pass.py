"""Driver ``gemm_pass``: a network's planned GEMMs, back to back.

One pass runs the configuration's frozen product list at the traffic's
token count: each layer's products in order, layer after layer, then the
products that run once (the tied logits head).  Dense products go through
``repro_torch.gemm.matmul`` (plan on the Hopper tile model, then the
kernel), grouped ones through ``repro_torch.gemm.grouped_matmul``.  Each
layer has weights of its own, made on the device from the seed in one
call a dtype; a product's input activations are shared by the layers.

The window enqueues passes while at most ``inflight_passes`` are on the
device, and records a CUDA event at every pass boundary: a pass's time runs
from the event before it to the event after it, so a host stall that
starves the card lengthens the pass it falls in.  After the window the
outputs of the last pass and of one earlier pass drawn from the seed are
compared with the plain reference (``reference/gemm.py``).

A traced run runs the same untraced window and then goes on for
:data:`TRACE_PASSES` more passes under the profiler: device time, kernels
and idle gaps come from the traced passes, host-clock numbers from the
window.  Its last compared pass is the last traced one.
"""
from __future__ import annotations

import random
import time

import torch

from perfbench import faults, harness, roofline
from perfbench.reference import gemm as ref
from perfbench.tracing import Trace

DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
#: passes a traced run traces after its window
TRACE_PASSES = 20
FAULTS = faults.GEMM_FAULTS
fault = faults.gemm_fault


def resolve(config: dict, tokens: int) -> list[dict]:
    """The frozen product list at ``tokens``: each entry's rows are the
    tokens, or (``"rows": "routed"``) the tokens a routed expert sees,
    ``tokens * experts_per_token // experts`` (at least one)."""
    out = []
    for p in config["products"]:
        q = {k: v for k, v in p.items() if k != "rows"}
        if p["rows"] == "routed":
            q["m"] = max(1, tokens * config["num_experts_per_tok"]
                         // config["num_local_experts"])
        else:
            q["m"] = tokens
        out.append(q)
    return out


def order(products: list[dict]) -> list[tuple[int, int]]:
    """(product index, its layer) in the order a pass calls them: the
    products that every layer runs, layer by layer, then the others."""
    layers = max(p["count"] for p in products)
    seq = [(j, i) for i in range(layers)
           for j, p in enumerate(products) if p["count"] == layers]
    seq += [(j, i) for j, p in enumerate(products) if p["count"] < layers
            for i in range(p["count"])]
    return seq


def _draw(gen, numel: int, dtype: str, device):
    if dtype == "int8":
        return torch.randint(-127, 128, (numel,), generator=gen,
                             dtype=torch.int8, device=device)
    return torch.randn((numel,), generator=gen, dtype=DTYPES[dtype],
                       device=device)


def _b_numel(p: dict) -> int:
    return p.get("groups", 1) * p["k"] * p["n"]


def make_operands(products: list[dict], dtype: str, seed: int, device):
    """``(inputs, weights)``: one input a product, ``count`` weights a
    product (bf16: normal, B at a weight's init scale K^-1/2; int8: uniform
    over [-127, 127]).  A tied head's B is the ``.t()`` of a row-major
    (n, k) table, as the model hands it."""
    gen = torch.Generator(device).manual_seed(seed)
    a_numel = [p.get("groups", 1) * p["m"] * p["k"] for p in products]
    b_numel = [p["count"] * _b_numel(p) for p in products]
    flat_a = _draw(gen, sum(a_numel), dtype, device)
    flat_b = _draw(gen, sum(b_numel), dtype, device)
    inputs, weights, ia, ib = [], [], 0, 0
    for p, na, nb in zip(products, a_numel, b_numel):
        g = p.get("groups", 1)
        shape_a = (g, p["m"], p["k"]) if "groups" in p else (p["m"], p["k"])
        inputs.append(flat_a[ia:ia + na].view(shape_a))
        region = flat_b[ib:ib + nb]
        if dtype != "int8":
            region.mul_(p["k"] ** -0.5)
        per = _b_numel(p)
        ws = []
        for i in range(p["count"]):
            w = region[i * per:(i + 1) * per]
            if "groups" in p:
                ws.append(w.view(g, p["k"], p["n"]))
            elif p.get("layout") == "tied":
                ws.append(w.view(p["n"], p["k"]).t())
            else:
                ws.append(w.view(p["k"], p["n"]))
        weights.append(ws)
        ia, ib = ia + na, ib + nb
    return inputs, weights


def run_pass(products, inputs, weights, seq):
    from repro_torch import gemm
    outs = []
    for j, i in seq:
        if "groups" in products[j]:
            outs.append(gemm.grouped_matmul(inputs[j], weights[j][i]))
        else:
            outs.append(gemm.matmul(inputs[j], weights[j][i]))
    return outs


class Marks:
    """Pass boundaries: CUDA events on the card, the host clock (after the
    synchronous CPU kernels) on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if self.cuda else b - a

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def window(products, inputs, weights, seq, seconds: float, inflight: int,
           keep: int, held: list, marks: Marks, passes: int | None = None):
    """Passes back to back for ``seconds`` (or, given, ``passes`` of
    them); returns the window's record and the outputs of pass ``keep``
    and of the last pass.  ``held`` (a list holding outputs made before,
    which stand in for the kept pass; the only reference to them) is
    emptied when pass ``keep`` is taken (with no pass to keep, when the
    first pass is done), so that no pass of the window allocates more
    than the warm-up did."""
    marks.sync()
    t0 = time.perf_counter()
    bounds = [marks.mark()]
    enqueue, kept, outs = [], None, None
    while True:
        if len(bounds) > inflight:
            marks.wait(bounds[-1 - inflight])
        t = time.perf_counter()
        with torch.profiler.record_function("perfbench.pass"):
            outs = run_pass(products, inputs, weights, seq)
        enqueue.append(time.perf_counter() - t)
        bounds.append(marks.mark())
        if len(enqueue) - 1 == keep:
            kept = outs
            held.clear()
        elif keep < 0:
            held.clear()
        if len(enqueue) == passes or passes is None \
                and time.perf_counter() - t0 >= seconds:
            break
    marks.sync()
    wall = time.perf_counter() - t0
    passes = len(enqueue)
    pass_s = [marks.seconds(a, b) for a, b in zip(bounds, bounds[1:])]
    rec = {"passes": passes, "wall_s": wall, "pass_s": pass_s,
           "enqueue_s": enqueue, "calls_per_pass": len(seq)}
    return rec, (kept if kept is not None else outs), outs


def p95(xs: list[float]) -> float:
    """The 95th percentile (linear between closest ranks)."""
    s = sorted(xs)
    pos = 0.95 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def plan_record(products, dtype: str, inputs, weights, device) -> list:
    """For each dense product: the tile the planner picks (on the
    machine the kernels plan on), that tile's predicted seconds on the
    fitted ``h100-measured`` machine, and the device seconds of the pick
    and of the planner's next two ranked tiles (CUDA events, in turns)."""
    from repro_torch import gemm
    from repro_torch.core import hopper_model
    from repro_torch.machines import resolve as machine

    h100 = machine("h100")
    out = []
    for j, p in enumerate(products):
        if "groups" in p:
            continue
        shape = (p["m"], p["n"], p["k"])
        pick = gemm.plan(shape, backend="cuda", dtype=dtype)
        pred = gemm.plan(shape, backend="cuda", dtype=dtype,
                         machine="h100-measured",
                         tile=pick.selection).predicted_seconds
        gshape = pick.problem.as_shape()
        ranked = sorted(hopper_model.lattice(dtype),
                        key=lambda t: hopper_model.estimate(gshape, t,
                                                            h100).total)
        a, b = inputs[j], weights[j][0]
        tiles, secs = [pick.selection], []
        for t in ranked:
            if len(tiles) == 3:
                break
            if t == pick.selection:
                continue
            try:
                gemm.plan(shape, backend="cuda", dtype=dtype,
                          tile=t).execute(a, b)
            except ValueError:
                continue
            tiles.append(t)
        secs = tile_seconds(shape, dtype, tiles, a, b, device)
        out.append({"name": p["name"], "m": p["m"], "n": p["n"],
                    "k": p["k"], "count": p["count"],
                    "tile": str(pick.selection), "pred_measured_s": pred,
                    "tiles": [str(t) for t in tiles], "tile_s": secs})
    return out


def tile_seconds(shape, dtype, tiles, a, b, device, rounds: int = 3,
                 min_s: float = 0.02) -> list[float]:
    """Device seconds of one product at each tile: ``rounds`` turns over
    the tiles, each a run of calls between CUDA events lasting at least
    ``min_s``; the least turn of each tile."""
    from repro_torch import gemm
    marks = Marks(device)
    plans = [gemm.plan(shape, backend="cuda", dtype=dtype, tile=t)
             for t in tiles]
    best = [float("inf")] * len(tiles)
    reps = None
    for _ in range(rounds):
        for i, pl in enumerate(plans):
            pl.execute(a, b)
            if reps is None:
                s = marks.mark()
                pl.execute(a, b)
                e = marks.mark()
                marks.sync()
                reps = max(1, int(min_s / max(marks.seconds(s, e), 1e-6)))
            s = marks.mark()
            for _ in range(reps):
                pl.execute(a, b)
            e = marks.mark()
            marks.sync()
            best[i] = min(best[i], marks.seconds(s, e) / reps)
    return best


def compare_outputs(seq, inputs, weights, outs, dtype) -> dict:
    """The worst of each number over one pass's outputs (``outs`` in
    ``seq``'s order; any iterable)."""
    got: dict[str, list] = {}
    for (j, i), out in zip(seq, outs):
        for name, v in ref.compare(out, inputs[j], weights[j][i],
                                   dtype).items():
            got.setdefault(name, []).append(v)
    return {name: harness.worst(vs) for name, vs in got.items()}


def run(ctx) -> dict:
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dtype, tokens = traffic["dtype"], traffic["tokens"]
    inflight = traffic["inflight_passes"]
    products = resolve(cfg, tokens)
    seq = order(products)
    from repro_torch import gemm  # noqa: F401  (its import is set-up)
    ctx.mark("imports")
    inputs, weights = make_operands(products, dtype, ctx.seed, ctx.device)
    marks = Marks(ctx.device)
    marks.sync()
    ctx.mark("operands")
    # every shape, the card's clocks up to speed, and the allocator holding
    # what the window will: one pass kept, and each pass's outputs alive
    # while the next one allocates its own
    t = time.perf_counter()
    held = [run_pass(products, inputs, weights, seq)]
    marks.sync()
    ctx.mark("first_pass")
    outs = None
    while True:
        outs = run_pass(products, inputs, weights, seq)
        marks.sync()
        if time.perf_counter() - t >= traffic["warmup_seconds"]:
            break
    del outs
    keep = random.Random(ctx.seed).randrange(traffic["sample_passes"])
    harness.end_setup()
    ctx.mark("warm_up")
    setup_s = time.perf_counter() - ctx.t_start
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    rec, kept, last = window(products, inputs, weights, seq, ctx.seconds,
                             inflight, keep, held, marks)
    ops = roofline.pass_ops(products)
    device = harness.device_info(ctx.device)
    e2e = {"gemm_tops": rec["passes"] * ops / rec["wall_s"] / 1e12,
           "gemm_pass_p95_ms": 1e3 * p95(rec["pass_s"]),
           "setup_s": setup_s}
    rec.update(kind="gemm_pass", dtype=dtype, products=products,
               ops_per_pass=ops)
    if ctx.trace:
        # the window's last outputs are let go of after the first traced
        # pass, so that the traced passes allocate no more than the window
        held = [last]
        del last
        with Trace() as tr:
            traced, _, last = window(products, inputs, weights, seq, 0.0,
                                     inflight, -1, held, marks,
                                     passes=TRACE_PASSES)
        red = tr.reduce()
        device["busy_s"], device["window_s"] = red["busy_s"], red["window_s"]
        rec["trace"] = red
        rec["traced_passes"] = traced["passes"]
        rec["breakdown"] = {"device_ops": red["device_ops"],
                            "idle_gaps": red["idle_gaps"]}
        rec["plan"] = plan_record(products, dtype, inputs, weights,
                                  ctx.device)
    checks, failed = {}, 0
    for outs in (kept, last):
        got = compare_outputs(seq, inputs, weights, outs, dtype)
        failed += harness.over_limits(got, ctx.cell.limits)
        for k, v in got.items():
            checks[k] = harness.worst([checks.get(k, 0.0), v])
    return {"e2e": e2e, "rec": rec, "checks": checks,
            "attempted": rec["passes"], "failed": failed, "device": device}


def control_checks(ctx) -> dict:
    """The comparison's numbers with the control (``reference/gemm.py``)
    in the program's place, on the run's own operands: every product of
    one pass."""
    traffic = ctx.cell.traffic
    dtype = traffic["dtype"]
    products = resolve(ctx.cell.config, traffic["tokens"])
    seq = order(products)
    inputs, weights = make_operands(products, dtype, ctx.seed, ctx.device)
    return compare_outputs(seq, inputs, weights,
                           (ref.control_output(inputs[j], weights[j][i],
                                               dtype) for j, i in seq),
                           dtype)
