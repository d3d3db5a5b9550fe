#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one sm_90 card and the
CUDA toolkit.  It imports only ``repro_torch`` (from ``src/``), never JAX or
the JAX package, and raises on the first failed check, so any failure exits
non-zero.  Phases:

1. build   — compile ``src/repro_torch/kernels/csrc/gemm.cu`` for sm_90a
             (one nvcc per element type, in parallel); print build seconds,
             register use and the card's name and power limit.
2. kernels — both loop orders against their plain PyTorch versions on the
             card: every tile the planner picks for the slice's shapes, in
             bf16, f32 and int8, on a divisible and a ragged shape; plus the
             bf16 finding that k-outer's per-pass rounding costs more than
             twice k-inner's error.
3. main    — the Qwen2-1.5B GEMMs at tokens=4096, planned on ``cuda`` for
             ``h100`` and executed (k-inner, then pinned to k-outer with the
             same tile), each checked against its plain version.
4. loop    — ``measure.run_campaign`` (Table-2 and the Qwen2-1.5B shapes, in
             int8 and bf16) -> ``fit_from_store`` -> ``validate_spec``, plus
             k-outer Qwen samples held out of the fit.
5. timing  — each kernel at the Qwen2-1.5B shapes with CUDA events, beside
             its plain version, ``torch.matmul`` and its roofline bound.

Launch counters are zeroed just before phase 3 and read just after phase 4
(the main path); both kernels must have launched.  The line before the last
is the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.  Samples, the fitted manifest and the
per-shape timings are written under ``--out``
(default ``build/chip_smoke``).

Tolerances (kernel vs plain version, same inputs, on the card):
int8 exact; f32 rtol 1e-5 / atol 1e-4 (FP32 FMA vs cuBLAS FP32, no TF32);
bf16 k-inner rtol = atol = 2e-2 (both sum in f32 and round once; the sum
order differs); bf16 k-outer one bf16 ulp of the running |C| per pass (each
pass rounds C to bf16, and a different f32 sum order can cross a rounding
boundary once per pass).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM data sheet, dense: the roofline bound's rates.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4, "int8": 1}


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def bf16_ulp(x):
    import torch
    x = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def k_outer_peak(a, b, c, bk):
    """Per element, the largest |C| any pass of the streamed product holds
    (the scale of the per-pass bf16 ulp)."""
    import torch
    peak = c.float().abs()
    acc = c.float()
    for k0 in range(0, a.shape[1], bk):
        acc = (acc + a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float())
        acc = acc.to(c.dtype).float()
        peak = torch.maximum(peak, acc.abs())
    return peak


def compare(order, tag, got, want, *, passes=1, peak=None):
    """Max |got - want|; raises when it is outside the stated tolerance."""
    import torch
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
          f"{order}/{tag}: got {tuple(got.shape)} {got.dtype}, want "
          f"{tuple(want.shape)} {want.dtype}")
    if tag == "int8":
        err = (got.long() - want.long()).abs().max().item()
        check(err == 0, f"{order}/int8 not exact: max err {err}")
        return float(err)
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{order}/{tag}: non-finite output")
    diff = (g - w).abs()
    if tag == "f32":
        bad = diff > 1e-4 + 1e-5 * w.abs()
    elif order == "gemm_k_inner":
        bad = diff > 2e-2 + 2e-2 * w.abs()
    else:
        bad = diff > passes * bf16_ulp(peak)
    nbad = int(bad.sum().item())
    err = float(diff.max().item())
    check(nbad == 0, f"{order}/{tag}: {nbad} elements outside tolerance "
                     f"(max abs err {err})")
    return err


def seeded(m, n, k, tag, seed, device):
    import torch
    g = torch.Generator(device).manual_seed(seed)
    if tag == "int8":
        a = torch.randint(-100, 100, (m, k), generator=g, device=device,
                          dtype=torch.int8)
        b = torch.randint(-100, 100, (k, n), generator=g, device=device,
                          dtype=torch.int8)
    else:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        a = torch.randn((m, k), generator=g, device=device, dtype=dt)
        b = torch.randn((k, n), generator=g, device=device, dtype=dt)
    return a, b


def cuda_ms(fn, min_total_ms=200.0, max_reps=50):
    """Mean ms of ``fn`` over a run of launches bracketed by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    fn()
    e.record()
    e.synchronize()
    est = max(s.elapsed_time(e), 1e-3)
    reps = max(1, min(max_reps, int(math.ceil(min_total_ms / est))))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def bound(m, n, k, tag, c_in):
    """(ms, "bytes" | "operations"): each input read once, each output
    written once, over 3.35 TB/s; 2mnk operations over the dtype's peak."""
    s = ELEM_BYTES[tag]
    out_s = 4 if tag == "int8" else s
    nbytes = (m * k + k * n) * s + m * n * out_s * (2 if c_in else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_OPS[tag]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"error: {SRC}/repro_torch not found; run chip_smoke.py from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"error: no CUDA device (torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}); the chip smoke runs on an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # the plain versions' float32 products stay full FP32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import gemm, measure
    from repro_torch.configs import get_config
    from repro_torch.core.autotune import model_gemm_shapes
    from repro_torch.core.mobilenet import TABLE2
    from repro_torch.core.tpu_model import GemmShape, GridOrder, TileConfig
    from repro_torch.gemm.api import GemmProblem
    from repro_torch.kernels import build
    from repro_torch.kernels import gemm as K
    from repro_torch.machines import resolve

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # -- phase 1 ---------------------------------------------------------
    phase(1, "build")
    t0 = time.perf_counter()
    paths = build.build()
    for v in paths:
        build.load(v)
    print(f"built {sorted(paths)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s ({build.build_dir()})")
    regs, spills = [], []
    for v in paths:
        log = build.build_log(v)
        with open(os.path.join(args.out, f"ptxas_{v}.log"), "w") as f:
            f.write(log)
        for line in log.splitlines():
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" ")[0]))
            if "spill" in line and not (" 0 bytes spill stores" in line
                                        and " 0 bytes spill loads" in line):
                spills.append(line.strip())
    print(f"ptxas: {len(regs)} kernels, registers {min(regs)}..{max(regs)}, "
          f"{len(spills)} with spills")
    print(f"device: {card}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi("name,power.limit"))

    # -- phase 2 ---------------------------------------------------------
    phase(2, "kernels vs plain versions on the card")
    qwen = get_config("qwen2-1.5b")
    picks = set()
    for d in gemm.plan_many(model_gemm_shapes(qwen, tokens=4096),
                            backend="cuda", machine="h100"):
        picks.add((d.selection.bm, d.selection.bn, d.selection.bk))
    for tag in ("int8", "bf16", "f32"):
        for d in gemm.plan_many([GemmShape(r.m, r.n, r.k, dtype=tag)
                                 for r in TABLE2],
                                backend="cuda", machine="h100"):
            picks.add((d.selection.bm, d.selection.bn, d.selection.bk))
    picks = sorted(picks)
    print(f"planner tiles for the slice: {picks}")
    shapes = [(512, 512, 512), (300, 520, 390)]
    checked = 0
    for i, (bm, bn, bk) in enumerate(picks):
        for tag in ("int8", "bf16", "f32"):
            for (m, n, k) in shapes:
                a, b = seeded(m, n, k, tag, 100 + i, dev)
                c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype),
                                 device=dev)
                ti = TileConfig(bm, bn, bk, GridOrder.K_INNER)
                to = TileConfig(bm, bn, bk, GridOrder.K_OUTER)
                compare("gemm_k_inner", tag, K.gemm_k_inner(a, b, tile=ti),
                        K.gemm_k_inner_plain(a, b))
                passes = -(-k // bk)
                compare("gemm_k_outer", tag, K.gemm_k_outer(a, b, c0, tile=to),
                        K.gemm_k_outer_plain(a, b, c0, bk=bk), passes=passes,
                        peak=k_outer_peak(a, b, c0, bk) if tag == "bf16"
                        else None)
                checked += 2
    torch.cuda.synchronize()
    print(f"{checked} kernel/plain comparisons passed "
          f"({len(picks)} tiles x 3 dtypes x {len(shapes)} shapes x 2 orders)")
    a, b = seeded(128, 256, 512, "bf16", 7, dev)
    exact = a.double() @ b.double()
    inner = K.gemm_k_inner(a, b, tile=TileConfig(64, 128, 64))
    outer = K.gemm_k_outer(a, b, torch.zeros((128, 256), dtype=torch.bfloat16,
                                             device=dev),
                           tile=TileConfig(64, 128, 64, GridOrder.K_OUTER))
    e_in = (inner.double() - exact).abs().max().item()
    e_out = (outer.double() - exact).abs().max().item()
    print(f"bf16 error vs exact: k_inner {e_in:.4g}, k_outer {e_out:.4g} "
          f"(ratio {e_out / e_in:.2f})")
    check(e_out > 2 * e_in, "bf16 k_outer error is not > 2x k_inner error")

    # -- phase 3 ---------------------------------------------------------
    phase(3, "main path: Qwen2-1.5B GEMMs planned on cuda@h100, executed")
    K.reset_launch_counts()
    plans = gemm.plan_model_gemms(qwen, tokens=4096, backend="cuda",
                                  machine="h100")
    names = ["qkv", "o", "gate_up", "down", "logits"]
    max_err = {"gemm_k_inner": 0.0, "gemm_k_outer": 0.0}
    for i, (name, plan) in enumerate(zip(names, plans)):
        p, t = plan.problem, plan.selection
        a, b = seeded(p.m, p.n, p.k, "bf16", 1000 + i, dev)
        out = plan.execute(a, b)
        torch.cuda.synchronize()
        max_err["gemm_k_inner"] = max(max_err["gemm_k_inner"], compare(
            "gemm_k_inner", "bf16", out, K.gemm_k_inner_plain(a, b)))
        del out
        pinned = gemm.plan(p, backend="cuda", machine="h100",
                           tile=TileConfig(t.bm, t.bn, t.bk,
                                           GridOrder.K_OUTER))
        out = pinned.execute(a, b)
        torch.cuda.synchronize()
        c0 = torch.zeros((p.m, p.n), dtype=torch.bfloat16, device=dev)
        want = K.gemm_k_outer_plain(a, b, c0, bk=t.bk)
        max_err["gemm_k_outer"] = max(max_err["gemm_k_outer"], compare(
            "gemm_k_outer", "bf16", out, want, passes=-(-p.k // t.bk),
            peak=k_outer_peak(a, b, c0, t.bk)))
        print(f"{name:<8} {p.m}x{p.n}x{p.k} tile {t}: k_inner and k_outer "
              f"match their plain versions")
        del out, want, a, b, c0
        torch.cuda.empty_cache()

    # -- phase 4 ---------------------------------------------------------
    phase(4, "loop: run_campaign -> fit_from_store -> validate_spec")
    store = os.path.join(args.out, "h100.jsonl")
    held = os.path.join(args.out, "h100_k_outer_heldout.jsonl")
    for path in (store, held):
        if os.path.exists(path):
            os.remove(path)
    qshapes = [(pl.problem.m, pl.problem.n, pl.problem.k) for pl in plans]
    for tag in ("int8", "bf16"):
        res = measure.run_campaign("table2", harness="cuda", machine="h100",
                                   dtype=tag, store=store)
        print(f"table2/{tag}: {len(res.samples)} samples, "
              f"{res.measured_seconds:.4g} s measured")
        res = measure.run_campaign(
            "table2", harness="cuda", machine="h100", store=store,
            problems=[GemmProblem(m, n, k, dtype=tag) for m, n, k in qshapes])
        print(f"qwen2-1.5b/{tag}: {len(res.samples)} samples, "
              f"{res.measured_seconds:.4g} s measured")
    harness = measure.get_harness("cuda")
    held_samples = []
    for pl in plans:
        t = pl.selection
        pinned = gemm.plan(pl.problem, backend="cuda", machine="h100",
                           tile=TileConfig(t.bm, t.bn, t.bk,
                                           GridOrder.K_OUTER))
        s = measure.Sample.from_measurement(
            pinned, harness.measure(pinned), "cuda",
            resolve("h100"),
            meta={"grid": "qwen2-1.5b-k_outer"})
        measure.SampleStore(held).append(s)
        held_samples.append(s)
    spec, rep = measure.fit_from_store(
        store, "h100", name="h100-fit", date=time.strftime("%Y-%m-%d"),
        on_nonpositive="drop", manifest_dir=args.out)
    print(f"fit: {rep.samples} samples, residual RMS {rep.residual_rms_s:.4g}"
          f" s, in-sample MAPE {rep.insample_mape_pct:.4g}%, dropped "
          f"{rep.dropped} (on_nonpositive='drop': columns the k-inner grid "
          f"cannot constrain keep the data-sheet rate)")
    for col, x in zip(rep.columns, rep.inverse_rates):
        print(f"  {col:<16} " + ("dropped (data-sheet rate kept)"
                                 if math.isnan(x) else f"{1.0 / x:.6g}"))
    print(f"fitted manifest: {os.path.join(args.out, 'h100-fit.json')}")
    report = measure.validate_spec(spec, store)
    check(report.finite, "validation MAPE is not finite")
    print(report.table())
    heldout = measure.validate_spec(spec, held_samples)
    check(heldout.finite, "held-out MAPE is not finite")
    print("predicted vs measured on the Qwen2-1.5B shapes (bf16):")
    inner_rows = {(r.sample.m, r.sample.n, r.sample.k): r
                  for r in report.rows if r.sample.dtype == "bf16"
                  and r.sample.meta.get("grid") == "custom"}
    for r in heldout.rows:
        key = (r.sample.m, r.sample.n, r.sample.k)
        ri = inner_rows[key]
        print(f"  {key[0]}x{key[1]}x{key[2]}: k_inner measured "
              f"{ri.measured_s:.4g} s predicted {ri.predicted_s:.4g} s; "
              f"k_outer measured {r.measured_s:.4g} s predicted "
              f"{r.predicted_s:.4g} s (held out)")
    print(f"MAPE: campaign {report.mape:.4g}% over {len(report.rows)} cells; "
          f"held-out k_outer {heldout.mape:.4g}% over {len(heldout.rows)}")
    launches = dict(K.LAUNCHES)
    print(f"main-path launches: {launches}")
    for name_, n_ in launches.items():
        check(n_ > 0, f"{name_} was never launched on the main path")

    # -- phase 5 ---------------------------------------------------------
    phase(5, "timing at the Qwen2-1.5B shapes (CUDA events)")
    rows = []
    for i, (name, plan) in enumerate(zip(names, plans)):
        p, t = plan.problem, plan.selection
        a, b = seeded(p.m, p.n, p.k, "bf16", 2000 + i, dev)
        c0 = torch.zeros((p.m, p.n), dtype=torch.bfloat16, device=dev)
        ti = TileConfig(t.bm, t.bn, t.bk, GridOrder.K_INNER)
        to = TileConfig(t.bm, t.bn, t.bk, GridOrder.K_OUTER)
        lib = cuda_ms(lambda: torch.matmul(a, b))
        for kname, fn, plain, c_in in (
                ("gemm_k_inner", lambda: K.gemm_k_inner(a, b, tile=ti),
                 lambda: K.gemm_k_inner_plain(a, b), False),
                ("gemm_k_outer", lambda: K.gemm_k_outer(a, b, c0, tile=to),
                 lambda: K.gemm_k_outer_plain(a, b, c0, bk=t.bk), True)):
            ms = cuda_ms(fn)
            pms = cuda_ms(plain, min_total_ms=100.0, max_reps=10)
            bms, by = bound(p.m, p.n, p.k, "bf16", c_in)
            rows.append({"kernel": kname, "gemm": name,
                         "shape": [p.m, p.n, p.k],
                         "tile": str(to if c_in else ti),
                         "ms": ms, "plain_ms": pms, "library_ms": lib,
                         "bound_ms": bms, "bound_by": by,
                         "tflops": 2.0 * p.m * p.n * p.k / ms / 1e9})
            print(f"{kname:<13}{name:<8}{p.m}x{p.n}x{p.k}: {ms:.4f} ms "
                  f"({rows[-1]['tflops']:.2f} TFLOP/s), plain {pms:.4f} ms, "
                  f"torch.matmul {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        del a, b, c0
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump({"device": card, "power": smi("name,power.limit"),
                   "rows": rows}, f, indent=1)

    kernels = []
    for kname, line in (("gemm_k_inner", 56), ("gemm_k_outer", 89)):
        rs = [r for r in rows if r["kernel"] == kname]
        t_ops = sum(r["bound_ms"] for r in rs if r["bound_by"] == "operations")
        t_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm.cu",
            "replaces": f"src/repro/kernels/gemm.py:{line}",
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rs)})
    print(f"\n(times are sums over the five Qwen2-1.5B GEMMs; "
          f"{time.perf_counter() - t_start:.1f} s in all)")
    print(smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
