#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one sm_90 card and the
CUDA toolkit.  It imports only ``repro_torch`` (from ``src/``), never JAX or
the JAX package, and raises on the first failed check, so any failure exits
non-zero.  It drives two paths of the port: the paper's GEMM loop (phases
3-4) and serving granite-moe-3b-a800m at full width (phase 7).  Phases:

1. build   — compile every source of ``src/repro_torch/kernels/csrc/`` for
             sm_90a (one nvcc per library, all in parallel); print build
             seconds, register use, the grouped kernel's shared memory per
             tile, and the card's name and power limit.
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
6. grouped — the grouped (MoE expert) kernel against its plain version in
             bf16 and f32 at granite's serving shapes (decode with
             max_batch 4: C = 32; one request's prefill at bucket 32: C = 8),
             at a prefill at bucket 512 (C = 128, which the served run's
             max_len 256 never reaches) and at a ragged C = 24, with the
             weights at the model's init scale; the f32 errors of both
             against a float64 product are printed.  Then timed beside its
             plain version, ``torch.bmm`` and its bound.
7. serve   — ``serve_demo`` serves 8 requests (prompts of 3-11 tokens, 12
             new tokens, max_batch 4, max_len 256, bf16) with
             granite-moe-3b-a800m at full width (32 layers, d_model 1536,
             40 experts, random weights from a seeded generator on the
             card); every request must finish with in-vocabulary tokens,
             every forward must launch the grouped kernel 3 x 32 times, and
             every grouped shape it launches must be one phase 6 held
             against the plain version.  Two of the requests are replayed
             through a per-request ``decode_step`` loop fed the served
             tokens: their logits must agree with the served run's.  Then a
             second engine's drain (4 requests x 6 tokens) runs under
             ``torch.profiler``: device time by kernel and the device's busy
             share of the drain's wall time.
8. greedy  — f32 compute and KV cache, full width cut to 4 layers: the
             engine's tokens must equal a per-request ``decode_step`` loop's,
             and so must its logits at every generated step.

With tied embeddings and random weights, the token's own embedding
dominates the last hidden state, so greedy decoding echoes the input token
whatever the layers compute; tokens alone would not catch a serving bug.
Phases 7 and 8 therefore compare the logits over the whole vocabulary,
and print a request's logits against another request's as the error a
slot mix-up would give.

Launch counters are zeroed just before each path and read just after it:
phases 3-4 must launch both GEMM kernels, phase 7 the grouped kernel and
at least one GEMM kernel.  The line before the last is the
``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.  Samples, the fitted manifest and the
per-shape timings and the serving profile are written under ``--out``
(default ``build/chip_smoke``).

Tolerances (kernel vs plain version, same inputs, on the card):
int8 exact; f32 rtol 1e-5 / atol 1e-4 (FP32 FMA vs cuBLAS FP32, no TF32);
bf16 k-inner and grouped rtol = atol = 2e-2 (both sum in f32 and round
once; the sum order differs); bf16 k-outer one bf16 ulp of the running |C|
per pass (each pass rounds C to bf16, and a different f32 sum order can
cross a rounding boundary once per pass).  Served logits against the
per-request loop: f32 rtol = atol = 1e-4 per element (phase 8); bf16 0.1
relative L2 per step (phase 7: the bucketed prefill and the batch of 4 take
other bf16 rounding paths than one-token decode at batch 1, through 32
layers).
"""
from __future__ import annotations

import argparse
import dataclasses
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
    elif order in ("gemm_k_inner", "grouped_gemm"):
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


def grouped_bound(e, c, d, f, tag):
    """(ms, "bytes" | "operations") of the grouped product: x, w read once
    and y written once over 3.35 TB/s; 2ecdf operations over the peak."""
    nbytes = (e * c * d + e * d * f + e * c * f) * ELEM_BYTES[tag]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * e * c * d * f / PEAK_OPS[tag]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


#: granite-moe-3b-a800m's expert products, (E, C, D, F)
GROUPED_SHAPES = {
    "decode gate/up": (40, 32, 1536, 512),    # max_batch 4 x capacity 8
    "decode down": (40, 32, 512, 1536),
    "prefill gate/up": (40, 8, 1536, 512),    # one request at bucket 32:
    "prefill down": (40, 8, 512, 1536),       # capacity 8
    "bucket-512 gate/up": (40, 128, 1536, 512),  # capacity 128: beyond the
    "bucket-512 down": (40, 128, 512, 1536),     # served run's max_len 256
    "ragged": (40, 24, 1536, 512),
}
#: the shapes phase 7's served run launches; the kernels line sums these
SERVED_SHAPES = ("decode gate/up", "decode down", "prefill gate/up",
                 "prefill down")
#: phase 7: the served requests replayed through a per-request loop
REPLAYED = (0, 7)
#: phase 7: relative L2 error allowed between served and replayed bf16
#: logits (on an H100 the steps read 1.6-4.6 %; another request's ~145 %)
BF16_LOGITS_RTOL = 0.1


def grouped_phase(args, dev, G):
    """Phase 6: the grouped kernel against its plain version, then timed.
    Returns (timing rows, max |err| over the bf16 comparisons)."""
    import torch

    phase(6, "grouped kernel vs plain version on the card, and timing")
    err = {"bf16": 0.0, "f32": 0.0}
    exact = {"kernel": 0.0, "plain": 0.0}
    for i, (name, (e, c, d, f)) in enumerate(GROUPED_SHAPES.items()):
        for tag in ("bf16", "f32"):
            g = torch.Generator(dev).manual_seed(300 + i)
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
            # activations N(0, 1) and weights at the model's init scale
            # (dense_init: std D^-1/2), so outputs are O(1) as when served
            x = torch.randn((e, c, d), generator=g, device=dev, dtype=dt)
            w = (torch.randn((e, d, f), generator=g, device=dev)
                 * d ** -0.5).to(dt)
            got = G.grouped_gemm(x, w)
            torch.cuda.synchronize()
            want = G.grouped_gemm_plain(x, w)
            err[tag] = max(err[tag], compare("grouped_gemm", tag, got, want))
            if tag == "f32":
                ref = torch.einsum("ecd,edf->ecf", x.double(), w.double())
                for side, y in (("kernel", got), ("plain", want)):
                    exact[side] = max(exact[side], float(
                        (y.double() - ref).abs().max()))
        print(f"{name:<19}({e}, {c}, {d}) @ ({e}, {d}, {f}) tile "
              f"{G.grouped_tile(c, torch.bfloat16)}: bf16 and f32 match "
              f"the plain version")
    print(f"max |err|: bf16 {err['bf16']:.4g}, f32 {err['f32']:.4g}; f32 "
          f"against a float64 product: kernel {exact['kernel']:.4g}, plain "
          f"version {exact['plain']:.4g}")
    rows = []
    for i, (name, (e, c, d, f)) in enumerate(GROUPED_SHAPES.items()):
        g = torch.Generator(dev).manual_seed(400 + i)
        x = torch.randn((e, c, d), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w = torch.randn((e, d, f), generator=g, device=dev,
                        dtype=torch.bfloat16)
        ms = cuda_ms(lambda: G.grouped_gemm(x, w))
        pms = cuda_ms(lambda: G.grouped_gemm_plain(x, w), min_total_ms=100.0,
                      max_reps=10)
        lib = cuda_ms(lambda: torch.bmm(x, w))
        bms, by = grouped_bound(e, c, d, f, "bf16")
        rows.append({"kernel": "grouped_gemm", "shape_name": name,
                     "shape": [e, c, d, f], "served": name in SERVED_SHAPES,
                     "tile": str(G.grouped_tile(c, torch.bfloat16)),
                     "ms": ms, "plain_ms": pms, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by,
                     "tflops": 2.0 * e * c * d * f / ms / 1e9,
                     "bound_share": bms / ms})
        print(f"grouped {name:<19}bf16: {ms:.4f} ms "
              f"({rows[-1]['tflops']:.3f} TFLOP/s, {100 * bms / ms:.1f}% of "
              f"the bound), plain {pms:.4f} ms, torch.bmm {lib:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
        del x, w
    torch.cuda.empty_cache()
    return rows, err["bf16"]


def record_logits(eng, rids):
    """Wrap ``eng``'s decode step so that it keeps, for each request in
    ``rids``, the f32 logits over the vocabulary at every step it decodes.
    Returns {rid: [logits row per generated token]}."""
    vocab = eng.lm.cfg.vocab_size
    kept = {rid: [] for rid in rids}
    inner = eng._decode

    def decode(params, caches, token, pos):
        nxt, logits, caches = inner(params, caches, token, pos)
        for i, r in enumerate(eng.slot_req):
            if r is not None and r.rid in kept:
                kept[r.rid].append(logits[i, :vocab].float().clone())
        return nxt, logits, caches

    eng._decode = decode
    return kept


def replay(lm, params, prompt, n_new, max_len, forced=None):
    """One request through a per-token ``decode_step`` loop at batch 1:
    greedy, or fed the tokens ``forced``.  Returns (tokens, the f32 logits
    over the vocabulary at each generated step)."""
    import torch

    vocab = lm.cfg.vocab_size
    caches = lm.init_cache(1, max_len)
    toks, rows = list(prompt), []
    for t in range(len(prompt) + n_new - 1):
        logits, caches = lm.decode_step(
            params, caches, torch.tensor([[toks[t]]], device=lm.device), t)
        if t >= len(prompt) - 1:
            rows.append(logits[0, :vocab].float())
            step = len(rows) - 1
            toks.append(int(torch.argmax(rows[-1])) if forced is None
                        else forced[step])
    return toks[len(prompt):], rows


def rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def top1_gap(row):
    import torch
    top = torch.topk(row, 2).values
    return float(top[0] - top[1])


def serve_phase(K, G):
    """Phase 7: serve granite-moe-3b-a800m at full width through the
    port's entry point; returns the run's numbers and launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod

    phase(7, "serving granite-moe-3b-a800m at full width on the card")
    cfg = get_config("granite-moe-3b-a800m")
    n_moe = sum(k == "moe" for k in cfg.block_pattern)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token}, expert "
          f"d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}); compute {cfg.compute_dtype}")
    # the served run's engine keeps the logits of the replayed requests,
    # and every grouped launch records its shape
    held = {}

    class Recording(serve_mod.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            held["engine"] = self
            held["logits"] = record_logits(self, REPLAYED)

    shapes = set()
    launch = G._launch

    def shape_launch(x, w, y, tile):
        shapes.add((*x.shape, w.shape[2]))
        launch(x, w, y, tile)

    engine_cls = serve_mod.ServingEngine
    serve_mod.ServingEngine, G._launch = Recording, shape_launch
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    G.reset_launch_counts()
    try:
        out = serve_mod.serve_demo(
            "granite-moe-3b-a800m", smoke=False, n_requests=8, max_new=12,
            max_batch=4, max_len=256, seed=0, device="cuda")
        launches = {**K.LAUNCHES, **G.LAUNCHES}
    finally:
        serve_mod.ServingEngine, G._launch = engine_cls, launch
    print(f"serving-path launches: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checked = {GROUPED_SHAPES[n] for n in SERVED_SHAPES}
    print(f"grouped shapes launched: {sorted(shapes)}")
    check(shapes <= checked, f"grouped shapes {sorted(shapes - checked)} "
                             f"ran on the served path but phase 6 never held "
                             f"them against the plain version")
    check(out["requests"] == 8, f"{out['requests']} of 8 requests finished")
    for rid, toks in out["generated"].items():
        check(len(toks) == 12 and all(0 <= t < cfg.vocab_size
                                      for t in toks),
              f"request {rid}: {toks} is not 12 in-vocabulary tokens")
    check(launches["grouped_gemm"] > 0, "grouped_gemm was never launched "
                                        "on the serving path")
    check(launches["gemm_k_inner"] + launches["gemm_k_outer"] > 0,
          "no GEMM kernel was launched on the serving path")
    forwards = len(out["steps"]) + out["prefills"]
    per_fwd, rest = divmod(launches["grouped_gemm"], forwards)
    check(rest == 0 and per_fwd == 3 * n_moe,
          f"{launches['grouped_gemm']} grouped launches over {forwards} "
          f"forwards is not {3 * n_moe} per forward")
    decode = [st["dt"] for st in out["steps"] if st["admitted"] == 0]
    all_steps = [st["dt"] for st in out["steps"]]
    res = {"tokens": out["tokens"], "seconds": out["seconds"],
           "tokens_per_s": out["tokens"] / out["seconds"],
           "steps": len(all_steps), "prefills": out["prefills"],
           "decode_steps": len(decode),
           "decode_step_ms": 1e3 * sum(decode) / max(len(decode), 1),
           "step_ms_all": 1e3 * sum(all_steps) / len(all_steps),
           "grouped_per_forward": per_fwd, "peak_memory_gb": peak_gb,
           "grouped_shapes": sorted(shapes), **launches}
    print(f"{res['tokens']} tokens in {res['seconds']:.3f} s: "
          f"{res['tokens_per_s']:.2f} tok/s; {res['steps']} steps "
          f"({res['decode_steps']} without admissions: "
          f"{res['decode_step_ms']:.3f} ms each; all steps "
          f"{res['step_ms_all']:.3f} ms); {out['prefills']} prefills; "
          f"{per_fwd} grouped launches per forward (= 3 x {n_moe}); peak "
          f"memory {res['peak_memory_gb']:.2f} GB")
    print(f"perf_report: machine {out['perf']['machine']}, drift "
          f"{out['perf']['drift_status']}")
    res["replay"] = replay_served(held["engine"], held["logits"])
    held.clear()
    torch.cuda.empty_cache()
    res["profile"] = profile_serving(cfg)
    torch.cuda.empty_cache()
    return res


def replay_served(eng, kept):
    """Phase 7's logits check: each request in ``REPLAYED`` goes through a
    per-request ``decode_step`` loop at batch 1, with the served run's
    weights, fed the tokens it was served; its logits must agree with the
    ones the served run computed, to ``BF16_LOGITS_RTOL``."""
    reqs = {r.rid: r for r in eng.finished}
    errs, gaps, want = {}, [], {}
    for rid in REPLAYED:
        r = reqs[rid]
        got = kept[rid]
        check(len(got) == len(r.generated), f"request {rid}: {len(got)} "
              f"logits rows kept for {len(r.generated)} tokens")
        _, want[rid] = replay(eng.lm, eng.params, r.prompt,
                              len(r.generated), eng.max_len,
                              forced=r.generated)
        errs[rid] = [rel_l2(g, w) for g, w in zip(got, want[rid])]
        gaps += [top1_gap(w) for w in want[rid]]
    a, b = REPLAYED
    mixed = rel_l2(kept[a][0], want[b][0])
    worst = max(max(e) for e in errs.values())
    print(f"requests {list(REPLAYED)} replayed at batch 1 on the served "
          f"tokens: logits within {worst:.4g} relative L2 of the served "
          f"run's at every step (tolerance {BF16_LOGITS_RTOL}); request {a} "
          f"against request {b}: {mixed:.4g}; smallest top-1 logit gap "
          f"{min(gaps):.4g}")
    check(worst <= BF16_LOGITS_RTOL,
          f"served logits differ from the replay by {worst:.4g} relative L2 "
          f"(per step: {errs})")
    check(mixed > 10 * BF16_LOGITS_RTOL,
          f"two requests' logits differ by only {mixed:.4g}: the check "
          f"cannot tell them apart")
    return {"requests": list(REPLAYED), "rel_l2_max": worst,
            "rel_l2_per_step": errs, "other_request_rel_l2": mixed,
            "min_top1_gap": min(gaps)}


def profile_serving(cfg):
    """One engine's drain (4 requests x 6 tokens, max_batch 4) under
    torch.profiler, the model built and the requests queued beforehand:
    device time by kernel (device-side events only, so nothing is counted
    twice) and the device's busy share of the drain's wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request, ServingEngine

    lm = LM(cfg, device="cuda")
    eng = ServingEngine(lm, lm.init(torch.Generator(lm.device).manual_seed(1)),
                        max_batch=4, max_len=256)
    rng = np.random.default_rng(1)
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(3, 12))).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=6))
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = sum(1 for e in eng.trace_events if e["type"] == "step")
    rows = [{"name": ev.key, "device_ms": ev.self_device_time_total / 1e3,
             "count": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    print(f"profile of one drain (4 requests x 6 tokens, {steps} steps, "
          f"profiler on): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {sum(r['count'] for r in rows)} "
          f"device events")
    for r in rows[:12]:
        print(f"  {r['device_ms']:9.3f} ms {r['count']:6d}x  {r['name'][:90]}")
    del eng, lm
    return {"wall_ms": wall_ms, "steps": steps, "device_busy_ms": busy,
            "device_events": sum(r["count"] for r in rows),
            "top": rows[:25]}


def greedy_phase(dev):
    """Phase 8: engine == sequential greedy decode, f32, full width cut to
    4 layers (bf16 leaves argmax near-ties that flip with the batch): the
    tokens, and the logits at every generated step to rtol = atol = 1e-4."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request, ServingEngine

    phase(8, "engine == sequential greedy decode (f32, 4 layers)")
    full = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=4, block_pattern=("moe",) * 4,
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    print(f"depth cut {full.n_layers} -> {cfg.n_layers} layers; widths as "
          f"published (d_model {cfg.d_model}, {cfg.n_experts} experts)")
    lm = LM(cfg, device=dev)
    params = lm.compute_params(lm.init(
        torch.Generator(dev).manual_seed(3)))
    prompts = [[5, 6, 7, 8], [1, 2, 3], [9, 4, 2, 7, 5, 3], [11, 12]]

    eng = ServingEngine(lm, params, max_batch=3, max_len=128)
    kept = record_logits(eng, range(len(prompts)))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    ref = {i: replay(lm, params, p, 5, 128) for i, p in enumerate(prompts)}
    want = {i: toks for i, (toks, _) in ref.items()}
    check(got == want, f"engine tokens {got} != sequential {want}")
    err, gaps = 0.0, []
    for i, (_, rows) in ref.items():
        check(len(kept[i]) == len(rows), f"request {i}: {len(kept[i])} "
              f"logits rows kept for {len(rows)} steps")
        for g, w in zip(kept[i], rows):
            diff = (g - w).abs()
            nbad = int((diff > 1e-4 + 1e-4 * w.abs()).sum())
            check(nbad == 0, f"request {i}: {nbad} engine logits outside "
                             f"rtol = atol = 1e-4 of the sequential loop's "
                             f"(max abs err {float(diff.max()):.4g})")
            err = max(err, float(diff.max()))
            gaps.append(top1_gap(w))
    mixed = rel_l2(kept[0][0], ref[1][1][0])
    peak = max(float(w.abs().max()) for _, rows in ref.values()
               for w in rows)
    print(f"engine (max_batch 3) == sequential greedy for {len(prompts)} "
          f"requests: {got}; logits within {err:.4g} at every step (max "
          f"|logit| {peak:.4g}); request 0 against request 1: {mixed:.4g} "
          f"relative L2; smallest top-1 logit gap {min(gaps):.4g}")
    del eng, lm, params, kept, ref
    torch.cuda.empty_cache()
    return {"tokens": got, "max_abs_logit_err": err,
            "other_request_rel_l2": mixed, "min_top1_gap": min(gaps)}


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
    from repro_torch.kernels import grouped_gemm as G
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
    for v in paths:
        regs, spills = [], []
        log = build.build_log(v)
        with open(os.path.join(args.out, f"ptxas_{v}.log"), "w") as f:
            f.write(log)
        for line in log.splitlines():
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" ")[0]))
            if "spill" in line and not (" 0 bytes spill stores" in line
                                        and " 0 bytes spill loads" in line):
                spills.append(line.strip())
        print(f"ptxas {v}: {len(regs)} kernels, registers "
              f"{min(regs)}..{max(regs)}, {len(spills)} with spills")
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        tiles = {str(G.grouped_tile(c, dt)): K.smem_bytes(G.grouped_tile(c, dt),
                                                          tag)
                 for c in (8, 24, 32, 128)}
        print(f"grouped {tag}: dynamic shared memory per tile {tiles} "
              f"(a block may claim {K.MAX_SMEM_BYTES})")
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

    grouped_rows, grouped_err = grouped_phase(args, dev, G)
    served = serve_phase(K, G)
    greedy = greedy_phase(dev)

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
    rs = [r for r in grouped_rows if r["served"]]
    t_ops = sum(r["bound_ms"] for r in rs if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
    kernels.append({
        "name": "grouped_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/grouped_gemm.py:37",
        "launches": served["grouped_gemm"], "max_abs_err": grouped_err,
        "ms": sum(r["ms"] for r in rs),
        "plain_ms": sum(r["plain_ms"] for r in rs),
        "bound_ms": sum(r["bound_ms"] for r in rs),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in rs)})
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump({"device": card, "power": smi("name,power.limit"),
                   "rows": rows, "grouped_rows": grouped_rows,
                   "serve": served, "greedy": greedy}, f, indent=1)
    print(f"\n(GEMM times are sums over the five Qwen2-1.5B GEMMs, grouped "
          f"times over the four bf16 shapes of the served run; "
          f"{time.perf_counter() - t_start:.1f} s in all)")
    print(smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
