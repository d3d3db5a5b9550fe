#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR] [--parent DIR]

Run from the root of a checkout, on a machine with one sm_90 card and the
CUDA toolkit.  It imports only ``repro_torch`` (from ``src/``), never JAX or
the JAX package, and raises on the first failed check, so any failure exits
non-zero.  It drives five paths of the port: the paper's GEMM loop
(phases 3-4), serving granite-moe-3b-a800m at full width (phase 7), the
attention and norm entry points on that model's activations (phase 9),
serving zamba2-1.2b at full width (phase 11), and Qwen2-1.5B
autoconfigured, served and replayed (phase 14), beside the other model
families (phase 12) and the deployment report (phase 13).  Phases:

1. build   — compile every source of ``src/repro_torch/kernels/csrc/`` for
             sm_90a (one nvcc per library, all in parallel); print build
             seconds, register use, the bf16 GEMM and grouped (wgmma)
             kernels' registers and spills, the grouped routes'
             configuration per tile (bf16: slab depth, stages, shared
             memory, blocks per SM, blocks per launch at the served
             shapes; f32: shared memory), the GEMM's wgmma configuration at
             every planner tile, the RMSNorm kernels' registers and shared
             memory per kernel, the f32 flash attention (CUDA-core)
             instantiations' registers and spills and their block per
             head-dim width and block height (threads, register tile, K and
             V pieces, ring, shared memory, blocks per SM; a spill fails),
             the bf16 flash attention (wgmma) kernel's registers, spills,
             warpgroups, keys per step, stages and shared memory per
             head-dim width, the int8 GEMM (wgmma s8) instantiations'
             registers and spills and its configuration at every planner
             tile, the f32 (CUDA-core, ``tile_gemm.cuh``) instantiations'
             registers and spills and their block (threads, register tile,
             sub-slab depth, stages, shared memory, blocks per SM) at every
             planner tile and 64x128x128 and for the f32 grouped tiles, and
             the card's name and power limit.  Where the toolkit has
             ``cuobjdump``, fail unless the gemm_bf16 library's SASS holds
             HGMMA instructions, the gemm_int8 library's IGMMA and UTMALDG,
             the grouped_gemm_bf16 and flash_attention_bf16 libraries'
             HGMMA and UTMALDG, and the gemm_f32, grouped_gemm_f32 and
             flash_attention_f32 libraries' FFMA and no HMMA or HGMMA (no
             TF32).
2. kernels — both loop orders against their plain PyTorch versions on the
             card: every tile the planner (the Hopper tile model) picks for
             the slice's shapes in that dtype (the Qwen2-1.5B GEMMs,
             Table-2, granite's GEMMs at 1-256 rows and its logits GEMM at
             M = 4, 8, 32, 128) and every tile phases 4-5 time, in bf16,
             f32 and int8 (bf16 also 128x256x128, one warpgroup in rounds),
             on a divisible shape and one whose last k-outer pass is ragged;
             the Table-2 shapes whose rows TMA cannot read in place (K = 27,
             1; N = 49, 196) in bf16, int8 (exact) and f32 (B at a
             weight's init scale); f32 on strided views whose base and row
             stride fall off 16 bytes at every planner tile; every bf16 and
             int8 launch on the wgmma route and every f32 one on the CUDA
             cores (int8 after one transposed copy of B a call); plus the
             bf16
             finding that k-outer's per-pass rounding costs more than twice
             k-inner's error; one RMSNorm call with a bf16 scale must run
             exactly one device kernel and allocate only its output.
3. main    — the Qwen2-1.5B GEMMs at tokens=4096, planned on ``cuda`` for
             ``h100`` (the Hopper tile model) and executed by
             ``plan.execute`` in the planner's loop order and pinned to the
             other with the same tile, each checked against its plain
             version, in bf16, in int8 (exact) and in f32 (on the CUDA
             cores; B at a weight's init scale).
4. loop    — Table-2 in int8, bf16 and f32 at the planner's tiles
             (``measure.run_campaign``), the five Qwen2-1.5B GEMMs in each
             dtype at the planner's tile and two more (``gemm.plan(...,
             tile=)`` and ``measure.Sample.from_measurement``), k-outer at
             one tile per dtype -> ``fit_from_store`` on the Hopper model
             with ``on_nonpositive="raise"`` -> ``validate_spec``, plus
             bf16 k-outer at 64x128x128 held out of the fit.  Prints every
             fitted rate and per-call cost beside the manifest's, the MAPE
             by dtype and loop order (campaign and held out) and, per
             Qwen2-1.5B GEMM and dtype, the planner's tile's time over the
             fastest tile timed.  Then step 5: the fit is registered
             (``h100-fit``), the 15 Qwen2-1.5B GEMM x dtype cells are
             re-planned on it, and each refit pick phase 4 has not timed
             is held against its plain version and timed (into
             ``h100_refit.jsonl``, out of the fit); per cell the data
             sheet's pick and the refit's, each over the fastest tile
             timed (target <= 1.10).
5. timing  — each kernel at the Qwen2-1.5B shapes with CUDA events, beside
             its plain version, ``torch.matmul`` and its roofline bound
             (TFLOP/s and share of the bound; for k-outer also the C-stream
             floor its variant defines), at the planner's tiles and at the
             TPU model's old pick (64x128x128); k-inner with two
             shared-memory stages against as many as fit, in turns; with
             ``--parent DIR`` (an export of an earlier commit) also that
             tree's times at the planner's tiles, in the order parent,
             change, change, parent.  Then the int8 route (wgmma s8,
             ``wgmma_s8.cuh``) at the same shapes at the int8 planner's
             tile, the old 128x128x128 and 64x128x128, beside
             its plain version, ``torch._int_mm`` (int8 -> int32), its
             bound (the 1,979 TOP/s int8 tensor-core rate) and k-outer's
             int32 C-stream floor; the 19 Table-2 int8 cells (k-inner on
             the planner's tiles, with the wrapper's host µs a call); two
             stages against as many as fit; the transposed copy of B
             alone.  With ``--parent``, the int8 GEMMs, the Table-2 cells
             and the f32 route (at the f32 planner's tile, the old
             32x64x128 and 64x128x128) in both trees, each in a fresh
             process: parent, change, change, parent.  Then the f32 route
             (the CUDA cores, ``tile_gemm.cuh``) at those tiles beside
             ``torch.matmul`` (TF32 off) and its bound (67 TFLOP/s).
             Phases 3, 4, 5 and 7 fail unless every bf16 and int8 GEMM
             launch went through the wgmma route,
             phase 5 unless every f32 launch went through the CUDA
             cores.
6. grouped — the grouped (MoE expert) kernel against its plain version in
             bf16 and f32 at granite's serving shapes (decode with
             max_batch 4: C = 32; one request's prefill at bucket 32: C = 8),
             at a prefill at bucket 512 (C = 128, which the served run's
             max_len 256 never reaches), at a ragged C = 24 and at a ragged
             D and F (3, 24, 201, 75), with the weights at the model's init
             scale; every bf16 launch on the wgmma route, every f32 one on
             the CUDA cores; the f32 errors of both against a float64
             product are printed.  Then the ring's stage cap (3, 2, 4 and
             as many as fit three blocks to an SM) is timed in turns at the
             served shapes, and the kernel is timed in bf16 and in f32
             beside its plain version, ``torch.bmm`` and its bound: device
             time by CUDA-graph replay (20 calls a graph; a CUDA-event loop
             at these sizes reads the host's enqueue rate) beside the event
             time; with ``--parent`` also that tree's, both dtypes, in the
             order parent, change, change, parent.
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
             ``torch.profiler``: device time by kernel (the wgmma GEMM's
             and the grouped kernel's rows printed whatever their rank),
             the grouped share of device time and the device's busy share
             of the drain's wall time; then the served logits GEMM at
             decode (4 rows) is timed alone beside ``torch.matmul``.  Fails
             unless every bf16 grouped launch of the served run took the
             wgmma route.  With ``--parent``, that tree and this one each
             serve the same requests and drain under the profiler in fresh
             processes, in the order parent, change, change, parent
             (decode step time and grouped share side by side).
8. greedy  — f32 compute and KV cache, full width cut to 4 layers: the
             engine's tokens must equal a per-request ``decode_step`` loop's,
             and so must its logits at every generated step.
9. model   — granite-moe-3b-a800m at full width, depth cut to 4 layers,
             bf16: one prefill at bucket 32 and one decode step at batch 4
             with ``blockwise_attention`` and ``apply_norm`` wrapped (in
             this script only) to record their inputs and outputs: q, k, v
             (1, 32, 24, 64) and norms (1, 32, 1536) and (4, 1, 1536).
             ``ops.flash_attention`` and ``rmsnorm`` run on those exact
             tensors and are held against the model's own outputs and
             against their plain versions; RMSNorm on the model's bf16
             scale must equal, bit for bit, RMSNorm on its f32 copy; every
             bf16 flash launch must take the wgmma route.
10. attention/norm timing — both kernels against their plain versions at
             granite's and Qwen2-1.5B's full widths (attention (1, S, 24,
             64) for S in 32, 256, 4096 causal in bf16 and f32, S = 4096
             non-causal, S = 32768 causal in bf16 (the plain version one
             head at a time: all 24 heads' f32 scores would take 103 GB),
             Qwen2-1.5B's (1, 4096, 12, 128) causal, head dims 16, 32,
             160, 192 and 256 and B * H = 70,000; RMSNorm of 4, 32, 4096
             and 32768 rows of 1536 in bf16 and f32, kimi-k2-1t's 7168, a
             ragged D = 1001 and a non-contiguous x), each timed beside its
             plain version, one PyTorch call (SDPA, ``F.rms_norm``) and its
             bound.  RMSNorm takes the f32 scale the models keep, and is
             also timed by CUDA-graph replay (device time) and by a
             host-clock loop that does not synchronise per call (the
             wrapper's host µs per call, beside ``F.rms_norm``'s); a bf16
             scale must give the output of its f32 copy, bit for bit; every
             bf16 flash launch must take the wgmma route and every f32 one
             the CUDA cores (aligned copies printed).  With ``--parent``,
             RMSNorm at 4, 32 and 32768 rows and flash attention (causal;
             bf16 at S = 32, granite and Qwen2-1.5B at S = 4096,
             paligemma-3b's D = 256; f32 at the two S = 4096 shapes,
             paligemma-3b's D = 256, stablelm-12b's D = 160,
             xlstm-125m's D = 192 and the launch-bound S = 32, 256, D =
             16, 32) in both trees, each in a fresh process: parent,
             change, change, parent.

11. zamba2 — ``serve_demo`` serves phase 7's traffic (8 requests, 12 new
             tokens, max_batch 4, max_len 256, bf16) with zamba2-1.2b at
             full width (38 layers: 32 Mamba2 and 6 sites of one shared
             attention+MLP block, d_model 2048, random weights from a
             seeded generator on the card): every request finishes with
             in-vocabulary tokens, every prefill runs at its exact length,
             ``gemm_k_inner`` (the shared MLP, the logits) is launched on
             the wgmma route and every GEMM shape x tile the run launched
             is held against its plain version; the footprint model's
             decode-state bytes must equal the engine's caches' bytes on
             the card, and its weights and total bytes are printed beside
             the model's, the compute copy's and
             ``torch.cuda.max_memory_allocated``.  Two requests are
             replayed through a per-request ``decode_step`` loop; in bf16
             their distance is printed beside a one-ulp probe (one
             embedding row scaled by 1 + 2^-8 moves the logits as far:
             38 random layers amplify any rounding), and the same traffic
             served in f32 (GEMMs on the CUDA cores) must agree with its
             replay within 1e-3 relative L2.  Then a profiled drain (the
             device's busy share).
12. families — decode == prefill at full width in f32 for zamba2-1.2b,
             xlstm-125m, paligemma-3b (256 patches before 16 tokens) and
             musicgen-medium (16 frames): a prefill of all but the last
             position and one ``decode_step`` against the last position
             of the whole prefill, ``tests/test_models.py``'s bounds
             (attention archs rtol = atol = 2e-2; recurrent archs max
             |err| under 0.06 of max |logit|); the bf16 error printed
             beside it (no bound), and the host ms of xlstm-125m's sLSTM
             steps inside its prefill; every GEMM shape x tile the phase
             ran held against its plain version.
13. deploy  — ``plan_deployment`` for all ten archs on ``cuda`` /
             ``h100``, bf16 and int8, batches 1-16, max_len 4096: the
             ranked table per arch; kimi-k2-1t must be rejected on one
             card for its weights (footprint and budget printed); zamba2's
             predicted decode tok/s at batch 4 beside phase 11's measured
             figure (no bound: the served step is bound by the host);
             zamba2 and qwen2-1.5b also priced on ``h100-measured`` (the
             zoo's fitted manifest) and ``h100-fit`` (phase 4's).
14. autoconf — ``serve_demo(..., autoconfigure=True)`` configures
             Qwen2-1.5B at full width (28 layers, d_model 1536, 12 heads /
             2 KV heads of 128, d_ff 8960, vocab 151,936, tied embeddings;
             random weights from a seeded generator on the card) with
             ``ServingEngine.autoconfigure`` on ``cuda`` /
             ``h100-measured`` (bf16 and int8, batches 1-16, max_len 256)
             under an SLO (p99 <= 0.35 s, Poisson traffic at 5 requests/s,
             16-token prompts, 12 new tokens): the pick, its simulated p99
             and goodput and every rejected cell are printed, and the pick
             must be a bf16 cell of ``h100-measured``.  It then serves
             phase 7's traffic on the configured engine: every request
             finishes with in-vocabulary tokens, every GEMM launch takes
             the wgmma route, every GEMM shape x tile the run launched is
             held against its plain version, two requests replayed through
             a per-request ``decode_step`` loop agree with the served
             logits within 0.1 relative L2 in bf16 (phase 7's bound; the
             one-ulp probe printed beside it).  The engine's trace
             (``autoconf_trace.json`` under ``--out``) is replayed through
             ``repro_torch.simulate.replay``: with the measured step
             durations the completion order, step count and sheds must
             match and every request's latency lie within 2 % (MAPE under
             2 %); priced by ``ServiceModel.from_plans`` on the same
             manifest, order and steps must match and the MAPE is printed
             with no bound (the model prices one layer's GEMMs and the
             logits; the served step is bound by the host).

With tied embeddings and random weights, the token's own embedding
dominates the last hidden state, so greedy decoding echoes the input token
whatever the layers compute; tokens alone would not catch a serving bug.
Phases 7 and 8 therefore compare the logits over the whole vocabulary,
and print a request's logits against another request's as the error a
slot mix-up would give.

Launch counters are zeroed just before each path and read just after it:
phases 3-4 must launch both GEMM kernels in bf16, in int8 and in f32 (the
int8 and f32 launches are counted apart, by the counters' growth over
their runs),
phase 7 the grouped kernel and at least one GEMM kernel, phases 9 and 10
(each) the flash attention and RMSNorm kernels, phases 11 and 14
``gemm_k_inner`` on the wgmma route.  The line before the last is the
``{"kernels": [...]}`` record (the GEMM kernels three times, each timed at
its dtype's planner tiles: bf16 from ``wgmma_gemm.cuh``, int8,
``*_int8``, from ``wgmma_s8.cuh``, and f32, ``*_f32``, from
``tile_gemm.cuh``; flash attention twice: bf16 over the shapes
phase 9 recorded, ``flash_attention_f32`` at phase 10's granite S = 4096
causal f32 row with phase 10's f32 launches); the last line is
``{"ok": true, "device": {...}}``.  Samples, the fitted manifest and the
per-shape timings and the serving profile are written under ``--out``
(default ``build/chip_smoke``).  In the kernels line, ``ms``,
``plain_ms`` and ``library_ms`` of the grouped GEMM and RMSNorm are device
times by CUDA-graph replay; the others' are CUDA-event times.

Tolerances (kernel vs plain version, same inputs, on the card):
int8 exact; f32 rtol 1e-5 / atol 1e-4 (FP32 FMA vs cuBLAS FP32, no TF32);
bf16 k-inner and grouped rtol = atol = 2e-2 (both sum in f32 and round
once; the sum order differs); bf16 k-outer one bf16 ulp of the running |C|
per pass (each pass rounds C to bf16, and a different f32 sum order can
cross a rounding boundary once per pass) plus the spread of two f32 sums
of the same K products in different orders, 2 gamma_K sum |a b| (gamma_K =
K 2^-24 / (1 - K 2^-24)): where a single pass cancels to near zero that
spread exceeds one ulp of |C|, and kernel and plain version land on either
side of the float64 product.  Served logits against the
per-request loop: f32 rtol = atol = 1e-4 per element (phase 8); bf16 0.1
relative L2 per step (phase 7: the bucketed prefill and the batch of 4 take
other bf16 rounding paths than one-token decode at batch 1, through 32
layers).  Flash attention against its plain version: f32 rtol = atol =
1e-5, bf16 3e-2 (``tests/test_kernels.py``'s); against the model's
blockwise attention f32 2e-5, bf16 3e-2.  RMSNorm, against its plain
version and the model's norm: f32 rtol = atol = 1e-5; bf16 one bf16 ulp of
|y| (``rsqrtf`` and the sum order differ from PyTorch's, and one f32
last-bit difference can cross a bf16 rounding boundary).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
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


T_START = time.perf_counter()


def phase(n, title):
    print(f"\n== phase {n}: {title} ({time.perf_counter() - T_START:.1f} s "
          f"into the run)", flush=True)


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


def sum_order_bound(a, b):
    """Per element, how far two f32 sums of the K products a_ik b_kj can
    lie apart in different orders: 2 gamma_K sum_k |a_ik b_kj|, gamma_K =
    K u / (1 - K u), u = 2^-24 (each within gamma_K of the exact sum)."""
    k = a.shape[1]
    gamma = k * 2.0 ** -24 / (1.0 - k * 2.0 ** -24)
    return 2.0 * gamma * (a.float().abs() @ b.float().abs())


def k_outer_bounds(a, b, c, bk):
    """bf16 k-outer's tolerance terms for :func:`compare`: the peak |C| of
    the passes and the f32 sum-order bound."""
    return {"peak": k_outer_peak(a, b, c, bk),
            "order_bound": sum_order_bound(a, b)}


def held(name, tag, got, want, allowed=None):
    """Max |got - want|; raises when an element differs from ``want`` by
    more than ``allowed`` (a float, or a tensor shaped like ``want``), or,
    for int8, at all."""
    import torch
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
          f"{name}/{tag}: got {tuple(got.shape)} {got.dtype}, want "
          f"{tuple(want.shape)} {want.dtype}")
    if tag == "int8":
        err = (got.long() - want.long()).abs().max().item()
        check(err == 0, f"{name}/int8 not exact: max err {err}")
        return float(err)
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}/{tag}: non-finite output")
    diff = (g - w).abs()
    nbad = int((diff > allowed).sum().item())
    err = float(diff.max().item())
    check(nbad == 0, f"{name}/{tag}: {nbad} elements outside tolerance "
                     f"(max abs err {err})")
    return err


def within(want, rtol, atol):
    """The allowed |difference| per element: atol + rtol * |want|."""
    return atol + rtol * want.float().abs()


def compare(order, tag, got, want, *, passes=1, peak=None, order_bound=None,
            where=""):
    """:func:`held` with the GEMM kernels' stated tolerances; ``where``
    (e.g. the tile and shape) goes into a failure's message.  bf16
    k-outer: one bf16 ulp of the running |C| per pass, plus
    ``order_bound`` (:func:`sum_order_bound`), the f32 sum-order spread
    the ulp alone does not cover where a sum cancels to near zero."""
    if tag == "int8":
        allowed = None
    elif tag == "f32":
        allowed = within(want, 1e-5, 1e-4)
    elif order in ("gemm_k_inner", "grouped_gemm"):
        allowed = within(want, 2e-2, 2e-2)
    else:
        allowed = passes * bf16_ulp(peak)
        if order_bound is not None:
            allowed = allowed + order_bound
    return held(order + where, tag, got, want, allowed)


def norm_tolerance(tag, want):
    """RMSNorm's: one bf16 ulp of |want| in bf16, rtol = atol = 1e-5 in
    f32."""
    return bf16_ulp(want) if tag == "bf16" else within(want, 1e-5, 1e-5)


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


def graph_ms(fn, calls=20, replays=5):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that no host
    work stands between the kernels (after two warm-up calls on the
    capturing stream's side stream)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(replays):
        graph.replay()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, calls=200):
    """Host µs per call of ``fn`` in a loop that does not synchronise per
    call (the wrapper's enqueue cost, while the device keeps up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def ptxas_entries(log):
    """[(kernel, registers, static shared memory bytes, spill line)] from an
    ``nvcc -Xptxas -v`` log, kernel names demangled and shortened where
    ``c++filt`` is found."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "spill": ""}
            entries.append(cur)
        elif cur is not None and "spill" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "registers" in line:
            cur["registers"] = int(line.split("Used ")[1].split(" ")[0])
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e["name"] for e in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(entries):
        names = [e["name"] for e in entries]
    # "void repro::(anonymous namespace)::flash_fwd<64, 4, true>(...)" ->
    # "flash_fwd<64, 4, true>"
    short = [re.search(r"(\w+<[^()]*>)\(", n) for n in names]
    return [(m.group(1) if m else n, e.get("registers"), e.get("smem"),
             e["spill"]) for n, m, e in zip(names, short, entries)]


#: the tiles the TPU model (the port's planner before the Hopper model,
#: still ``analytic-tpu``) picked for the five Qwen2-1.5B GEMMs: phase 5
#: times the kernels there too, so the kernel table keeps comparable rows
OLD_PICKS = {"bf16": (64, 128, 128), "int8": (128, 128, 128),
             "f32": (32, 64, 128)}


#: phase 4: the tile each dtype's k-outer fit samples run at (the held-out
#: samples are bf16 k-outer at OLD_PICKS["bf16"], out of the fit)
FIT_K_OUTER = {"bf16": (128, 128, 128), "int8": (128, 128, 128),
               "f32": (64, 128, 128)}
#: phase 4: a second tile for each Qwen2-1.5B GEMM, beside the old pick
FIT_ALT = {"bf16": (128, 128, 128), "int8": (64, 128, 128),
           "f32": (64, 128, 128)}
#: phase 4's harness repetitions: one warm-up, 3 to 5 rounds
FIT_TIMING = {"warmup": 1, "rounds": 3, "max_rounds": 5}


def phase4_tiles(gemm, GemmShape, qwen, model_gemm_shapes, tag):
    """{GEMM name: [the planner's tile, two more]} for the five Qwen2-1.5B
    GEMMs in ``tag``: the planner's (in its loop order), then k-inner at
    the first two of the TPU model's old pick, :data:`FIT_ALT` and the
    Hopper model's next cheapest tiles that are not the planner's
    (bm, bn, bk)."""
    from repro_torch.core import hopper_model as H
    from repro_torch.core.tpu_model import TileConfig
    from repro_torch.machines import resolve

    h100 = resolve("h100")
    out = {}
    for name, s in zip(["qkv", "o", "gate_up", "down", "logits"],
                       model_gemm_shapes(qwen, tokens=4096)):
        shape = GemmShape(s.m, s.n, s.k, dtype=tag)
        pick = gemm.plan(shape, backend="cuda", machine="h100").selection
        ranked = sorted(H.lattice(tag),
                        key=lambda t: H.estimate(shape, t, h100).total)
        tiles = [pick]
        for t in [OLD_PICKS[tag], FIT_ALT[tag]] + [
                (t.bm, t.bn, t.bk) for t in ranked]:
            if tuple(t) not in {(x.bm, x.bn, x.bk) for x in tiles}:
                tiles.append(TileConfig(*t))
            if len(tiles) == 3:
                break
        out[name] = tiles
    return out


def pinned_sample(gemm, measure, harness, spec, problem, tile, grid, path):
    """One harness sample of ``problem`` planned on ``cuda`` at ``tile``,
    appended to the store at ``path``."""
    plan = gemm.plan(problem, backend="cuda", machine="h100", tile=tile)
    s = measure.Sample.from_measurement(
        plan, harness.measure(plan, timing=FIT_TIMING), "cuda", spec,
        meta={"grid": grid})
    measure.SampleStore(path).append(s)
    return s


def refit_picks(gemm, measure, harness, K, h100, names, qshapes, pick_rows,
                checked, dev, path, tag):
    """Phase 4's step 5 in ``tag``: re-plan the five Qwen2-1.5B GEMMs on
    the registered fit (``h100-fit``); a pick phase 4 has not timed is held
    against its plain version (phase 2's shapes) and timed like the others
    (into the store at ``path``, out of the fit).  Returns per GEMM the
    data-sheet pick and the refit's, each over the fastest tile timed."""
    from repro_torch.gemm.api import GemmProblem

    out = []
    times = {(r["dtype"], r["gemm"]): dict(zip(r["tiles"], r["seconds"]))
             for r in pick_rows}
    for name, (m, n, k) in zip(names, qshapes):
        p = GemmProblem(m, n, k, dtype=tag)
        sheet = gemm.plan(p, backend="cuda", machine="h100").selection
        refit = gemm.plan(p, backend="cuda", machine="h100-fit").selection
        timed = times[(tag, name)]
        if str(refit) not in timed:
            if (refit.bm, refit.bn, refit.bk) not in checked[tag]:
                hold_tile(K, refit, tag, dev)
            timed[str(refit)] = pinned_sample(
                gemm, measure, harness, h100, p, refit, "qwen2-1.5b-refit",
                path).seconds
        fastest = min(timed.values())
        out.append({"dtype": tag, "gemm": name, "sheet": str(sheet),
                    "refit": str(refit), "timed": timed,
                    "sheet_ratio": timed[str(sheet)] / fastest,
                    "refit_ratio": timed[str(refit)] / fastest})
    return out


def hold_tile(K, tile, tag, dev):
    """A tile phase 2 did not check, against the plain versions on phase
    2's shapes, both loop orders."""
    import torch
    from repro_torch.core.tpu_model import GridOrder, TileConfig

    ti = TileConfig(tile.bm, tile.bn, tile.bk, GridOrder.K_INNER)
    to = TileConfig(tile.bm, tile.bn, tile.bk, GridOrder.K_OUTER)
    for j, (m, n, k) in enumerate([(512, 512, 512), (300, 520, 390)]):
        a, b = seeded(m, n, k, tag, 400 + j, dev)
        if tag == "f32":
            b *= k ** -0.5
        c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype), device=dev)
        where = f" at {ti.bm}x{ti.bn}x{ti.bk} (a refit pick), {m}x{n}x{k}"
        compare("gemm_k_inner", tag, K.gemm_k_inner(a, b, tile=ti),
                K.gemm_k_inner_plain(a, b), where=where)
        compare("gemm_k_outer", tag, K.gemm_k_outer(a, b, c0, tile=to),
                K.gemm_k_outer_plain(a, b, c0, bk=tile.bk),
                passes=-(-k // tile.bk), where=where,
                **(k_outer_bounds(a, b, c0, tile.bk) if tag == "bf16"
                   else {}))
    print(f"refit pick {tile} ({tag}): not among phase 2's tiles; both "
          f"orders match their plain versions")


def route_check(K, label, tag, since):
    """Fails unless every GEMM launch since ``since`` (a :func:`snapshot`)
    took ``tag``'s route: wgmma for bf16 and int8, the CUDA cores for
    f32."""
    if tag != "f32":
        all_on_wgmma(K, label, since)
        return
    n = sum(K.LAUNCHES.values()) - since[0]
    routes = {r: K.ROUTES[r] - since[1][r] for r in K.ROUTES}
    print(f"{label}: {n} GEMM launches, by route {routes}")
    check(n > 0 and routes == {"wgmma": 0, "cuda_cores": n},
          f"{label}: an f32 GEMM launch left the CUDA-core route")


def main_path_gemms(gemm, K, names, shapes, tag, dev):
    """Phase 3 in one dtype: each Qwen2-1.5B GEMM planned on ``cuda`` for
    ``h100`` and run by ``plan.execute`` at the planner's tile, in its loop
    order and pinned to the other, each against its plain version (int8
    exact; f32 with B at a weight's init scale).  Returns the largest
    error per kernel and the rows (name, m, n, k, (bm, bn, bk))."""
    import torch
    from repro_torch.core.tpu_model import GridOrder, TileConfig
    from repro_torch.gemm.api import GemmProblem

    err = {kname: 0.0 for kname in K.LAUNCHES}
    rows = []
    seed = {"bf16": 1000, "int8": 1100, "f32": 1200}[tag]
    for i, (name, (m, n, k)) in enumerate(zip(names, shapes)):
        p = GemmProblem(m, n, k, dtype=tag)
        plan = gemm.plan(p, backend="cuda", machine="h100")
        t = plan.selection
        a, b = seeded(m, n, k, tag, seed + i, dev)
        if tag == "f32":
            # B at a weight's init scale (std K^-1/2): C is O(1), as in the
            # models (with N(0, 1) operands at K = 1536 |C| reaches ~40,
            # and any two f32 sum orders differ past atol 1e-4)
            b *= k ** -0.5
        c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype), device=dev)
        for order, kname in ((GridOrder.K_INNER, "gemm_k_inner"),
                             (GridOrder.K_OUTER, "gemm_k_outer")):
            run = plan if t.order is order else gemm.plan(
                p, backend="cuda", machine="h100",
                tile=TileConfig(t.bm, t.bn, t.bk, order))
            got = run.execute(a, b)
            if order is GridOrder.K_INNER:
                want, kw = K.gemm_k_inner_plain(a, b), {}
            else:
                want = K.gemm_k_outer_plain(a, b, c0, bk=t.bk)
                kw = {"passes": -(-k // t.bk)}
                if tag == "bf16":
                    kw.update(k_outer_bounds(a, b, c0, t.bk))
            err[kname] = max(err[kname], compare(kname, tag, got, want,
                                                 **kw))
            del got, want
        rows.append((name, m, n, k, (t.bm, t.bn, t.bk)))
        print(f"{name:<8} {m}x{n}x{k} {tag} planned {t}: k_inner and "
              f"k_outer match their plain versions")
        del a, b, c0
        torch.cuda.empty_cache()
    return {"err": err, "shapes": rows}


def fit_columns(rep, spec):
    """Each fitted design column beside the manifest's value: rates in
    bytes or ops per second, per-call costs in µs."""
    import math
    rows = []
    for col, x in zip(rep.columns, rep.inverse_rates):
        kind, _, key = col.partition(":")
        if kind == "call":
            fitted, manifest, unit = x * 1e6, spec.call_costs[key] * 1e6, "us"
        elif kind == "rate":
            o, _, d = key.partition("->")
            fitted, manifest, unit = 1.0 / x, spec.rate(o, d), "B/s"
        else:
            fitted, manifest, unit = 1.0 / x, spec.arith_rate[key], "op/s"
        check(math.isfinite(fitted), f"column {col} was not fitted")
        rows.append({"column": col, "fitted": fitted, "manifest": manifest,
                     "unit": unit, "ratio": fitted / manifest})
    return rows


def mape_breakdown(report, heldout):
    """MAPE (%) by dtype, by loop order and by both, of the campaign
    report, and of the held-out samples."""
    groups = {}
    for label, rep in (("campaign", report), ("held-out", heldout)):
        for r in rep.rows:
            order = (r.sample.tile or "").partition(":")[2] or "k_inner"
            for key in (f"{label}", f"{label} {r.sample.dtype}",
                        f"{label} {order}",
                        f"{label} {r.sample.dtype} {order}"):
                groups.setdefault(key, []).append(r.ape)
    return {key: {"cells": len(v), "mape_pct": 100.0 * sum(v) / len(v)}
            for key, v in sorted(groups.items())}


def planner_tiles(gemm, get_config, model_gemm_shapes, table2, GemmShape):
    """Every tile (bm, bn, bk) the planner picks on ``cuda`` for ``h100``,
    by dtype, for the slice's shapes: the Qwen2-1.5B GEMMs at tokens=4096,
    Table-2, granite-moe-3b-a800m's GEMMs at the rows its served run
    plans (1 to 256 tokens) and its logits GEMM at M = 4, 8, 32, 128, each
    in int8, bf16 and f32."""
    granite = get_config("granite-moe-3b-a800m")
    qwen = model_gemm_shapes(get_config("qwen2-1.5b"), tokens=4096)
    served = [s for t in (1, 2, 4, 8, 16, 32, 64, 128, 256)
              for s in model_gemm_shapes(granite, tokens=t)]
    picks = {}
    for tag in ("int8", "bf16", "f32"):
        shapes = [GemmShape(s.m, s.n, s.k, dtype=tag) for s in qwen + served]
        shapes += [GemmShape(r.m, r.n, r.k, dtype=tag) for r in table2]
        shapes += [GemmShape(m, granite.padded_vocab, granite.d_model,
                             dtype=tag) for m in (4, 8, 32, 128)]
        picks[tag] = sorted({(d.selection.bm, d.selection.bn, d.selection.bk)
                             for d in gemm.plan_many(shapes, backend="cuda",
                                                     machine="h100")})
    return picks


def sass_check(build, lib, name, need, forbid=()):
    """Fails unless the library ``name``'s SASS holds each instruction in
    ``need`` (HGMMA: a bf16 wgmma; IGMMA: an int8 one; UTMALDG: a TMA
    load; FFMA: an FP32 fused multiply-add) and none in ``forbid`` (HMMA,
    HGMMA: tensor-core products, which an f32 library must not run, or
    TF32 would slip in); says so where the toolkit has no cuobjdump."""
    import shutil
    cands = [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
             shutil.which("cuobjdump") or ""]
    tool = next((c for c in cands if c and os.access(c, os.X_OK)), None)
    if tool is None:
        print(f"cuobjdump not found: the {'/'.join(need)} check of the "
              f"{name} SASS could not run")
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    n = {op: len(re.findall(rf"\b{op}\b", sass))
         for op in ("HGMMA", "IGMMA", "HMMA", "UTMALDG", "FFMA")}
    print(f"{name} SASS ({tool}): {n['HGMMA']} HGMMA, {n['IGMMA']} IGMMA, "
          f"{n['HMMA']} HMMA and {n['FFMA']} FFMA instructions, "
          f"{n['UTMALDG']} TMA loads (UTMALDG)")
    for op in need:
        check(n[op] > 0, f"the {name} library's SASS has no {op} "
                         f"instruction")
    for op in forbid:
        check(n[op] == 0, f"the {name} library's SASS has {n[op]} {op} "
                          f"instructions")


def one_norm_kernel(dev, R):
    """Fails unless one RMSNorm call with a bf16 scale runs exactly one
    device kernel (no conversion of the scale) and allocates only y, by
    the profiler and the caching allocator."""
    import torch
    from torch.autograd import DeviceType
    x = torch.randn((SERVED_NORM_ROWS[0], NORM_D), device=dev,
                    dtype=torch.bfloat16)
    w = torch.randn((NORM_D,), device=dev).to(torch.bfloat16)
    R.rmsnorm(x, w)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        R.rmsnorm(x, w)
        torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    kernels = [ev.key for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    print(f"one RMSNorm call with a bf16 scale: device kernels {kernels}, "
          f"{allocs} allocation(s)")
    check(len(kernels) == 1 and "rmsnorm" in kernels[0] and allocs == 1,
          f"an RMSNorm call with a bf16 scale ran {kernels} and made "
          f"{allocs} allocations, not the one RMSNorm kernel and y")


def snapshot(K):
    """(GEMM launches so far, launches by route so far)."""
    return sum(K.LAUNCHES.values()), dict(K.ROUTES)


def all_on_wgmma(K, label, since=None):
    """Fails unless every GEMM launch since ``since`` (a :func:`snapshot`;
    None: since the last reset) went through the tensor-core route."""
    n0, r0 = since or (0, {r: 0 for r in K.ROUTES})
    n = sum(K.LAUNCHES.values()) - n0
    routes = {r: K.ROUTES[r] - r0[r] for r in K.ROUTES}
    print(f"{label}: {n} GEMM launches, by route {routes}")
    check(n > 0 and routes == {"wgmma": n, "cuda_cores": 0},
          f"{label}: {n} bf16 GEMM launches, by route {routes}: not every "
          f"one went through wgmma")


def core_line(cfg):
    """One line of a CUDA-core (f32) block's configuration."""
    return (f"{cfg.threads} threads, {cfg.rm}x{cfg.rn} register tile, "
            f"sub-slabs {cfg.ks} deep, {cfg.stages} stages, "
            f"{cfg.smem_bytes} B dynamic shared memory, "
            f"{cfg.blocks_per_sm} blocks per SM by shared memory and threads")


def c_stream_ms(m, n, k, bk, tag="bf16"):
    """k-outer's C stream: C (bf16; int32 for int8, f32 for f32) read and
    written once per pass, over 3.35 TB/s."""
    out = 4 if tag == "int8" else ELEM_BYTES[tag]
    return m * n * out * 2 * -(-k // bk) / HBM_BYTES_PER_S * 1e3


def tiles_label(shapes):
    """The tiles of rows (name, m, n, k, (bm, bn, bk)), e.g. "64x128x128"
    or "128x256x128 (qkv, o), 128x128x128 (down)"."""
    by = {}
    for name, *_, t in shapes:
        by.setdefault("x".join(map(str, t)), []).append(name)
    if len(by) == 1:
        return next(iter(by))
    return ", ".join(f"{t} ({', '.join(n)})" for t, n in by.items())


def gemm_timings(K, shapes, dev, *, plain=True, quiet=False, tag="bf16"):
    """Both GEMM kernels at ``shapes`` [(name, m, n, k, (bm, bn, bk))] in
    ``tag`` (bf16 and int8: the wgmma route; f32: the CUDA cores), timed
    with CUDA events beside their plain versions (when ``plain``), one
    PyTorch call (``torch.matmul``, TF32 off; ``torch._int_mm`` for int8,
    int8 -> int32 as the kernel) and their bound.  Takes only the kernel
    module's ``route`` / ``gemm_k_inner`` / ``gemm_k_outer`` / ``*_plain``,
    so it also times an older tree's module (whose int8 route was the CUDA
    cores)."""
    import torch
    from repro_torch.core.tpu_model import GridOrder, TileConfig

    rows = []
    mm = torch._int_mm if tag == "int8" else torch.matmul
    slow = K.route(tag) == "cuda_cores"   # tens of ms a call
    for i, (name, m, n, k, (bm, bn, bk)) in enumerate(shapes):
        a, b = seeded(m, n, k, tag, 2000 + i, dev)
        c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype), device=dev)
        ti = TileConfig(bm, bn, bk, GridOrder.K_INNER)
        to = TileConfig(bm, bn, bk, GridOrder.K_OUTER)
        lib = cuda_ms(lambda: mm(a, b))
        for kname, fn, plain_fn, c_in in (
                ("gemm_k_inner", lambda: K.gemm_k_inner(a, b, tile=ti),
                 lambda: K.gemm_k_inner_plain(a, b), False),
                ("gemm_k_outer", lambda: K.gemm_k_outer(a, b, c0, tile=to),
                 lambda: K.gemm_k_outer_plain(a, b, c0, bk=bk), True)):
            ms = cuda_ms(fn, max_reps=5 if slow else 50)
            pms = cuda_ms(plain_fn, min_total_ms=100.0,
                          max_reps=2 if slow else 10) if plain else None
            bms, by = bound(m, n, k, tag, c_in)
            row = {"kernel": kname, "dtype": tag, "gemm": name,
                   "shape": [m, n, k],
                   "tile": str(to if c_in else ti), "ms": ms,
                   "plain_ms": pms, "library_ms": lib, "bound_ms": bms,
                   "bound_by": by, "tflops": 2.0 * m * n * k / ms / 1e9,
                   "bound_share": bms / ms}
            if c_in:
                row["c_stream_ms"] = c_stream_ms(m, n, k, bk, tag)
            rows.append(row)
            if not quiet:
                floor = (f", C-stream floor {row['c_stream_ms']:.4f} ms"
                         if c_in else "")
                shown = f"plain {pms:.4f} ms, " if plain else ""
                print(f"{kname:<13}{tag:<5}{name:<8}{m}x{n}x{k}: {ms:.4f} ms "
                      f"({row['tflops']:.2f} T(FL)OP/s, "
                      f"{100 * row['bound_share']:.1f}% of the bound), "
                      f"{shown}{mm.__name__} {lib:.4f} ms, "
                      f"bound {bms:.4f} ms ({by}){floor}")
        del a, b, c0
        torch.cuda.empty_cache()
    if not quiet:
        for kname in ("gemm_k_inner", "gemm_k_outer"):
            mine = [r for r in rows if r["kernel"] == kname]
            floor = (f", C-stream floor "
                     f"{sum(r['c_stream_ms'] for r in mine):.4f} ms"
                     if kname == "gemm_k_outer" else "")
            shown = (f"plain {sum(r['plain_ms'] for r in mine):.4f} ms, "
                     if plain else "")
            print(f"{kname} {tag} over the five GEMMs at "
                  f"{tiles_label(shapes)}: "
                  f"{sum(r['ms'] for r in mine):.4f} ms, {mm.__name__} "
                  f"{sum(r['library_ms'] for r in mine):.4f} ms, {shown}"
                  f"bound {sum(r['bound_ms'] for r in mine):.4f} ms{floor}")
    return rows


def stage_timings(K, shapes, dev, tag="bf16"):
    """k-inner at each shape in ``tag`` with its stage cap at its value and
    at another, in turns: bf16's ``K.WGMMA_STAGES`` (two: two blocks share
    an SM at the planner's tile) against four (as many as fit: one block
    per SM); int8's ``K.S8_STAGES`` (as many as fit without costing a
    resident block) against two.  Returns the rows (ms by the stages a
    block kept) and prints the sums."""
    import torch
    from repro_torch.core.tpu_model import TileConfig

    rows = []
    knob, other = ("WGMMA_STAGES", 4) if tag == "bf16" else ("S8_STAGES", 2)
    default = getattr(K, knob)
    for i, (name, m, n, k, (bm, bn, bk)) in enumerate(shapes):
        tile = TileConfig(bm, bn, bk)
        a, b = seeded(m, n, k, tag, 2000 + i, dev)
        times = {}
        try:
            for cap in (default, other, other, default):
                setattr(K, knob, cap)
                st = K.check_tile(tile, tag).stages
                times.setdefault(st, []).append(cuda_ms(
                    lambda: K.gemm_k_inner(a, b, tile=tile)))
        finally:
            setattr(K, knob, default)
        rows.append({"gemm": name, "shape": [m, n, k],
                     "ms_by_stages": {st: min(v) for st, v in
                                      times.items()}})
        del a, b
        torch.cuda.empty_cache()
    sums = {}
    for r in rows:
        for st, v in r["ms_by_stages"].items():
            sums[st] = sums.get(st, 0.0) + v
    print(f"gemm_k_inner {tag} over the five GEMMs at "
          f"{tiles_label(shapes)} by shared-memory stages (the "
          f"faster of two turns each): "
          + ", ".join(f"{st} stage(s) {v:.4f} ms" for st, v in
                      sorted(sums.items())))
    return rows


def table2_timings(K, cells, dev):
    """int8 k-inner at each Table-2 cell [(m, n, k, (bm, bn, bk))] on the
    planner's tile, by CUDA events, as phase 4's int8 campaign runs it:
    launch-bound cells, so the events read the host's enqueue rate where it
    is slower than the device; and the wrapper's host µs per call
    (:func:`host_us`).  Takes only the module's ``gemm_k_inner``, so it
    also times an older tree's module."""
    import torch
    from repro_torch.core.tpu_model import TileConfig

    rows = []
    for i, (m, n, k, t) in enumerate(cells):
        a, b = seeded(m, n, k, "int8", 3000 + i, dev)
        tile = TileConfig(*t)
        fn = lambda: K.gemm_k_inner(a, b, tile=tile)  # noqa: E731
        rows.append({"shape": [m, n, k], "tile": list(t),
                     "ms": cuda_ms(fn, min_total_ms=50.0),
                     "host_us": host_us(fn, calls=50)})
        del a, b
    torch.cuda.empty_cache()
    return rows


def int8_turn(K, dev, shapes):
    """One turn of the int8 and f32 comparison with ``--parent``: the
    Qwen2-1.5B GEMMs at each tile of ``shapes["qwen"]`` in int8 and of
    ``shapes["f32"]`` in f32 (the CUDA cores; both orders) and the Table-2
    int8 cells of ``shapes["table2"]`` (k-inner), in this process's
    tree."""
    return {"qwen": {name: gemm_timings(K, rows, dev, plain=False,
                                        quiet=True, tag="int8")
                     for name, rows in shapes["qwen"].items()},
            "table2": table2_timings(K, shapes["table2"], dev),
            "f32": {name: gemm_timings(K, rows, dev, plain=False,
                                       quiet=True, tag="f32")
                    for name, rows in shapes["f32"].items()}}


def transpose_timings(K, shapes, dev):
    """The int8 route's transposed copy of B alone (``K.transposed_copy``)
    at each shape's B, by CUDA events, beside its bytes bound (K x N read,
    N x K rounded up to 16 written); returns the rows and prints them."""
    import torch

    rows = []
    for i, (name, m, n, k, _) in enumerate(shapes):
        _, b = seeded(1, n, k, "int8", 2000 + i, dev)
        ms = cuda_ms(lambda: K.transposed_copy(b))
        nbytes = k * n + n * -(-k // 16) * 16
        rows.append({"gemm": name, "shape": [k, n], "ms": ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        print(f"transposed copy of B {k}x{n} ({name}): {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, bytes bound "
              f"{rows[-1]['bound_ms']:.4f} ms")
        del b
    torch.cuda.empty_cache()
    print(f"transposed copies over the five GEMMs: "
          f"{sum(r['ms'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms")
    return rows


def compare_int8(turns):
    """Prints the int8 turns (parent, change, change, parent) of
    :func:`int8_turn`: each Qwen2-1.5B GEMM and its sum per tile and order,
    and each Table-2 cell and their sum."""
    print("int8 GEMMs, parent vs this change on this card (order: parent, "
          "change, change, parent; ms by CUDA events):")
    for tile in turns[0]["qwen"]:
        for kname in ("gemm_k_inner", "gemm_k_outer"):
            per = [[r for r in t["qwen"][tile] if r["kernel"] == kname]
                   for t in turns]
            for r0, r1, r2, r3 in zip(*per):
                print(f"  {tile} {kname:<13}{r1['gemm']:<8}parent "
                      f"{r0['ms']:.4f} / {r3['ms']:.4f}, change "
                      f"{r1['ms']:.4f} / {r2['ms']:.4f}")
            sums = [sum(r["ms"] for r in rs) for rs in per]
            lib = sum(r["library_ms"] for r in per[1])
            extra = (f", C-stream floor "
                     f"{sum(r['c_stream_ms'] for r in per[1]):.4f}"
                     if kname == "gemm_k_outer" else "")
            print(f"  {tile} {kname} sum: parent {sums[0]:.4f} / "
                  f"{sums[3]:.4f}, change {sums[1]:.4f} / {sums[2]:.4f} "
                  f"({min(sums[0], sums[3]) / min(sums[1], sums[2]):.1f}x); "
                  f"torch._int_mm {lib:.4f}{extra}")
    cells = [t["table2"] for t in turns]
    for r0, r1, r2, r3 in zip(*cells):
        m, n, k = r1["shape"]
        print(f"  Table-2 {m}x{n}x{k} ({'x'.join(map(str, r1['tile']))}): "
              f"parent {r0['ms']:.4f} / {r3['ms']:.4f}, change "
              f"{r1['ms']:.4f} / {r2['ms']:.4f}; host us a call parent "
              f"{r0['host_us']:.1f} / {r3['host_us']:.1f}, change "
              f"{r1['host_us']:.1f} / {r2['host_us']:.1f}")
    sums = [sum(r["ms"] for r in c) for c in cells]
    print(f"  Table-2 int8 sum over {len(cells[0])} cells: parent "
          f"{sums[0]:.4f} / {sums[3]:.4f}, change {sums[1]:.4f} / "
          f"{sums[2]:.4f}")
    for tile in turns[0]["f32"]:
        for kname in ("gemm_k_inner", "gemm_k_outer"):
            per = [[r for r in t["f32"][tile] if r["kernel"] == kname]
                   for t in turns]
            for r0, r1, r2, r3 in zip(*per):
                print(f"  f32 {tile} {kname:<13}{r1['gemm']:<8}parent "
                      f"{r0['ms']:.4f} / {r3['ms']:.4f}, change "
                      f"{r1['ms']:.4f} / {r2['ms']:.4f}")
            sums = [sum(r["ms"] for r in rs) for rs in per]
            extra = (f", C-stream floor "
                     f"{sum(r['c_stream_ms'] for r in per[1]):.4f}"
                     if kname == "gemm_k_outer" else "")
            print(f"  f32 {tile} {kname} sum (CUDA cores): parent "
                  f"{sums[0]:.4f} / {sums[3]:.4f}, change {sums[1]:.4f} / "
                  f"{sums[2]:.4f} "
                  f"({min(sums[0], sums[3]) / min(sums[1], sums[2]):.2f}x); "
                  f"torch.matmul {sum(r['library_ms'] for r in per[1]):.4f}"
                  f", bound {sum(r['bound_ms'] for r in per[1]):.4f}{extra}")


def tree_run(tree, what, out, shapes=None):
    """One measurement of a tree (an export of an earlier commit, or this
    checkout), made by this script's own functions in a fresh process that
    imports that tree's ``repro_torch``: ``"gemm"`` (phase 5's GEMM times
    at ``shapes``), ``"gemm_int8"`` (phase 5's int8 turn, :func:`int8_turn`
    at ``shapes``), ``"grouped"`` (phase 6's grouped times), ``"serve"``
    (phase 7's served decode step and profiled drain), ``"norm"`` (phase
    10's RMSNorm times at the served rows) or ``"flash"`` (phase 10's flash
    attention times at ``FLASH_TURN_SHAPES``)."""
    path = os.path.join(out, f"tree_{what}.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--time-tree", os.path.abspath(tree),
                           "--what", what, "--out", path, "--shapes",
                           json.dumps(shapes)], capture_output=True,
                          text=True, timeout=1800)
    check(proc.returncode == 0, f"{tree}'s {what} run failed (exit "
                                f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                                f"\n{proc.stderr[-3000:]}")
    with open(path) as f:
        return json.load(f)


def time_tree(tree, what, shapes, path):
    """The child process of :func:`tree_run`."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if what == "gemm":
        from repro_torch.kernels import gemm as K
        res = gemm_timings(K, [(n, m, nn, k, tuple(t)) for n, m, nn, k, t in
                               shapes], dev, plain=False, quiet=True)
    elif what == "gemm_int8":
        from repro_torch.kernels import gemm as K
        res = int8_turn(K, dev, {
            "qwen": {t: [(n, m, nn, k, tuple(tl)) for n, m, nn, k, tl in
                         rows] for t, rows in shapes["qwen"].items()},
            "table2": [(m, n, k, tuple(t)) for m, n, k, t in
                       shapes["table2"]],
            "f32": {t: [(n, m, nn, k, tuple(tl)) for n, m, nn, k, tl in
                        rows] for t, rows in shapes["f32"].items()}})
    elif what == "grouped":
        from repro_torch.kernels import grouped_gemm as G
        res = {tag: grouped_timings(G, dev, plain=False, tag=tag)
               for tag in ("bf16", "f32")}
    elif what == "norm":
        from repro_torch.kernels import rmsnorm as R
        res = norm_timings(R, dev)
    elif what == "flash":
        from repro_torch.kernels import flash_attention as FA
        res = flash_timings(FA, dev)
    else:
        from repro_torch.configs import get_config
        res = served_steps()
        res["profile"] = profile_serving(
            get_config("granite-moe-3b-a800m"), quiet=True)
    with open(path, "w") as f:
        json.dump(res, f)
    return 0


def compare_with_parent(rows, again, parent):
    """Prints the parent's and this tree's GEMM times, timed in the order
    parent, change, change, parent on one card."""
    print("parent vs this change on this card (order: parent, change, "
          "change, parent; ms):")
    for kname in ("gemm_k_inner", "gemm_k_outer"):
        sums = []
        for rs in (parent[0], rows, again, parent[1]):
            sums.append(sum(r["ms"] for r in rs if r["kernel"] == kname))
        for r0, r1, r2, r3 in zip(*[[r for r in rs if r["kernel"] == kname]
                                    for rs in (parent[0], rows, again,
                                               parent[1])]):
            print(f"  {kname:<13}{r1['gemm']:<8}parent {r0['ms']:.4f} / "
                  f"{r3['ms']:.4f}, change {r1['ms']:.4f} / {r2['ms']:.4f}")
        print(f"  {kname} sum: parent {sums[0]:.4f} / {sums[3]:.4f}, change "
              f"{sums[1]:.4f} / {sums[2]:.4f} "
              f"({min(sums[0], sums[3]) / min(sums[1], sums[2]):.1f}x)")


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
    "ragged D/F": (3, 24, 201, 75),   # rows TMA cannot read: both copied
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
    """Phase 6: the grouped kernel against its plain version, then timed
    (with ``--parent``, beside that tree's times).  Returns (timing rows,
    max |err| over the bf16 comparisons, the parent's rows)."""
    import torch

    phase(6, "grouped kernel vs plain version on the card, and timing")
    err = {"bf16": 0.0, "f32": 0.0}
    exact = {"kernel": 0.0, "plain": 0.0}
    G.reset_launch_counts()
    expect = {"wgmma": 0, "cuda_cores": 0}
    copies = 0
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
            expect[G.route(dt)] += 1
            if tag == "bf16":
                copies += (d % 8 != 0) + (f % 8 != 0)
            want = G.grouped_gemm_plain(x, w)
            err[tag] = max(err[tag], compare("grouped_gemm", tag, got, want))
            if tag == "f32":
                ref = torch.einsum("ecd,edf->ecf", x.double(), w.double())
                for side, y in (("kernel", got), ("plain", want)):
                    exact[side] = max(exact[side], float(
                        (y.double() - ref).abs().max()))
        print(f"{name:<19}({e}, {c}, {d}) @ ({e}, {d}, {f}) tile "
              f"{G.grouped_tile(c, torch.bfloat16)} (bf16), "
              f"{G.grouped_tile(c, torch.float32)} (f32): both match the "
              f"plain version")
    routes = dict(G.ROUTES)
    print(f"phase 6 grouped launches by route: {routes}, expected {expect} "
          f"(every bf16 launch on wgmma, every f32 one on the CUDA cores); "
          f"aligned copies {G.COPIES['aligned']}, expected {copies}")
    check(routes == expect and G.LAUNCHES["grouped_gemm"] == sum(
        expect.values()), f"phase 6 grouped launches by route {routes} are "
                          f"not {expect}")
    check(G.COPIES["aligned"] == copies, f"{G.COPIES['aligned']} aligned "
                                         f"copies, not {copies}")
    print(f"max |err|: bf16 {err['bf16']:.4g}, f32 {err['f32']:.4g}; f32 "
          f"against a float64 product: kernel {exact['kernel']:.4g}, plain "
          f"version {exact['plain']:.4g}")
    stage_rows = grouped_stage_timings(G, dev)
    parent = []
    if args.parent:
        parent.append(tree_run(args.parent, "grouped", args.out))
    mine = {tag: grouped_timings(G, dev, tag=tag) for tag in ("bf16", "f32")}
    if args.parent:
        again = {tag: grouped_timings(G, dev, plain=False, tag=tag)
                 for tag in ("bf16", "f32")}
        parent.append(tree_run(args.parent, "grouped", args.out))
        for tag in ("bf16", "f32"):
            print(f"grouped {tag}, parent vs this change on this card "
                  f"(order: parent, change, change, parent; device ms by "
                  f"CUDA-graph replay, event ms in brackets):")
            sums = [[0.0, 0.0] for _ in range(4)]
            for r0, r1, r2, r3 in zip(parent[0][tag], mine[tag], again[tag],
                                      parent[1][tag]):
                print(f"  {r1['shape_name']:<19}parent {r0['ms']:.4f} / "
                      f"{r3['ms']:.4f} ({r0['event_ms']:.4f} / "
                      f"{r3['event_ms']:.4f}), change {r1['ms']:.4f} / "
                      f"{r2['ms']:.4f} ({r1['event_ms']:.4f} / "
                      f"{r2['event_ms']:.4f})")
                if r1["served"]:
                    for j, r in enumerate((r0, r1, r2, r3)):
                        sums[j][0] += r["ms"]
                        sums[j][1] += r["event_ms"]
            best_p = min(sums[0][0], sums[3][0])
            best_c = min(sums[1][0], sums[2][0])
            print(f"  {tag} served-shape sum: parent {sums[0][0]:.4f} / "
                  f"{sums[3][0]:.4f} ms, change {sums[1][0]:.4f} / "
                  f"{sums[2][0]:.4f} ms ({best_p / best_c:.3f}x; change "
                  f"{100 * (best_c / best_p - 1):+.1f}%); events: parent "
                  f"{sums[0][1]:.4f} / {sums[3][1]:.4f}, change "
                  f"{sums[1][1]:.4f} / {sums[2][1]:.4f}")
    return mine, err["bf16"], parent, stage_rows


#: phase 6: the grouped ring's stage caps timed in turns (8: as many
#: stages as fit three blocks to an SM, 5-7 at the served shapes)
GROUPED_STAGE_CAPS = (3, 2, 4, 8)


def grouped_stage_timings(G, dev):
    """The bf16 grouped kernel at the served shapes with the ring capped at
    each of ``GROUPED_STAGE_CAPS`` stages, in turns (the caps in order,
    then reversed), device ms by CUDA-graph replay; prints the sums (the
    faster turn of each) and returns the rows."""
    import torch

    ops = []
    for i, name in enumerate(SERVED_SHAPES):
        e, c, d, f = GROUPED_SHAPES[name]
        g = torch.Generator(dev).manual_seed(450 + i)
        ops.append((name, torch.randn((e, c, d), generator=g, device=dev,
                                      dtype=torch.bfloat16),
                    torch.randn((e, d, f), generator=g, device=dev,
                                dtype=torch.bfloat16)))
    default = G.WGMMA_MAX_STAGES
    times = {}
    try:
        for cap in GROUPED_STAGE_CAPS + GROUPED_STAGE_CAPS[::-1]:
            G.WGMMA_MAX_STAGES = cap
            G._PLANS.clear()
            for name, x, w in ops:
                times.setdefault((cap, name), []).append(
                    graph_ms(lambda: G.grouped_gemm(x, w)))
    finally:
        G.WGMMA_MAX_STAGES = default
        G._PLANS.clear()
    rows = [{"cap": cap, "shape_name": name, "ms": min(v)}
            for (cap, name), v in times.items()]
    print("grouped over the four served shapes by the ring's stage cap "
          "(device ms, the faster of two turns each): " + ", ".join(
              f"cap {cap} {sum(r['ms'] for r in rows if r['cap'] == cap):.4f}"
              for cap in GROUPED_STAGE_CAPS) + f" (in use: {default})")
    return rows


def grouped_timings(G, dev, *, plain=True, tag="bf16"):
    """The grouped kernel in ``tag`` (bf16: wgmma; f32: the CUDA cores) at
    every ``GROUPED_SHAPES`` entry: device ms by CUDA-graph replay and ms by
    CUDA events, and (``plain``) the plain version, ``torch.bmm`` and the
    bound beside them, printed.  Takes only ``G.grouped_gemm`` /
    ``G.grouped_gemm_plain``, so it also times an older tree's module
    (quietly: ``plain`` False)."""
    import torch

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
    rows = []
    for i, (name, (e, c, d, f)) in enumerate(GROUPED_SHAPES.items()):
        g = torch.Generator(dev).manual_seed(400 + i)
        x = torch.randn((e, c, d), generator=g, device=dev, dtype=dt)
        w = torch.randn((e, d, f), generator=g, device=dev, dtype=dt)
        row = {"kernel": "grouped_gemm", "dtype": tag, "shape_name": name,
               "shape": [e, c, d, f], "served": name in SERVED_SHAPES,
               "ms": graph_ms(lambda: G.grouped_gemm(x, w)),
               "event_ms": cuda_ms(lambda: G.grouped_gemm(x, w))}
        rows.append(row)
        if not plain:
            continue
        ms = row["ms"]
        bms, by = grouped_bound(e, c, d, f, tag)
        row.update({
            "tile": str(G.grouped_tile(c, dt)),
            "plain_ms": graph_ms(lambda: G.grouped_gemm_plain(x, w),
                                 calls=4),
            "plain_event_ms": cuda_ms(lambda: G.grouped_gemm_plain(x, w),
                                      min_total_ms=100.0, max_reps=10),
            "library_ms": graph_ms(lambda: torch.bmm(x, w)),
            "library_event_ms": cuda_ms(lambda: torch.bmm(x, w)),
            "bound_ms": bms, "bound_by": by,
            "tflops": 2.0 * e * c * d * f / ms / 1e9,
            "tb_per_s": (e * c * d + e * d * f + e * c * f)
            * ELEM_BYTES[tag] / ms / 1e9,
            "bound_share": bms / ms})
        print(f"grouped {name:<19}{tag}: device {ms:.4f} ms (events "
              f"{row['event_ms']:.4f}; {row['tb_per_s']:.2f} TB/s, "
              f"{100 * bms / ms:.1f}% of the bound), plain "
              f"{row['plain_ms']:.4f} ms, torch.bmm {row['library_ms']:.4f} "
              f"ms (events {row['library_event_ms']:.4f}), bound "
              f"{bms:.4f} ms ({by})")
        del x, w
    torch.cuda.empty_cache()
    if plain:
        served = [r for r in rows if r["served"]]
        tot = {k: sum(r[k] for r in served) for k in
               ("ms", "event_ms", "library_ms", "library_event_ms",
                "bound_ms")}
        print(f"grouped {tag} over the four served shapes: device "
              f"{tot['ms']:.4f} ms (events {tot['event_ms']:.4f}), "
              f"torch.bmm {tot['library_ms']:.4f} (events "
              f"{tot['library_event_ms']:.4f}), bound {tot['bound_ms']:.4f} "
              f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
    return rows


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

    def shape_launch(x, w, y, plan):
        shapes.add((*x.shape, w.shape[2]))
        launch(x, w, y, plan)

    engine_cls = serve_mod.ServingEngine
    serve_mod.ServingEngine, G._launch = Recording, shape_launch
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    G.reset_launch_counts()
    try:
        out = serve_mod.serve_demo(**SERVED_RUN)
        launches = {**K.LAUNCHES, **G.LAUNCHES}
        routes = dict(K.ROUTES)
        grouped_routes = dict(G.ROUTES)
    finally:
        serve_mod.ServingEngine, G._launch = engine_cls, launch
    print(f"serving-path launches: {launches}")
    all_on_wgmma(K, "phase 7's served run")
    print(f"phase 7's served run: {launches['grouped_gemm']} grouped "
          f"launches, by route {grouped_routes}")
    check(grouped_routes == {"wgmma": launches["grouped_gemm"],
                             "cuda_cores": 0},
          f"grouped launches by route {grouped_routes}: not every one of "
          f"the {launches['grouped_gemm']} bf16 launches went through wgmma")
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
    res = {**step_times(out), "grouped_per_forward": per_fwd,
           "peak_memory_gb": peak_gb, "grouped_shapes": sorted(shapes),
           "gemm_routes": routes, "grouped_routes": grouped_routes,
           **launches}
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
    res["logits_gemm"] = served_logits_timing(cfg, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    return res


#: phase 7's served run (``serve_demo``'s arguments)
SERVED_RUN = dict(arch="granite-moe-3b-a800m", smoke=False, n_requests=8,
                  max_new=12, max_batch=4, max_len=256, seed=0,
                  device="cuda")


def step_times(out):
    """Tokens per second and mean wall ms per step (all steps, and decode
    steps without admissions) of a ``serve_demo`` result."""
    decode = [st["dt"] for st in out["steps"] if st["admitted"] == 0]
    all_steps = [st["dt"] for st in out["steps"]]
    return {"tokens": out["tokens"], "seconds": out["seconds"],
            "tokens_per_s": out["tokens"] / out["seconds"],
            "steps": len(all_steps), "prefills": out["prefills"],
            "decode_steps": len(decode),
            "decode_step_ms": 1e3 * sum(decode) / max(len(decode), 1),
            "step_ms_all": 1e3 * sum(all_steps) / len(all_steps)}


def served_steps():
    """Phase 7's served run, for an older tree: its step times."""
    import contextlib
    import io
    from repro_torch.launch import serve as serve_mod
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve_mod.serve_demo(**SERVED_RUN)
    return step_times(out)


def replay_served(eng, kept, rtol=BF16_LOGITS_RTOL):
    """Phase 7's logits check: each request in ``REPLAYED`` goes through a
    per-request ``decode_step`` loop at batch 1, with the served run's
    weights, fed the tokens it was served; its logits must agree with the
    ones the served run computed, to ``rtol`` relative L2 (None: printed,
    not held), and lie further from another request's."""
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
          f"run's at every step (tolerance {rtol}); request {a} "
          f"against request {b}: {mixed:.4g}; smallest top-1 logit gap "
          f"{min(gaps):.4g}")
    if rtol is not None:
        check(worst <= rtol,
              f"served logits differ from the replay by {worst:.4g} "
              f"relative L2 (per step: {errs})")
        check(mixed > 10 * rtol,
              f"two requests' logits differ by only {mixed:.4g}: the check "
              f"cannot tell them apart")
    check(mixed > worst, f"served logits lie {worst:.4g} from their own "
                         f"replay, no nearer than another request's "
                         f"({mixed:.4g})")
    return {"requests": list(REPLAYED), "rel_l2_max": worst,
            "rel_l2_per_step": errs, "other_request_rel_l2": mixed,
            "min_top1_gap": min(gaps)}


#: the grouped kernel's name in a profile: this tree's wgmma kernel, or
#: the CUDA-core tile kernel an older tree ran it on (in a bf16 serve the
#: GEMMs run wgmma_gemm, so there tile_gemm is the grouped kernel alone)
GROUPED_KERNELS = ("grouped_wgmma", "tile_gemm")


def profile_serving(cfg, quiet=False):
    """One engine's drain (4 requests x 6 tokens, max_batch 4) under
    torch.profiler, the model built and the requests queued beforehand:
    device time by kernel (device-side events only, so nothing is counted
    twice), the grouped kernel's share of it and the device's busy share
    of the drain's wall time."""
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
    gemm_rows = [r for r in rows if "wgmma_gemm" in r["name"]]
    grouped_rows = [r for r in rows
                    if any(n in r["name"] for n in GROUPED_KERNELS)]
    grouped_ms = sum(r["device_ms"] for r in grouped_rows)
    del eng, lm
    res = {"wall_ms": wall_ms, "steps": steps, "device_busy_ms": busy,
           "device_events": sum(r["count"] for r in rows),
           "top": rows[:25], "gemm_rows": gemm_rows,
           "grouped_rows": grouped_rows, "grouped_device_ms": grouped_ms,
           "grouped_share": grouped_ms / busy if busy else 0.0}
    if quiet:
        return res
    print(f"profile of one drain (4 requests x 6 tokens, {steps} steps, "
          f"profiler on): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {res['device_events']} device "
          f"events")
    for r in rows[:12]:
        print(f"  {r['device_ms']:9.3f} ms {r['count']:6d}x  {r['name'][:90]}")
    for label, picked in (("GEMM (wgmma)", gemm_rows),
                          ("grouped", grouped_rows)):
        for r in picked:
            print(f"  {label}: {r['device_ms']:.4f} ms over {r['count']} "
                  f"calls, {r['device_ms'] / r['count']:.4f} ms per call  "
                  f"{r['name'][:60]}")
    if cfg.n_experts:
        print(f"  grouped kernel: {grouped_ms:.3f} ms of {busy:.3f} ms "
              f"device time ({100 * res['grouped_share']:.1f}%)")
    return res


def served_logits_timing(cfg, dev):
    """The served logits GEMM at decode (M = max_batch 4 rows against the
    (d_model, padded vocab) head) on the planner's tile, timed with CUDA
    events beside ``torch.matmul`` and its bound (the head's bytes)."""
    import torch
    from repro_torch import gemm

    m, n, k = 4, cfg.padded_vocab, cfg.d_model
    plan = gemm.plan((m, n, k), backend="cuda", machine="h100",
                     dtype="bf16")
    a, b = seeded(m, n, k, "bf16", 9, dev)
    ms = cuda_ms(lambda: plan.execute(a, b))
    lib = cuda_ms(lambda: torch.matmul(a, b))
    bms, by = bound(m, n, k, "bf16", False)
    print(f"served logits GEMM at decode {m}x{n}x{k}, tile {plan.selection}: "
          f"{ms:.4f} ms per call, torch.matmul {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    return {"shape": [m, n, k], "tile": str(plan.selection), "ms": ms,
            "library_ms": lib, "bound_ms": bms, "bound_by": by}


def compare_serving(served, turns):
    """Prints the served decode step and the profiled drain's grouped
    share of parent and change, each run in a fresh process on this card
    in the order parent, change, change, parent (``turns``), beside phase
    7's own run of this tree."""
    p0, c1, c2, p1 = turns
    print("serving, parent vs this change on this card (fresh processes, "
          "order: parent, change, change, parent; phase 7's run in this "
          "process last):")
    for label, key in (("decode step ms", "decode_step_ms"),
                       ("tok/s", "tokens_per_s")):
        print(f"  {label}: parent {p0[key]:.3f} / {p1[key]:.3f}, change "
              f"{c1[key]:.3f} / {c2[key]:.3f}; phase 7 {served[key]:.3f}")
    for label, key, scale in (("grouped device ms", "grouped_device_ms", 1),
                              ("grouped share of device time %",
                               "grouped_share", 100),
                              ("device busy ms", "device_busy_ms", 1),
                              ("drain wall ms", "wall_ms", 1),
                              ("device events", "device_events", 1)):
        print(f"  {label} (profiled drain): parent "
              f"{scale * p0['profile'][key]:.3f} / "
              f"{scale * p1['profile'][key]:.3f}, change "
              f"{scale * c1['profile'][key]:.3f} / "
              f"{scale * c2['profile'][key]:.3f}; phase 7 "
              f"{scale * served['profile'][key]:.3f}")


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


#: phase 10: attention shapes (B, S, H, D) at full width, causal, dtypes
ATTN_SHAPES = (
    ("granite S=32", (1, 32, 24, 64), True, ("bf16", "f32")),
    ("granite S=256", (1, 256, 24, 64), True, ("bf16", "f32")),
    ("granite S=4096", (1, 4096, 24, 64), True, ("bf16", "f32")),
    ("granite S=4096 full", (1, 4096, 24, 64), False, ("bf16", "f32")),
    ("granite S=32768", (1, 32768, 24, 64), True, ("bf16",)),
    ("qwen2-1.5b S=4096", (1, 4096, 12, 128), True, ("bf16", "f32")),
    # head dims the 64- and 128-wide instantiations hold past their width,
    # and the 256-wide one: the smoke configs' 16, stablelm-12b's 160,
    # xlstm-125m's 192, paligemma-3b's 256; B * H past 65,535
    ("smoke D=16", (2, 128, 4, 16), True, ("bf16", "f32")),
    ("D=32", (1, 256, 8, 32), True, ("bf16", "f32")),
    ("stablelm-12b D=160", (1, 2048, 32, 160), True, ("bf16", "f32")),
    ("xlstm-125m D=192", (1, 2048, 4, 192), True, ("bf16", "f32")),
    ("paligemma-3b D=256", (1, 2048, 8, 256), True, ("bf16", "f32")),
    ("B*H=70000 D=16", (1000, 64, 70, 16), True, ("bf16",)),
    # a head dim whose rows TMA cannot read in place: q, k, v copied
    ("ragged D=100", (1, 512, 4, 100), True, ("bf16",)),
)
#: phase 10: RMSNorm rows of D = 1536 (both models' d_model)
NORM_ROWS = (4, 32, 4096, 32768)
NORM_D = 1536
#: phase 10: RMSNorm past the register path (name, rows, D, layout):
#: kimi-k2-1t's d_model 7168 (two passes in f32), a D that is no multiple
#: of the vector width (scalar path), a non-contiguous x (copied first)
NORM_EXTRA = (("kimi-k2-1t d_model", 4096, 7168, "contiguous"),
              ("ragged D", 4096, 1001, "contiguous"),
              ("non-contiguous x", 4096, 1536, "transposed"))
#: the shapes phase 9 records from the served model (bucket-32 prefill,
#: decode at max_batch 4); the kernels line sums phase 10's times at these
SERVED_ATTN = (1, 32, 24, 64)
SERVED_NORM_ROWS = (32, 4)
#: from this length on, the plain attention runs one head at a time
PLAIN_PER_HEAD_FROM = 16384
#: flash attention against its plain version, and against the model's
#: blockwise attention (rtol = atol)
FLASH_TOL = {"f32": 1e-5, "bf16": 3e-2}
FLASH_MODEL_TOL = {"f32": 2e-5, "bf16": 3e-2}


def attention_bound(b, s, h, d, causal, tag):
    """(ms, "bytes" | "operations"): q, k, v read once and o written once
    over 3.35 TB/s; 4*B*H*D operations per visible (query, key) pair over
    the dtype's peak."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_bytes = 4 * b * s * h * d * ELEM_BYTES[tag] / HBM_BYTES_PER_S
    t_ops = 4.0 * b * h * d * pairs / PEAK_OPS[tag]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def norm_bound(rows, d, tag):
    """(ms, "bytes"): x read and y written once, the f32 scale read once,
    over 3.35 TB/s (four operations per element are far below the ridge)."""
    return (2 * rows * d * ELEM_BYTES[tag] + 4 * d) / HBM_BYTES_PER_S * 1e3, \
        "bytes"


def plain_attention(FA, q, k, v, causal):
    """The plain version; one head at a time at long sequences, where all
    heads' f32 scores at once would not fit on the card."""
    import torch
    if q.shape[1] < PLAIN_PER_HEAD_FROM:
        return FA.flash_attention_plain(q, k, v, causal=causal)
    return torch.cat([FA.flash_attention_plain(
        q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1], causal=causal)
        for i in range(q.shape[2])], dim=2)


def flash_routes(FA, label, expect):
    """Fails unless the flash attention launches since the last reset went
    by route as ``expect`` says (bf16 on wgmma, f32 on the CUDA cores);
    prints them and the aligned copies."""
    want = {"wgmma": 0, "cuda_cores": 0, **expect}
    print(f"{label} flash attention launches by route: {dict(FA.ROUTES)}, "
          f"expected {want} (every bf16 launch on wgmma, every f32 one on "
          f"the CUDA cores); aligned copies {FA.COPIES['aligned']}")
    check(dict(FA.ROUTES) == want and sum(want.values())
          == FA.LAUNCHES["flash_attention"] > 0,
          f"{label}: flash attention launches by route {dict(FA.ROUTES)} "
          f"are not {want}")


def model_kernels_phase(dev, FA, R, ops):
    """Phase 9: granite's own attention and norm activations through the
    entry points.  Returns the launches and max |err| of each kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.model import LM

    phase(9, "flash attention and RMSNorm on granite-moe-3b-a800m's own "
             "activations")
    full = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=4, block_pattern=("moe",) * 4)
    print(f"depth cut {full.n_layers} -> {cfg.n_layers} layers; widths as "
          f"published (d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.n_kv_heads} KV heads); {cfg.compute_dtype}")
    lm = LM(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    params = lm.compute_params(lm.init(gen))
    rec = {"attn": [], "norm": []}
    blockwise, norm = attn_mod.blockwise_attention, layers_mod.apply_norm

    def recording_attention(q, k, v, *, chunk, causal, prefix_len=0):
        out = blockwise(q, k, v, chunk=chunk, causal=causal,
                        prefix_len=prefix_len)
        rec["attn"].append((q, k, v, causal, prefix_len, out))
        return out

    def recording_norm(p, x, c):
        y = norm(p, x, c)
        rec["norm"].append((x, p["scale"], c.norm_eps, c.norm_type, y))
        return y

    attn_mod.blockwise_attention = recording_attention
    layers_mod.apply_norm = recording_norm
    try:
        tokens = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen,
                               device=dev)
        lm.prefill(params, {"tokens": tokens})          # bucket 32
        caches = lm.init_cache(4, 64)
        lm.decode_step(params, caches, tokens[:, :4].T.contiguous(), 0)
        torch.cuda.synchronize()
    finally:
        attn_mod.blockwise_attention = blockwise
        layers_mod.apply_norm = norm
    del params, caches, lm
    attn_shapes = sorted({tuple(r[0].shape) for r in rec["attn"]})
    norm_shapes = sorted({tuple(r[0].shape) for r in rec["norm"]})
    print(f"recorded {len(rec['attn'])} attention calls {attn_shapes} "
          f"(KV already repeated to {cfg.n_heads} heads) and "
          f"{len(rec['norm'])} norm calls {norm_shapes}")
    check(attn_shapes == [SERVED_ATTN], f"attention shapes {attn_shapes} "
                                        f"are not {[SERVED_ATTN]}")
    want_norms = sorted((1, n, NORM_D) if n == 32 else (n, 1, NORM_D)
                        for n in SERVED_NORM_ROWS)
    check(norm_shapes == want_norms, f"norm shapes {norm_shapes} are not "
                                     f"{want_norms}")
    check(all(r[3] and not r[4] for r in rec["attn"]),
          "the model's attention was not plain causal")
    check(all(r[3] == "rmsnorm" for r in rec["norm"]),
          "the model's norm is not an RMSNorm")

    # the main path: the entry points on the model's own tensors
    FA.reset_launch_counts()
    R.reset_launch_counts()
    flash_out = [ops.flash_attention(q, k, v, causal=True)
                 for q, k, v, *_ in rec["attn"]]
    norm_out = [R.rmsnorm(x, scale, eps=eps)
                for x, scale, eps, *_ in rec["norm"]]
    torch.cuda.synchronize()
    launches = {**FA.LAUNCHES, **R.LAUNCHES}
    print(f"entry-point launches on the model's tensors: {launches}")
    for name_, n_ in launches.items():
        check(n_ > 0, f"{name_} was never launched in phase 9")
    flash_routes(FA, "phase 9", {
        FA.route(q.dtype): len(rec["attn"]) for q, *_ in rec["attn"]})

    err = {"flash_attention": 0.0, "rmsnorm": 0.0}
    model_err = {"flash_attention": 0.0, "rmsnorm": 0.0}
    for got, (q, k, v, _, _, out) in zip(flash_out, rec["attn"]):
        tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
        want = FA.flash_attention_plain(q, k, v, causal=True)
        err["flash_attention"] = max(err["flash_attention"], held(
            "flash_attention", tag, got, want,
            within(want, FLASH_TOL[tag], FLASH_TOL[tag])))
        model_err["flash_attention"] = max(
            model_err["flash_attention"],
            held("flash_attention vs blockwise_attention", tag, got, out,
                 within(out, FLASH_MODEL_TOL[tag], FLASH_MODEL_TOL[tag])))
    for got, (x, scale, eps, _, out) in zip(norm_out, rec["norm"]):
        tag = "bf16" if x.dtype == torch.bfloat16 else "f32"
        want = R.rmsnorm_plain(x, scale, eps=eps)
        err["rmsnorm"] = max(err["rmsnorm"], held(
            "rmsnorm", tag, got, want, norm_tolerance(tag, want)))
        model_err["rmsnorm"] = max(model_err["rmsnorm"], held(
            "rmsnorm vs apply_norm", tag, got, out, norm_tolerance(tag, out)))
    # the model keeps its norm scales in f32; the same scales in bf16,
    # read as they are, give the outputs of their f32 copies
    for x, scale, eps, _, _ in rec["norm"]:
        sb = scale.to(torch.bfloat16)
        check(torch.equal(R.rmsnorm(x, sb, eps=eps),
                          R.rmsnorm(x, sb.float(), eps=eps)),
              "RMSNorm on a bf16 scale differs from RMSNorm on its f32 copy")
    print(f"the model's norm scales are {rec['norm'][0][1].dtype}; in bf16 "
          f"they give the outputs of their f32 copies, bit for bit, at "
          f"every recorded call")
    print(f"max |err| against the plain versions: {err}; against the "
          f"model's own blockwise_attention / apply_norm: {model_err}")
    rec.clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err,
            "model_max_abs_err": model_err, "attention_shapes": attn_shapes,
            "norm_shapes": norm_shapes}


def attention_norm_phase(dev, FA, R, ops):
    """Phase 10: both kernels against their plain versions at full width,
    then timed beside the plain version, one PyTorch call and the bound."""
    import torch
    import torch.nn.functional as F

    phase(10, "flash attention and RMSNorm vs plain versions, and timing")
    FA.reset_launch_counts()
    R.reset_launch_counts()
    rows = []
    expect = {"wgmma": 0, "cuda_cores": 0}
    for i, (name, (b, s, h, d), causal, tags) in enumerate(ATTN_SHAPES):
        for tag in tags:
            n0 = FA.LAUNCHES["flash_attention"]
            g = torch.Generator(dev).manual_seed(500 + i)
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
            q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev,
                                   dtype=dt) for _ in range(3))
            got = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = plain_attention(FA, q, k, v, causal)
            err = held("flash_attention", tag, got, want,
                       within(want, FLASH_TOL[tag], FLASH_TOL[tag]))
            del got, want
            long_ = s >= PLAIN_PER_HEAD_FROM
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                         min_total_ms=50.0 if long_ else 200.0)
            pms = cuda_ms(lambda: plain_attention(FA, q, k, v, causal),
                          min_total_ms=100.0, max_reps=1 if long_ else 10)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bms, by = attention_bound(b, s, h, d, causal, tag)
            pairs = s * (s + 1) // 2 if causal else s * s
            rows.append({"kernel": "flash_attention", "shape_name": name,
                         "shape": [b, s, h, d], "causal": causal,
                         "dtype": tag, "max_abs_err": err,
                         "served": (b, s, h, d) == SERVED_ATTN and causal
                         and tag == "bf16",
                         "plain_per_head": long_, "ms": ms, "plain_ms": pms,
                         "library_ms": lib, "bound_ms": bms, "bound_by": by,
                         "tflops": 4.0 * b * h * d * pairs / ms / 1e9,
                         "bound_share": bms / ms})
            print(f"flash {name:<20}{'causal' if causal else 'full':<7}"
                  f"{tag:<5}: {ms:.4f} ms ({rows[-1]['tflops']:.3f} TFLOP/s, "
                  f"{100 * bms / ms:.2f}% of the bound), plain {pms:.4f} ms"
                  f"{' (one head at a time)' if long_ else ''}, SDPA "
                  f"{lib:.4f} ms ({ms / lib:.2f}x), bound {bms:.4f} ms "
                  f"({by}); max |err| {err:.3g}")
            expect[FA.route(q.dtype)] += FA.LAUNCHES["flash_attention"] - n0
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    flash_routes(FA, "phase 10", expect)
    f32_launches = expect["cuda_cores"]
    check(f32_launches > 0, "phase 10 launched no f32 flash attention kernel")
    norms = [(f"{n} rows", n, NORM_D, "contiguous") for n in NORM_ROWS]
    for i, (nname, n, nd, layout) in enumerate(norms + list(NORM_EXTRA)):
        for tag in ("bf16", "f32"):
            g = torch.Generator(dev).manual_seed(600 + i)
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
            if layout == "transposed":
                x = torch.randn((nd, n), generator=g, device=dev,
                                dtype=dt).t()
            else:
                x = torch.randn((n, nd), generator=g, device=dev, dtype=dt)
            # the scale in f32, as the models keep it (cast_for_compute);
            # F.rms_norm takes its weight in x's dtype
            scale = torch.randn((nd,), generator=g, device=dev)
            w = scale.to(dt)
            eps = 1e-5

            def kernel():
                return R.rmsnorm(x, scale, eps=eps)

            def library():
                return F.rms_norm(x, (nd,), weight=w, eps=eps)

            got = kernel()
            torch.cuda.synchronize()
            want = R.rmsnorm_plain(x, scale, eps=eps)
            err = held("rmsnorm", tag, got, want, norm_tolerance(tag, want))
            # a bf16 scale, read as it is, gives the output of its f32 copy
            sb = scale.to(torch.bfloat16)
            check(torch.equal(R.rmsnorm(x, sb, eps=eps),
                              R.rmsnorm(x, sb.float(), eps=eps)),
                  f"rmsnorm {nname} {tag}: the output for a bf16 scale "
                  f"differs from the output for its f32 copy")
            ms = graph_ms(kernel)
            bms, by = norm_bound(n, nd, tag)
            row = {"kernel": "rmsnorm", "shape_name": nname,
                   "shape": [n, nd], "dtype": tag, "layout": layout,
                   "path": R.kernel_input(x, scale)[1],
                   "max_abs_err": err,
                   "served": (n in SERVED_NORM_ROWS and nd == NORM_D
                              and tag == "bf16"),
                   "ms": ms, "event_ms": cuda_ms(kernel),
                   "host_us": host_us(kernel),
                   "plain_ms": graph_ms(
                       lambda: R.rmsnorm_plain(x, w, eps=eps)),
                   "library_ms": graph_ms(library),
                   "library_event_ms": cuda_ms(library),
                   "library_host_us": host_us(library),
                   "bound_ms": bms, "bound_by": by,
                   "gb_per_s": (2 * n * nd * ELEM_BYTES[tag] + 4 * nd)
                   / ms / 1e6,
                   "bound_share": bms / ms}
            rows.append(row)
            print(f"rmsnorm {nname:<19}{n:>6} x {nd} {tag:<5}{layout:<11}"
                  f"{row['path']:<10}: device {ms:.4f} ms "
                  f"({row['gb_per_s']:.1f} GB/s, {100 * bms / ms:.2f}% of "
                  f"the bound), events {row['event_ms']:.4f} ms, host "
                  f"{row['host_us']:.1f} us/call; plain {row['plain_ms']:.4f}"
                  f" ms; F.rms_norm device {row['library_ms']:.4f} ms, "
                  f"events {row['library_event_ms']:.4f} ms, host "
                  f"{row['library_host_us']:.1f} us/call; bound {bms:.5f} "
                  f"ms; max |err| {err:.3g}")
            del x, w, scale, sb, got, want
    for tag in ("bf16", "f32"):
        mine = {r["shape"][0]: r for r in rows if r["kernel"] == "rmsnorm"
                and r["dtype"] == tag and r["layout"] == "contiguous"
                and r["shape"][1] == NORM_D}
        print(f"RMSNorm {tag}, rows of {NORM_D}: " + "; ".join(
            f"{n}: device {r['ms']:.4f} / F.rms_norm {r['library_ms']:.4f} "
            f"ms, events {r['event_ms']:.4f} / {r['library_event_ms']:.4f} "
            f"ms, host {r['host_us']:.1f} / {r['library_host_us']:.1f} us"
            for n, r in sorted(mine.items())))
        big = mine[max(NORM_ROWS)]
        print(f"  {max(NORM_ROWS)} rows: {100 * big['bound_share']:.1f}% of "
              f"the bytes bound (>= 80 % "
              f"{'met' if big['bound_share'] >= 0.8 else 'NOT met'})")
    launches = {**FA.LAUNCHES, **R.LAUNCHES}
    print(f"phase 10 launches: {launches}")
    for name_, n_ in launches.items():
        check(n_ > 0, f"{name_} was never launched in phase 10")
    torch.cuda.empty_cache()
    return rows, f32_launches


#: phase 10 with ``--parent``: RMSNorm rows of NORM_D timed in both trees
NORM_TURN_ROWS = (4, 32, 32768)


def norm_timings(R, dev):
    """RMSNorm (bf16 x, the models' f32 scale) at ``NORM_TURN_ROWS`` rows:
    device ms by CUDA-graph replay, CUDA-event ms and host µs per call.
    Takes only ``R.rmsnorm``, so it also times an older tree's module."""
    import torch

    rows = []
    for n in NORM_TURN_ROWS:
        g = torch.Generator(dev).manual_seed(700 + n)
        x = torch.randn((n, NORM_D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        scale = torch.randn((NORM_D,), generator=g, device=dev)

        def kernel():
            return R.rmsnorm(x, scale)

        rows.append({"rows": n, "ms": graph_ms(kernel),
                     "event_ms": cuda_ms(kernel), "host_us": host_us(kernel)})
    return rows


def compare_norms(turns):
    """Prints RMSNorm's times of parent and change, each in a fresh process
    on this card, in the order parent, change, change, parent."""
    p0, c1, c2, p1 = turns
    print("RMSNorm (bf16, f32 scale), parent vs this change on this card "
          "(fresh processes, order: parent, change, change, parent):")
    for r0, r1, r2, r3 in zip(p0, c1, c2, p1):
        print(f"  {r1['rows']:>6} rows: device ms parent {r0['ms']:.4f} / "
              f"{r3['ms']:.4f}, change {r1['ms']:.4f} / {r2['ms']:.4f}; "
              f"events ms parent {r0['event_ms']:.4f} / {r3['event_ms']:.4f}"
              f", change {r1['event_ms']:.4f} / {r2['event_ms']:.4f}; host "
              f"us parent {r0['host_us']:.1f} / {r3['host_us']:.1f}, change "
              f"{r1['host_us']:.1f} / {r2['host_us']:.1f}")


#: phase 10 with ``--parent``: flash attention (causal) timed in both trees
FLASH_TURN_SHAPES = (
    ("granite S=32", (1, 32, 24, 64), "bf16"),
    ("granite S=4096", (1, 4096, 24, 64), "bf16"),
    ("qwen2-1.5b S=4096", (1, 4096, 12, 128), "bf16"),
    ("paligemma-3b D=256", (1, 2048, 8, 256), "bf16"),
    ("granite S=4096", (1, 4096, 24, 64), "f32"),
    ("qwen2-1.5b S=4096", (1, 4096, 12, 128), "f32"),
    ("paligemma-3b D=256", (1, 2048, 8, 256), "f32"),
    ("stablelm-12b D=160", (1, 2048, 32, 160), "f32"),
    ("xlstm-125m D=192", (1, 2048, 4, 192), "f32"),
    # the launch-bound f32 shapes
    ("granite S=32", (1, 32, 24, 64), "f32"),
    ("granite S=256", (1, 256, 24, 64), "f32"),
    ("smoke D=16", (2, 128, 4, 16), "f32"),
    ("D=32", (1, 256, 8, 32), "f32"),
)


def flash_timings(FA, dev):
    """Flash attention (causal) at ``FLASH_TURN_SHAPES``: CUDA-event ms,
    device ms by CUDA-graph replay and host µs per call.  Takes only
    ``FA.flash_attention_fwd``, so it also times an older tree's module."""
    import torch

    rows = []
    for i, (name, shape, tag) in enumerate(FLASH_TURN_SHAPES):
        g = torch.Generator(dev).manual_seed(800 + i)
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=dt)
                   for _ in range(3))

        def kernel():
            return FA.flash_attention_fwd(q, k, v, causal=True)

        rows.append({"shape_name": name, "shape": list(shape), "dtype": tag,
                     "event_ms": cuda_ms(kernel), "ms": graph_ms(kernel),
                     "host_us": host_us(kernel)})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def compare_flash(turns):
    """Prints flash attention's times of parent and change, each in a fresh
    process on this card, in the order parent, change, change, parent."""
    p0, c1, c2, p1 = turns
    print("flash attention (causal), parent vs this change on this card "
          "(fresh processes, order: parent, change, change, parent):")
    for r0, r1, r2, r3 in zip(p0, c1, c2, p1):
        speedup = min(r0["ms"], r3["ms"]) / min(r1["ms"], r2["ms"])
        print(f"  {r1['shape_name']:<19}{r1['dtype']:<5}device ms parent "
              f"{r0['ms']:.4f} / {r3['ms']:.4f}, change {r1['ms']:.4f} / "
              f"{r2['ms']:.4f} ({speedup:.2f}x); events ms parent "
              f"{r0['event_ms']:.4f} / {r3['event_ms']:.4f}, change "
              f"{r1['event_ms']:.4f} / {r2['event_ms']:.4f}; host us parent "
              f"{r0['host_us']:.1f} / {r3['host_us']:.1f}, change "
              f"{r1['host_us']:.1f} / {r2['host_us']:.1f}")


#: the phase-10 row whose f32 times the kernels line's flash_attention_f32
#: entry reports (causal)
FLASH_F32_ROW = "granite S=4096"


def flash_f32_phase1(FA, entries):
    """Phase 1 for the f32 flash attention kernel: each instantiation's
    registers and spills, the configuration per width in both block
    heights; fails on a spill."""
    for w in FA.F32_HEAD_DIMS:
        for bq in (FA.BLOCK_Q, FA.BLOCK_Q // 2):
            c = FA.f32_config(w, bq)
            rm = c.rows
            kern = [f"{fn}: {r} registers; {sp or 'no spill line'}"
                    for fn, r, _, sp in entries
                    if fn in (f"flash_fwd<{w}, {rm}, true>",
                              f"flash_fwd<{w}, {rm}, false>")]
            print(f"flash f32 (CUDA cores) width {w}, {bq} rows: "
                  f"{c.threads} threads, register tile {c.rows} rows x "
                  f"{c.keys} keys, {c.columns} output columns, K pieces of "
                  f"{c.k_slab} columns, V pieces of {c.v_slab} keys, "
                  f"{c.stages} slots of {c.slot_bytes} B, "
                  f"{c.smem_bytes} B dynamic shared memory, "
                  f"{c.blocks_per_sm} blocks per SM by shared memory; "
                  + ("; ".join(kern) or "not named in the ptxas log"))
    spills = [(fn, sp) for fn, _, _, sp in entries if not (
        " 0 bytes spill stores" in sp and " 0 bytes spill loads" in sp)]
    check(len(entries) == 4 * len(FA.F32_HEAD_DIMS) and not spills,
          f"flash_attention_f32: {len(entries)} instantiations, spills "
          f"{spills}")


# ---------------------------------------------------------------------------
# Phases 11-13: the model families, and the deployment report on the card
# ---------------------------------------------------------------------------

#: phase 11's served run: zamba2-1.2b at full width with phase 7's traffic
ZAMBA_RUN = dict(SERVED_RUN, arch="zamba2-1.2b")
#: phase 12: the families held to decode == prefill at full width, and the
#: positions S of the longer prefill (paligemma-3b: its 256 patches, then
#: S tokens; musicgen-medium: S frames)
FAMILY_ARCHS = ("zamba2-1.2b", "xlstm-125m", "paligemma-3b",
                "musicgen-medium")
FAMILY_S = 16
#: phase 11 in f32: relative L2 allowed between served and replayed logits
#: (the bucketless prefill and the batch of 4 against one-token decode at
#: batch 1; f32 sums in other orders)
F32_LOGITS_RTOL = 1e-3
#: phase 12's bounds, ``tests/test_models.py``'s: attention archs rtol =
#: atol = 2e-2 per logit; recurrent archs max |err| over max |logit|
ATTN_DECODE_TOL = 2e-2
RECURRENT_DECODE_TOL = 0.06
#: phase 13's grid: every arch on one card
DEPLOY_GRID = dict(dtypes=("bf16", "int8"), batches=(1, 2, 4, 8, 16),
                   max_len=4096, backend="cuda")


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_bytes(tree, skip=()):
    """Bytes of a tree's tensors, each storage once, leaving out the
    storages of the tensors in ``skip``."""
    seen = {t.data_ptr() for t in skip}
    total = 0
    for t in tree_leaves(tree):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def record_gemms(K):
    """Wraps ``K.gemm`` (what the ``cuda`` backend's ``execute`` calls) to
    record every (m, n, k, tile, dtype tag) it runs.  Returns (the set,
    a function that restores ``K.gemm``)."""
    seen = set()
    inner = K.gemm

    def gemm(a, b, c=None, *, tile):
        seen.add((a.shape[0], b.shape[1], a.shape[1], tile,
                  K._tag(a.dtype)))
        return inner(a, b, c, tile=tile)

    def restore():
        K.gemm = inner

    K.gemm = gemm
    return seen, restore


def hold_gemms(K, shapes, dev, label):
    """Each GEMM a path ran, at its (m, n, k) and tile, against its plain
    version on seeded operands (B at a weight's init scale, as the models
    hold it).  Returns the largest error per dtype."""
    import torch
    from repro_torch.core.tpu_model import GridOrder

    err = {}
    for i, (m, n, k, tile, tag) in enumerate(sorted(
            shapes, key=lambda s: (s[4], s[0], s[1], s[2], str(s[3])))):
        a, b = seeded(m, n, k, tag, 3000 + i, dev)
        b *= k ** -0.5
        where = f" at {tile}, {m}x{n}x{k} ({label})"
        if tile.order is GridOrder.K_OUTER:
            c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype), device=dev)
            e = compare("gemm_k_outer", tag,
                        K.gemm_k_outer(a, b, c0, tile=tile),
                        K.gemm_k_outer_plain(a, b, c0, bk=tile.bk),
                        passes=-(-k // tile.bk), where=where,
                        **(k_outer_bounds(a, b, c0, tile.bk)
                           if tag == "bf16" else {}))
        else:
            e = compare("gemm_k_inner", tag, K.gemm_k_inner(a, b, tile=tile),
                        K.gemm_k_inner_plain(a, b), where=where)
        err[tag] = max(err.get(tag, 0.0), e)
        del a, b
    torch.cuda.empty_cache()
    print(f"{label}: the {len(shapes)} GEMM shape x tile pairs it ran match "
          f"their plain versions (max |err| by dtype {err}; bf16 rtol = "
          f"atol = 2e-2, f32 rtol 1e-5 / atol 1e-4)")
    return err


def zamba_phase(K, G, dev):
    """Phase 11: serve zamba2-1.2b at full width through the port's entry
    point, phase 7's traffic; returns the run's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving.footprint import footprint

    phase(11, "serving zamba2-1.2b at full width on the card")
    cfg = get_config("zamba2-1.2b")
    kinds = cfg.block_counts()
    print(f"{cfg.name}: {cfg.n_layers} layers ({kinds['mamba2']} Mamba2, "
          f"{kinds['shared_attn']} sites of one shared attention+MLP "
          f"block), d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, {cfg.n_heads} attention heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}); compute {cfg.compute_dtype}")
    held_ = {}

    class Recording(serve_mod.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            held_["engine"] = self
            held_["logits"] = record_logits(self, REPLAYED)

    gemms, restore = record_gemms(K)
    engine_cls = serve_mod.ServingEngine
    serve_mod.ServingEngine = Recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    G.reset_launch_counts()
    try:
        out = serve_mod.serve_demo(**ZAMBA_RUN)
        launches = {**K.LAUNCHES, **G.LAUNCHES}
        routes = dict(K.ROUTES)
    finally:
        serve_mod.ServingEngine = engine_cls
        restore()
    peak = torch.cuda.max_memory_allocated()
    print(f"serving-path launches: {launches}, GEMM routes {routes}")
    all_on_wgmma(K, "phase 11's served run")
    check(launches["gemm_k_inner"] > 0 and routes["wgmma"] > 0,
          "gemm_k_inner was never launched on the wgmma route on the "
          "served zamba2 path")
    check(out["requests"] == 8, f"{out['requests']} of 8 requests finished")
    for rid, toks in out["generated"].items():
        check(len(toks) == 12 and all(0 <= t < cfg.vocab_size
                                      for t in toks),
              f"request {rid}: {toks} is not 12 in-vocabulary tokens")
    eng = held_["engine"]
    admits = [e for e in eng.trace_events if e["type"] == "admit"]
    check(all(e["bucket"] == e["prefix_len"] for e in admits),
          "a recurrent prefill ran at a bucket, not its exact length")
    res = {**step_times(out), **launches, "gemm_routes": routes,
           "gemm_shapes": sorted((m, n, k, str(t), tag)
                                 for m, n, k, t, tag in gemms)}
    print(f"{res['tokens']} tokens in {res['seconds']:.3f} s: "
          f"{res['tokens_per_s']:.2f} tok/s; {res['steps']} steps "
          f"({res['decode_steps']} without admissions: "
          f"{res['decode_step_ms']:.3f} ms each; all steps "
          f"{res['step_ms_all']:.3f} ms); {out['prefills']} prefills at "
          f"their exact lengths {sorted(e['bucket'] for e in admits)}")
    # the footprint model's bytes against the engine's tensors on the card
    fp = footprint(cfg, batch=eng.max_batch, max_len=eng.max_len,
                   dtype="bf16")
    cache_bytes = tree_bytes(eng.caches)
    values = eng.lm.values()
    value_bytes = tree_bytes(values)
    compute_bytes = tree_bytes(eng.params)
    copy_bytes = tree_bytes(eng.params, skip=tree_leaves(values))
    n_params = sum(t.numel() for t in tree_leaves(values))
    print(f"footprint (bf16, batch {eng.max_batch}, max_len "
          f"{eng.max_len}): decode state {fp.kv_cache_bytes:,} B, the "
          f"engine's caches on the card {cache_bytes:,} B")
    check(fp.kv_cache_bytes == cache_bytes,
          f"footprint decode-state bytes {fp.kv_cache_bytes} != the caches' "
          f"{cache_bytes}")
    print(f"footprint weights_bytes {fp.weights_bytes:,} B "
          f"(config.param_count() {cfg.param_count():,} x 2 B); the model's "
          f"{n_params:,} parameters (lm.values(), {cfg.param_dtype}) "
          f"{value_bytes:,} B; the compute copy {compute_bytes:,} B, of "
          f"which {copy_bytes:,} B new (matrices in bf16; f32 vectors "
          f"shared)")
    print(f"footprint total_bytes {fp.total_bytes:,} B; "
          f"torch.cuda.max_memory_allocated {peak:,} B over the served run")
    res["footprint"] = {**fp.as_dict(), "cache_bytes_on_card": cache_bytes,
                        "param_count": n_params, "values_bytes": value_bytes,
                        "compute_bytes": compute_bytes,
                        "compute_copy_new_bytes": copy_bytes,
                        "max_memory_allocated": peak}
    # bf16 through 38 random layers amplifies any one-ulp difference (the
    # probe below): the served bf16 logits are printed beside the probe,
    # and the served path is held in f32
    res["replay"] = replay_served(eng, held_["logits"], rtol=None)
    res["probe"] = perturbation_probe(eng, held_["logits"])
    res["gemm_err"] = hold_gemms(K, gemms, dev, "phase 11's served run")
    del eng, values
    held_.clear()
    torch.cuda.empty_cache()
    res["f32"] = served_f32(cfg, K, dev)
    res["profile"] = profile_serving(cfg)
    torch.cuda.empty_cache()
    return res


def perturbation_probe(eng, kept, steps=4):
    """How far one bf16 ulp moves the served model's logits: request
    ``REPLAYED[0]`` replayed twice at batch 1, the second time with its
    first token's embedding row scaled by (1 + 2^-8); relative L2 per
    step, beside the served run's distance from its replay."""
    r = {q.rid: q for q in eng.finished}[REPLAYED[0]]
    _, base = replay(eng.lm, eng.params, r.prompt, steps, eng.max_len,
                     forced=r.generated)
    params = dict(eng.params, embed=dict(eng.params["embed"]))
    table = params["embed"]["table"].clone()
    table[r.prompt[0]] *= 1 + 2 ** -8
    params["embed"]["table"] = table
    _, moved = replay(eng.lm, params, r.prompt, steps, eng.max_len,
                      forced=r.generated)
    probe = [rel_l2(a, b) for a, b in zip(moved, base)]
    served = [rel_l2(g, w) for g, w in zip(kept[r.rid], base)]
    print(f"one-ulp probe (request {r.rid}, its first token's embedding "
          f"scaled by 1 + 2^-8, replayed at batch 1): logits move "
          + ", ".join(f"{e:.4g}" for e in probe)
          + " relative L2 over the first steps; the served run lies "
          + ", ".join(f"{e:.4g}" for e in served) + " from the replay")
    return {"request": r.rid, "probe_rel_l2": probe,
            "served_rel_l2": served}


def served_f32(cfg, K, dev):
    """Phase 11 in f32: the same traffic at full width through a fresh
    engine (f32 compute and KV cache, the GEMMs on the CUDA cores); the
    replayed requests' logits within ``F32_LOGITS_RTOL`` relative L2."""
    import numpy as np
    import torch
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request, ServingEngine

    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              kv_cache_dtype="float32")
    lm = LM(f32, device=dev)
    eng = ServingEngine(lm, lm.init(torch.Generator(dev).manual_seed(
        ZAMBA_RUN["seed"])), max_batch=ZAMBA_RUN["max_batch"],
        max_len=ZAMBA_RUN["max_len"])
    kept = record_logits(eng, REPLAYED)
    rng = np.random.default_rng(ZAMBA_RUN["seed"])
    for i in range(ZAMBA_RUN["n_requests"]):
        prompt = rng.integers(0, f32.vocab_size,
                              size=int(rng.integers(3, 12))).tolist()
        eng.submit(Request(rid=i, prompt=prompt,
                           max_new_tokens=ZAMBA_RUN["max_new"]))
    before = snapshot(K)
    gemms, restore = record_gemms(K)
    try:
        eng.run_until_drained()
    finally:
        restore()
    route_check(K, "phase 11's f32 served run", "f32", before)
    print("f32, the same traffic:", end=" ")
    out = replay_served(eng, kept, rtol=F32_LOGITS_RTOL)
    del eng, lm, kept
    torch.cuda.empty_cache()
    out["gemm_err"] = hold_gemms(K, gemms, dev, "phase 11's f32 served run")
    return out


def family_batch(cfg, s, dev, seed):
    """A prefill batch of ``s`` positions at batch 1: tokens; the vision
    stub's patches before them; the audio stub's frames instead."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": torch.randn((1, s, cfg.d_model), generator=g,
                                      device=dev)}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                                   device=dev)}
    if cfg.frontend == "vision_stub":
        out["patches"] = torch.randn((1, cfg.num_prefix_tokens, cfg.d_model),
                                     generator=g, device=dev)
    return out


def copy_prefix(caches, pref):
    """A prefill's caches copied into the front of decode caches."""
    if isinstance(caches, dict):
        for key in caches:
            copy_prefix(caches[key], pref[key])
    elif isinstance(caches, list):
        for c, p in zip(caches, pref, strict=True):
            copy_prefix(c, p)
    else:
        caches[tuple(slice(0, n) for n in pref.shape)] = \
            pref.to(caches.dtype)


def decode_vs_prefill(lm, params, batch, before_full=None):
    """The last position's logits of a prefill of all but the last
    position followed by one ``decode_step``, and of a prefill of every
    position (timed on the host clock, ``before_full()`` called just
    before it).  Returns (decoded, prefilled, prefill ms), f32."""
    import torch
    key = "frames" if "frames" in batch else "tokens"
    prefix = batch["patches"].shape[1] if "patches" in batch else 0
    s = batch[key].shape[1]
    _, pref = lm.prefill(params, dict(batch, **{key: batch[key][:, :-1]}))
    caches = lm.init_cache(1, prefix + s + 4)
    copy_prefix(caches, pref)
    got, _ = lm.decode_step(params, caches, batch[key][:, -1:],
                            prefix + s - 1)
    del pref, caches
    if before_full is not None:
        before_full()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = lm.prefill(params, batch)
    torch.cuda.synchronize()
    return got.float(), full.float(), 1e3 * (time.perf_counter() - t0)


def families_phase(K, dev):
    """Phase 12: decode == prefill at full width in f32 for the four
    families, the bf16 error beside it (no bound), the sLSTM prefill's host
    time; then every GEMM shape the phase ran against its plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models import xlstm

    phase(12, "decode == prefill at full width, f32 (bf16 beside it)")
    slstm = {"ms": 0.0, "calls": 0, "steps": 0}
    apply_slstm = xlstm.apply_slstm

    def timed_slstm(params, x, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_slstm(params, x, cfg)
        torch.cuda.synchronize()
        slstm["ms"] += 1e3 * (time.perf_counter() - t0)
        slstm["calls"] += 1
        slstm["steps"] += x.shape[1]
        return out

    gemms, restore = record_gemms(K)
    xlstm.apply_slstm = timed_slstm
    rows = {}
    try:
        for i, arch in enumerate(FAMILY_ARCHS):
            cfg = get_config(arch)
            f32 = dataclasses.replace(cfg, compute_dtype="float32",
                                      kv_cache_dtype="float32")
            lm = model_mod.LM(f32, device=dev)
            values = lm.init(torch.Generator(dev).manual_seed(20 + i))
            batch = family_batch(cfg, FAMILY_S, dev, 30 + i)
            recurrent = any(k in ("mamba2", "mlstm", "slstm")
                            for k in cfg.block_pattern)
            row = {"recurrent": recurrent,
                   "positions": FAMILY_S + cfg.num_prefix_tokens}
            for tag, c in (("f32", f32), ("bf16", cfg)):
                run = lm if tag == "f32" else model_mod.LM(c, device=dev)
                got, want, ms = decode_vs_prefill(
                    run, run.compute_params(values), batch,
                    before_full=lambda: slstm.update(ms=0.0, calls=0,
                                                     steps=0))
                diff = (got - want).abs()
                scale = float(want.abs().max())
                row[tag] = {"max_abs_err": float(diff.max()),
                            "max_abs_logit": scale,
                            "rel_err": float(diff.max()) / scale,
                            "outside_2e-2": int((diff > ATTN_DECODE_TOL * (
                                1 + want.abs())).sum()),
                            "prefill_ms": ms}
                if arch == "xlstm-125m":
                    row[tag]["slstm"] = dict(slstm)
                del got, want, diff
            e = row["f32"]
            if recurrent:
                ok = e["rel_err"] < RECURRENT_DECODE_TOL
                bound = (f"max |err| / max |logit| {e['rel_err']:.4g} "
                         f"(bound {RECURRENT_DECODE_TOL})")
            else:
                ok = e["outside_2e-2"] == 0
                bound = (f"max |err| {e['max_abs_err']:.4g}, "
                         f"{e['outside_2e-2']} logits outside rtol = atol = "
                         f"{ATTN_DECODE_TOL}")
            b16 = row["bf16"]
            print(f"{arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
                  f"{row['positions']} positions): f32 {bound}; bf16 max "
                  f"|err| {b16['max_abs_err']:.4g} of max |logit| "
                  f"{b16['max_abs_logit']:.4g} ({b16['rel_err']:.4g}; no "
                  f"bound); prefill {e['prefill_ms']:.1f} ms f32, "
                  f"{b16['prefill_ms']:.1f} ms bf16 (host clock)")
            if arch == "xlstm-125m":
                for tag in ("f32", "bf16"):
                    s_ = row[tag]["slstm"]
                    print(f"  sLSTM in the {tag} prefill: {s_['calls']} "
                          f"blocks x {s_['steps'] // max(s_['calls'], 1)} "
                          f"steps, {s_['ms']:.1f} ms host of the "
                          f"{row[tag]['prefill_ms']:.1f} ms prefill "
                          f"({s_['ms'] / max(s_['steps'], 1):.3f} ms a step)")
            check(ok, f"{arch}: decode != prefill at full width in f32: "
                      f"{bound}")
            rows[arch] = row
            del lm, run, values, batch
            torch.cuda.empty_cache()
    finally:
        xlstm.apply_slstm = apply_slstm
        restore()
    rows["gemm_err"] = hold_gemms(K, gemms, dev, "phase 12")
    return rows


def deployment_phase(zamba):
    """Phase 13: ``plan_deployment`` for every arch on the card (``cuda``,
    ``h100``), bf16 and int8, batches 1-16, max_len 4096; kimi-k2-1t must
    be rejected for its memory; zamba2's predicted decode tok/s at batch 4
    beside phase 11's measured; zamba2 and qwen2-1.5b also priced on the
    fitted manifests (``h100-measured`` from the zoo, ``h100-fit`` from
    phase 4)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.machines import list_machines
    from repro_torch.serving.report import REJECT_WEIGHTS, plan_deployment

    phase(13, "the deployment report on the card (cuda, h100)")
    gib = 1024.0 ** 3
    out = {}
    for arch in ARCH_IDS:
        rep = plan_deployment(get_config(arch), machines="h100",
                              **DEPLOY_GRID)
        print(f"{arch} (max_len {rep.max_len}, native "
              f"{rep.native_dtype}):")
        print("  " + rep.table().replace("\n", "\n  "))
        out[arch] = rep.to_json()
        if arch == "kimi-k2-1t-a32b":
            check(not rep.options and rep.rejected and all(
                r.reason == REJECT_WEIGHTS for r in rep.rejected),
                f"{arch} was not rejected on one card for its weights")
            r = rep.rejected[0]
            print(f"  rejected on one card: footprint {r.footprint_bytes:,} "
                  f"B ({r.footprint_bytes / gib:.1f} GiB) against the "
                  f"card's budget {r.budget_bytes:,} B "
                  f"({r.budget_bytes / gib:.1f} GiB; 80 GB less 5 % "
                  f"reserved): {r.reason}")
        else:
            check(bool(rep.options), f"{arch} has no feasible cell on h100")
    zrep = plan_deployment(get_config("zamba2-1.2b"), machines="h100",
                           **DEPLOY_GRID)
    pred = [o for o in zrep.options if o.batch == 4 and o.dtype == "bf16"]
    measured = zamba["tokens_per_s"]
    step_rate = 4e3 / zamba["decode_step_ms"]
    print(f"zamba2-1.2b bf16 at batch 4: predicted "
          f"{pred[0].tokens_per_second:.1f} tok/s ({1e3 * pred[0].seconds_per_step:.4f} ms a decode step, "
          f"GEMMs only); phase 11 measured {measured:.2f} tok/s end to end, "
          f"{step_rate:.2f} tok/s over its decode steps "
          f"({zamba['decode_step_ms']:.3f} ms a step; no bound: the served "
          f"step is bound by the host)")
    out["zamba2_batch4"] = {"predicted_tok_s": pred[0].tokens_per_second,
                            "predicted_step_s": pred[0].seconds_per_step,
                            "measured_tok_s": measured,
                            "measured_decode_tok_s": step_rate}
    fitted = [m for m in ("h100-measured", "h100-fit")
              if m in list_machines()]
    out["fitted"] = {}
    for arch in ("zamba2-1.2b", "qwen2-1.5b"):
        rep = plan_deployment(get_config(arch), machines=["h100"] + fitted,
                              **DEPLOY_GRID)
        best = rep.per_machine_best()
        at4 = {o.machine: o.tokens_per_second for o in rep.options
               if o.batch == 4 and o.dtype == "bf16"}
        print(f"{arch} on the data sheet and the fitted manifests: bf16 "
              f"batch 4 predicted "
              + ", ".join(f"{m} {v:.1f} tok/s" for m, v in sorted(
                  at4.items()))
              + "; best cell per machine "
              + ", ".join(f"{m}: {o.dtype} batch {o.batch} "
                          f"{o.tokens_per_second:.1f} tok/s"
                          for m, o in best.items()))
        out["fitted"][arch] = {"batch4_bf16_tok_s": at4,
                               "best": {m: o.as_dict()
                                        for m, o in best.items()}}
    check("h100-fit" in fitted, "phase 4's fit was not registered")
    return out


#: phase 14: Qwen2-1.5B autoconfigured on the card's fitted manifest,
#: served with phase 7's traffic, and its trace replayed
AUTOCONF_RUN = dict(arch="qwen2-1.5b", smoke=False, n_requests=8,
                    max_new=12, max_len=256, seed=0, device="cuda",
                    autoconfigure=True, machine="h100-measured",
                    backend="cuda")
AUTOCONF_SLO_P99 = 0.35
AUTOCONF_TRAFFIC = dict(rate=5, prompt_len=16, decode_len=12, seed=0)
#: the measured replay's bounds, ``tests/test_simulate.py``'s: every
#: request's latency within 2 % and the MAPE under 2 %
REPLAY_APE = 0.02
REPLAY_MAPE_PCT = 2.0


def autoconf_phase(K, dev, out_dir):
    """Phase 14: autoconfigure Qwen2-1.5B at full width on ``cuda`` /
    ``h100-measured`` under an SLO, serve it through the port's entry
    point, hold its logits and GEMMs, and replay its trace through the
    simulator (measured and model-priced steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.simulate import SLO, PoissonTraffic, ServiceModel
    from repro_torch.simulate import replay as sim_replay

    phase(14, "Qwen2-1.5B autoconfigured on h100-measured, served, "
              "its trace replayed")
    cfg = get_config("qwen2-1.5b")
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), tied embeddings {cfg.tie_embeddings}; "
          f"compute {cfg.compute_dtype}")
    held_ = {}

    class Recording(serve_mod.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            held_["engine"] = self
            held_["logits"] = record_logits(self, REPLAYED)

    gemms, restore = record_gemms(K)
    engine_cls = serve_mod.ServingEngine
    serve_mod.ServingEngine = Recording
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    try:
        out = serve_mod.serve_demo(
            **AUTOCONF_RUN, slo=SLO(p99_latency_s=AUTOCONF_SLO_P99),
            traffic=PoissonTraffic(**AUTOCONF_TRAFFIC))
        launches = dict(K.LAUNCHES)
        routes = dict(K.ROUTES)
    finally:
        serve_mod.ServingEngine = engine_cls
        restore()
    peak = torch.cuda.max_memory_allocated()
    eng = held_["engine"]
    ac = eng.autoconfig
    sim = ac["slo"]["sim"]
    print(f"the pick: max_batch {ac['max_batch']}, dtype {ac['dtype']}, "
          f"machine {ac['machine']} ({ac['backend']}), predicted "
          f"{ac['predicted_tokens_per_second']:.1f} tok/s; simulated p99 "
          f"{sim['latency']['p99']:.6g} s, goodput {sim['goodput_tps']:.6g} "
          f"tok/s (SLO p99 <= {AUTOCONF_SLO_P99} s, "
          f"{ac['slo']['traffic']})")
    rejected = ac["rejected"] + ac["slo"]["rejected"]
    for r in rejected:
        print(f"  rejected: {r['machine']} {r['dtype']} batch {r['batch']}: "
              f"{r['reason']}")
    if not rejected:
        print(f"  rejected: none of the {len(ac['grid'])} cells")
    check(ac["machine"] == "h100-measured" and ac["backend"] == "cuda"
          and ac["dtype"] == ac["native_dtype"] == "bf16",
          f"autoconfigure picked {ac['machine']} {ac['dtype']} on "
          f"{ac['backend']}, not a bf16 cell of h100-measured on cuda")
    check(eng.max_batch == ac["max_batch"], "the engine's max_batch is not "
                                            "the autoconfigured pick")
    print(f"serving-path launches: {launches}, GEMM routes {routes}")
    all_on_wgmma(K, "phase 14's served run")
    check(launches["gemm_k_inner"] > 0 and routes["wgmma"] > 0,
          "gemm_k_inner was never launched on the wgmma route on the "
          "served Qwen2-1.5B path")
    check(out["requests"] == 8, f"{out['requests']} of 8 requests finished")
    for rid, toks in out["generated"].items():
        check(len(toks) == 12 and all(0 <= t < cfg.vocab_size
                                      for t in toks),
              f"request {rid}: {toks} is not 12 in-vocabulary tokens")
    res = {**step_times(out), **launches, "gemm_routes": routes,
           "autoconfig": ac, "max_memory_allocated": peak,
           "gemm_shapes": sorted((m, n, k, str(t), tag)
                                 for m, n, k, t, tag in gemms)}
    print(f"{res['tokens']} tokens in {res['seconds']:.3f} s: "
          f"{res['tokens_per_s']:.2f} tok/s; {res['steps']} steps "
          f"({res['decode_steps']} without admissions: "
          f"{res['decode_step_ms']:.3f} ms each; all steps "
          f"{res['step_ms_all']:.3f} ms); {out['prefills']} prefills; "
          f"torch.cuda.max_memory_allocated {peak:,} B")

    trace = eng.trace_json()
    with open(os.path.join(out_dir, "autoconf_trace.json"), "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
    measured = sim_replay(trace)
    print(measured.table())
    res["replay_measured"] = measured.to_json()
    check(measured.order_match and measured.steps_match
          and measured.shed_match,
          f"measured replay: order {measured.order_match}, steps "
          f"{measured.steps_real}/{measured.steps_sim}, shed "
          f"{measured.shed_match}")
    check(len(measured.rows) == 8, f"measured replay kept "
                                   f"{len(measured.rows)} of 8 requests")
    worst = measured.worst
    check(worst.ape < REPLAY_APE,
          f"measured replay: request {worst.rid}'s latency is "
          f"{100 * worst.ape:.3f} % off (bound {100 * REPLAY_APE:g} %)")
    check(measured.mape < REPLAY_MAPE_PCT,
          f"measured replay MAPE {measured.mape:.4f} % (bound "
          f"{REPLAY_MAPE_PCT} %)")
    svc = ServiceModel.from_plans(cfg, batch=ac["max_batch"],
                                  machine="h100-measured", backend="cuda",
                                  max_len=AUTOCONF_RUN["max_len"])
    model = sim_replay(trace, svc)
    print(model.table(limit=2))
    res["replay_model"] = model.to_json()
    res["service_model"] = {"decode_step_s": svc.decode_step_s,
                            "prefill_s": dict(svc.prefill_s)}
    check(model.order_match and model.steps_match,
          f"model replay: order {model.order_match}, steps "
          f"{model.steps_real}/{model.steps_sim}")
    print(f"replay MAPE: measured {measured.mape:.6g} % (worst request "
          f"{worst.rid}, {100 * worst.ape:.4g} %), model {model.mape:.6g} "
          f"% (no bound); the model prices a decode step at "
          f"{1e3 * svc.decode_step_s:.6g} ms (one layer's GEMMs and the "
          f"logits on the Hopper tile model) against "
          f"{res['decode_step_ms']:.6g} ms measured, a prefill at "
          + ", ".join(f"{1e3 * v:.4g} ms (bucket {b})"
                      for b, v in sorted(svc.prefill_s.items())))
    res["replay"] = replay_served(eng, held_["logits"])
    res["probe"] = perturbation_probe(eng, held_["logits"])
    res["gemm_err"] = hold_gemms(K, gemms, dev, "phase 14's served run")
    del eng
    held_.clear()
    torch.cuda.empty_cache()
    return res


def kernel_entry(name, source, replaces, launches, max_err, rows):
    """One entry of the kernels line: times summed over ``rows``."""
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "chip_smoke"))
    ap.add_argument("--parent", default=None,
                    help="an export of an earlier commit (git archive) "
                         "whose phase-5 GEMM, phase-6 grouped and phase-10 "
                         "RMSNorm and flash attention times to take on the "
                         "same card, in the order parent, change, change, "
                         "parent, and whose served run (phase 7) to take "
                         "before and after this tree's")
    ap.add_argument("--time-tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--what", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time_tree:
        return time_tree(args.time_tree, args.what,
                           json.loads(args.shapes), args.out)

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
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as K
    from repro_torch.kernels import grouped_gemm as G
    from repro_torch.kernels import rmsnorm as R
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
        log = build.build_log(v)
        with open(os.path.join(args.out, f"ptxas_{v}.log"), "w") as f:
            f.write(log)
        entries = ptxas_entries(log)
        regs = [r for _, r, _, _ in entries]
        spills = [sp for *_, sp in entries if not (
            " 0 bytes spill stores" in sp and " 0 bytes spill loads" in sp)]
        print(f"ptxas {v}: {len(regs)} kernels, registers "
              f"{min(regs)}..{max(regs)}, {len(spills)} with spills")
        if v.startswith("rmsnorm"):
            print("  " + ", ".join(f"{fn} {r} registers / {smem} B static "
                                   f"shared memory"
                                   for fn, r, smem, _ in entries))
        if v == "flash_attention_bf16":
            flash_entries = entries
        if v == "flash_attention_f32":
            flash_f32_entries = entries
        if v in ("gemm_bf16", "gemm_int8", "grouped_gemm_bf16", "gemm_f32",
                 "grouped_gemm_f32"):
            for fn, r, _, sp in entries:
                print(f"  {fn}: {r} registers; {sp or 'no spill line'}")
        if v == "gemm_f32":
            f32_entries = entries
    sass_check(build, paths["gemm_bf16"], "gemm_bf16", ("HGMMA",))
    sass_check(build, paths["gemm_int8"], "gemm_int8", ("IGMMA", "UTMALDG"))
    sass_check(build, paths["grouped_gemm_bf16"], "grouped_gemm_bf16",
               ("HGMMA", "UTMALDG"))
    sass_check(build, paths["flash_attention_bf16"], "flash_attention_bf16",
               ("HGMMA", "UTMALDG"))
    for v in ("gemm_f32", "grouped_gemm_f32", "flash_attention_f32"):
        sass_check(build, paths[v], v, ("FFMA",), forbid=("HMMA", "HGMMA"))
    for w in FA.HEAD_DIMS:
        c = FA.wgmma_config(w)
        name = f"flash_wgmma<{w}, {c.block_k}, {c.consumers}>"
        regs = [f"{r} registers; {sp or 'no spill line'}"
                for fn, r, _, sp in flash_entries if fn == name]
        print(f"flash bf16 (wgmma) width {w}: {name}: "
              f"{regs[0] if regs else 'not named in the ptxas log'}; "
              f"{c.consumers} consumer "
              f"warpgroup(s) ({c.block_q} query rows), {c.block_k} keys a "
              f"step, {c.stages} K/V stages of {c.stage_bytes} B, "
              f"{c.smem_bytes} B dynamic shared memory, {c.threads} threads")
    for c in (8, 24, 32, 128):
        t = G.grouped_tile(c, torch.bfloat16)
        cfg = G.grouped_config(t)
        blocks = {n: G.grid_blocks(e, c, f, t) for n, (e, cc, d, f) in
                  GROUPED_SHAPES.items() if cc == c and n in SERVED_SHAPES}
        print(f"grouped bf16 (wgmma) C = {c}: tile {t} (bc x bf x slab "
              f"depth), {cfg.consumers} consumer warpgroup(s), "
              f"{cfg.stages} stages of {cfg.stage_bytes} B, "
              f"{cfg.smem_bytes} B dynamic shared memory, "
              f"{G.resident_blocks(cfg)} blocks per SM by shared memory, "
              f"{cfg.threads} threads"
              + (f"; blocks per launch {blocks} on {G.SMS} SMs" if blocks
                 else ""))
    for c in (8, 24, 32, 128):
        t = G.grouped_tile(c, torch.float32)
        print(f"grouped f32 (CUDA cores) C = {c}: tile {t}, "
              f"{core_line(K.launch_config(t, 'f32'))}")
    flash_f32_phase1(FA, flash_f32_entries)
    print("RMSNorm: no dynamic shared memory")
    picks = planner_tiles(gemm, get_config, model_gemm_shapes, TABLE2,
                          GemmShape)
    # and the tiles phases 4 and 5 time besides the planner's
    qwen = get_config("qwen2-1.5b")
    fit_tiles = {tag: phase4_tiles(gemm, GemmShape, qwen, model_gemm_shapes,
                                   tag) for tag in picks}
    checked_tiles = {tag: sorted(set(picks[tag]) | {
        OLD_PICKS[tag], FIT_K_OUTER[tag], (64, 128, 128)} | {
            (t.bm, t.bn, t.bk) for ts in fit_tiles[tag].values()
            for t in ts}) for tag in picks}
    # bf16 at N = 256 runs one warpgroup in rounds (two would spill)
    checked_tiles["bf16"] = sorted(set(checked_tiles["bf16"])
                                   | {(128, 256, 128)})
    for tag in ("bf16", "int8"):
        for t in checked_tiles[tag]:
            for order in ("k_inner", "k_outer"):
                c = K.check_tile(TileConfig(*t), tag,
                                 k_outer=order == "k_outer")
                print(f"wgmma {tag} {t[0]}x{t[1]}x{t[2]} {order}: N = "
                      f"{c.nw}, {c.consumers} consumer warpgroup(s), "
                      f"{c.rounds} round(s), slab {c.ks} deep, {c.stages} "
                      f"stage(s) of {c.stage_bytes} B, {c.smem_bytes} B "
                      f"dynamic shared memory, {c.threads} threads")
    for t in checked_tiles["f32"]:
        for order in ("k_inner", "k_outer"):
            cfg = K.launch_config(TileConfig(*t), "f32",
                                  k_outer=order == "k_outer")
            fixed = f"tile_gemm<{cfg.rm}, {cfg.rn}, {cfg.ks}, {t[0]}, {t[1]}>"
            regs = [f"{r} registers; {sp or 'no spill line'}"
                    for fn, r, _, sp in f32_entries if fn == fixed]
            print(f"f32 (CUDA cores) {t[0]}x{t[1]}x{t[2]} {order}: "
                  f"{core_line(cfg)}; "
                  + (f"{fixed}: {regs[0]}" if regs else
                     f"run-time extents, tile_gemm<{cfg.rm}, {cfg.rn}, 0, 0, "
                     f"0>"))
    print(f"device: {card}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi("name,power.limit"))

    # -- phase 2 ---------------------------------------------------------
    phase(2, "kernels vs plain versions on the card")
    print(f"planner tiles for the slice, by dtype: {picks}; with the tiles "
          f"phases 4-5 time: {checked_tiles}")
    # 390 = 3 x 128 + 6: at bk = 128 the k-outer passes end on a ragged one
    shapes = [(512, 512, 512), (300, 520, 390)]
    checked = 0
    K.reset_launch_counts()
    expect = {"wgmma": 0, "cuda_cores": 0}
    for tag in ("int8", "bf16", "f32"):
        for i, (bm, bn, bk) in enumerate(checked_tiles[tag]):
            for (m, n, k) in shapes:
                where = f" at {bm}x{bn}x{bk}, {m}x{n}x{k}"
                a, b = seeded(m, n, k, tag, 100 + i, dev)
                c0 = torch.zeros((m, n), dtype=K.out_dtype(a.dtype),
                                 device=dev)
                ti = TileConfig(bm, bn, bk, GridOrder.K_INNER)
                to = TileConfig(bm, bn, bk, GridOrder.K_OUTER)
                compare("gemm_k_inner", tag, K.gemm_k_inner(a, b, tile=ti),
                        K.gemm_k_inner_plain(a, b), where=where)
                passes = -(-k // bk)
                compare("gemm_k_outer", tag, K.gemm_k_outer(a, b, c0, tile=to),
                        K.gemm_k_outer_plain(a, b, c0, bk=bk), passes=passes,
                        where=where, **(k_outer_bounds(a, b, c0, bk)
                                        if tag == "bf16" else {}))
                expect[K.route(a.dtype)] += 1 + passes
                checked += 2
    torch.cuda.synchronize()
    print(f"{checked} kernel/plain comparisons passed "
          f"({ {t: len(v) for t, v in checked_tiles.items()} } tiles by "
          f"dtype x {len(shapes)} shapes x 2 orders, the last k-outer pass "
          f"of {shapes[1]} ragged at bk = 128)")
    unaligned = [(r.m, r.n, r.k) for r in TABLE2
                 if r.k % 8 or r.n % 8]
    for tag in ("bf16", "int8", "f32"):
        odt = {"bf16": torch.bfloat16, "int8": torch.int32,
               "f32": torch.float32}[tag]
        for j, ((m, n, k), d) in enumerate(zip(unaligned, gemm.plan_many(
                [GemmShape(m, n, k, dtype=tag) for m, n, k in unaligned],
                backend="cuda", machine="h100"))):
            a, b = seeded(m, n, k, tag, 200 + j, dev)
            if tag == "f32":
                # at a weight's init scale, so C stays O(1) up to K = 9216
                # (phase 3 says why)
                b *= k ** -0.5
            c0 = torch.zeros((m, n), dtype=odt, device=dev)
            t = d.selection
            copies = dict(K.COPIES)
            where = f" at {t.bm}x{t.bn}x{t.bk}, Table-2 {m}x{n}x{k}"
            compare("gemm_k_inner", tag,
                    K.gemm_k_inner(a, b, tile=TileConfig(t.bm, t.bn, t.bk)),
                    K.gemm_k_inner_plain(a, b), where=where)
            compare("gemm_k_outer", tag,
                    K.gemm_k_outer(a, b, c0, tile=TileConfig(
                        t.bm, t.bn, t.bk, GridOrder.K_OUTER)),
                    K.gemm_k_outer_plain(a, b, c0, bk=t.bk),
                    passes=-(-k // t.bk), where=where,
                    **(k_outer_bounds(a, b, c0, t.bk) if tag == "bf16"
                       else {}))
            expect[K.route(tag)] += 1 + -(-k // t.bk)
            made = {c: K.COPIES[c] - copies[c] for c in copies}
            print(f"Table-2 {m}x{n}x{k} ({tag}, tile {t.bm}x{t.bn}x{t.bk}): "
                  f"both orders match; copies {made} (to TMA-aligned rows; "
                  f"int8: B transposed, once per call; f32: none, rows "
                  f"that are not 16-byte aligned are read 4 bytes a copy)")
            if tag == "bf16" and k <= t.bk:
                # one k-outer pass: how far kernel and plain version each
                # lie from the float64 product rounded to bf16
                exact = (a.double() @ b.double()).to(torch.bfloat16)
                got = K.gemm_k_outer(a, b, c0, tile=TileConfig(
                    t.bm, t.bn, t.bk, GridOrder.K_OUTER))
                want = K.gemm_k_outer_plain(a, b, c0, bk=t.bk)
                expect["wgmma"] += 1
                print(f"  one pass: {int((got != exact).sum())} kernel and "
                      f"{int((want != exact).sum())} plain-version elements "
                      f"of {m * n} differ from the float64 product rounded "
                      f"to bf16")
    # f32 on views whose base and row stride are not 16-byte aligned
    big_a, big_b = seeded(301, 530, 400, "f32", 250, dev)
    a, b = big_a[1:, 3:393], big_b[5:395, 1:521]
    c0 = torch.zeros((300, 520), device=dev)
    for t in checked_tiles["f32"]:
        compare("gemm_k_inner", "f32",
                K.gemm_k_inner(a, b, tile=TileConfig(*t)),
                K.gemm_k_inner_plain(a, b))
        compare("gemm_k_outer", "f32",
                K.gemm_k_outer(a, b, c0, tile=TileConfig(*t,
                                                         GridOrder.K_OUTER)),
                K.gemm_k_outer_plain(a, b, c0, bk=t[2]))
        expect["cuda_cores"] += 1 + -(-390 // t[2])
    print("f32 300x520x390 on strided views (base and row stride off 16 "
          "bytes): both orders match at every planner tile")
    torch.cuda.synchronize()
    routes = dict(K.ROUTES)
    print(f"phase 2 launches by route: {routes}, expected {expect} (every "
          f"bf16 and int8 launch on wgmma, every f32 one on the CUDA "
          f"cores); copies {dict(K.COPIES)}")
    check(routes == expect, f"phase 2 launches by route {routes} are not "
                            f"{expect}")
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
    one_norm_kernel(dev, R)

    # -- phase 3 ---------------------------------------------------------
    phase(3, "main path: Qwen2-1.5B GEMMs planned on cuda@h100, executed")
    K.reset_launch_counts()
    names = ["qkv", "o", "gate_up", "down", "logits"]
    qshapes = [(s_.m, s_.n, s_.k)
               for s_ in model_gemm_shapes(qwen, tokens=4096)]
    # bf16, int8 (exact) and f32 (the CUDA cores; B at a weight's init
    # scale): each dtype's launches are counted apart for its entries of
    # the kernels line
    main_path = {}
    for tag in ("bf16", "int8", "f32"):
        before = snapshot(K)
        counts = dict(K.LAUNCHES)
        main_path[tag] = main_path_gemms(gemm, K, names, qshapes, tag, dev)
        main_path[tag]["launches"] = {kname: K.LAUNCHES[kname] - counts[kname]
                                      for kname in K.LAUNCHES}
        route_check(K, f"phase 3 {tag}", tag, before)

    # -- phase 4 ---------------------------------------------------------
    phase(4, "loop: run_campaign -> fit_from_store (Hopper tile model) -> "
             "validate_spec")
    store = os.path.join(args.out, "h100.jsonl")
    held = os.path.join(args.out, "h100_k_outer_heldout.jsonl")
    for path in (store, held):
        if os.path.exists(path):
            os.remove(path)
    h100 = resolve("h100")
    harness = measure.get_harness("cuda")
    pick_rows = []
    for tag in ("int8", "bf16", "f32"):
        before = snapshot(K)
        counts = dict(K.LAUNCHES)
        res = measure.run_campaign("table2", harness="cuda", machine="h100",
                                   dtype=tag, store=store, timing=FIT_TIMING)
        print(f"table2/{tag}: {len(res.samples)} samples at the planner's "
              f"tiles, {res.measured_seconds:.4g} s measured")
        for name, (m, n, k) in zip(names, qshapes):
            p = GemmProblem(m, n, k, dtype=tag)
            tiles = fit_tiles[tag][name]
            secs = [pinned_sample(gemm, measure, harness, h100, p, t,
                                  "qwen2-1.5b", store).seconds
                    for t in tiles]
            pick_rows.append({"dtype": tag, "gemm": name,
                              "tiles": [str(t) for t in tiles],
                              "seconds": secs,
                              "ratio": secs[0] / min(secs)})
            pinned_sample(gemm, measure, harness, h100, p,
                          TileConfig(*FIT_K_OUTER[tag], GridOrder.K_OUTER),
                          "qwen2-1.5b-k_outer", store)
        route_check(K, f"phase 4's {tag} samples", tag, before)
        for kname in K.LAUNCHES:
            main_path[tag]["launches"][kname] += \
                K.LAUNCHES[kname] - counts[kname]
    before = snapshot(K)
    counts = dict(K.LAUNCHES)
    held_samples = [pinned_sample(gemm, measure, harness, h100,
                                  GemmProblem(m, n, k, dtype="bf16"),
                                  TileConfig(*OLD_PICKS["bf16"],
                                             GridOrder.K_OUTER),
                                  "qwen2-1.5b-k_outer-heldout", held)
                    for m, n, k in qshapes]
    route_check(K, "phase 4's held-out k-outer samples", "bf16", before)
    for kname in K.LAUNCHES:
        main_path["bf16"]["launches"][kname] += \
            K.LAUNCHES[kname] - counts[kname]
    # every column must solve positive: the fit keeps them all
    spec, rep = measure.fit_from_store(
        store, "h100", name="h100-fit", date=time.strftime("%Y-%m-%d"),
        on_nonpositive="raise", manifest_dir=args.out, register=True)
    check(not rep.dropped, f"the fit dropped {rep.dropped}")
    print(f"fit (Hopper tile model, on_nonpositive='raise'): {rep.samples} "
          f"samples, residual RMS {rep.residual_rms_s:.4g} s, in-sample "
          f"MAPE {rep.insample_mape_pct:.4g}%; fitted beside the h100 "
          f"manifest (data sheet; per-call costs placeholders):")
    fitted = fit_columns(rep, h100)
    for row in fitted:
        print(f"  {row['column']:<14} {row['fitted']:.6g} {row['unit']} "
              f"(manifest {row['manifest']:.6g}, x{row['ratio']:.3g})")
    print(f"fitted manifest: {os.path.join(args.out, 'h100-fit.json')}")
    report = measure.validate_spec(spec, store)
    heldout = measure.validate_spec(spec, held_samples)
    check(report.finite, "validation MAPE is not finite")
    check(heldout.finite, "held-out MAPE is not finite")
    report.save(os.path.join(args.out, "validation.json"))
    print(report.table(limit=12))
    mapes = mape_breakdown(report, heldout)
    for key, v in mapes.items():
        print(f"  MAPE {key}: {v['mape_pct']:.4g}% over {v['cells']} cells")
    print(f"MAPE: campaign {report.mape:.4g}% over {len(report.rows)} cells "
          f"(target <= 25%: {'met' if report.mape <= 25 else 'missed'}); "
          f"held-out bf16 k_outer at 64x128x128 {heldout.mape:.4g}% over "
          f"{len(heldout.rows)} (target <= 30%: "
          f"{'met' if heldout.mape <= 30 else 'missed'})")
    for r in heldout.rows:
        print(f"  held out {r.sample.m}x{r.sample.n}x{r.sample.k}: measured "
              f"{r.measured_s:.4g} s, predicted {r.predicted_s:.4g} s")
    print("the planner's tile (first) against the other tiles timed, per "
          "Qwen2-1.5B GEMM and dtype (harness seconds):")
    for r in pick_rows:
        print(f"  {r['dtype']:<5}{r['gemm']:<8}"
              + ", ".join(f"{t} {sec * 1e3:.4f} ms"
                          for t, sec in zip(r["tiles"], r["seconds"]))
              + f": picked / fastest {r['ratio']:.3f}")
    # step 5: the registered fit feeds the next plan
    refit_store = os.path.join(args.out, "h100_refit.jsonl")
    if os.path.exists(refit_store):
        os.remove(refit_store)
    refit_rows = []
    for tag in main_path:
        counts = dict(K.LAUNCHES)
        before = snapshot(K)
        refit = refit_picks(gemm, measure, harness, K, h100, names,
                            qshapes, pick_rows, checked_tiles, dev,
                            refit_store, tag)
        if sum(K.LAUNCHES.values()) > before[0]:   # a pick not yet timed
            route_check(K, f"phase 4's {tag} refit picks", tag, before)
        for kname in K.LAUNCHES:
            main_path[tag]["launches"][kname] += \
                K.LAUNCHES[kname] - counts[kname]
        refit_rows += refit
    print("re-planned on the registered fit (h100-fit): each pick's "
          "harness time over the fastest tile timed (target <= 1.10):")
    for r in refit_rows:
        print(f"  {r['dtype']:<5}{r['gemm']:<8}data sheet {r['sheet']} "
              f"{r['sheet_ratio']:.3f}, refit {r['refit']} "
              f"{r['refit_ratio']:.3f}"
              + ("" if r["sheet"] != r["refit"] else " (same tile)"))
    worst = max(r["refit_ratio"] for r in refit_rows)
    moved = sum(r["sheet"] != r["refit"] for r in refit_rows)
    print(f"refit picks: {moved} of {len(refit_rows)} differ from the data "
          f"sheet's; worst picked / fastest {worst:.3f} (target <= 1.10: "
          f"{'met' if worst <= 1.10 else 'missed'})")
    with open(os.path.join(args.out, "phase4.json"), "w") as f:
        json.dump({"fitted": fitted, "mape": mapes,
                   "campaign_mape_pct": report.mape,
                   "heldout_mape_pct": heldout.mape, "picks": pick_rows,
                   "refit_picks": refit_rows,
                   "power": smi("name,power.limit")}, f, indent=1)
    launches = dict(K.LAUNCHES)
    print(f"main-path launches: {launches}, by dtype "
          f"{ {t: v['launches'] for t, v in main_path.items()} }, by route "
          f"{dict(K.ROUTES)}")
    for tag, v in main_path.items():
        for name_, n_ in v["launches"].items():
            check(n_ > 0, f"{name_} was never launched in {tag} on the main "
                          f"path")

    # -- phase 5 ---------------------------------------------------------
    phase(5, "timing at the Qwen2-1.5B shapes (CUDA events)")
    # each dtype at the planner's tiles and at the TPU model's old picks
    # (int8 and f32 also at 64x128x128, as the kernel table has them)
    gemm_shapes = main_path["bf16"]["shapes"]
    int8_shapes = main_path["int8"]["shapes"]
    f32_shapes = main_path["f32"]["shapes"]

    def at(tile, rows_):
        return [(n_, m_, nn_, k_, tile) for n_, m_, nn_, k_, _ in rows_]
    before = snapshot(K)
    parent = []
    if args.parent:
        parent.append(tree_run(args.parent, "gemm", args.out, gemm_shapes))
    rows = gemm_timings(K, gemm_shapes, dev)
    if args.parent:
        again = gemm_timings(K, gemm_shapes, dev, quiet=True)
        parent.append(tree_run(args.parent, "gemm", args.out, gemm_shapes))
        compare_with_parent(rows, again, parent)
    # (the plain versions' times do not depend on the tile: taken once)
    old_rows = gemm_timings(K, at(OLD_PICKS["bf16"], gemm_shapes), dev,
                            plain=False)
    stage_rows = stage_timings(K, gemm_shapes, dev)
    # int8 (wgmma_s8.cuh) beside torch._int_mm; the 19 Table-2 int8 cells
    # phase 4 runs; with --parent both in turns with the parent's tree (and
    # the f32 route)
    int8_sets = {"planner": int8_shapes,
                 "x".join(map(str, OLD_PICKS["int8"])):
                     at(OLD_PICKS["int8"], int8_shapes),
                 "64x128x128": at((64, 128, 128), int8_shapes)}
    table2_cells = [(r.m, r.n, r.k, (d.selection.bm, d.selection.bn,
                                     d.selection.bk))
                    for r, d in zip(TABLE2, gemm.plan_many(
                        [GemmShape(r.m, r.n, r.k, dtype="int8")
                         for r in TABLE2], backend="cuda", machine="h100"))]
    f32_sets = {"planner": f32_shapes,
                "x".join(map(str, OLD_PICKS["f32"])):
                    at(OLD_PICKS["f32"], f32_shapes),
                "64x128x128": at((64, 128, 128), f32_shapes)}
    # the turns take the planner's tiles and the old picks
    turn_shapes = {"qwen": {t: v for t, v in int8_sets.items()
                            if t != "64x128x128"},
                   "table2": table2_cells,
                   "f32": {t: v for t, v in f32_sets.items()
                           if t != "64x128x128"}}
    int8_rows = {t: gemm_timings(K, sh, dev, tag="int8",
                                 plain=t == "planner")
                 for t, sh in int8_sets.items()}
    table2_rows = table2_timings(K, table2_cells, dev)
    for r in table2_rows:
        print(f"Table-2 int8 {'x'.join(map(str, r['shape']))} (tile "
              f"{'x'.join(map(str, r['tile']))}): {r['ms']:.4f} ms, host "
              f"{r['host_us']:.1f} us a call")
    print(f"Table-2 int8 over {len(table2_rows)} cells: "
          f"{sum(r['ms'] for r in table2_rows):.4f} ms")
    int8_stage_rows = {t: stage_timings(K, sh, dev, tag="int8")
                       for t, sh in int8_sets.items() if t == "planner"}
    transpose_rows = transpose_timings(K, gemm_shapes, dev)
    all_on_wgmma(K, "phase 5", before)
    # the f32 route (tile_gemm.cuh) beside torch.matmul (TF32 off)
    before = snapshot(K)
    core_rows = {t: gemm_timings(K, sh, dev, tag="f32",
                                 plain=t == "planner")
                 for t, sh in f32_sets.items()}
    route_check(K, "phase 5 f32", "f32", before)
    int8_turns = []
    if args.parent:
        int8_turns = [tree_run(t, "gemm_int8", args.out, turn_shapes)
                      for t in (args.parent, HERE, HERE, args.parent)]
        compare_int8(int8_turns)

    grouped_tags, grouped_err, grouped_parent, grouped_stage_rows = \
        grouped_phase(args, dev, G)
    grouped_rows = grouped_tags["bf16"]
    serve_turns = []
    if args.parent:
        serve_turns += [tree_run(args.parent, "serve", args.out),
                        tree_run(HERE, "serve", args.out)]
    served = serve_phase(K, G)
    if args.parent:
        serve_turns += [tree_run(HERE, "serve", args.out),
                        tree_run(args.parent, "serve", args.out)]
        compare_serving(served, serve_turns)
    greedy = greedy_phase(dev)
    model_k = model_kernels_phase(dev, FA, R, ops)
    attn_rows, flash_f32_launches = attention_norm_phase(dev, FA, R, ops)
    norm_turns, flash_turns = [], []
    if args.parent:
        norm_turns = [tree_run(t, "norm", args.out)
                      for t in (args.parent, HERE, HERE, args.parent)]
        compare_norms(norm_turns)
        flash_turns = [tree_run(t, "flash", args.out)
                       for t in (args.parent, HERE, HERE, args.parent)]
        compare_flash(flash_turns)
    zamba = zamba_phase(K, G, dev)
    families = families_phase(K, dev)
    deployment = deployment_phase(zamba)
    autoconf = autoconf_phase(K, dev, args.out)

    csrc = "src/repro_torch/kernels/csrc"
    kernels = []
    for tag, suffix, source, timed in (
            ("bf16", "", "wgmma_gemm.cuh", rows),
            ("int8", "_int8", "wgmma_s8.cuh", int8_rows["planner"]),
            ("f32", "_f32", "tile_gemm.cuh", core_rows["planner"])):
        kernels += [kernel_entry(f"{kname}{suffix}", f"{csrc}/{source}",
                                 f"src/repro/kernels/gemm.py:{line}",
                                 main_path[tag]["launches"][kname],
                                 main_path[tag]["err"][kname],
                                 [r for r in timed if r["kernel"] == kname])
                    for kname, line in (("gemm_k_inner", 56),
                                        ("gemm_k_outer", 89))]
    kernels.append(kernel_entry(
        "grouped_gemm", f"{csrc}/grouped_gemm.cu",
        "src/repro/kernels/grouped_gemm.py:37", served["grouped_gemm"],
        grouped_err, [r for r in grouped_rows if r["served"]]))
    for kname, line in (("flash_attention", 68), ("rmsnorm", 29)):
        kernels.append(kernel_entry(
            kname, f"{csrc}/{kname}.cu",
            f"src/repro/kernels/{kname}.py:{line}",
            model_k["launches"][kname], model_k["max_abs_err"][kname],
            [r for r in attn_rows if r["kernel"] == kname and r["served"]]))
    f32_row = [r for r in attn_rows if r["kernel"] == "flash_attention"
               and r["dtype"] == "f32" and r["shape_name"] == FLASH_F32_ROW]
    kernels.append(kernel_entry(
        "flash_attention_f32", f"{csrc}/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:68", flash_f32_launches,
        f32_row[0]["max_abs_err"], f32_row))
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump({"device": card, "power": smi("name,power.limit"),
                   "rows": rows, "old_tile_rows": old_rows,
                   "stage_rows": stage_rows,
                   "parent_rows": parent, "grouped_rows": grouped_rows,
                   "grouped_f32_rows": grouped_tags["f32"],
                   "parent_grouped_rows": grouped_parent,
                   "grouped_stage_rows": grouped_stage_rows,
                   "serve": served, "serve_turns": serve_turns,
                   "greedy": greedy,
                   "model_kernels": model_k,
                   "attention_norm_rows": attn_rows,
                   "norm_turns": norm_turns, "flash_turns": flash_turns,
                   "f32_gemm_rows": core_rows, "int8_rows": int8_rows,
                   "table2_int8_rows": table2_rows,
                   "int8_turns": int8_turns,
                   "int8_stage_rows": int8_stage_rows,
                   "transpose_rows": transpose_rows,
                   "main_path": main_path, "zamba": zamba,
                   "families": families, "deployment": deployment,
                   "autoconf": autoconf},
                  f, indent=1)
    print(f"\n(GEMM times are sums over the five Qwen2-1.5B GEMMs at the "
          f"planner's tiles, by dtype "
          f"{ {t: [r[4] for r in v['shapes']] for t, v in main_path.items()} }"
          f"; grouped "
          f"times over the four bf16 shapes of the served run, flash "
          f"attention and RMSNorm times over the bf16 shapes phase 9 "
          f"recorded from the model; grouped and RMSNorm times are device "
          f"times by CUDA-graph replay, the others CUDA-event times; "
          f"{time.perf_counter() - t_start:.1f} s in all)")
    print(smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
