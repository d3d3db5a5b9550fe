#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR] [--parent DIR]

Run from the root of a checkout, on a machine with one sm_90 card and the
CUDA toolkit.  It imports only ``repro_torch`` (from ``src/``), never JAX or
the JAX package, and raises on the first failed check, so any failure exits
non-zero.  It drives six paths of the port: the paper's GEMM loop
(phases 3-4), serving granite-moe-3b-a800m at full width (phase 7), the
attention and norm entry points on that model's activations (phase 9),
serving zamba2-1.2b at full width (phase 11), Qwen2-1.5B
autoconfigured, served and replayed (phase 14), Qwen2-1.5B trained
at full width (phase 15), the multi-device layer (phase 16) and its
sequence-sharded long decode (phase 16 (d)), beside the other model
families (phase 12), the deployment report (phase 13), the dry run's
accounting of phase 16's step (phase 17), and the drivers outside the
package with the last two mesh branches (phase 18).
Phases:

1. build   — compile every source of ``src/repro_torch/kernels/csrc/`` for
             sm_90a (one nvcc per library, all in parallel); print build
             seconds, register use, the bf16 GEMM and grouped (wgmma)
             kernels' registers and spills, the grouped routes'
             configuration per tile (bf16: slab depth, stages, shared
             memory, blocks per SM, blocks per launch at the served
             shapes; f32: shared memory), the GEMM's wgmma configuration at
             every planner tile, the RMSNorm kernels' registers and shared
             memory per kernel (a spill fails) and the columns path's
             tile at D = 1536, the f32 flash attention (CUDA-core)
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
             exactly one device kernel, the one of the path
             ``kernels/rmsnorm.py:path`` names, and allocate only its
             output, on a contiguous x, a row-strided slice, a slice off
             16 bytes, a transposed x and a row past the single-read width
             alike.
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
             and so must its logits at every generated step (rtol = atol =
             1e-4, atol raised by ``GREEDY_ULPS`` f32 ulps of the row's
             largest |logit|: the two sum in other orders).
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
             and 32768 rows of 1536 in bf16 and f32, kimi-k2-1t's 7168,
             qwen2.5-32b's 5120, a ragged D = 1001, a transposed x, a
             row-strided slice, slices off 16 bytes at 1536 and 7168, and
             16392 (past the single-read width) contiguous and off 16
             bytes, each row's kernel path checked against the one it must
             take (``NORM_EXTRA``)), each timed beside its
             plain version, one PyTorch call (SDPA, ``F.rms_norm``) and its
             bound.  RMSNorm takes the f32 scale the models keep, and is
             also timed by CUDA-graph replay (device time) and by a
             host-clock loop that does not synchronise per call (the
             wrapper's host µs per call, beside ``F.rms_norm``'s); a bf16
             scale must give the output of its f32 copy, bit for bit; every
             bf16 flash launch must take the wgmma route and every f32 one
             the CUDA cores (aligned copies printed).  With ``--parent``,
             RMSNorm (``NORM_TURNS``: 4, 32 and 32768 rows of 1536, and
             kimi-k2-1t's, qwen2.5-32b's, the ragged, the transposed, the
             row-strided and the 16392-wide shapes in both dtypes) and
             flash attention (causal;
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
             logits; the served step is bound by the host).  The tied
             head's logits launch at the served batch (``gemm.matmul`` on
             ``layers.head_matrix``, the table's ``.t()`` read in place) is
             timed; with ``--parent``, in turns with the parent's.
15. train   — (a) ``launch.train.train`` trains Qwen2-1.5B at full width
             (the widths above; f32 master weights and AdamW moments, bf16
             compute, random weights from a seeded generator on the card)
             for 4 steps of 4 x 256 tokens with a checkpoint every 2 steps
             under ``--out``/ckpt: each step's loss, wall ms, tokens/s
             and grad_norm, ``torch.cuda.max_memory_allocated``, the
             watchdog and the GEMM launches by route, backward (the
             products ``gemm/autograd.py``'s Functions run in their
             ``backward``, also by operand layout: row-major, A or B
             transposed) and forward (block remat's recompute
             included) are printed; it fails on a loss or grad_norm that
             is not finite, a bf16 GEMM launch off wgmma, a transposed
             copy, a row-major backward product other than the tied
             head's dX (one a step), parameters that step 1 (learning
             rate 0) moved or steps 2-4 did not, or a checkpoint missing
             at step 2 or 4.  (b) ``serve_demo`` serves
             the step-4 checkpoint (2 requests, 4 new tokens): the step
             served must be 4 and every token in the vocabulary; the
             checkpoints (37 GB) are then deleted.  (e) granite-moe-3b-
             a800m at full width cut to 4 layers (phase 8's cut), bf16,
             takes 2 steps of 4 x 256 tokens: every grouped launch,
             forward and backward, on wgmma, every backward one on a
             transposed operand, no transposed copy.  (c) every backward
             product (kind, direction, shapes, dtype, layout) that (a) and
             (e) ran is held against its plain version on seeded operands
             stored in that layout.  (d) Qwen2-1.5B
             at full width cut to 2 layers, f32 (the GEMMs on the CUDA
             cores), one step of gradients at 2 x 64 tokens on the card
             against the same step of the port on the CPU: 1e-4 relative
             L2 a leaf.  (f) dA = dC·Bᵀ and dB = Aᵀ·dC of the five
             Qwen2-1.5B GEMMs at 1,024 tokens on the operands as stored
             (CUDA events and device time by graph replay, the planner's
             tiles; each product's tile, layout and whether its blocks
             walk) beside their plain versions, ``torch.matmul`` on the
             same views and their bound, the dA of qkv, o, gate_up and
             logits also at the planner's next two tiles (picked /
             fastest); granite's grouped dx and dw at (e)'s shapes by
             CUDA-graph replay beside ``torch.bmm``; with ``--parent``,
             all of them in turns with the parent's copy + product; then
             one step under ``torch.profiler`` (the card's busy share,
             the wgmma GEMM's device ms against the rest) and AdamW's wall
             ms in one step.
16. meshes  — Qwen2-1.5B at full width (28 layers, 4 x 256 tokens) on the
             multi-device layer (``runtime/sharding.py``).  (a) a (1, 1)
             ``make_host_mesh`` over a one-rank NCCL group: two FSDP +
             int8_ef steps (``ParallelConfig(fsdp=True,
             grad_compression="int8_ef")``; the first at learning rate 0),
             a prefill and a decode step, against the unsharded path from
             the same seed: the state (parameters, moments, error buffer:
             digests of their bits), the metrics and both logits must be
             equal bit for bit (every collective over one rank is the
             identity), and every GEMM launch on wgmma; one step's
             collectives (calls and bytes by op and axis) are printed.
             (b) two ranks spawned on cuda:0 through gloo (NCCL refuses
             two ranks on one device) on a (1, 2) mesh, tensor parallel
             only (12/2 query heads, 2/2 KV heads, d_ff 8960/2, vocabulary
             151,936/2): each rank's prefill logits (gathered) within 0.1
             relative L2 of (a)'s unsharded ones (phase 7's bound), the
             first step's loss within 1e-2 relative, an f32 two-layer
             model's gradients within 1e-4
             relative L2 a leaf of the unsharded ones (phase 15 (d)'s
             bound); per rank the ms of two steps, the peak memory, the
             collectives of a step and which collectives gloo takes on
             CUDA tensors are printed.  (c) on the same two ranks,
             expert parallelism: granite-moe-3b-a800m's MoE block at full
             width (40 experts top-8, 20 a rank), bf16, 4 x 256 tokens,
             capacity factor 64 so that neither path drops a token:
             ``apply_moe_ep`` (two all-to-alls each way, the local experts
             on the grouped kernel, every launch on wgmma) against
             ``apply_moe`` on the whole block, output and each gradient of
             sum(y^2) within 2e-2 relative L2.  The pipeline's sends and
             receives have no gloo CUDA path (a send of a CUDA tensor
             aborts the rank) and one card holds no two NCCL ranks: the
             CPU tests hold it.  (d) zamba2-1.2b's long_500k decode
             (``serve_plan``'s sequence-sharded branch for a batch of 1)
             at full width in f32, its 6 attention sites' K/V seeded at
             all 524,288 positions chunk by chunk (8.59 GB a site), the
             Mamba2 states and conv tails seeded, no prefill: the
             script's process decodes unsharded on the card at positions
             262,143, 262,144 and 524,287 (the two sides of the ranks'
             boundary, where at the first one rank holds no visible key,
             and the last), frees the 51.5 GB cache, then two gloo ranks
             on cuda:0 decode the same steps on a (2, 1) mesh with the
             caches' sequence axis over data (25.8 GB a rank): logits
             finite and within 1e-3 relative L2 (phase 11's f32 bound),
             the same greedy tokens, three all-reduces over data a step
             at each attention site, every GEMM launch on the CUDA cores
             and held against its plain version at its shape and tile; ms
             a step and peak memory per rank are printed.
17. dry run — in a child process (its fake default group cannot live
             beside phase 16's): ``launch.dryrun.run_cell`` at phase 16
             (a)'s cell (Qwen2-1.5B, a (1, 1) mesh, FSDP + int8_ef, 4 x
             256 tokens) must count the collectives (a) measured in a
             step, by op and axis, in calls and bytes, and (a)'s state and
             batch as its argument bytes; its flops are printed beside the
             2 m n k of the GEMMs (a)'s step launched and its roofline
             bound (``core/roofline.py``, on the h100 manifest) beside
             (a)'s step time; then ``roofline_probe.probe_cell(
             "qwen2-1.5b", "train_4k")`` on the 16x16 mesh and zamba2-
             1.2b's long_500k cell on 2x16x16, with their seconds.
18. last   — (a) the drivers outside the package, each run in this
             process as its command line runs it (``runpy``):
             ``examples/autotune_explore_torch.py --m 4096 --n 1536 --k
             8960`` (Qwen2-1.5B's down projection at full width; the
             chosen ``cuda`` plan's bf16 result within rtol = atol = 2e-2
             of its plain version), ``quickstart_torch.py`` (2b gives
             128.0 on the card; it trains and serves a smoke qwen2),
             ``serve_batch_torch.py`` with its defaults and with ``--arch
             granite-moe-3b-a800m``, and ``train_e2e_torch.py --steps 70``
             three times: whole; stopped by SIGTERM after step 60 (its
             emergency checkpoint); run again, resuming at 60: the
             stopped and resumed runs' losses and final parameters equal
             the whole run's bit for bit.  Each driver's GEMM launches
             must all take wgmma, its training runs launch backward
             products and granite's serving the grouped kernel on wgmma;
             every GEMM and grouped product the drivers ran is held
             against its plain version at its shape, tile and layout.
             (b) in a child process on the dry run's fake group:
             kimi-k2-1t-a32b at full width, cut to 2 of its 61 blocks,
             ``LM.init(shard=True)`` on the card as rank 0 of the 16x16
             production mesh (FSDP): its peak memory within its shards
             plus the larger of one expert's f32 leaf (58.7 MB) and the
             largest non-expert f32 leaf (the 4.70 GB embedding) plus 256
             MB, and its shard bytes equal to the spec tree's; then
             granite-moe-3b-a800m at full width (48 padded experts, 3 a
             rank) ``init(shard=True) == shard(init())`` bit for bit.  (c)
             Mamba2 sharded on d_inner alone: zamba2-1.2b's smoke config
             with ``ssm_head_dim`` 128 (one head; a cut of the width, no
             mesh under a model axis of 128 reaches the branch at full
             width) in f32, a prefill, three greedy decode steps and the
             CE loss's gradients on one card, then on two gloo ranks
             sharing the card on a (1, 2) mesh from their own
             ``init(shard=True)``: logits within 1e-5 relative L2, the
             same tokens, each leaf's gradient within 1e-4 relative L2 of
             one card's, except the head-wise leaves (dt_bias, A_log,
             Dskip: cancelling sums, one card's own f32 error reaches
             1.6e-4 there), which lie no more than 1e-4 further from a
             float64 run's (on the host) than one card's and within 3e-4
             of one card's; every GEMM launch on the CUDA cores and held
             against its plain version.

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
``gemm_k_inner`` on the wgmma route, phase 15 ``gemm_k_inner`` forward
and backward and (in (e)) the grouped kernel forward and backward, phase
16 ``gemm_k_inner`` and (in (c)) the grouped kernel on the wgmma route
(their launches, forward and backward, are added to ``gemm_k_inner``'s,
``gemm_k_inner_bwd``'s, ``grouped_gemm``'s and ``grouped_gemm_bwd``'s),
phase 16 (d) ``gemm_k_inner`` in f32 (added to ``gemm_k_inner_f32``'s),
phase 18 (a) each driver ``gemm_k_inner`` on wgmma, forward and (where
it trains) backward, and serve_batch on granite the grouped kernel
(added to ``gemm_k_inner``'s, ``gemm_k_inner_bwd``'s and
``grouped_gemm``'s), phase 18 (c) ``gemm_k_inner`` in f32 (added to
``gemm_k_inner_f32``'s).  The
line before the last is the ``{"kernels": [...]}`` record (the GEMM
kernels three times, each timed at its dtype's planner tiles: bf16 from
``wgmma_gemm.cuh``, int8, ``*_int8``, from ``wgmma_s8.cuh``, and f32,
``*_f32``, from ``tile_gemm.cuh``; flash attention twice: bf16 over the
shapes phase 9 recorded, ``flash_attention_f32`` at phase 10's granite
S = 4096 causal f32 row with phase 10's f32 launches; the backward
products as ``gemm_k_inner_bwd``, phase 15 (a)'s backward launches and
(f)'s dA and dB times summed, and ``grouped_gemm_bwd``, (e)'s backward
launches and (f)'s grouped rows); the last line is
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


#: the device kernel each RMSNorm path launches (csrc/rmsnorm.cu)
NORM_KERNELS = {"direct": "rmsnorm_direct", "element": "rmsnorm_ring",
                "columns": "rmsnorm_columns", "two-pass": "rmsnorm_two_pass"}
#: phase 2's RMSNorm layouts (as :func:`norm_input` takes them), widths and
#: the path each must take
ONE_NORM = (("contiguous", 1536, "direct"), ("slice", 1536, "direct"),
            ("offset", 1536, "element"), ("transposed", 1536, "columns"),
            ("contiguous", 16392, "two-pass"))


def one_norm_kernel(dev, R):
    """Fails unless one RMSNorm call with a bf16 scale runs exactly one
    device kernel (no conversion of the scale, no copy of x), the kernel of
    the path ``R.path`` names, and allocates only y, by the profiler and
    the caching allocator, on each of ``ONE_NORM``'s layouts: a contiguous
    x, a row-strided slice, a slice off 16 bytes, a transposed x and a row
    past the single-read width."""
    import torch
    from torch.autograd import DeviceType
    for layout, d, want in ONE_NORM:
        g = torch.Generator(dev).manual_seed(650)
        w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
        x = norm_input(SERVED_NORM_ROWS[0], d, layout, torch.bfloat16, g,
                       dev)
        check(R.path(x) == want, f"an RMSNorm {layout} x of width {d} takes "
                                 f"the {R.path(x)} path, not {want}")
        R.rmsnorm(x, w)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            R.rmsnorm(x, w)
            torch.cuda.synchronize()
        allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                  - before)
        kernels = [ev.key for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0]
        print(f"one RMSNorm call with a bf16 scale, {layout} x of width {d} "
              f"({want} path): device kernels {kernels}, {allocs} "
              f"allocation(s)")
        check(len(kernels) == 1 and NORM_KERNELS[want] in kernels[0]
              and allocs == 1,
              f"an RMSNorm call with a bf16 scale on a {layout} x of width "
              f"{d} ran {kernels} and made {allocs} allocations, not the one "
              f"{NORM_KERNELS[want]} kernel and y")


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
    10's RMSNorm times at ``NORM_TURNS``), ``"flash"`` (phase 10's flash
    attention times at ``FLASH_TURN_SHAPES``), ``"backward"`` (phase 15
    (f)'s backward products, :func:`backward_timings`; ``shapes`` says
    whether the tree is the parent) or ``"logits"`` (phase 14's tied-head
    logits launch at ``shapes["rows"]`` rows)."""
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
        res = norm_timings(R, dev, shapes["paths"])
    elif what == "flash":
        from repro_torch.kernels import flash_attention as FA
        res = flash_timings(FA, dev)
    elif what == "backward":
        rows, grows = backward_timings(dev, parent=shapes["parent"],
                                       quiet=True)
        res = {"rows": rows, "grows": grows}
    elif what == "logits":
        res = logits_timing(dev, shapes["rows"])
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
    "4k gate+up": (40, 819, 1536, 1024),  # the benchmark's pass at 4,096
    "4k down": (40, 819, 512, 1536),      # tokens: the wide design
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
        tiles = {}
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
            tiles[tag] = f"{G.plan(x, w).tile}"
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
              f"{tiles['bf16']} (bf16, {G.design(c, f)} design), "
              f"{tiles['f32']} (f32): both match the plain version")
    routes = dict(G.ROUTES)
    print(f"phase 6 grouped launches by route: {routes}, expected {expect} "
          f"(every bf16 launch on wgmma, every f32 one on the CUDA cores); "
          f"by design {G.DESIGNS}; aligned copies {G.COPIES['aligned']}, "
          f"expected {copies}")
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
            "tile": str(G.plan(x, w).tile),
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


class float64_products:
    """In its block the GEMM and grouped kernels' wrappers take float64
    operands as plain float64 products (the kernels take no float64, and
    their plain versions sum in f32): the float64 runs that f32 results
    are read against."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import gemm as K
        from repro_torch.kernels import grouped_gemm as G

        self.K, self.G = K, G
        self.inner = K.gemm_k_inner, G.grouped_gemm
        k_inner, grouped = self.inner

        def gemm_k_inner(a, b, *, tile):
            if a.dtype == torch.float64:
                return a @ b
            return k_inner(a, b, tile=tile)

        def grouped_gemm(x, w, *, tile=None):
            if x.dtype == torch.float64:
                return x @ w
            return grouped(x, w, tile=tile)

        K.gemm_k_inner, G.grouped_gemm = gemm_k_inner, grouped_gemm
        return self

    def __exit__(self, *exc):
        self.K.gemm_k_inner, self.G.grouped_gemm = self.inner


def host_float64(lm, values):
    """``lm``'s config in float64 on the host, holding ``values`` (its
    f32 parameters, converted exactly)."""
    import torch
    from repro_torch.models.common import tree_copy_
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(lm.cfg, param_dtype="float64",
                              compute_dtype="float64",
                              kv_cache_dtype="float64")
    out = LM(cfg, lm.mesh, device="cpu")
    out.init(torch.Generator().manual_seed(0))
    tree_copy_(out.values(), values)
    return out


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


#: phase 8: the f32 ulps of a row's largest |logit| that its atol takes
#: beside 1e-4.  The engine and the sequential loop sum in other orders
#: (the GEMM tiles follow the batch), so a logit near zero beside logits
#: of several hundred moves by a few ulps of the largest (on an H100 one
#: logit lay 1.83e-4 from the loop's, 3 ulps of its row's ~900)
GREEDY_ULPS = 4


def f32_ulp(x):
    """The spacing of f32 numbers at ``x`` (> 0)."""
    return 2.0 ** (math.frexp(x)[1] - 24)


def greedy_phase(dev):
    """Phase 8: engine == sequential greedy decode, f32, full width cut to
    4 layers (bf16 leaves argmax near-ties that flip with the batch): the
    tokens, and the logits at every generated step to rtol = atol = 1e-4,
    atol raised by ``GREEDY_ULPS`` f32 ulps of the row's largest |logit|."""
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
    err, ulps, old, gaps = 0.0, 0.0, 0, []
    for i, (_, rows) in ref.items():
        check(len(kept[i]) == len(rows), f"request {i}: {len(kept[i])} "
              f"logits rows kept for {len(rows)} steps")
        for g, w in zip(kept[i], rows):
            diff, ulp = (g - w).abs(), f32_ulp(float(w.abs().max()))
            over = diff - 1e-4 - 1e-4 * w.abs()
            nbad = int((over > GREEDY_ULPS * ulp).sum())
            check(nbad == 0, f"request {i}: {nbad} engine logits outside "
                             f"rtol = atol = 1e-4 (atol + {GREEDY_ULPS} "
                             f"ulps of the row's largest, {ulp:.4g} each) "
                             f"of the sequential loop's (max abs err "
                             f"{float(diff.max()):.4g})")
            err = max(err, float(diff.max()))
            ulps = max(ulps, float(over.max()) / ulp)
            old += int((over > 0).sum())
            gaps.append(top1_gap(w))
    mixed = rel_l2(kept[0][0], ref[1][1][0])
    peak = max(float(w.abs().max()) for _, rows in ref.values()
               for w in rows)
    print(f"engine (max_batch 3) == sequential greedy for {len(prompts)} "
          f"requests: {got}; logits within {err:.4g} at every step (max "
          f"|logit| {peak:.4g}); {old} logits outside rtol = atol = 1e-4, "
          f"the furthest {max(ulps, 0.0):.3g} ulps of its row's largest "
          f"beyond it (bound {GREEDY_ULPS}); request 0 against request 1: "
          f"{mixed:.4g} relative L2; smallest top-1 logit gap "
          f"{min(gaps):.4g}")
    del eng, lm, params, kept, ref
    torch.cuda.empty_cache()
    return {"tokens": got, "max_abs_logit_err": err,
            "outside_1e-4": old, "ulps_beyond_1e-4": max(ulps, 0.0),
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
#: phase 10: RMSNorm at other widths and layouts (name, rows, D, layout,
#: the path it must take): kimi-k2-1t's and qwen2.5-32b's d_model, a D
#: that is no multiple of the vector width (the element path), a
#: transposed x (the columns path), a row-strided slice of a fused buffer
#: (the direct path, in place), slices whose base is off 16 bytes (the
#: element path, in place; at 7168 several warps a row), and rows past the
#: single-read width (two-pass), contiguous and off 16 bytes; see
#: :func:`norm_input`
NORM_EXTRA = (("kimi-k2-1t d_model", 4096, 7168, "contiguous", "direct"),
              ("qwen2.5-32b d_model", 4096, 5120, "contiguous", "direct"),
              ("ragged D", 4096, 1001, "contiguous", "element"),
              ("non-contiguous x", 4096, 1536, "transposed", "columns"),
              ("row-strided slice", 4096, 1536, "slice", "direct"),
              ("misaligned slice", 4096, 1536, "offset", "element"),
              ("misaligned kimi slice", 4096, 7168, "offset", "element"),
              ("past single-read D", 4096, 16392, "contiguous", "two-pass"),
              ("past it, misaligned", 4096, 16392, "offset", "two-pass"))
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


def norm_input(n, d, layout, dt, g, dev):
    """An (n, d) RMSNorm input from ``g``: ``"contiguous"``;
    ``"transposed"``, the transpose of a contiguous (d, n) tensor;
    ``"slice"``, the middle third of each row of an (n, 3 * d) buffer (as
    a fused projection's output holds it); ``"offset"``, columns 1 to d of
    an (n, d + 64) buffer (each row's base off 16 bytes)."""
    import torch
    if layout == "transposed":
        return torch.randn((d, n), generator=g, device=dev, dtype=dt).t()
    if layout == "slice":
        return torch.randn((n, 3 * d), generator=g, device=dev,
                           dtype=dt)[:, d:2 * d]
    if layout == "offset":
        return torch.randn((n, d + 64), generator=g, device=dev,
                           dtype=dt)[:, 1:d + 1]
    return torch.randn((n, d), generator=g, device=dev, dtype=dt)


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
    norms = [(f"{n} rows", n, NORM_D, "contiguous", "direct")
             for n in NORM_ROWS]
    for i, (nname, n, nd, layout, npath) in enumerate(norms
                                                      + list(NORM_EXTRA)):
        for tag in ("bf16", "f32"):
            g = torch.Generator(dev).manual_seed(600 + i)
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
            x = norm_input(n, nd, layout, dt, g, dev)
            check(R.path(x) == npath, f"rmsnorm {nname} {tag} takes the "
                                      f"{R.path(x)} path, not {npath}")
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
                   "path": R.path(x),
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
            print(f"rmsnorm {nname:<20}{n:>6} x {nd} {tag:<5}{layout:<11}"
                  f"{row['path']:<9}: device {ms:.4f} ms "
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


#: phase 10 with ``--parent``: RMSNorm shapes timed in both trees (name,
#: rows, D, layout as :func:`norm_input` takes it, dtype of x)
NORM_TURNS = (
    ("4 rows", 4, NORM_D, "contiguous", "bf16"),
    ("32 rows", 32, NORM_D, "contiguous", "bf16"),
    ("32768 rows", 32768, NORM_D, "contiguous", "bf16"),
    ("32768 rows", 32768, NORM_D, "contiguous", "f32"),
    *((name, n, d, layout, tag) for name, n, d, layout, _ in NORM_EXTRA
      if layout != "offset" for tag in ("bf16", "f32")),
)


def norm_timings(R, dev, paths):
    """RMSNorm (the models' f32 scale) at ``NORM_TURNS``: device ms by
    CUDA-graph replay, CUDA-event ms and host µs per call, and with
    ``paths`` the path ``R.path`` names.  Without ``paths`` it takes only
    ``R.rmsnorm``, so it also times an older tree's module."""
    import torch

    rows = []
    for i, (name, n, d, layout, tag) in enumerate(NORM_TURNS):
        g = torch.Generator(dev).manual_seed(700 + i)
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        x = norm_input(n, d, layout, dt, g, dev)
        scale = torch.randn((d,), generator=g, device=dev)

        def kernel():
            return R.rmsnorm(x, scale)

        rows.append({"name": name, "rows": n, "d": d, "layout": layout,
                     "dtype": tag, "ms": graph_ms(kernel),
                     "event_ms": cuda_ms(kernel), "host_us": host_us(kernel),
                     "path": R.path(x) if paths else None,
                     "bound_ms": norm_bound(n, d, tag)[0]})
        del x
        torch.cuda.empty_cache()
    return rows


def compare_norms(turns):
    """Prints RMSNorm's times of parent and change, each in a fresh process
    on this card, in the order parent, change, change, parent."""
    p0, c1, c2, p1 = turns
    print("RMSNorm (f32 scale), parent vs this change on this card "
          "(fresh processes, order: parent, change, change, parent; the "
          "share is of the bytes bound, from the change's faster turn):")
    for r0, r1, r2, r3 in zip(p0, c1, c2, p1):
        best = min(r1["ms"], r2["ms"])
        print(f"  {r1['name']:<20}{r1['rows']:>6} x {r1['d']:<5} "
              f"{r1['dtype']:<5}{r1['layout']:<11}{r1['path'] or '':<9}: "
              f"device ms parent {r0['ms']:.4f} / {r3['ms']:.4f}, change "
              f"{r1['ms']:.4f} / {r2['ms']:.4f} "
              f"({100 * r1['bound_ms'] / best:.1f}% of "
              f"{r1['bound_ms']:.4f}); events ms parent "
              f"{r0['event_ms']:.4f} / {r3['event_ms']:.4f}, change "
              f"{r1['event_ms']:.4f} / {r2['event_ms']:.4f}; host us parent "
              f"{r0['host_us']:.1f} / {r3['host_us']:.1f}, change "
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
    """Wraps ``K.gemm`` (what the ``cuda`` backend's ``execute`` calls,
    forward and backward products alike) to record every (m, n, k, tile,
    dtype tag, layout) it runs, the layout the operands' wgmma transpose
    bits (``K.wgmma_layout``: the tied logits head's B is the table's
    ``.t()``).  Returns (a ``collections.Counter`` of those keys: how
    often each ran, a function that restores ``K.gemm``)."""
    import collections
    seen = collections.Counter()
    inner = K.gemm

    def gemm(a, b, c=None, *, tile):
        seen[(a.shape[0], b.shape[1], a.shape[1], tile, K._tag(a.dtype),
              K.wgmma_layout(a, b))] += 1
        return inner(a, b, c, tile=tile)

    def restore():
        K.gemm = inner

    K.gemm = gemm
    return seen, restore


def in_layout(a, b, layout):
    """``a`` and ``b`` (matrices, or stacks of them) with the same values,
    stored as ``layout`` (wgmma's transpose bits, ``K.wgmma_layout``) says:
    A as the transpose of its contiguous transpose when ``ta``, B when not
    ``tb``."""
    def swapped(t):
        return t.transpose(-2, -1).contiguous().transpose(-2, -1)

    ta, tb = layout
    return swapped(a) if ta else a, b if tb else swapped(b)


LAYOUT_NAMES = {(0, 1): "row-major", (1, 1): "A transposed",
                (0, 0): "B transposed"}


def hold_gemms(K, shapes, dev, label):
    """Each GEMM a path ran, at its (m, n, k), tile and operand layout,
    against its plain version on seeded operands (B at a weight's init
    scale, as the models hold it).  Returns the largest error per dtype."""
    import torch
    from repro_torch.core.tpu_model import GridOrder

    err = {}
    for i, (m, n, k, tile, tag, layout) in enumerate(sorted(
            shapes, key=lambda s: (s[4], s[0], s[1], s[2], str(s[3]),
                                   s[5]))):
        a, b = seeded(m, n, k, tag, 3000 + i, dev)
        b *= k ** -0.5
        a, b = in_layout(a, b, layout)
        where = (f" at {tile}, {m}x{n}x{k}, {LAYOUT_NAMES[layout]} "
                 f"({label})")
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


def hold_gemms_by_kernel(K, shapes, dev, label):
    """:func:`hold_gemms` split by kernel: the largest error under each
    name of the kernels line (``gemm_k_inner``, ``gemm_k_outer``, with
    ``_f32`` / ``_int8`` after them for those dtypes)."""
    from repro_torch.core.tpu_model import GridOrder

    err = {}
    for kname in ("gemm_k_inner", "gemm_k_outer"):
        part = {s for s in shapes if (s[3].order is GridOrder.K_OUTER)
                == (kname == "gemm_k_outer")}
        if part:
            for tag, e in hold_gemms(K, part, dev,
                                     f"{label}, {kname}").items():
                err[kname + ("" if tag == "bf16" else f"_{tag}")] = e
    return err


def max_errors(*errs):
    """The largest error per key over dicts of errors."""
    out = {}
    for e in errs:
        for k, v in e.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


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
                                 for m, n, k, t, tag, _ in gemms)}
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

    def timed_slstm(params, x, *rest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_slstm(params, x, *rest)
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


def autoconf_phase(K, dev, out_dir, parent=None):
    """Phase 14: autoconfigure Qwen2-1.5B at full width on ``cuda`` /
    ``h100-measured`` under an SLO, serve it through the port's entry
    point, hold its logits and GEMMs, time its tied-head logits launch
    (with ``parent``, in turns with that tree's), and replay its trace
    through the simulator (measured and model-priced steps)."""
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
                                 for m, n, k, t, tag, _ in gemms)}
    print(f"{res['tokens']} tokens in {res['seconds']:.3f} s: "
          f"{res['tokens_per_s']:.2f} tok/s; {res['steps']} steps "
          f"({res['decode_steps']} without admissions: "
          f"{res['decode_step_ms']:.3f} ms each; all steps "
          f"{res['step_ms_all']:.3f} ms); {out['prefills']} prefills; "
          f"torch.cuda.max_memory_allocated {peak:,} B")

    rows_ = ac["max_batch"]
    turns = ([tree_run(parent, "logits", out_dir, {"rows": rows_})]
             if parent else [])
    res["logits_launch"] = logits_timing(dev, rows_)
    if parent:
        turns += [res["logits_launch"],
                  tree_run(HERE, "logits", out_dir, {"rows": rows_}),
                  tree_run(parent, "logits", out_dir, {"rows": rows_})]
        res["logits_turns"] = turns
    print(f"the tied-head logits launch at {rows_} row(s) (head a view of "
          f"the table: {res['logits_launch']['head_is_view']}): "
          f"{res['logits_launch']['ms']:.4f} ms"
          + (" (turns parent, change, change, parent: "
             + ", ".join(f"{t['ms']:.4f}" for t in turns) + " ms)"
             if parent else ""))

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


#: phase 15: training on the card
TRAIN_RUN = dict(smoke=False, steps=4, batch=4, seq=256, ckpt_every=2,
                 device="cuda")
#: (d): Qwen2-1.5B cut to 2 layers, f32, one step of gradients
F32_STEP = dict(layers=2, batch=2, seq=64)
F32_STEP_REL_L2 = 1e-4
#: (e): granite-moe-3b-a800m cut to 4 layers (phase 8's cut), bf16
MOE_TRAIN = dict(layers=4, batch=4, seq=256, steps=2)


class Products:
    """Records the products of ``gemm/autograd.py``'s two Functions: each
    (kind, direction, A shape, B shape, dtype tag, layout), the backward
    ones in ``seen`` and the forward ones in ``forward_seen``, and the GEMM
    and grouped kernels' launches, routes and layouts the backward
    products make (every other launch is a forward one,
    block remat's recompute included: it runs inside a Function's
    ``forward``, even when the backward pass triggers it).  ``install``
    wraps, and ``restore`` unwraps, the Functions' ``forward`` and
    ``backward`` and the module's ``product`` / ``grouped_product``."""

    def __init__(self, K, G, GA):
        self.K, self.G, self.GA = K, G, GA
        self.seen = set()
        self.forward_seen = set()
        self.backward = {"gemm_k_inner": 0, "gemm_k_outer": 0,
                         "grouped_gemm": 0}
        self.routes = {"gemm": {r: 0 for r in K.ROUTES},
                       "grouped": {r: 0 for r in G.ROUTES}}
        #: backward launches by operand layout (LAYOUT_NAMES), and the
        #: row-major backward products (the tied head's dX) by direction
        self.layouts = {kind: {name: 0 for name in LAYOUT_NAMES.values()}
                        for kind in ("gemm", "grouped")}
        self.row_major = {}
        self.depth = 0               # inside a Function's forward
        self.pending = []            # directions of the backward running

    def layout(self, kind, a, b):
        return (self.K.wgmma_layout(a, b) if kind == "gemm"
                else self.G.layout(a, b))

    def _count(self, kind, fn, a, b, rest):
        K, G = self.K, self.G
        before = (dict(K.LAUNCHES), dict(K.ROUTES), dict(G.LAUNCHES),
                  dict(G.ROUTES))
        name = LAYOUT_NAMES[self.layout(kind, a, b)]
        out = fn(a, b, *rest)
        if kind == "gemm":
            n = sum(K.LAUNCHES.values()) - sum(before[0].values())
            for kname in K.LAUNCHES:
                self.backward[kname] += K.LAUNCHES[kname] - before[0][kname]
            for r in K.ROUTES:
                self.routes["gemm"][r] += K.ROUTES[r] - before[1][r]
        else:
            n = G.LAUNCHES["grouped_gemm"] - before[2]["grouped_gemm"]
            self.backward["grouped_gemm"] += n
            for r in G.ROUTES:
                self.routes["grouped"][r] += G.ROUTES[r] - before[3][r]
        self.layouts[kind][name] += n
        return out

    def install(self):
        GA, rec = self.GA, self
        self.orig = (GA.product, GA.grouped_product,
                     GA.PlannedMatmul.forward, GA.PlannedMatmul.backward,
                     GA.GroupedMatmul.forward, GA.GroupedMatmul.backward)
        product, grouped, pm_fwd, pm_bwd, gm_fwd, gm_bwd = self.orig

        def wrap_product(kind, fn):
            def inner(a, b, *rest):
                if rec.depth:
                    rec.forward_seen.add((kind, "forward", tuple(a.shape),
                                          tuple(b.shape),
                                          rec.K._tag(a.dtype),
                                          rec.layout(kind, a, b)))
                if rec.depth or not rec.pending:
                    return fn(a, b, *rest)
                direction, layout = rec.pending.pop(0), rec.layout(kind, a,
                                                                   b)
                rec.seen.add((kind, direction, tuple(a.shape),
                              tuple(b.shape), rec.K._tag(a.dtype), layout))
                if layout == (0, 1):
                    rec.row_major[direction] = (
                        rec.row_major.get(direction, 0) + 1)
                return rec._count(kind, fn, a, b, rest)
            return inner

        def wrap_forward(fn):
            def forward(ctx, *args):
                rec.depth += 1
                try:
                    return fn(ctx, *args)
                finally:
                    rec.depth -= 1
            return staticmethod(forward)

        def wrap_backward(fn, names):
            def backward(ctx, grad):
                rec.pending = [n for n, want in zip(names,
                                                    ctx.needs_input_grad)
                               if want]
                try:
                    return fn(ctx, grad)
                finally:
                    rec.pending = []
            return staticmethod(backward)

        GA.product = wrap_product("gemm", product)
        GA.grouped_product = wrap_product("grouped", grouped)
        GA.PlannedMatmul.forward = wrap_forward(pm_fwd)
        GA.PlannedMatmul.backward = wrap_backward(pm_bwd, ("dA", "dB"))
        GA.GroupedMatmul.forward = wrap_forward(gm_fwd)
        GA.GroupedMatmul.backward = wrap_backward(gm_bwd, ("dx", "dw"))
        return self

    def restore(self):
        GA = self.GA
        (GA.product, GA.grouped_product, pm_fwd, pm_bwd, gm_fwd,
         gm_bwd) = self.orig
        GA.PlannedMatmul.forward = staticmethod(pm_fwd)
        GA.PlannedMatmul.backward = staticmethod(pm_bwd)
        GA.GroupedMatmul.forward = staticmethod(gm_fwd)
        GA.GroupedMatmul.backward = staticmethod(gm_bwd)


def hold_products(K, G, seen, dev, label="phase 15: the backward products "
                  "of (a) and (e)"):
    """Each product (kind, direction, shapes, dtype, layout) a
    :class:`Products` recorded against its plain version on seeded
    operands at those shapes, stored in that layout (the second operand at
    a weight's init scale), the GEMMs on the tile the planner gives their
    shape.  Returns the largest error per kind."""
    import torch
    from repro_torch import gemm

    err = {"gemm": 0.0, "grouped": 0.0}
    for i, (kind, direction, sa, sb, tag, layout) in enumerate(sorted(seen)):
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        g = torch.Generator(dev).manual_seed(4000 + i)
        a = torch.randn(sa, generator=g, device=dev).to(dt)
        b = (torch.randn(sb, generator=g, device=dev)
             * sb[-2] ** -0.5).to(dt)
        a, b = in_layout(a, b, layout)
        where = f" ({direction} {sa} @ {sb}, {LAYOUT_NAMES[layout]})"
        if kind == "gemm":
            plan = gemm.plan((sa[0], sb[1], sa[1]), backend="cuda",
                             dtype=tag)
            e = compare("gemm_k_inner", tag, plan.execute(a, b),
                        K.gemm_k_inner_plain(a, b),
                        where=f" at {plan.selection},{where}")
        else:
            e = compare("grouped_gemm", tag, G.grouped_gemm(a, b),
                        G.grouped_gemm_plain(a, b), where=where)
        err[kind] = max(err[kind], e)
        del a, b
    torch.cuda.empty_cache()
    print(f"{label}: {len(seen)} (kind, direction, shapes, dtype, layout) "
          f"match their plain versions (max |err| {err}; bf16 rtol = atol "
          f"= 2e-2, f32 rtol 1e-5 / atol 1e-4)")
    return err


#: phase 15 (f): the dA products also timed at the cuda planner's next two
#: tiles (at 1,024 tokens its 128x128x128 pick gives 96 tiles, leaving 36
#: of 132 SMs idle)
WAVE_GEMMS = ("qkv", "o", "gate_up", "logits")


def next_tiles(shape, pick, n=2):
    """The ``n`` tiles the Hopper tile model (the cuda planner's) ranks
    next after ``pick`` for ``shape``."""
    from repro_torch.core import hopper_model as H
    from repro_torch.machines import resolve

    h100 = resolve("h100")
    ranked = sorted(H.lattice("bf16"),
                    key=lambda t: H.estimate(shape, t, h100).total)
    return [t for t in ranked if t != pick][:n]


def backward_timings(dev, tokens=1024, parent=False, quiet=False):
    """dA = dC·Bᵀ and dB = Aᵀ·dC of the five Qwen2-1.5B GEMMs at
    ``tokens`` rows (CUDA events, which hold a call's host cost where it
    exceeds the kernel's, and device time by CUDA-graph replay; the
    planner's tiles; B at a weight's init scale), then granite's grouped
    dx = dy·wᵀ and dw = xᵀ·dy at its training shapes (device time by
    CUDA-graph replay), each as ``gemm/autograd.py`` runs it: on the
    operands as stored (``b.t()``, ``a.t()``, ``w.transpose(1, 2)``,
    ``x.transpose(1, 2)``; the tied head's B is the table's ``.t()``, its
    dB (dCᵀ·A)ᵀ), beside the plain version, ``torch.matmul`` /
    ``torch.bmm`` on the same views and the bound, and the dA of
    :data:`WAVE_GEMMS` at the planner's next two tiles (device time).
    ``parent``: a
    tree whose kernels read row-major operands only, timed as its autograd
    ran (each transposed operand copied, the copy inside the time; the
    tied head's dA on the table, its dB on a copy of Aᵀ); its rows hold
    the time alone."""
    import torch
    from repro_torch import gemm
    from repro_torch.configs import get_config
    from repro_torch.core.autotune import model_gemm_shapes
    from repro_torch.core.tpu_model import GemmShape
    from repro_torch.kernels import gemm as K
    from repro_torch.kernels import grouped_gemm as G

    def say(*a):
        if not quiet:
            print(*a)

    qwen = get_config("qwen2-1.5b")
    names = ["qkv", "o", "gate_up", "down", "logits"]
    rows = []
    for i, (name, s_) in enumerate(zip(names, model_gemm_shapes(
            qwen, tokens=tokens))):
        m, n, k = s_.m, s_.n, s_.k
        a, b = seeded(m, n, k, "bf16", 5000 + i, dev)
        b *= k ** -0.5
        tied = name == "logits" and qwen.tie_embeddings
        if tied:
            b = b.t().contiguous().t()       # the head: the table's .t()
        dc = torch.randn((m, n), device=dev, dtype=torch.bfloat16)
        # (x, y, copy x, copy y, the result transposed)
        prods = ({"dA": (dc, b.t(), False, not tied, False),
                  "dB": (a.t(), dc, True, False, False)} if parent else
                 {"dA": (dc, b.t(), False, False, False),
                  "dB": (dc.t(), a, False, False, True) if tied
                  else (a.t(), dc, False, False, False)})
        for direction, (x, y, cx, cy, back) in prods.items():
            mm, nn, kk = x.shape[0], y.shape[1], x.shape[1]
            plan = gemm.plan((mm, nn, kk), backend="cuda", dtype="bf16")

            def run(plan=plan, x=x, y=y, cx=cx, cy=cy):
                return plan.execute(x.contiguous() if cx else x,
                                    y.contiguous() if cy else y)
            ms = cuda_ms(run)
            bms, by = bound(mm, nn, kk, "bf16", False)
            row = {"gemm": name, "direction": direction,
                   "shape": [mm, nn, kk], "tile": str(plan.selection),
                   "ms": ms, "device_ms": graph_ms(run), "bound_ms": bms,
                   "bound_by": by, "copies": int(cx) + int(cy)}
            if parent:
                rows.append(row)
                continue
            lay = K.wgmma_layout(x, y)
            cfg = K.wgmma_config(plan.selection, ta=lay[0], tb=lay[1])
            blocks = K.launch_blocks(mm, nn, plan.selection, cfg)
            row.update(layout=LAYOUT_NAMES[lay], walk=cfg.walk,
                       blocks=blocks,
                       plain_ms=cuda_ms(lambda: K.gemm_k_inner_plain(x, y)),
                       library_ms=cuda_ms(lambda: torch.matmul(x, y)),
                       transposed_result=back)
            say(f"  {name:<8}{direction} {mm}x{nn}x{kk} at "
                f"{plan.selection}, {row['layout']}"
                f"{' (as its transpose)' if back else ''}, "
                f"{'walk' if cfg.walk else 'one tile a block'}: {blocks} "
                f"blocks; {ms:.4f} ms, device {row['device_ms']:.4f} "
                f"({100 * bms / row['device_ms']:.1f}% of the {bms:.4f} ms "
                f"bound, {by}), plain {row['plain_ms']:.4f}, torch.matmul "
                f"{row['library_ms']:.4f}")
            if direction == "dA" and name in WAVE_GEMMS:
                row["next_tiles"] = {}
                for t in next_tiles(GemmShape(mm, nn, kk, dtype="bf16"),
                                    plan.selection):
                    alt = gemm.plan((mm, nn, kk), backend="cuda",
                                    machine="h100", dtype="bf16", tile=t)
                    compare("gemm_k_inner", "bf16", alt.execute(x, y),
                            K.gemm_k_inner_plain(x, y),
                            where=f" at {t} ({name} dA)")
                    row["next_tiles"][str(t)] = graph_ms(
                        lambda: alt.execute(x, y))
                fastest = min([row["device_ms"],
                               *row["next_tiles"].values()])
                row["picked_over_fastest"] = row["device_ms"] / fastest
                say(f"    the planner's next tiles, device: "
                    + ", ".join(f"{t} {v:.4f} ms"
                                for t, v in row["next_tiles"].items())
                    + f"; picked / fastest "
                    f"{row['picked_over_fastest']:.3f}")
            rows.append(row)
        del a, b, dc
    tot = {k: sum(r.get(k, 0.0) for r in rows)
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    say(f"GEMM backward, five Qwen2-1.5B GEMMs at {tokens} tokens, dA + "
        f"dB: {tot['ms']:.4f} ms, device {tot['device_ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['device_ms']:.1f}% of the "
        f"{tot['bound_ms']:.4f} ms bound), torch.matmul "
        f"{tot['library_ms']:.4f}, plain {tot['plain_ms']:.4f}")
    cfg = get_config("granite-moe-3b-a800m")
    from repro_torch.models.moe import _capacity
    e, c = cfg.n_experts, MOE_TRAIN["batch"] * _capacity(
        MOE_TRAIN["seq"], cfg)
    grows = []
    for name, d, f in (("gate/up", cfg.d_model, cfg.moe_d_ff),
                       ("down", cfg.moe_d_ff, cfg.d_model)):
        g = torch.Generator(dev).manual_seed(6000 + d)
        x = torch.randn((e, c, d), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w = (torch.randn((e, d, f), generator=g, device=dev) * d ** -0.5
             ).to(torch.bfloat16)
        dy = torch.randn((e, c, f), generator=g, device=dev,
                         dtype=torch.bfloat16)
        for direction, (p, q, cp, cq, shp) in {
                "dx": (dy, w.transpose(1, 2), False, parent, (e, c, f, d)),
                "dw": (x.transpose(1, 2), dy, parent, False,
                       (e, d, c, f))}.items():
            def run(p=p, q=q, cp=cp, cq=cq):
                return G.grouped_gemm(p.contiguous() if cp else p,
                                      q.contiguous() if cq else q)
            ms = graph_ms(run)
            bms, by = grouped_bound(*shp, "bf16")
            row = {"gemm": name, "direction": direction, "shape": list(shp),
                   "ms": ms, "bound_ms": bms, "bound_by": by,
                   "copies": int(cp) + int(cq)}
            if not parent:
                lay = G.layout(p, q)
                gcfg = G.grouped_config(G.plan(p, q).tile, lay)
                row.update(layout=LAYOUT_NAMES[lay], walk=gcfg.walk,
                           blocks=K.launch_blocks(shp[1], shp[3],
                                                  G.plan(p, q).tile, gcfg,
                                                  e),
                           plain_ms=graph_ms(
                               lambda: G.grouped_gemm_plain(p, q)),
                           library_ms=graph_ms(lambda: torch.bmm(p, q)))
                say(f"  grouped {name:<8}{direction} {shp} at "
                    f"{G.plan(p, q).tile}, {row['layout']}, "
                    f"{'walk' if gcfg.walk else 'one tile a block'}: "
                    f"{row['blocks']} blocks; {ms:.4f} ms device "
                    f"({100 * bms / ms:.1f}% of the {bms:.4f} ms bound, "
                    f"{by}), plain {row['plain_ms']:.4f}, torch.bmm "
                    f"{row['library_ms']:.4f}")
            grows.append(row)
    if not parent:
        say(f"grouped backward dx + dw: "
            f"{sum(r['ms'] for r in grows):.4f} ms device, torch.bmm "
            f"{sum(r['library_ms'] for r in grows):.4f}, bound "
            f"{sum(r['bound_ms'] for r in grows):.4f}")
    return rows, grows


def compare_backward(turns):
    """Phase 15 (f) in turns (parent, change, change, parent): each
    backward product's ms, the parent's copy + product beside the change's
    product on the operands as stored."""
    print("(f) in turns, parent (copy + product) vs this change (product "
          "on the operands as stored), ms:")
    for kind, key in (("GEMM", "rows"), ("grouped", "grows")):
        per = [t[key] for t in turns]
        for r0, r1, r2, r3 in zip(*per):
            dev_ = (f"; device parent {r0['device_ms']:.4f} / "
                    f"{r3['device_ms']:.4f}, change {r1['device_ms']:.4f} / "
                    f"{r2['device_ms']:.4f}" if "device_ms" in r0 else "")
            print(f"  {kind} {r1['gemm']:<8}{r1['direction']}: parent "
                  f"{r0['ms']:.4f} / {r3['ms']:.4f}, change {r1['ms']:.4f} / "
                  f"{r2['ms']:.4f}{' (walk)' if r1.get('walk') else ''}"
                  f"{dev_}")
        for key_ in ("ms", "device_ms"):
            if key_ not in per[0][0]:
                continue
            sums = [sum(r[key_] for r in rs) for rs in per]
            print(f"  {kind} sum ({key_}): parent {sums[0]:.4f} / "
                  f"{sums[3]:.4f}, change {sums[1]:.4f} / {sums[2]:.4f} "
                  f"({min(sums[0], sums[3]) / min(sums[1], sums[2]):.2f}x)")


def logits_timing(dev, rows):
    """One tied-head logits launch of Qwen2-1.5B at ``rows`` (a decode
    step's batch): ``gemm.matmul(x, head)`` on the head this tree's
    ``layers.head_matrix`` makes (CUDA events)."""
    import torch
    from repro_torch import gemm
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("qwen2-1.5b")
    g = torch.Generator(dev).manual_seed(11)
    table = (torch.randn((cfg.padded_vocab, cfg.d_model), generator=g,
                         device=dev) * 0.02).to(torch.bfloat16)
    head = layers.head_matrix({"table": table}, cfg)
    x = torch.randn((rows, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return {"rows": rows, "ms": cuda_ms(lambda: gemm.matmul(x, head)),
            "head_is_view": head.data_ptr() == table.data_ptr()}


def profile_train_step(lm, tcfg, pcfg, batch):
    """One training step under torch.profiler, after a warm-up step:
    device time by kernel, the wgmma GEMM's and the grouped kernel's
    share, the card's busy share of the step's wall time; then one step
    with AdamW's own wall time read on the host (synchronised before and
    after it)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.runtime import train_lib
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    params, _, opt, _ = init_train_state(
        lm, tcfg, torch.Generator(lm.device).manual_seed(5), pcfg)
    step = make_train_step(lm, tcfg, pcfg)
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [{"name": ev.key, "device_ms": ev.self_device_time_total / 1e3,
             "count": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    gemm_ms = sum(r["device_ms"] for r in rows if "wgmma_gemm" in r["name"])
    grouped_ms = sum(r["device_ms"] for r in rows
                     if "grouped_wgmma" in r["name"])
    adamw = {}
    inner = train_lib.adamw_update

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        adamw["enqueue_ms"] = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        adamw["ms"] = 1e3 * (time.perf_counter() - t)
        return out

    train_lib.adamw_update = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        train_lib.adamw_update = inner
    res = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "device_events": sum(r["count"] for r in rows),
           "gemm_device_ms": gemm_ms, "grouped_device_ms": grouped_ms,
           "top": rows[:20], "adamw_ms": adamw["ms"],
           "adamw_enqueue_ms": adamw["enqueue_ms"], "timed_step_ms": step_ms}
    print(f"one step under the profiler: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{res['device_events']} device events; wgmma GEMM {gemm_ms:.3f} "
          f"ms, grouped {grouped_ms:.3f} ms, the rest "
          f"{busy - gemm_ms - grouped_ms:.3f} ms")
    for r in rows[:10]:
        print(f"  {r['device_ms']:9.3f} ms {r['count']:6d}x  {r['name'][:90]}")
    print(f"AdamW (one step, profiler off): {adamw['ms']:.1f} ms wall, "
          f"{adamw['enqueue_ms']:.1f} ms to enqueue, of a "
          f"{step_ms:.1f} ms step")
    del params, opt
    return res


def training_phase(K, G, dev, out_dir, parent=None):
    """Phase 15: train Qwen2-1.5B at full width through the port's entry
    point, serve its checkpoint, hold every backward product against its
    plain version at its operand layout, one f32 step on the card against
    the CPU, granite's grouped backward, the backward products timed (with
    ``parent``, in turns with that tree's copy + product) and one step's
    split."""
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (ParallelConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.data import DataIterator, make_batch
    from repro_torch.gemm import autograd as GA
    from repro_torch.interop import _flatten
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import LM
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    phase(15, "training on the card: Qwen2-1.5B at full width, its "
              "checkpoint served, every backward product held")
    cfg = get_config("qwen2-1.5b")
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), tied {cfg.tie_embeddings}; params "
          f"{cfg.param_dtype}, compute {cfg.compute_dtype}, moments "
          f"{cfg.opt_state_dtype}")
    print(smi("name,power.limit"))
    ckpt = os.path.join(out_dir, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    res = {}

    # -- (a) ---------------------------------------------------------------
    fingerprints = []
    real_make = train_mod.make_train_step

    def make_fingerprinted(*a, **kw):
        inner = real_make(*a, **kw)

        def step(params, opt, batch):
            if not fingerprints:
                fingerprints.append(torch.stack([
                    p.detach().float().sum() for p in tree_leaves(params)]))
            out = inner(params, opt, batch)
            fingerprints.append(torch.stack([
                p.detach().float().sum() for p in tree_leaves(out[0])]))
            return out
        return step

    rec = Products(K, G, GA).install()
    train_mod.make_train_step = make_fingerprinted
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    G.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = train_mod.train("qwen2-1.5b", ckpt_dir=ckpt, **TRAIN_RUN)
        launches, routes = dict(K.LAUNCHES), dict(K.ROUTES)
        copies = {"gemm": dict(K.COPIES), "grouped": dict(G.COPIES)}
        layouts = {k: dict(v) for k, v in rec.layouts.items()}
        row_major = dict(rec.row_major)
    finally:
        train_mod.make_train_step = real_make
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del out["params"]
    for h in out["history"]:
        print(f"  step {h['step']}: loss {h['loss']:.4f}, {h['ms']:.1f} ms, "
              f"{h['tokens_per_s']:.1f} tok/s, grad_norm "
              f"{h['grad_norm']:.4f}, lr {h['lr']:.3g}")
    bwd = dict(rec.backward)
    fwd = sum(launches.values()) - bwd["gemm_k_inner"] - bwd["gemm_k_outer"]
    print(f"train(): {len(out['history'])} steps in {train_s:.1f} s (two "
          f"checkpoints included); torch.cuda.max_memory_allocated "
          f"{peak:,} B; watchdog {out['watchdog']}")
    print(f"GEMM launches {launches} by route {routes}: backward "
          f"{bwd['gemm_k_inner'] + bwd['gemm_k_outer']} by route "
          f"{rec.routes['gemm']}, by layout {layouts['gemm']} (row-major "
          f"products by direction {row_major}), forward (the recompute "
          f"included) {fwd}; copies {copies}")
    for h in out["history"]:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']}, grad_norm "
              f"{h['grad_norm']} not finite")
    all_on_wgmma(K, "phase 15 (a)'s bf16 training run")
    check(bwd["gemm_k_inner"] > 0 and rec.routes["gemm"]["cuda_cores"] == 0,
          f"backward GEMM launches {bwd} by route {rec.routes['gemm']}")
    check(copies["gemm"]["transposed"] == 0
          and copies["grouped"]["transposed"] == 0,
          f"the bf16 training run made transposed copies: {copies}")
    # one row-major backward product a step: the tied head's dX, which
    # reads the table as stored; every other one reads a transposed view
    check(row_major == {"dA": TRAIN_RUN["steps"]}
          and layouts["gemm"]["row-major"] == TRAIN_RUN["steps"],
          f"row-major backward products {row_major}, launches by layout "
          f"{layouts['gemm']}: not one tied-head dX a step")
    check(len(fingerprints) == 5, f"{len(fingerprints)} parameter "
                                  f"fingerprints for 4 steps")
    moved = [bool((fingerprints[i + 1] != fingerprints[i]).any())
             for i in range(4)]
    print(f"parameters moved by step: {moved} (step 1's learning rate is 0)")
    check(not moved[0], "step 1 (learning rate 0) moved the parameters")
    check(all(moved[1:]), f"the parameters did not move in steps 2-4: "
                          f"{moved}")
    steps = CheckpointManager(ckpt).all_steps()
    check(steps == [2, 4], f"checkpoints at steps {steps}, not [2, 4]")
    ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(ckpt) for f in fs)
    print(f"checkpoints {steps}: {ckpt_bytes:,} B on disk")
    res["train"] = {"history": out["history"], "seconds": train_s,
                    "max_memory_allocated": peak, "launches": launches,
                    "routes": routes, "backward": bwd,
                    "backward_routes": rec.routes["gemm"],
                    "backward_layouts": layouts, "copies": copies,
                    "watchdog": out["watchdog"],
                    "checkpoint_bytes": ckpt_bytes}
    del out, fingerprints[:]
    torch.cuda.empty_cache()

    # -- (b) ---------------------------------------------------------------
    served = serve_mod.serve_demo("qwen2-1.5b", smoke=False, ckpt_dir=ckpt,
                                  n_requests=2, max_new=4, device="cuda")
    check(served["ckpt_step"] == 4, f"served checkpoint step "
                                    f"{served['ckpt_step']}, not 4")
    for rid, toks in served["generated"].items():
        check(len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid}: {toks} is not 4 in-vocabulary tokens")
    print(f"served the step-4 checkpoint: {served['generated']}")
    res["served"] = {"generated": served["generated"],
                     "ckpt_step": served["ckpt_step"]}
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- (e) ---------------------------------------------------------------
    full = get_config("granite-moe-3b-a800m")
    gcfg = dataclasses.replace(full, n_layers=MOE_TRAIN["layers"],
                               block_pattern=("moe",) * MOE_TRAIN["layers"])
    print(f"granite-moe-3b-a800m: depth cut {full.n_layers} -> "
          f"{gcfg.n_layers} layers, {gcfg.n_experts} experts top-"
          f"{gcfg.experts_per_token}, expert d_ff {gcfg.moe_d_ff}, "
          f"{gcfg.compute_dtype}")
    glm = LM(gcfg, device=dev)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    pcfg = ParallelConfig()
    gshape = ShapeConfig("t", "train", MOE_TRAIN["seq"], MOE_TRAIN["batch"])
    G.reset_launch_counts()
    before = dict(rec.backward)
    groutes_before = dict(rec.routes["grouped"])
    glayouts_before = dict(rec.layouts["grouped"])
    params, _, opt, _ = init_train_state(glm, tcfg,
                                         torch.Generator(dev).manual_seed(2))
    step = make_train_step(glm, tcfg, pcfg)
    data = DataIterator(gcfg, gshape, seed=2)
    glosses = []
    for _ in range(MOE_TRAIN["steps"]):
        params, opt, m = step(params, opt, {k: v.to(dev)
                                            for k, v in next(data).items()})
        glosses.append((float(m["loss"]), float(m["aux_loss"]),
                        float(m["grad_norm"])))
    torch.cuda.synchronize()
    g_launch, g_routes = G.LAUNCHES["grouped_gemm"], dict(G.ROUTES)
    g_bwd = rec.backward["grouped_gemm"] - before["grouped_gemm"]
    g_bwd_routes = {r: rec.routes["grouped"][r] - groutes_before[r]
                    for r in G.ROUTES}
    g_bwd_layouts = {n: rec.layouts["grouped"][n] - glayouts_before[n]
                     for n in glayouts_before}
    print(f"granite 2 steps: (loss, aux, grad_norm) {glosses}; grouped "
          f"launches {g_launch} by route {g_routes} (backward {g_bwd} by "
          f"route {g_bwd_routes}, by layout {g_bwd_layouts}); copies "
          f"{dict(G.COPIES)}")
    check(all(math.isfinite(x) for t in glosses for x in t),
          f"granite losses {glosses} not finite")
    check(g_launch > 0 and g_routes == {"wgmma": g_launch, "cuda_cores": 0},
          f"grouped launches {g_launch} by route {g_routes}: not every one "
          f"on wgmma")
    check(g_bwd > 0 and g_bwd_routes["cuda_cores"] == 0
          and g_bwd_layouts["row-major"] == 0
          and G.COPIES["transposed"] == 0,
          f"grouped backward launches {g_bwd} by route {g_bwd_routes}, by "
          f"layout {g_bwd_layouts}, copies {dict(G.COPIES)}")
    res["moe"] = {"losses": glosses, "grouped_launches": g_launch,
                  "grouped_routes": g_routes, "grouped_backward": g_bwd,
                  "grouped_backward_layouts": g_bwd_layouts}
    del params, opt, step, glm
    torch.cuda.empty_cache()
    rec.restore()

    # -- (c) ---------------------------------------------------------------
    res["backward_err"] = hold_products(K, G, rec.seen, dev)
    res["backward_products"] = sorted(rec.seen)

    # -- (d) ---------------------------------------------------------------
    fcfg = dataclasses.replace(cfg, n_layers=F32_STEP["layers"],
                               block_pattern=cfg.block_pattern[
                                   :F32_STEP["layers"]],
                               compute_dtype="float32")
    batch = make_batch(fcfg, ShapeConfig("t", "train", F32_STEP["seq"],
                                         F32_STEP["batch"]), 0, seed=7)
    card, host = LM(fcfg, device=dev), LM(fcfg, device="cpu")
    card.init(torch.Generator(dev).manual_seed(7))
    host.init(torch.Generator().manual_seed(7))
    with torch.no_grad():
        for p, q in zip(host.parameters(), card.parameters(), strict=True):
            p.copy_(q)
    before = snapshot(K)
    grads = {}
    for where, lm_ in (("cuda", card), ("cpu", host)):
        values = lm_.train_mode().values()
        loss, _ = lm_.loss_fn(values, {k: v.to(lm_.device)
                                       for k, v in batch.items()})
        leaves = _flatten(values)
        grads[where] = (loss.item(), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))))
    route_check(K, "phase 15 (d)'s f32 step", "f32", before)
    worst, worst_path = 0.0, None
    for path, g in grads["cpu"][1].items():
        rel = float((grads["cuda"][1][path].cpu() - g).norm() / g.norm())
        if rel >= worst:
            worst, worst_path = rel, path
    print(f"f32 step, {fcfg.n_layers} layers at full width, batch "
          f"{F32_STEP['batch']} x {F32_STEP['seq']}: loss card "
          f"{grads['cuda'][0]:.7g}, CPU {grads['cpu'][0]:.7g}; worst "
          f"gradient leaf {worst_path} at {worst:.3g} relative L2 (bound "
          f"{F32_STEP_REL_L2:g})")
    check(worst <= F32_STEP_REL_L2, f"f32 gradients: {worst_path} at "
                                    f"{worst:.3g} relative L2 of the CPU's")
    res["f32_step"] = {"loss_card": grads["cuda"][0],
                       "loss_cpu": grads["cpu"][0], "worst_rel_l2": worst,
                       "worst_leaf": str(worst_path)}
    del grads, card, host
    torch.cuda.empty_cache()

    # -- (f) ---------------------------------------------------------------
    print("(f) backward products at the planner's tiles on the operands as "
          "stored (CUDA events; grouped: device time by CUDA-graph "
          "replay):")
    turns = []
    if parent:
        turns.append(tree_run(parent, "backward", out_dir, {"parent": True}))
    res["timing"], res["grouped_timing"] = backward_timings(dev)
    if parent:
        turns += [{"rows": res["timing"], "grows": res["grouped_timing"]},
                  tree_run(HERE, "backward", out_dir, {"parent": False}),
                  tree_run(parent, "backward", out_dir, {"parent": True})]
        compare_backward(turns)
        res["backward_turns"] = turns
    lm = LM(cfg, device=dev)
    tbatch = {k: v.to(dev) for k, v in make_batch(
        cfg, ShapeConfig("t", "train", TRAIN_RUN["seq"], TRAIN_RUN["batch"]),
        0).items()}
    res["profile"] = profile_train_step(lm, TrainConfig(lr=3e-3,
                                                        warmup_steps=1,
                                                        total_steps=10),
                                        ParallelConfig(), tbatch)
    del lm, tbatch
    torch.cuda.empty_cache()
    print(smi("name,power.limit"))
    return res


#: phase 16: Qwen2-1.5B at full width on meshes, 4 x 256 tokens, two steps
#: (the learning rate of the first is 0) and one prefill and decode step
MESH_RUN = dict(batch=4, seq=256, steps=2, decode_len=16, seed=16)
#: (b): the loss of the two-rank step against (a)'s unsharded one
MESH_LOSS_RTOL = 1e-2
#: (b): seconds the two ranks may take (each builds Qwen2-1.5B and steps)
MESH_RANK_DEADLINE = 600.0
#: (c): expert parallelism on (b)'s ranks; the capacity factor of the JAX
#: package's EP test, so that neither path drops a token, and the bf16
#: kernels' bound (relative L2, output and each gradient)
MESH_EP = dict(capacity_factor=64.0, rel_l2=2e-2)
#: (a)'s parallelism, which phase 17's dry run of the same step takes too
MESH_PARALLEL = dict(fsdp=True, grad_compression="int8_ef")


def free_port():
    """A TCP port on localhost no one listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def digest(t):
    """Two integer sums of ``t``'s bits (plain and position-weighted, mod
    2**64): equal digests mean equal tensors unless by a coincidence."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    iv = t.detach().contiguous().view(ints[t.element_size()]).long() \
        .flatten()
    w = torch.arange(1, iv.numel() + 1, device=iv.device)
    return torch.stack([iv.sum(), (iv * w).sum()]).cpu()


def mesh_step_run(cfg, minfo, dev, batch):
    """A prefill of the batch's tokens and one decode step of ``cfg``
    under ``minfo`` (the ambient mesh, if any, installed by the caller),
    then two FSDP + int8_ef steps: the logits, the metrics, the state's
    digests and bytes, the second step's collectives and its GEMM
    launches' operations."""
    import torch
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.kernels import gemm as K
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    pcfg = ParallelConfig(**MESH_PARALLEL)
    lm = LM(cfg, minfo, device=dev)
    params, _, opt, _ = init_train_state(
        lm, tcfg, torch.Generator(dev).manual_seed(MESH_RUN["seed"]), pcfg)
    out = {}
    with torch.no_grad():     # before training: (b) starts from these
        out["logits"], _ = lm.prefill(params, {"tokens": batch["tokens"]})
        caches = lm.init_cache(MESH_RUN["batch"], MESH_RUN["decode_len"])
        out["decode"], _ = lm.decode_step(params, caches,
                                          batch["tokens"][:, :1], 0)
    out["logits"], out["decode"] = (out["logits"].float().cpu(),
                                    out["decode"].float().cpu())
    del caches
    step = make_train_step(lm, tcfg, pcfg)
    torch.cuda.reset_peak_memory_stats()
    out.update(metrics=[], ms=[], state_bytes=tree_bytes([params, opt]))
    for _ in range(MESH_RUN["steps"]):
        sh.reset_collective_counts()
        calls, unrecord = record_gemms(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
        finally:
            unrecord()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["metrics"].append(torch.stack([m["loss"], m["grad_norm"]])
                              .float().cpu())
    # the last step's: its collectives and its GEMM launches' 2 m n k
    out["collectives"] = sh.collective_counts()
    out["gemm_flops"] = sum(2 * m_ * n_ * k_ * c for (m_, n_, k_, *_), c
                            in calls.items())
    out["peak"] = torch.cuda.max_memory_allocated()
    out["digests"] = [digest(t) for t in tree_leaves([params, opt])]
    del params, opt, step, lm
    torch.cuda.empty_cache()
    return out


def mesh_phase(K, G, dev, out_dir):
    """Phase 16: the multi-device layer on the card.  (a) a (1, 1) mesh
    over a one-rank NCCL group: a prefill, a decode step and two FSDP +
    int8_ef steps of Qwen2-1.5B at full width equal the unsharded path bit
    for bit, every GEMM launch on wgmma; (b) two gloo ranks sharing the
    card on a (1, 2) tensor-parallel mesh (:func:`mesh_rank`), held to
    (a)'s unsharded results; (c) on the same ranks, granite's MoE block
    expert-parallel against the whole block (:func:`mesh_rank_ep`).
    Returns the results and the phase's GEMM and grouped launches, forward
    and backward."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.gemm import autograd as GA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import HOST_MESH
    from repro_torch.runtime import sharding as sh

    phase(16, "the multi-device layer: Qwen2-1.5B at full width on a "
              "one-rank NCCL mesh and on two gloo ranks sharing the card")
    print(smi("name,power.limit"))
    cfg = get_config("qwen2-1.5b")
    batch = {k: v.to(dev) for k, v in make_batch(
        cfg, ShapeConfig("t", "train", MESH_RUN["seq"], MESH_RUN["batch"]),
        0, seed=MESH_RUN["seed"]).items()}
    res = {}
    start = dict(K.LAUNCHES)

    # -- (a) ---------------------------------------------------------------
    rec = Products(K, G, GA).install()
    gemms, unrecord = record_gemms(K)
    try:
        before = snapshot(K)
        plain = mesh_step_run(cfg, HOST_MESH, dev, batch)
        all_on_wgmma(K, "phase 16 (a)'s unsharded run", before)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1)
        before = snapshot(K)
        try:
            mesh = make_host_mesh(1, 1, "cuda")
            with sh.use_mesh(mesh):
                sharded = mesh_step_run(cfg, sh.mesh_info(mesh, fsdp=True),
                                        dev, batch)
        finally:
            dist.destroy_process_group()
        all_on_wgmma(K, "phase 16 (a)'s one-rank mesh run", before)
    finally:
        unrecord()
        rec.restore()
    # the launches of (a)'s runs, before the holds below add theirs
    a_launches = {k: K.LAUNCHES[k] - start[k] for k in K.LAUNCHES}
    a_backward = dict(rec.backward)
    a_err = max_errors(hold_gemms_by_kernel(K, gemms, dev, "phase 16 (a)"),
                  {"gemm_k_inner_bwd": hold_products(
                      K, G, rec.seen, dev,
                      "phase 16 (a): the backward products")["gemm"]})
    for i, (p, s) in enumerate(zip(plain["metrics"], sharded["metrics"])):
        print(f"(a) step {i + 1}: loss {float(p[0]):.6f} / "
              f"{float(s[0]):.6f}, grad_norm {float(p[1]):.6f} / "
              f"{float(s[1]):.6f} (unsharded / one-rank mesh); "
              f"{plain['ms'][i]:.1f} / {sharded['ms'][i]:.1f} ms")
    same = {
        "state": all(torch.equal(a, b) for a, b in
                     zip(plain["digests"], sharded["digests"], strict=True)),
        "metrics": all(torch.equal(a, b) for a, b in
                       zip(plain["metrics"], sharded["metrics"])),
        "prefill logits": torch.equal(plain["logits"], sharded["logits"]),
        "decode logits": torch.equal(plain["decode"], sharded["decode"])}
    print(f"(a) one-rank NCCL mesh (FSDP + int8_ef) vs unsharded, bit for "
          f"bit: {same}; {len(plain['digests'])} state leaves; peak "
          f"{sharded['peak']:,} B (unsharded {plain['peak']:,} B)")
    print(f"(a) collectives of one step: {sharded['collectives']}")
    check(all(same.values()), f"phase 16 (a): the one-rank mesh differs "
                              f"from the unsharded path: {same}")
    check(plain["collectives"] == {}, "the unsharded path issued "
                                      f"collectives: {plain['collectives']}")
    res["a"] = {"bitwise": same, "ms": plain["ms"], "mesh_ms": sharded["ms"],
                "peak": sharded["peak"], "plain_peak": plain["peak"],
                "collectives": sharded["collectives"],
                "state_bytes": sharded["state_bytes"],
                "gemm_flops": sharded["gemm_flops"],
                "loss": float(plain["metrics"][0][0]), "max_abs_err": a_err}

    # -- (b) ---------------------------------------------------------------
    ref = {"logits": plain["logits"], "loss": float(plain["metrics"][0][0])}
    del plain, sharded
    port = free_port()
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        mesh_rank, args=(port, out_dir, ref, dev), nprocs=2, join=False,
        start_method="spawn")
    end = time.monotonic() + MESH_RANK_DEADLINE
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            check(time.monotonic() < end, f"phase 16 (b): the two ranks "
                  f"passed their {MESH_RANK_DEADLINE:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"phase16_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"(b) two gloo ranks on cuda:0, a (1, 2) mesh, "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    print(f"(b) gloo on CUDA tensors: {ranks[0]['gloo_cuda']}")
    for r in ranks:
        print(f"  rank {r['rank']}: prefill logits "
              f"{r['logits_rel_l2']:.4g} relative L2 of (a)'s (bound "
              f"{BF16_LOGITS_RTOL}); step 1 loss {r['loss']:.6f} vs "
              f"{ref['loss']:.6f} ({r['loss_rel']:.3g} relative, bound "
              f"{MESH_LOSS_RTOL}); steps "
              f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms; peak "
              f"{r['peak']:,} B; f32 {F32_STEP['layers']}-layer gradients: "
              f"worst leaf {r['f32_worst_leaf']} at {r['f32_worst']:.3g} "
              f"(bound {F32_STEP_REL_L2:g}); GEMM launches {r['launches']} "
              f"by route {r['routes']} (backward {r['backward']})")
        print(f"  rank {r['rank']} collectives of one step: "
              f"{r['collectives']}")
        print(f"  rank {r['rank']}: its products held against their plain "
              f"versions at its shapes, max |err| {r['max_abs_err']}")
        check(r["logits_rel_l2"] <= BF16_LOGITS_RTOL,
              f"phase 16 (b) rank {r['rank']}: logits at "
              f"{r['logits_rel_l2']:.4g} relative L2")
        check(r["loss_rel"] <= MESH_LOSS_RTOL,
              f"phase 16 (b) rank {r['rank']}: loss {r['loss']} vs "
              f"{ref['loss']}")
        check(r["f32_worst"] <= F32_STEP_REL_L2,
              f"phase 16 (b) rank {r['rank']}: f32 gradient "
              f"{r['f32_worst_leaf']} at {r['f32_worst']:.3g}")
        check(r["routes"]["cuda_cores"] == 0 and r["routes"]["wgmma"] > 0,
              f"phase 16 (b) rank {r['rank']}: GEMM routes {r['routes']}")
        ep = r["ep"]
        worst = max(ep["grad_rel_l2"], key=ep["grad_rel_l2"].get)
        print(f"  rank {r['rank']} (c) expert parallelism, granite's MoE "
              f"block at full width: y {ep['y_rel_l2']:.3g} relative L2 of "
              f"apply_moe's, worst gradient {worst} "
              f"{ep['grad_rel_l2'][worst]:.3g} (bound {MESH_EP['rel_l2']}); "
              f"grouped launches {ep['grouped_launches']} by route "
              f"{ep['grouped_routes']} (backward {ep['grouped_backward']}); "
              f"collectives {ep['collectives']}")
        check(ep["y_rel_l2"] <= MESH_EP["rel_l2"]
              and ep["grad_rel_l2"][worst] <= MESH_EP["rel_l2"],
              f"phase 16 (c) rank {r['rank']}: EP output "
              f"{ep['y_rel_l2']:.3g}, gradient {worst} "
              f"{ep['grad_rel_l2'][worst]:.3g} relative L2")
        check(ep["grouped_launches"] > 0 and ep["grouped_routes"] == {
            "wgmma": ep["grouped_launches"], "cuda_cores": 0},
              f"phase 16 (c) rank {r['rank']}: grouped launches "
              f"{ep['grouped_launches']} by route {ep['grouped_routes']}")
        check(ep["collectives"].get("all_to_all over model", {})
              .get("calls") == 4, f"phase 16 (c) rank {r['rank']}: "
              f"collectives {ep['collectives']}: not two all-to-alls each "
              f"way")
    res["b"] = ranks
    # the phase's bf16 launches by kernel, forward and backward, for the
    # kernels line, and the largest errors of the products held at the
    # shapes, tiles and layouts the phase ran them at
    bwd = {k: a_backward[k] + sum(r["backward"][k] for r in ranks)
           for k in K.LAUNCHES}
    total = {k: a_launches[k] + sum(r["launches"][k] for r in ranks)
             for k in K.LAUNCHES}
    res["launches"] = {"forward": {k: total[k] - bwd[k] for k in total},
                       "backward": bwd}
    g_bwd = sum(r["ep"]["grouped_backward"] for r in ranks)
    res["launches"]["grouped"] = {
        "forward": sum(r["ep"]["grouped_launches"] for r in ranks) - g_bwd,
        "backward": g_bwd}
    res["max_abs_err"] = max_errors(a_err, *(r["max_abs_err"] for r in ranks))
    print(f"phase 16 bf16 GEMM launches: {res['launches']}")
    print(f"phase 16: every product held at the shapes it ran at, max |err| "
          f"by kernel {res['max_abs_err']} ((a) {a_err}; "
          + "; ".join(f"rank {r['rank']} {r['max_abs_err']}" for r in ranks)
          + ")")
    print(smi("name,power.limit"))
    return res


def gloo_cuda_probe():
    """Which collectives this build's gloo takes on CUDA tensors: each is
    tried once on the world group ("ok" or the error's first line).  Every
    rank raises alike on an op gloo refuses, before any exchange.  Not
    tried: a send or receive, which aborts the process (gloo's TCP pair
    writes from the device pointer: "writev ... Bad address", seen with
    torch 2.11.0+cu128)."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    x = torch.arange(4.0, device="cuda")
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(4 // world, device="cuda"), list(x.chunk(world))),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x)}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as err:
            out[name] = str(err).strip().splitlines()[0][:160]
    return out


def mesh_rank(rank, port, out_dir, ref, dev):
    """Phase 16 (b), one of two ranks sharing cuda:0 through gloo (NCCL
    refuses two ranks on one device): a (1, 2) mesh, tensor parallelism
    only.  Qwen2-1.5B at full width from (a)'s seed: the prefill's logits
    (gathered over the vocabulary shards) and the first of two steps'
    loss against (a)'s unsharded results, then an f32 two-layer model's
    gradients against the unsharded ones on this rank.  Writes
    ``phase16_rank<rank>.json`` to ``out_dir``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        res = {"rank": rank, "gloo_cuda": gloo_cuda_probe()}
        res.update(mesh_rank_run(ref, dev))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"phase16_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def mesh_rank_run(ref, dev):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (ParallelConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.data import make_batch
    from repro_torch.gemm import autograd as GA
    from repro_torch.interop import _flatten
    from repro_torch.kernels import gemm as K
    from repro_torch.kernels import grouped_gemm as G
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import HOST_MESH
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.train_lib import (init_train_state,
                                               make_train_step)

    cfg = get_config("qwen2-1.5b")
    batch = {k: v.to(dev) for k, v in make_batch(
        cfg, ShapeConfig("t", "train", MESH_RUN["seq"], MESH_RUN["batch"]),
        0, seed=MESH_RUN["seed"]).items()}
    mesh = make_host_mesh(1, 2, "cuda")
    out = {}
    rec = Products(K, G, GA).install()
    gemms, unrecord = record_gemms(K)
    try:
        with sh.use_mesh(mesh):
            lm = LM(cfg, sh.mesh_info(mesh), device=dev)
            tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
            pcfg = ParallelConfig()
            params, _, opt, _ = init_train_state(
                lm, tcfg, torch.Generator(dev).manual_seed(MESH_RUN["seed"]),
                pcfg)
            with torch.no_grad():
                logits, _ = lm.prefill(params, {"tokens": batch["tokens"]})
            out["logits_rel_l2"] = float(rel_l2(logits.float(),
                                                ref["logits"].to(dev)))
            step = make_train_step(lm, tcfg, pcfg)
            torch.cuda.reset_peak_memory_stats()
            out["step_ms"] = []
            for i in range(MESH_RUN["steps"]):
                sh.reset_collective_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    out["loss"] = float(m["loss"])
            out["peak"] = torch.cuda.max_memory_allocated()
            out["collectives"] = sh.collective_counts()
            out["loss_rel"] = abs(out["loss"] - ref["loss"]) / abs(
                ref["loss"])
            del params, opt, step, lm, m
            torch.cuda.empty_cache()
    finally:
        unrecord()
        rec.restore()
    out["launches"], out["routes"] = dict(K.LAUNCHES), dict(K.ROUTES)
    out["backward"] = dict(rec.backward)
    bwd_products = set(rec.seen)

    # f32, two layers: the sharded gradients against the unsharded ones
    fcfg = dataclasses.replace(cfg, n_layers=F32_STEP["layers"],
                               block_pattern=cfg.block_pattern[
                                   :F32_STEP["layers"]],
                               compute_dtype="float32")
    fbatch = {k: v.to(dev) for k, v in make_batch(
        fcfg, ShapeConfig("t", "train", F32_STEP["seq"], F32_STEP["batch"]),
        0, seed=7).items()}
    grads = {}
    gemms_f32, unrecord = record_gemms(K)
    for name, minfo in (("plain", HOST_MESH), ("mesh", sh.mesh_info(mesh))):
        with sh.use_mesh(mesh if name == "mesh" else None):
            lm = LM(fcfg, minfo, device=dev)
            lm.init(torch.Generator(dev).manual_seed(7))
            lm.train_mode()
            values = lm.shard() if name == "mesh" else lm.values()
            loss, _ = lm.loss_fn(values, fbatch)
            leaves = _flatten(values)
            grads[name] = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            specs = dict(_flatten(lm.specs()))
            del lm, values, loss
    unrecord()
    worst, worst_path = 0.0, None
    with sh.use_mesh(mesh):
        for path, g in grads["mesh"].items():
            want = sh.shard_tensor(grads["plain"][path], specs[path])
            rel = float(rel_l2(g, want))
            if rel >= worst:
                worst, worst_path = rel, path
    out["f32_worst"], out["f32_worst_leaf"] = worst, str(worst_path)
    out["ep"] = mesh_rank_ep(mesh, dev)
    # every product this rank ran, held at its shape, tile and layout
    # (after the launch counts were taken)
    where = f"phase 16 (b) rank {dist.get_rank()}"
    out["max_abs_err"] = max_errors(
        hold_gemms_by_kernel(K, gemms | gemms_f32, dev, where),
        {"gemm_k_inner_bwd": hold_products(
            K, G, bwd_products, dev, f"{where}: the backward products")[
                "gemm"]},
        {"grouped_gemm": out["ep"].pop("grouped_err"),
         "grouped_gemm_bwd": out["ep"].pop("grouped_bwd_err")})
    return out


def mesh_rank_ep(mesh, dev):
    """Phase 16 (c) on one of (b)'s ranks: granite-moe-3b-a800m's MoE
    block at full width (40 experts top-8, expert d_ff 512), bf16, 4 x 256
    tokens, capacity factor 64 (no token drops on either path): the
    expert-parallel branch (each rank 20 experts, two all-to-alls, the
    local experts on the grouped kernel) against ``apply_moe`` on the
    whole block, forward and the gradients of sum(y^2) with respect to
    the input and every parameter."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.gemm import autograd as GA
    from repro_torch.kernels import gemm as K
    from repro_torch.kernels import grouped_gemm as G
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as sh

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              capacity_factor=MESH_EP["capacity_factor"])
    gen = torch.Generator(dev).manual_seed(MESH_RUN["seed"])
    full = moe.init_moe(gen, cfg, sh.mesh_info(mesh), torch.bfloat16, dev)
    x = torch.randn((MESH_RUN["batch"], MESH_RUN["seq"], cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    res = {}
    G.reset_launch_counts()
    rec = Products(K, G, GA).install()
    try:
        grads = {}
        for name in ("plain", "ep"):
            with sh.use_mesh(mesh if name == "ep" else None):
                minfo = sh.mesh_info(mesh)
                specs = moe.moe_specs(cfg, minfo)
                p = {k: sh.shard_tensor(v, specs[k]).requires_grad_(True)
                     for k, v in full.items()}
                xin = x.clone().requires_grad_(True)
                if name == "ep":
                    sh.reset_collective_counts()
                    y, _ = moe.apply_moe_ep(p, xin, cfg, minfo)
                else:
                    y, _ = moe.apply_moe(p, xin, cfg, None)
                g = torch.autograd.grad(y.float().square().sum(),
                                        [xin] + list(p.values()))
                if name == "ep":
                    res["collectives"] = sh.collective_counts()
                grads[name] = (y.detach(), dict(zip(["x"] + list(p), g)))
        specs["x"] = (None, None, None)
        with sh.use_mesh(mesh):
            res["y_rel_l2"] = float(rel_l2(grads["ep"][0].float(),
                                           grads["plain"][0].float()))
            res["grad_rel_l2"] = {
                k: float(rel_l2(g.float(), sh.shard_tensor(
                    grads["plain"][1][k], specs[k]).float()))
                for k, g in grads["ep"][1].items()}
    finally:
        rec.restore()
    res["grouped_launches"] = G.LAUNCHES["grouped_gemm"]
    res["grouped_routes"] = dict(G.ROUTES)
    res["grouped_backward"] = rec.backward["grouped_gemm"]
    # both paths' grouped products at the shapes and layouts they ran
    # (the expert-parallel ones: the local experts, (M_src, B) folded into
    # C), held against the plain version
    where = f"phase 16 (c) rank {dist.get_rank()}"
    res["grouped_err"] = hold_products(
        K, G, {p for p in rec.forward_seen if p[0] == "grouped"}, dev,
        f"{where}: the forward grouped products")["grouped"]
    res["grouped_bwd_err"] = hold_products(
        K, G, {p for p in rec.seen if p[0] == "grouped"}, dev,
        f"{where}: the backward grouped products")["grouped"]
    return res


#: phase 16 (d): zamba2-1.2b's long_500k decode at full width in f32, the
#: KV caches' sequence axis split over two data ranks (``serve_plan``'s
#: branch for a batch of 1): decode steps at the two sides of the ranks'
#: boundary (at 262,143 rank 1 holds no visible key) and at the last
#: position, from a cache seeded at every position (no 500k prefill)
LONG_RUN = dict(arch="zamba2-1.2b", max_len=524288,
                positions=(262143, 262144, 524287), token=11, seed=26,
                chunk=8192)
#: (d): seconds the two ranks may take (each builds zamba2, fills 25.8 GB
#: of cache and decodes)
LONG_RANK_DEADLINE = 600.0


def long_config():
    """zamba2-1.2b at full width with f32 compute and KV cache (phase
    11's f32: its bf16 logits of 38 random layers are chaotic)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LONG_RUN["arch"]),
                               compute_dtype="float32",
                               kv_cache_dtype="float32")


def fill_long_cache(caches, specs):
    """Seeds every leaf of ``caches`` (this rank's shards under ``specs``
    on the ambient mesh; the whole tree without one): each attention
    site's K and V chunk by chunk of ``LONG_RUN["chunk"]`` positions, each
    chunk from a generator of its own, so that a rank holding positions
    [r S/n, (r+1) S/n) draws there what one process drawing them all
    does; the Mamba2 states and conv tails whole (replicated), at 0.1."""
    import zlib
    import torch
    from repro_torch.models.common import tree_paths
    from repro_torch.runtime import sharding as sh

    spec_of = dict(tree_paths(specs))
    chunk = LONG_RUN["chunk"]
    for path, t in tree_paths(caches):
        base = zlib.crc32("/".join(map(str, path)).encode()) * 1000 \
            + LONG_RUN["seed"]
        if path[-1] not in ("k", "v"):
            gen = torch.Generator(t.device).manual_seed(base)
            t.copy_(0.1 * torch.randn(t.shape, generator=gen,
                                      device=t.device))
            continue
        first = sh.axis_index(spec_of[path][1]) * t.shape[1]
        for g0 in range(first, first + t.shape[1], chunk):
            gen = torch.Generator(t.device).manual_seed(base + g0 // chunk)
            t[:, g0 - first:g0 - first + chunk] = torch.randn(
                (t.shape[0], chunk) + tuple(t.shape[2:]), generator=gen,
                device=t.device)


def long_decode_run(minfo, dev, seq_shard):
    """LONG_RUN's greedy decode steps of ``long_config()`` under
    ``minfo`` (the ambient mesh, if any, installed by the caller): the
    weights from LONG_RUN's seed, the cache seeded
    (:func:`fill_long_cache`), sequence-sharded with ``seq_shard``.
    Returns each step's logits (on the host) and token, ms per step, the
    peak memory, the collectives and the GEMM launches by kernel and by
    route."""
    import torch
    from repro_torch.kernels import gemm as K
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.serve_lib import make_decode_step

    lm = LM(long_config(), minfo, device=dev)
    lm.init(torch.Generator(dev).manual_seed(LONG_RUN["seed"]),
            shard=sh.ambient_mesh() is not None)
    params = lm.compute_params()
    flags = dict(seq_shard=seq_shard, batch_shard=not seq_shard)
    caches = lm.init_cache(1, LONG_RUN["max_len"], **flags)
    fill_long_cache(caches, lm.cache_specs(**flags))
    decode = make_decode_step(lm, seq_shard=seq_shard)
    out = {"logits": [], "tokens": [], "ms": [],
           "cache_bytes": tree_bytes(caches)}
    tok = LONG_RUN["token"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sh.reset_collective_counts()
    launches, routes = dict(K.LAUNCHES), dict(K.ROUTES)
    with torch.no_grad():
        for pos in LONG_RUN["positions"]:
            t0 = time.perf_counter()
            nxt, logits, caches = decode(params, caches, torch.tensor(
                [[tok]], device=dev), pos)
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["logits"].append(logits[0].cpu())
            tok = int(nxt[0, 0])
            out["tokens"].append(tok)
    out["launches"] = {k: K.LAUNCHES[k] - launches[k] for k in K.LAUNCHES}
    out["routes"] = {r: K.ROUTES[r] - routes[r] for r in K.ROUTES}
    out["collectives"] = sh.collective_counts()
    out["peak"] = torch.cuda.max_memory_allocated()
    del lm, params, caches, decode
    torch.cuda.empty_cache()
    return out


def long_decode_phase(K, dev, out_dir):
    """Phase 16 (d): the sequence-sharded long decode.  The script's own
    process decodes unsharded on the card first (one 51.5 GB f32 cache),
    frees it, then two gloo ranks sharing cuda:0 decode on a (2, 1) mesh
    with the cache's sequence axis over data (:func:`long_rank`), each
    held to the unsharded logits (``F32_LOGITS_RTOL`` relative L2, the
    same greedy tokens).  Every GEMM launch of both runs is held against
    its plain version at its shape and tile.  Returns the results, the
    launches by kernel and the largest errors."""
    import torch
    from repro_torch.models.common import HOST_MESH

    phase("16 (d)", "zamba2-1.2b long_500k at full width in f32: the "
                    "sequence-sharded decode on two gloo ranks against one "
                    "card")
    print(smi("name,power.limit"))
    before = snapshot(K)
    gemms, unrecord = record_gemms(K)
    t0 = time.perf_counter()
    try:
        ref = long_decode_run(HOST_MESH, dev, seq_shard=False)
    finally:
        unrecord()
    route_check(K, "phase 16 (d)'s unsharded decode", "f32", before)
    print(f"(d) unsharded, one card: {len(LONG_RUN['positions'])} decode "
          f"steps at {LONG_RUN['positions']} of {LONG_RUN['max_len']:,}: "
          f"{', '.join(f'{t:.1f}' for t in ref['ms'])} ms; tokens "
          f"{ref['tokens']}; cache {ref['cache_bytes']:,} B, peak "
          f"{ref['peak']:,} B ({time.perf_counter() - t0:.1f} s with the "
          f"build and the fill)")
    port = free_port()
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        long_rank, args=(port, out_dir, {"logits": ref["logits"],
                                         "tokens": ref["tokens"]}, dev),
        nprocs=2, join=False, start_method="spawn")
    end = time.monotonic() + LONG_RANK_DEADLINE
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            check(time.monotonic() < end, f"phase 16 (d): the two ranks "
                  f"passed their {LONG_RANK_DEADLINE:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"phase16d_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"(d) two gloo ranks on cuda:0, a (2, 1) mesh, the KV caches' "
          f"sequence axis over data, {time.perf_counter() - t0:.1f} s with "
          f"the spawn")
    sites = long_config().block_pattern.count("shared_attn")
    for r in ranks:
        worst = max(r["logits_rel_l2"])
        calls = r["collectives"].get("all_reduce over data", {}).get(
            "calls", 0)
        print(f"  rank {r['rank']}: logits {r['logits_rel_l2']} relative "
              f"L2 of the unsharded run's (bound {F32_LOGITS_RTOL}), all "
              f"finite {r['finite']}; tokens {r['tokens']}; steps "
              f"{', '.join(f'{t:.1f}' for t in r['ms'])} ms; cache "
              f"{r['cache_bytes']:,} B, peak {r['peak']:,} B; GEMM launches "
              f"{r['launches']} by route {r['routes']}")
        print(f"  rank {r['rank']} collectives of the {len(r['ms'])} "
              f"steps: {r['collectives']}")
        print(f"  rank {r['rank']}: its GEMMs held against their plain "
              f"versions at its shapes and tiles, max |err| "
              f"{r['max_abs_err']}")
        check(r["finite"] and worst <= F32_LOGITS_RTOL,
              f"phase 16 (d) rank {r['rank']}: logits {r['logits_rel_l2']} "
              f"relative L2 (finite: {r['finite']})")
        check(r["tokens"] == ref["tokens"], f"phase 16 (d) rank "
              f"{r['rank']}: tokens {r['tokens']}, unsharded {ref['tokens']}")
        check(r["routes"]["wgmma"] == 0 and r["routes"]["cuda_cores"] > 0
              and r["routes"]["cuda_cores"] == sum(r["launches"].values()),
              f"phase 16 (d) rank {r['rank']}: f32 GEMM launches "
              f"{r['launches']} by route {r['routes']}")
        check(calls == 3 * sites * len(LONG_RUN["positions"]),
              f"phase 16 (d) rank {r['rank']}: {calls} all-reduces over "
              f"data, not 3 a step at each of the {sites} attention sites")
    err = max_errors(hold_gemms_by_kernel(K, gemms, dev,
                                          "phase 16 (d), unsharded"),
                     *(r["max_abs_err"] for r in ranks))
    launches = {k: ref["launches"][k] + sum(r["launches"][k] for r in ranks)
                for k in K.LAUNCHES}
    print(f"phase 16 (d) f32 GEMM launches: {launches}; every product held "
          f"at the shapes it ran at, max |err| by kernel {err}")
    print(smi("name,power.limit"))
    return {"unsharded": {k: v for k, v in ref.items() if k != "logits"},
            "ranks": ranks, "launches": launches, "max_abs_err": err}


def long_rank(rank, port, out_dir, ref, dev):
    """Phase 16 (d), one of two ranks sharing cuda:0 through gloo: the
    sequence-sharded decode (:func:`long_decode_run`) held to the
    unsharded run's logits and tokens ``ref``, and its GEMMs to their
    plain versions.  Writes ``phase16d_rank<rank>.json`` to ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import gemm as K
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding as sh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_host_mesh(2, 1, "cuda")
        gemms, unrecord = record_gemms(K)
        try:
            with sh.use_mesh(mesh):
                res = long_decode_run(sh.mesh_info(mesh), dev,
                                      seq_shard=True)
        finally:
            unrecord()
        logits = res.pop("logits")
        res.update(rank=rank, finite=all(bool(torch.isfinite(x).all())
                                         for x in logits),
                   logits_rel_l2=[rel_l2(x, w) for x, w in
                                  zip(logits, ref["logits"])],
                   max_abs_err=hold_gemms_by_kernel(
                       K, gemms, dev, f"phase 16 (d) rank {rank}"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"phase16d_rank{rank}.json"), "w") as f:
        json.dump(res, f)


#: phase 17: seconds the dry-run child may take
DRYRUN_DEADLINE = 600.0


def dryrun_phase(meshes, out_dir):
    """Phase 17: the dry run (``launch/dryrun.py``) on the card's machine,
    in a child process (:func:`dryrun_child`: its fake default group
    cannot live beside phase 16's groups).  (i) Phase 16 (a)'s cell,
    Qwen2-1.5B on one rank, FSDP + int8_ef, 4 x 256 tokens: its
    collectives by op and axis must equal, in calls and bytes, those (a)
    measured in a step, and its argument bytes (a)'s state and batch;
    its flops are printed beside the 2 m n k of the GEMMs (a)'s step
    launched, its roofline bound beside (a)'s step time.  (ii)
    ``probe_cell("qwen2-1.5b", "train_4k")`` on the 16x16 mesh and
    zamba2-1.2b's long_500k cell on 2x16x16, printed with their seconds."""
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.roofline import from_record
    from repro_torch.launch.roofline_probe import model_flops

    phase(17, "the dry run on fake ranks (child process), beside phase 16 "
              "(a)'s measured step")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        dryrun_child, args=(out_dir,), nprocs=1, join=False,
        start_method="spawn")
    end = time.monotonic() + DRYRUN_DEADLINE
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            check(time.monotonic() < end, f"phase 17: the dry run passed "
                  f"its {DRYRUN_DEADLINE:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    with open(os.path.join(out_dir, "phase17.json")) as f:
        res = json.load(f)
    print(f"phase 17's child: {time.perf_counter() - t0:.1f} s with the "
          f"spawn")
    cell, a = res["cell"], meshes["a"]
    shape = ShapeConfig(**res["shape"])
    qwen = get_config("qwen2-1.5b")
    batch = sum(t.numel() * t.element_size()
                for t in input_specs(qwen, shape).values())
    print(f"(i) {cell['arch']} {cell['mesh']} FSDP + int8_ef, "
          f"{shape.global_batch} x {shape.seq_len} tokens, "
          f"{cell['compile_seconds']} s: collectives {cell['collectives']}")
    print(f"(i) phase 16 (a) measured: {a['collectives']}")
    print(f"(i) argument bytes {cell['argument_size_in_bytes']:,} (dry run) "
          f"vs {a['state_bytes'] + batch:,} ((a)'s state {a['state_bytes']:,}"
          f" + the batch's {batch:,})")
    rep = from_record(cell, model_flops(qwen, shape))
    print(f"(i) flops {cell['flops']:.6g} (dry run, every matrix product) "
          f"vs {a['gemm_flops']:.6g} (2 m n k of (a)'s GEMM launches in a "
          f"step), ratio {cell['flops'] / max(a['gemm_flops'], 1):.4f}; bytes "
          f"{cell['bytes_accessed']:.6g}; roofline bound "
          f"{1e3 * rep.step_time:.4f} ms ({rep.dominant}; compute "
          f"{1e3 * rep.t_compute:.4f}, memory {1e3 * rep.t_memory:.4f}, "
          f"collective {1e3 * rep.t_collective:.4f}) vs (a)'s one-rank mesh "
          f"steps {', '.join(f'{t:.1f}' for t in a['mesh_ms'])} ms")
    check(cell["collectives"] == a["collectives"], "phase 17 (i): the dry "
          "run's collectives differ from phase 16 (a)'s measured ones")
    check(cell["argument_size_in_bytes"] == a["state_bytes"] + batch,
          "phase 17 (i): the dry run's argument bytes differ from (a)'s "
          "state and batch")
    probe, long_ = res["probe"], res["long"]
    print(f"(ii) probe_cell(qwen2-1.5b, train_4k) on {probe['mesh']}, "
          f"{res['probe_s']:.1f} s: {json.dumps(probe)}")
    print(f"(ii) run_cell(zamba2-1.2b, long_500k, multi_pod=True), "
          f"{res['long_s']:.1f} s: "
          f"{json.dumps({k: v for k, v in long_.items() if k != 'collectives'})}"
          f"; collectives {long_['collectives']}")
    return res


def dryrun_child(_, out_dir):
    """Phase 17's child: the dry-run cells, written to ``phase17.json``
    under ``out_dir``.  Imports no CUDA path: the dry run's tensors are
    fake CPU tensors."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.launch import dryrun, roofline_probe

    shape = ShapeConfig("train_4k", "train", MESH_RUN["seq"],
                        MESH_RUN["batch"])
    res = {"shape": dataclasses.asdict(shape)}
    res["cell"] = dryrun.run_cell(
        "qwen2-1.5b", "train_4k", False,
        pcfg=ParallelConfig(**MESH_PARALLEL), shape=shape,
        mesh_shape=(1, 1))
    t0 = time.perf_counter()
    res["probe"] = roofline_probe.probe_cell("qwen2-1.5b", "train_4k")
    res["probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["long"] = dryrun.run_cell("zamba2-1.2b", "long_500k", True)
    res["long_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "phase17.json"), "w") as f:
        json.dump(res, f)


#: phase 18 (a): the drivers outside the package, each run in-process as
#: its command line runs it.  autotune_explore at Qwen2-1.5B's down
#: projection at full width; train_e2e's 70-step command stopped by
#: SIGTERM after step ``kill_at`` (its emergency checkpoint) and run again,
#: against the same command run whole: a 60-step command would take
#: another learning-rate schedule (warmup and cosine over ``--steps``)
DRIVERS_RUN = dict(autotune=("--m", "4096", "--n", "1536", "--k", "8960"),
                   train_steps=70, kill_at=60,
                   serve_archs=(None, "granite-moe-3b-a800m"))
#: phase 18 (b): kimi-k2-1t-a32b at full width cut to two of its 61
#: blocks, and the slack its peak may take over its shards and one leaf
KIMI_INIT = dict(layers=2, slack=256 * 2**20)
#: phase 18 (c): zamba2-1.2b's smoke config with one Mamba2 head of 128
#: channels (a cut of the width: no zamba2-1.2b mesh with a model axis
#: under 128 reaches the branch at full width), in f32, on two gloo ranks.
#: A leaf's gradient on the ranks lies within ``grad_rel_l2`` of one
#: card's.  The head-wise leaves (``HEADWISE``: one element a block here)
#: are sums that cancel, and two f32 orders of them differ by about one f32
#: run's own error (on an H100 one card's A_log lies 1.55e-4 from float64):
#: they lie no more than ``grad_rel_l2`` further from the float64 gradient
#: than one card's does, and within ``headwise_cap`` of one card's
MAMBA_RUN = dict(ssm_head_dim=128, batch=2, seq=24, steps=3, seed=18,
                 grad_rel_l2=1e-4, headwise_cap=3e-4, logits_rel_l2=1e-5)
HEADWISE = ("dt_bias", "A_log", "Dskip")
#: phase 18: seconds each child (the init's, the two ranks') may take
LAST_DEADLINE = 600.0


class Tee:
    """A stdout that also keeps what is written to it."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def run_driver(name, argv):
    """``python <name> <argv>`` in this process (``runpy``, as
    ``__main__``); returns what it printed.  A non-zero exit fails the
    phase."""
    import contextlib
    import runpy

    path = os.path.join(HERE, name)
    old, tee = sys.argv, Tee(sys.stdout)
    sys.argv = [path, *argv]
    print(f"-- python {name} {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        check(e.code in (None, 0), f"phase 18 (a): {name} exited with "
                                   f"{e.code}")
    finally:
        sys.argv = old
    print(f"-- {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return tee.text()


def record_grouped(G):
    """Wraps ``G.grouped_gemm`` to record every (x shape, w shape, dtype
    tag, layout) it runs, as :func:`record_gemms` does for the GEMM."""
    import collections
    seen = collections.Counter()
    inner = G.grouped_gemm

    def grouped_gemm(x, w, *, tile=None):
        seen[(tuple(x.shape), tuple(w.shape), G._tag(x.dtype),
              G.layout(x, w))] += 1
        return inner(x, w, tile=tile)

    def restore():
        G.grouped_gemm = inner

    G.grouped_gemm = grouped_gemm
    return seen, restore


def hold_grouped(G, seen, dev, label):
    """Each grouped product :func:`record_grouped` saw, at its shapes and
    layout, against its plain version on seeded operands (w at a
    weight's init scale).  Returns the largest error."""
    import torch

    err = 0.0
    for i, (sx, sw, tag, layout) in enumerate(sorted(seen)):
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
        g = torch.Generator(dev).manual_seed(5000 + i)
        x = torch.randn(sx, generator=g, device=dev).to(dt)
        w = (torch.randn(sw, generator=g, device=dev) * sw[-2] ** -0.5
             ).to(dt)
        x, w = in_layout(x, w, layout)
        err = max(err, compare("grouped_gemm", tag, G.grouped_gemm(x, w),
                               G.grouped_gemm_plain(x, w),
                               where=f" ({sx} @ {sw}, "
                                     f"{LAYOUT_NAMES[layout]}, {label})"))
    print(f"{label}: the {len(seen)} grouped products it ran match their "
          f"plain versions (max |err| {err})")
    return err


def launch_counts(K, G, rec):
    """(GEMM launches by kernel, GEMM routes, grouped launches, grouped
    routes, backward launches by kernel) so far."""
    return (dict(K.LAUNCHES), dict(K.ROUTES), dict(G.LAUNCHES),
            dict(G.ROUTES), dict(rec.backward))


def launches_since(K, G, rec, before):
    """:func:`launch_counts` since ``before``, each as a dict of
    differences."""
    return [{k: now[k] - then[k] for k in now}
            for now, then in zip(launch_counts(K, G, rec), before)]


def drivers_phase(K, G, dev, out_dir):
    """Phase 18 (a): the torch drivers outside the package
    (``examples/*_torch.py``), each run in-process with its command line.
    Each must launch its kernels on their routes: every GEMM on wgmma
    (bf16), the backward products where it trains, the grouped kernel on
    wgmma where it serves granite.  train_e2e's resumed run must give the
    whole run's losses and parameters bit for bit.  Every GEMM and grouped
    product the drivers ran is then held against its plain version at its
    shape, tile and layout.  Returns the launches and the errors."""
    import signal

    import torch
    import repro_torch.launch.train as launch_train
    from repro_torch.gemm import autograd as GA
    from repro_torch.models.common import tree_leaves

    phase("18 (a)", "the drivers outside the package: examples/*_torch.py "
                    "in-process")
    print(smi("name,power.limit"))
    res = {}
    rec = Products(K, G, GA).install()
    gemms, unrecord = record_gemms(K)
    grouped, unrecord_grouped = record_grouped(G)
    trained = []
    inner_train, inner_step = launch_train.train, launch_train.make_train_step
    sigterm = signal.getsignal(signal.SIGTERM)

    def recording(*args, **kwargs):
        trained.append(inner_train(*args, **kwargs))
        return trained[-1]

    def stopped(*args, **kwargs):
        step, done = inner_step(*args, **kwargs), [0]

        def once(*a, **kw):
            out = step(*a, **kw)
            done[0] += 1
            if done[0] == DRIVERS_RUN["kill_at"]:
                signal.raise_signal(signal.SIGTERM)
            return out
        return once

    def run(label, name, argv, *, backward=False, grouped_on=False):
        before = launch_counts(K, G, rec)
        text = run_driver(name, argv)
        gl, gr, pl, pr, bw = launches_since(K, G, rec, before)
        n = sum(gl.values())
        print(f"{label}: GEMM launches {gl} by route {gr}, backward {bw}; "
              f"grouped {pl['grouped_gemm']} by route {pr}")
        check(n > 0 and gr == {"wgmma": n, "cuda_cores": 0}
              and gl["gemm_k_inner"] > 0,
              f"phase 18 (a) {label}: GEMM launches {gl} by route {gr}")
        check(not backward or bw["gemm_k_inner"] > 0,
              f"phase 18 (a) {label}: no backward product launched: {bw}")
        if grouped_on:
            p = pl["grouped_gemm"]
            check(p > 0 and pr == {"wgmma": p, "cuda_cores": 0},
                  f"phase 18 (a) {label}: grouped launches {p} by route "
                  f"{pr}")
        res[label] = {"gemm": gl, "routes": gr, "backward": bw,
                      "grouped": pl["grouped_gemm"], "grouped_routes": pr}
        return text

    t0 = time.perf_counter()
    try:
        text = run("autotune_explore", "examples/autotune_explore_torch.py",
                   list(DRIVERS_RUN["autotune"]))
        m = re.search(r"kernel vs plain max\|err\| = (\S+) on (\S+) bf16 at "
                      r"(\S+) ", text)
        check(m is not None, "phase 18 (a): autotune_explore printed no "
                             "kernel-vs-plain line")
        res["autotune_explore"].update(max_abs_err=float(m.group(1)),
                                       shape=m.group(2), tile=m.group(3))
        text = run("quickstart", "examples/quickstart_torch.py", [],
                   backward=True)
        check(re.search(r"execute\(ones, halves\)\[0,0\] = 128\.0 \(expect "
                        r"128\.0\) on cuda", text) is not None,
              "phase 18 (a): quickstart's 2b did not give 128.0 on the card")
        for arch in DRIVERS_RUN["serve_archs"]:
            argv = [] if arch is None else ["--arch", arch]
            text = run(f"serve_batch {arch or 'default'}",
                       "examples/serve_batch_torch.py", argv,
                       grouped_on=arch is not None)
            check(re.search(r"^served \d+ requests", text, re.M) is not None,
                  f"phase 18 (a): serve_batch {argv} served nothing")
        launch_train.train = recording
        ckpt = os.path.join(out_dir, "train_e2e")
        steps = ["--steps", str(DRIVERS_RUN["train_steps"])]
        run("train_e2e whole", "examples/train_e2e_torch.py",
            steps + ["--ckpt-dir", os.path.join(ckpt, "whole")],
            backward=True)
        launch_train.make_train_step = stopped
        text = run("train_e2e stopped", "examples/train_e2e_torch.py",
                   steps + ["--ckpt-dir", os.path.join(ckpt, "kill")],
                   backward=True)
        launch_train.make_train_step = inner_step
        check(f"preempted: emergency checkpoint at step "
              f"{DRIVERS_RUN['kill_at']}" in text, "phase 18 (a): the "
              "stopped train_e2e run wrote no emergency checkpoint")
        text = run("train_e2e resumed", "examples/train_e2e_torch.py",
                   steps + ["--ckpt-dir", os.path.join(ckpt, "kill")],
                   backward=True)
        check(f"resumed from step {DRIVERS_RUN['kill_at']}" in text,
              "phase 18 (a): train_e2e did not resume")
    finally:
        launch_train.train, launch_train.make_train_step = (inner_train,
                                                             inner_step)
        signal.signal(signal.SIGTERM, sigterm)
        unrecord_grouped()
        unrecord()
        rec.restore()
    whole, first, second = trained
    same_losses = first["losses"] + second["losses"] == whole["losses"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(whole["params"]), tree_leaves(second["params"]),
        strict=True))
    print(f"(a) train_e2e: {len(whole['losses'])} losses whole, "
          f"{len(first['losses'])} + {len(second['losses'])} stopped and "
          f"resumed; equal bit for bit: losses {same_losses}, parameters "
          f"{same_params}; loss {whole['losses'][0]:.4f} -> "
          f"{whole['losses'][-1]:.4f}")
    check(same_losses and same_params, "phase 18 (a): the resumed "
          "train_e2e run differs from the whole one")
    res["train_e2e"] = {"losses": whole["losses"], "bitwise": True}
    total = {k: sum(r["gemm"][k] for r in res.values() if "gemm" in r)
             for k in K.LAUNCHES}
    bwd = {k: sum(r["backward"][k] for r in res.values() if "backward" in r)
           for k in rec.backward}
    g_total = sum(r.get("grouped", 0) for r in res.values())
    res["launches"] = {"forward": {k: total[k] - bwd[k] for k in total},
                       "backward": {k: bwd[k] for k in total},
                       "grouped": {"forward": g_total
                                   - bwd["grouped_gemm"],
                                   "backward": bwd["grouped_gemm"]}}
    res["seconds"] = time.perf_counter() - t0
    res["max_abs_err"] = max_errors(
        hold_gemms_by_kernel(K, gemms, dev, "phase 18 (a)"),
        {"grouped_gemm": hold_grouped(G, grouped, dev, "phase 18 (a)")})
    print(f"phase 18 (a): {res['seconds']:.1f} s; launches "
          f"{res['launches']}; every product held at its shape, tile and "
          f"layout, max |err| by kernel {res['max_abs_err']}")
    return res


def shard_bytes(values, specs):
    """The bytes of this rank's shards of ``values`` (global shapes)
    under ``specs`` on the ambient mesh."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import sharding as sh

    return sum(v.numel() // math.prod(sh.axis_size(ax) for ax in spec)
               * v.element_size()
               for v, spec in zip(tree_leaves(values), tree_leaves(specs),
                                  strict=True))


def init_phase(out_dir):
    """Phase 18 (b): in a child process (:func:`init_child`, on the dry
    run's fake group), kimi-k2-1t-a32b's ``LM.init(shard=True)`` at full
    width on the card as rank 0 of the 16x16 production mesh, its peak
    memory against its shards plus one leaf (the larger of one expert's
    f32 leaf and the largest non-expert f32 leaf) plus 256 MB, its shard
    bytes against the spec tree's; then granite-moe-3b-a800m's
    ``init(shard=True)`` against ``shard(init())``, bit for bit."""
    import torch

    phase("18 (b)", "kimi-k2-1t-a32b's init cut one leaf at a time, at "
                    "full width on the card (rank 0 of 16x16)")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        init_child, args=(out_dir,), nprocs=1, join=False,
        start_method="spawn")
    end = time.monotonic() + LAST_DEADLINE
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            check(time.monotonic() < end, f"phase 18 (b): the child passed "
                  f"its {LAST_DEADLINE:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    with open(os.path.join(out_dir, "phase18b.json")) as f:
        res = json.load(f)
    k, g = res["kimi"], res["granite"]
    bound = max(k["expert_leaf"], k["other_leaf"])
    limit = k["shard_bytes"] + bound + KIMI_INIT["slack"]
    print(f"(b) kimi-k2-1t-a32b, {k['layers']} of 61 blocks, rank 0 of "
          f"16x16 (FSDP {k['fsdp']}): init {k['seconds']:.2f} s; peak "
          f"{k['peak']:,} B against its shards {k['shard_bytes']:,} B + "
          f"one leaf {bound:,} B (expert f32 {k['expert_leaf']:,}, largest "
          f"other f32 {k['other_leaf']:,}) + {KIMI_INIT['slack']:,} B = "
          f"{limit:,} B; spec tree's shard bytes {k['spec_bytes']:,} B; a "
          f"whole block would be {k['block_bytes']:,} B")
    print(f"(b) granite-moe-3b-a800m, rank 0 of 16x16 ({g['experts']} "
          f"experts a rank of {g['padded']}): init(shard=True) == "
          f"shard(init()) bit for bit: {g['equal']} over {g['leaves']} "
          f"leaves ({g['seconds']:.2f} s)")
    print(f"phase 18 (b)'s child: {time.perf_counter() - t0:.1f} s with "
          f"the spawn")
    check(k["peak"] <= limit, f"phase 18 (b): kimi's init peaked at "
          f"{k['peak']:,} B, over {limit:,} B")
    check(k["shard_bytes"] == k["spec_bytes"], "phase 18 (b): kimi's "
          "shards differ from the spec tree's bytes")
    check(g["equal"] and g["experts"] < g["padded"], "phase 18 (b): "
          "granite's leaf-by-leaf init differs from shard(init())")
    return res


def init_child(_, out_dir):
    """Phase 18 (b)'s child: writes ``phase18b.json`` to ``out_dir``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {}
    full = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(
        full, n_layers=KIMI_INIT["layers"],
        block_pattern=full.block_pattern[:KIMI_INIT["layers"]])
    fsdp = sh.default_parallel(full.name).fsdp
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        minfo = sh.mesh_info(mesh, fsdp=fsdp)
        with torch.device("meta"):
            values = LM(cfg, minfo, device="meta").init(torch.Generator())
        experts = [v for p, v in tree_paths(values)
                   if "moe" in p and p[-1] != "router"]
        others = [v for p, v in tree_paths(values)
                  if not ("moe" in p and p[-1] != "router")]
        lm = LM(cfg, minfo, device=dev)
        with sh.use_mesh(mesh):
            spec = shard_bytes(values, lm.specs())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            shards = lm.init(torch.Generator(dev).manual_seed(0), shard=True)
            torch.cuda.synchronize()
            res["kimi"] = {
                "layers": KIMI_INIT["layers"], "fsdp": fsdp,
                "seconds": time.perf_counter() - t0,
                "peak": torch.cuda.max_memory_allocated() - base,
                "shard_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(shards)),
                "spec_bytes": spec,
                "expert_leaf": max(4 * math.prod(v.shape[1:])
                                   for v in experts),
                "other_leaf": max(4 * v.numel() for v in others),
                "block_bytes": sum(v.numel() * v.element_size()
                                   for p, v in tree_paths(values)
                                   if p[:2] == ("stack", 0))}
        del lm, shards
        torch.cuda.empty_cache()
        cfg = get_config("granite-moe-3b-a800m")
        minfo = sh.mesh_info(mesh)
        with sh.use_mesh(mesh):
            t0 = time.perf_counter()
            cut = LM(cfg, minfo, device=dev).init(
                torch.Generator(dev).manual_seed(1), shard=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            whole = LM(cfg, minfo, device=dev)
            whole.init(torch.Generator(dev).manual_seed(1))
            shards = whole.shard()
            pairs = list(zip(tree_leaves(cut), tree_leaves(shards),
                             strict=True))
            res["granite"] = {
                "equal": all(a.shape == b.shape and torch.equal(a, b)
                             for a, b in pairs),
                "leaves": len(pairs), "seconds": seconds,
                "padded": moe.padded_experts(cfg, minfo),
                "experts": cut["stack"][0]["b0_moe"]["moe"]["w_gate"]
                .shape[0]}
    with open(os.path.join(out_dir, "phase18b.json"), "w") as f:
        json.dump(res, f)


def mamba_config():
    import dataclasses as dc
    from repro_torch.configs import get_config

    return dc.replace(get_config("zamba2-1.2b", smoke=True),
                      ssm_head_dim=MAMBA_RUN["ssm_head_dim"],
                      compute_dtype="float32", kv_cache_dtype="float32")


def mamba_run(lm, params, tokens, fed):
    """A prefill of ``tokens``, ``len(fed)`` decode steps after it (the
    tokens ``fed`` fed in), and the CE loss's gradients: (the prefill's
    logits and each step's, on the host; the gradients by path)."""
    import torch
    from repro_torch.interop import _flatten

    with torch.no_grad():
        logits, pref = lm.prefill(params, {"tokens": tokens})
        caches = lm.init_cache(tokens.shape[0], tokens.shape[1] + len(fed))
        copy_prefix(caches, pref)
        out = [logits.float().cpu()]
        for i, tok in enumerate(fed):
            step, _ = lm.decode_step(params, caches, tok.to(tokens.device),
                                     tokens.shape[1] + i)
            out.append(step.float().cpu())
    _, m = lm.loss_fn(params, {"tokens": tokens, "labels": tokens})
    leaves = _flatten(params)
    grads = torch.autograd.grad(m["ce_loss"], list(leaves.values()))
    return out, dict(zip(leaves, grads))


def float64_grads(lm, params, tokens):
    """The CE loss's gradients of ``lm``'s config at ``params`` in
    float64 on the host (:func:`host_float64`, :class:`float64_products`),
    by path: the reference a leaf's f32 error is read against."""
    import torch
    from repro_torch.interop import _flatten

    lm64 = host_float64(lm, params)
    with float64_products():
        p64 = lm64.train_mode().values()
        toks = tokens.cpu()
        _, m = lm64.loss_fn(p64, {"tokens": toks, "labels": toks})
        leaves = _flatten(p64)
        grads = torch.autograd.grad(m["ce_loss"], list(leaves.values()))
    return {"/".join(map(str, p)): g for p, g in zip(leaves, grads)}


def mamba_phase(K, dev, out_dir):
    """Phase 18 (c): Mamba2 sharded on d_inner alone.  zamba2-1.2b's
    smoke config with one 128-channel head, f32: the script's process
    runs it on one card (a prefill, three greedy decode steps, the CE
    loss's gradients), then two gloo ranks on cuda:0 (:func:`mamba_rank`)
    on a (1, 2) mesh, whose model axis divides d_inner (128) but not the
    one head, run it from their own ``init(shard=True)`` of the same seed:
    logits within 1e-5 relative L2 of one card's, the same greedy tokens,
    each leaf's gradient within 1e-4 relative L2 of one card's, but the
    head-wise leaves (``HEADWISE``), which lie no more than 1e-4 further
    from the float64 gradient (:func:`float64_grads`) than one card's and
    within 3e-4 of one card's.  Every GEMM launch on the CUDA cores, held
    against its plain version."""
    import numpy as np
    import torch
    from repro_torch.models.common import MeshInfo
    from repro_torch.models.model import LM

    phase("18 (c)", "Mamba2 with d_inner sharded and the heads whole: two "
                    "gloo ranks sharing the card against one card, f32")
    cfg = mamba_config()
    print(f"(c) {cfg.name} with ssm_head_dim {cfg.ssm_head_dim}: d_inner "
          f"{cfg.d_inner}, {cfg.ssm_heads} head(s), "
          f"{cfg.block_pattern.count('mamba2')} Mamba2 blocks")
    before, start = snapshot(K), dict(K.LAUNCHES)
    gemms, unrecord = record_gemms(K)
    try:
        lm = LM(cfg, MeshInfo(model=2), device=dev)
        lm.init(torch.Generator(dev).manual_seed(MAMBA_RUN["seed"]))
        params = lm.train_mode().values()
        tokens = torch.from_numpy(np.random.default_rng(
            MAMBA_RUN["seed"]).integers(0, cfg.vocab_size, (
                MAMBA_RUN["batch"], MAMBA_RUN["seq"]))).to(dev)
        fed = []
        for _ in range(MAMBA_RUN["steps"]):   # the greedy tokens, in turn
            logits, grads = mamba_run(lm, params, tokens, fed)
            fed.append(logits[-1].argmax(-1, keepdim=True))
        logits, grads = mamba_run(lm, params, tokens, fed)
    finally:
        unrecord()
    route_check(K, "phase 18 (c)'s one-card run", "f32", before)
    ref = {"logits": logits, "fed": fed,
           "grads": {"/".join(map(str, p)): g.cpu()
                     for p, g in grads.items()},
           "grads64": float64_grads(lm, params, tokens)}
    launches = {k: K.LAUNCHES[k] - start[k] for k in K.LAUNCHES}
    del lm, params, grads
    torch.cuda.empty_cache()
    port = free_port()
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        mamba_rank, args=(port, out_dir, ref, dev), nprocs=2, join=False,
        start_method="spawn")
    end = time.monotonic() + LAST_DEADLINE
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            check(time.monotonic() < end, f"phase 18 (c): the two ranks "
                  f"passed their {LAST_DEADLINE:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"phase18c_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"(c) two gloo ranks on cuda:0, a (1, 2) mesh, "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    mamba = cfg.block_pattern.count("mamba2")
    tokens = [[int(x) for x in t.flatten()] for t in ref["fed"]]
    for r in ranks:
        gathers = r["collectives"].get("all_gather over model", {}).get(
            "calls", 0)
        headwise = max(h["card"] for h in r["headwise"].values())
        print(f"  rank {r['rank']}: logits {r['logits_rel_l2']} relative "
              f"L2 of one card's (prefill, then {MAMBA_RUN['steps']} decode "
              f"steps; bound {MAMBA_RUN['logits_rel_l2']}), tokens "
              f"{r['tokens']} (one card {tokens}); gradients: worst leaf "
              f"but the head-wise against one card's {r['worst_leaf']} at "
              f"{r['worst']:.3g} (bound {MAMBA_RUN['grad_rel_l2']}); the "
              f"head-wise against one card's at most {headwise:.3g} (cap "
              f"{MAMBA_RUN['headwise_cap']}), the most one lies further "
              f"from float64 than one card's: {r['excess']:.3g} "
              f"({r['excess_leaf']}; bound {MAMBA_RUN['grad_rel_l2']}); "
              f"GEMM launches {r['launches']} by route {r['routes']}; "
              f"collectives {r['collectives']}")
        for path, h in sorted(r["headwise"].items()):
            print(f"    {path}: {h['card']:.3g} of one card's; float64 "
                  f"{h['float64']:.3g}, one card's {h['card_float64']:.3g}")
        check(max(r["logits_rel_l2"]) <= MAMBA_RUN["logits_rel_l2"],
              f"phase 18 (c) rank {r['rank']}: logits "
              f"{r['logits_rel_l2']}")
        check(r["tokens"] == tokens, f"phase 18 (c) rank {r['rank']}: "
              f"tokens {r['tokens']}, one card {tokens}")
        check(r["worst"] <= MAMBA_RUN["grad_rel_l2"],
              f"phase 18 (c) rank {r['rank']}: gradient {r['worst_leaf']} "
              f"{r['worst']:.3g} relative L2 of one card's")
        check(len(r["headwise"]) == len(HEADWISE) * mamba,
              f"phase 18 (c) rank {r['rank']}: head-wise leaves "
              f"{sorted(r['headwise'])}")
        check(r["excess"] <= MAMBA_RUN["grad_rel_l2"],
              f"phase 18 (c) rank {r['rank']}: gradient {r['excess_leaf']} "
              f"{r['excess']:.3g} further from float64 than one card's")
        check(headwise <= MAMBA_RUN["headwise_cap"],
              f"phase 18 (c) rank {r['rank']}: a head-wise gradient "
              f"{headwise:.3g} relative L2 of one card's")
        check(r["routes"]["wgmma"] == 0 and r["routes"]["cuda_cores"] > 0,
              f"phase 18 (c) rank {r['rank']}: f32 GEMM routes "
              f"{r['routes']}")
        check(gathers >= 2 * mamba, f"phase 18 (c) rank {r['rank']}: "
              f"{gathers} all-gathers over model, not one a Mamba2 block "
              f"a pass")
    err = max_errors(hold_gemms_by_kernel(K, gemms, dev,
                                          "phase 18 (c), one card"),
                     *(r["max_abs_err"] for r in ranks))
    total = {k: launches[k] + sum(r["launches"][k] for r in ranks)
             for k in K.LAUNCHES}
    print(f"phase 18 (c) f32 GEMM launches: {total}; every product held at "
          f"the shapes it ran at, max |err| by kernel {err}")
    return {"ranks": ranks, "launches": total, "max_abs_err": err}


def mamba_rank(rank, port, out_dir, ref, dev):
    """Phase 18 (c), one of two ranks sharing cuda:0 through gloo: writes
    ``phase18c_rank<rank>.json`` to ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import gemm as K
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.models.common import tree_paths
    from repro_torch.models.model import LM
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime import train_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        cfg = mamba_config()
        mesh = make_host_mesh(1, 2, "cuda")
        gemms, unrecord = record_gemms(K)
        try:
            with sh.use_mesh(mesh):
                minfo = sh.mesh_info(mesh)
                check(ssm._tp_axes(cfg, minfo) == ("model", "model"),
                      "phase 18 (c): the mesh does not take the branch")
                lm = LM(cfg, minfo, device=dev)
                lm.init(torch.Generator(dev).manual_seed(MAMBA_RUN["seed"]),
                        shard=True)
                params = lm.train_mode().values()
                tokens = torch.from_numpy(np.random.default_rng(
                    MAMBA_RUN["seed"]).integers(0, cfg.vocab_size, (
                        MAMBA_RUN["batch"], MAMBA_RUN["seq"]))).to(dev)
                sh.reset_collective_counts()
                logits, grads = mamba_run(lm, params, tokens, ref["fed"])
                collectives = sh.collective_counts()
                synced, _ = train_lib._data_sync(
                    lm, train_lib._unflatten(params, list(grads.values())),
                    None)
                whole = {"/".join(map(str, p)): g for p, g in
                         tree_paths(sh.gather_tree(synced, lm.specs()))}
        finally:
            unrecord()
        res = {"worst": 0.0, "headwise": {}, "excess": -1.0}
        for path, g in whole.items():
            card, got = ref["grads"][path].double(), g.double().cpu()
            rel = rel_l2(got, card)
            if path.rsplit("/", 1)[-1] not in HEADWISE:
                if rel >= res["worst"]:
                    res.update(worst=rel, worst_leaf=path)
                continue
            g64 = ref["grads64"][path]
            rel64, card64 = rel_l2(got, g64), rel_l2(card, g64)
            res["headwise"][path] = {"card": rel, "float64": rel64,
                                     "card_float64": card64}
            if rel64 - card64 >= res["excess"]:
                res.update(excess=rel64 - card64, excess_leaf=path)
        res.update({"rank": rank,
               "logits_rel_l2": [rel_l2(x, w) for x, w in
                                 zip(logits, ref["logits"])],
               "tokens": [[int(x) for x in s.argmax(-1).flatten()]
                          for s in logits[:-1]],
               "collectives": collectives,
               "launches": dict(K.LAUNCHES), "routes": dict(K.ROUTES),
               "max_abs_err": hold_gemms_by_kernel(
                   K, gemms, dev, f"phase 18 (c) rank {rank}")})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"phase18c_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def last_phase(K, G, dev, out_dir):
    """Phase 18: the last mesh branches and the drivers ((a) the drivers,
    (b) kimi-k2's init, (c) Mamba2's new branch); returns their results,
    the phase's launches by kernel and its largest errors."""
    t0 = time.perf_counter()
    drivers = drivers_phase(K, G, dev, out_dir)
    init = init_phase(out_dir)
    mamba = mamba_phase(K, dev, out_dir)
    seconds = time.perf_counter() - t0
    print(f"phase 18: {seconds:.1f} s ((a) {drivers['seconds']:.1f} s)")
    print(smi("name,power.limit"))
    return {"drivers": drivers, "init": init, "mamba": mamba,
            "seconds": seconds,
            "max_abs_err": max_errors(drivers["max_abs_err"],
                                      mamba["max_abs_err"])}


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
                         "RMSNorm and flash attention, phase-14 logits "
                         "launch and phase-15 backward product times to "
                         "take on the same card, in the order parent, "
                         "change, change, parent, and whose served run "
                         "(phase 7) to take before and after this tree's")
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
    for c in (8, 24, 32, 64):
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
    cfg = G.wide_config()
    print(f"grouped bf16 (wgmma) from C = {G.WIDE_MIN_C}: the wide design, "
          f"tile {G.WIDE_TILE}, {cfg.consumers} consumer warpgroups of "
          f"m64n{cfg.nw}k16, {cfg.stages} stages of {cfg.stage_bytes} B, "
          f"{cfg.smem_bytes} B dynamic shared memory, {cfg.threads} threads, "
          f"one block an SM walking tiles")
    for c in (8, 24, 32, 128):
        t = G.grouped_tile(c, torch.float32)
        print(f"grouped f32 (CUDA cores) C = {c}: tile {t}, "
              f"{core_line(K.launch_config(t, 'f32'))}")
    flash_f32_phase1(FA, flash_f32_entries)
    rms_spills = [(v, fn, sp) for v in paths if v.startswith("rmsnorm")
                  for fn, _, _, sp in ptxas_entries(build.build_log(v))
                  if not (" 0 bytes spill stores" in sp
                          and " 0 bytes spill loads" in sp)]
    check(not rms_spills, f"RMSNorm kernels spill: {rms_spills}")
    print(f"RMSNorm columns: {R.column_rows(torch.bfloat16, NORM_D)} bf16 / "
          f"{R.column_rows(torch.float32, NORM_D)} f32 rows a block at D = "
          f"{NORM_D}; widest D {R.max_columns_dim()}")
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
        norm_turns = [tree_run(t, "norm", args.out, {"paths": t == HERE})
                      for t in (args.parent, HERE, HERE, args.parent)]
        compare_norms(norm_turns)
        flash_turns = [tree_run(t, "flash", args.out)
                       for t in (args.parent, HERE, HERE, args.parent)]
        compare_flash(flash_turns)
    zamba = zamba_phase(K, G, dev)
    families = families_phase(K, dev)
    deployment = deployment_phase(zamba)
    autoconf = autoconf_phase(K, dev, args.out, args.parent)
    training = training_phase(K, G, dev, args.out, args.parent)
    meshes = mesh_phase(K, G, dev, args.out)
    long_decode = long_decode_phase(K, dev, args.out)
    dry = dryrun_phase(meshes, args.out)
    last = last_phase(K, G, dev, args.out)
    # phases 16 and 18 held their products at their own shapes: their
    # errors join each kernel's
    mesh_err = max_errors(meshes["max_abs_err"], long_decode["max_abs_err"],
                          last["max_abs_err"])
    drivers = last["drivers"]["launches"]

    csrc = "src/repro_torch/kernels/csrc"
    kernels = []
    for tag, suffix, source, timed in (
            ("bf16", "", "wgmma_gemm.cuh", rows),
            ("int8", "_int8", "wgmma_s8.cuh", int8_rows["planner"]),
            ("f32", "_f32", "tile_gemm.cuh", core_rows["planner"])):
        kernels += [kernel_entry(f"{kname}{suffix}", f"{csrc}/{source}",
                                 f"src/repro/kernels/gemm.py:{line}",
                                 main_path[tag]["launches"][kname]
                                 + (meshes["launches"]["forward"][kname]
                                    + drivers["forward"][kname]
                                    if tag == "bf16" else 0)
                                 + (long_decode["launches"][kname]
                                    + last["mamba"]["launches"][kname]
                                    if tag == "f32" else 0),
                                 max(main_path[tag]["err"][kname],
                                     mesh_err.get(f"{kname}{suffix}", 0.0)),
                                 [r for r in timed if r["kernel"] == kname])
                    for kname, line in (("gemm_k_inner", 56),
                                        ("gemm_k_outer", 89))]
    kernels.append(kernel_entry(
        "grouped_gemm", f"{csrc}/grouped_gemm.cu",
        "src/repro/kernels/grouped_gemm.py:37",
        served["grouped_gemm"] + meshes["launches"]["grouped"]["forward"]
        + drivers["grouped"]["forward"],
        max(grouped_err, mesh_err["grouped_gemm"]),
        [r for r in grouped_rows if r["served"]]))
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
    kernels.append(kernel_entry(
        "gemm_k_inner_bwd", f"{csrc}/wgmma_gemm.cuh",
        "src/repro/kernels/gemm.py:56",
        training["train"]["backward"]["gemm_k_inner"]
        + meshes["launches"]["backward"]["gemm_k_inner"]
        + drivers["backward"]["gemm_k_inner"],
        max(training["backward_err"]["gemm"], mesh_err["gemm_k_inner_bwd"]),
        training["timing"]))
    kernels.append(kernel_entry(
        "grouped_gemm_bwd", f"{csrc}/grouped_gemm.cu",
        "src/repro/kernels/grouped_gemm.py:37",
        training["moe"]["grouped_backward"]
        + meshes["launches"]["grouped"]["backward"]
        + drivers["grouped"]["backward"],
        max(training["backward_err"]["grouped"],
            mesh_err["grouped_gemm_bwd"]), training["grouped_timing"]))
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
                   "autoconf": autoconf, "training": training,
                   "meshes": meshes, "long_decode": long_decode,
                   "dryrun": dry, "last": last},
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
