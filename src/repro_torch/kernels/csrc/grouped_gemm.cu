// Grouped (per-expert) GEMM for the MoE experts on Hopper (sm_90a):
// y[e] = x[e] . w[e] for every expert e in one launch.
//
// Replaces the Pallas TPU kernel grouped_gemm_kernel of
// src/repro/kernels/grouped_gemm.py:37 (body _grouped_kernel :23).  That
// kernel walks a (E, C/bc, F/bf, D/bk) grid in order on one core and carries
// its f32 sum across the sequential D axis in a VMEM scratch; Hopper's
// blocks run in parallel and in no order, so here the D loop runs inside
// the block instead: a thread block per (expert, C tile, F tile) (the
// wide design below: per SM, walking such tiles) loops over D and keeps
// the f32 accumulator in registers.  The function is the JAX kernel's: an f32 sum over D, rounded
// once to x's dtype; only the order of the sum differs.
//
// What bounds it on an H100 depends on C, the rows an expert, and so does
// the design; kernels/grouped_gemm.py:design picks one by shape.
//
// Decode and short prefill (C <= 64, the served shapes): bytes.  At
// decode (C = 32: max_batch 4 x capacity 8) each call reads every expert's
// weights once, 40 * 1536 * 512 * 2 B = 62.9 MB, for 2 * 40 * 32 * 1536 *
// 512 = 2.0 GFLOP: far below the ~295 flop/byte ridge, so the bound is
// 18.8 us at 3.35 TB/s.  What matters is keeping enough weight bytes in
// flight: about 3.35 TB/s x ~1 us of latency, 3.4 MB over 132 SMs, so at
// least ~25 KB per SM.  The decode design (grouped_wgmma<NW, W, TA, TB>):
// the kernel body of wgmma_gemm.cuh (its note gives the ring, the
// m64nNk16 products and the epilogue), with
//   * the expert as blockIdx.z and rank-3 tensor maps over x (E, C, D),
//     w (E, D, F) and y (E, C, F): every box zero-fills and clips at its own
//     expert's edges, so a ragged C (24 rows on a 32-row tile) neither reads
//     the next expert's tokens nor stores into its output, and a slab past
//     D reads zeros, not the next expert's weights.  When y's rows are not
//     16-byte aligned (F not a multiple of 8) the rounded sums are stored
//     from registers, each expert's rows c_plane elements apart.
//   * x (the tokens) as the m64 operand, K-major; w as B, MN-major (the
//     transpose bit).  bm = C rounded up to a power of two (8 at a bucket-32
//     prefill, 32 at decode, at most 128); rows past C are never stored.
//     The tensor cores idle most of the time either way, because the kernel
//     is bound by bytes: an m64n64k16 step on a 64 x 64 weight slab moves
//     8 KB for 2 x 64 x 64 x 64 flops, which the tensor cores absorb at
//     about 7.7 TB/s of weights (2.3x HBM's rate) however few rows are
//     real.  Swapping the operands (the weights as the m64 side, the tokens
//     as N = 8-32) would waste none of the m64 rows but needs a transposed
//     epilogue; it was not built (PERF.md).
//   * the backward products read their transposed operands in place, in
//     wgmma_gemm.cuh's layouts, at any C: dx = dy.w^T reads w^T's storage
//     (w) as a K-major B, dw = x^T.dy reads x as an MN-major A, whose blocks
//     walk the tiles of every expert persistently (its products are four
//     64-deep slabs at granite's training shapes).  Both take a deeper
//     ring than the served step (kernels/grouped_gemm.py:grouped_config).
//   * tiles sized for a bytes-bound kernel of short-lived blocks
//     (kernels/grouped_gemm.py: grouped_tile, grouped_config): bn = 64 F
//     columns per block, so that gate/up (F = 512) has 40 x 8 = 320 blocks
//     and down (F = 1536) 960, more than the 132 SMs at every served shape;
//     slabs 64 deep (one A box and one B box a stage) in a ring of three
//     stages, 27-37 KB per block (24 KB of weights) and four blocks per SM
//     (registers allow four at 82 a thread).  Measured at the served shapes,
//     more blocks in flight beat a deeper ring: three stages took less time
//     than two or four, and than as many as fit three blocks to an SM (5-7),
//     and 64 F columns or slabs less than 128 (chip_smoke.py phase 6 sweeps
//     the stage cap; PERF.md).
//
// Prefill (the row-major forward from C = 65, F a multiple of 8):
// operations.  At granite's 819 rows an expert (4,096 tokens, top-8 of 40)
// gate+up is 103 GFLOP against 294 MB, 351 flop/byte, and down sits at
// about the ridge.  There the decode design ran at 22-30 % of the bound:
// its m64n64k16 products read 4 KB of shared memory for each 64 x 64 x 16
// step, all that the SM's shared memory delivers a tensor-core step; its
// 128-row tiles had a ring of two stages; and each block did one tile, so
// down's eight slabs a tile paid the ring's fill and the epilogue alone.
// The wide design (wide::grouped_wgmma<256>, above) answers each:
//   * 128 x 256 tiles: two consumer warpgroups, each issuing m64n256k16 on
//     its 64 rows over 64-deep slabs, four times the operations per byte
//     of shared memory read; 128 f32 accumulators a thread (ptxas: 168
//     registers a thread of the 384, no spill).  The producer is a whole
//     warpgroup that hands its registers to the consumers (setmaxnreg
//     40 / 232): 1-2 % faster than one producer warp, or than a producer
//     warpgroup without setmaxnreg (PERF.md).
//   * a ring of three 48 KB stages (x's 128 x 64 box, four of w's 64 x 64
//     boxes) beside the 64 KB bf16 C tile, 213,048 B, one block an SM.
//     The consumers keep one wgmma group in flight and release a stage
//     one slab late.  128 x 128 tiles with up to six stages took 5 % more
//     time over gate+up and down together (PERF.md).
//   * persistent blocks: the launch holds one block an SM, each walking
//     the tiles of every expert, expert-major, all C tiles of one F column
//     band together (raster_group), so each weight slab is read from
//     device memory about once; the producer's ring runs on across tiles,
//     so the next tile's slabs load during this tile's epilogue, and the C
//     tile's TMA store drains while the next tile computes.
//   * unchanged: the rank-3 maps that clip at every expert's edges, the f32
//     sum over D rounded once to bf16.
// From 65 rows an expert on, the wide design took 1.16-1.52x less device
// time than the decode one at every granite shape, and 2.1-2.4x at 819;
// at 64 and below it lost on gate+up at F = 1024 (PERF.md).
//
// The wrapper encodes each tensor map once per (base, dims, strides, box)
// and keeps it (kernels/grouped_gemm.py: the expert weights are the same
// 96 maps every forward), so a call costs one ctypes launch and no
// cuTensorMapEncodeTiled call.
//
// f32 stays on the CUDA cores (FP32 FMA: TF32 would not compute the f32
// function): the kernel of tile_gemm.cuh, one group per expert (blockIdx.z)
// with the experts' strides, on a bc x bf x bk tile with bc = the smallest
// power of two >= min(C, 128), bf = 128, bk = 128 (kernels/grouped_gemm.py);
// its cp.async ring keeps each block's next weight sub-slab in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_GEMM_<BF16|F32> grouped_gemm.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py: the bf16 one exports repro_grouped_encode,
// repro_grouped_gemm_wgmma (the decode design) and repro_grouped_gemm_wide,
// the f32 one repro_grouped_gemm.

#if defined(REPRO_GEMM_BF16)
#include "wgmma_gemm.cuh"
#else
#include "tile_gemm.cuh"
#endif

#if defined(REPRO_GEMM_BF16)
namespace repro {
namespace {
namespace wide {

constexpr int kBm = 128;       // two consumer warpgroups of 64 rows
constexpr int kKs = 64;        // one 128-byte-swizzled box deep
constexpr int kThreads = 384;  // two consumer warpgroups, one producer

// y (E, C, F) = x (E, C, D) . w (E, D, F), row-major, on 128 x BN tiles
// (the design note above; BN = 256 is the one instantiated).  Warpgroups
// 0 and 1 consume, warpgroup 2 produces; the launch holds one block an SM,
// and each block walks the tiles of all experts, expert-major, C tiles
// fastest within groups of `group` (every C tile of an expert when its x
// rows fit kernels/gemm.py:RASTER_L2_BYTES), taking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_y, int C, int D, int F,
              int experts, int stages, int group) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Geom g(kBm, BN, kKs, true);
  unsigned char* ctile = smem + stages * g.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ctile + g.c_bytes);
  uint64_t* empty = full + stages;

  const int gm = (C + kBm - 1) / kBm, gn = (F + BN - 1) / BN;
  const int per_e = gm * gn, per_group = group * gn;
  const int tiles = per_e * experts;
  const int pieces = (D + kKs - 1) / kKs;
  int e = 0, i0 = 0, j0 = 0;
  auto place = [&](int tile) {
    e = tile / per_e;
    const int t = tile - e * per_e;
    const int first_m = t / per_group * group;
    const int gsize = min(gm - first_m, group);
    const int in_group = t % per_group;
    i0 = (first_m + in_group % gsize) * kBm;
    j0 = in_group / gsize * BN;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) % 1024 != 0) __trap();
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread loads x's 128 x 64 box and BN/64 of w's 64 x 64
    // boxes a stage, its ring running on from one tile to the next; the
    // warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 8 || lane != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      place(tile);
      for (int p = 0; p < pieces; ++p) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * g.stage_bytes;
        mbar_expect_tx(&full[stage], g.stage_bytes);
        tma_load<true>(&map_x, st, &full[stage], p * kKs, i0, e);
#pragma unroll
        for (int c = 0; c < BN / kBoxCols; ++c)
          tma_load<true>(&map_w, st + g.a_bytes + c * kKs * 128,
                         &full[stage], j0 + c * kBoxCols, p * kKs, e);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, t = threadIdx.x % 128;
  int stage = 0, phase = 0;
  bool stored = false;  // a C tile's TMA store is in flight
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    place(tile);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // one wgmma group stays in flight: a stage is released once the slab
    // after it has been issued and its own group has retired
    int held = -1;
    for (int p = 0; p < pieces; ++p) {
      mbar_wait(&full[stage], phase);
      const uint32_t a0 = smem_u32(smem + stage * g.stage_bytes) + wg * 8192;
      const uint32_t b0 = smem_u32(smem + stage * g.stage_bytes + g.a_bytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kt = 0; kt < kKs / 16; ++kt)
        Wgmma<BN, 0, 1>::mma(acc, sw128_desc(a0 + kt * 32, 16, 1024),
                             sw128_desc(b0 + kt * 2048, kKs * 128, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0 && held >= 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&empty[held]);
    if (stored) {
      // the previous tile's store must have read the C tile first
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
    // epilogue: thread t holds rows 16 (t/32) + (t%32)/4 (+ 8) and columns
    // 8j + 2 (t%4) (+ 1) of its warpgroup's 64 x BN unit; the C tile is
    // BN/64 boxes of 128 rows x 64 columns, 128-byte swizzled (Geom)
    const int r0 = wg * 64 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      unsigned char* rowp = ctile + r * 128 + (t % 4) * 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            rowp + (j / 8) * (kBm * 128) + (((j % 8) ^ (r & 7)) << 4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    // one thread stores the tile (clipped at the expert's C and F) and
    // lets it drain while the next tile computes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (threadIdx.x == 0) {
#pragma unroll
      for (int n = 0; n < BN; n += kBoxCols)
        tma_store<true>(&map_y, ctile + n * kBm * 2, j0 + n, i0, e);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    stored = true;
  }
  if (stored && threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int BN>
int launch(const CUtensorMap* m, int E, int C, int D, int F, int stages,
           int group, cudaStream_t stream) {
  auto* kernel = grouped_wgmma<BN>;
  const int smem = Geom(kBm, BN, kKs, true).smem(stages);
  if (smem > kWgmmaMaxSmem) return cudaErrorInvalidValue;
  // attributes and resident blocks (one an SM at any stage count that
  // fits), set and asked once, so that a call can be captured in a graph
  static int sized = -1, per_sm = 0;
  if (sized != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  const int64_t tiles = static_cast<int64_t>((C + kBm - 1) / kBm) *
                        ((F + BN - 1) / BN) * E;
  const int64_t resident = static_cast<int64_t>(per_sm) * sm_count();
  if (tiles > 2147483647LL || resident < 1)
    return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(tiles < resident ? tiles : resident),
           kThreads, smem, stream>>>(m[0], m[1], m[2], C, D, F, E, stages,
                                    group);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace
}  // namespace repro
#endif

extern "C" {

#if defined(REPRO_GEMM_BF16)

// Encode the rank-3 tensor map of one operand of a bm x bn tile staged ks
// deep: a stack of `depth` row-major (rows, cols) bf16 matrices with row
// stride ld and `plane` elements apart, as stored; operand 0 is x (the A
// side), 1 is w (the B side), 2 is y (the C tile's boxes).  trans: the
// operand is read in place as its transpose (x^T's storage, rows = D and
// cols = C, read MN-major; w^T's storage, rows = F and cols = D, read
// K-major).  Writes one CUtensorMap (128 bytes) to `map`.  Returns 0, a
// CUDA error code, or 100000 + the CUresult of cuTensorMapEncodeTiled.
int repro_grouped_encode(void* map, const void* base, int rows, int cols,
                         int depth, int64_t ld, int64_t plane, int operand,
                         int bm, int bn, int ks, int trans) {
  using namespace repro;
  if (rows <= 0 || cols <= 0 || depth <= 0 || bm <= 0 || bn <= 0 ||
      ks <= 0 || operand < 0 || operand > 2 || (operand == 2 && trans))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || ld % 8 != 0 ||
      plane % 8 != 0)
    return cudaErrorMisalignedAddress;
  const Geom g(bm, bn, ks, true, operand == 0 && trans,
               !(operand == 1 && trans));
  const int box_rows = operand == 0 ? g.a_rows : g.b_rows;
  alignas(64) CUtensorMap m;
  memset(&m, 0, sizeof(m));
  const int e =
      operand < 2
          ? encode_map(&m, base, rows, cols, ld, kBoxCols,
                       box_rows < kMaxBoxRows ? box_rows : kMaxBoxRows,
                       CU_TENSOR_MAP_SWIZZLE_128B, depth, plane)
          : encode_map(&m, base, rows, cols, ld, g.c_cols, g.c_rows,
                       g.c_swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_NONE,
                       depth, plane);
  if (e == 0) memcpy(map, &m, sizeof(m));
  return e;
}

// y (E, C, F) = x (E, C, D) . w (E, D, F) on the maps of
// repro_grouped_encode (x as operand 0, w as 1, y as 2, all for the same
// bm, bn, ks) in the layout (ta, tb) (the instruction's transpose bits:
// ta = 1 when x's map is x^T's storage, tb = 0 when w's is w^T's; (0, 1),
// (1, 1) and (0, 0) are taken).  map_y null: y is stored from registers,
// rows ldy elements apart and experts plane_y apart; else through the C
// tile by TMA (y's rows and base 16-byte aligned).  Slabs ks deep through
// `stages` shared-memory stages; blocks walk C tiles fastest within groups
// of `group`, and an MN-major x walks the tiles of all experts
// persistently.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int repro_grouped_gemm_wgmma(const void* map_x, const void* map_w,
                             const void* map_y, void* y, int E, int C, int D,
                             int F, int64_t ldy, int64_t plane_y, int bm,
                             int bn, int ks, int stages, int group, int ta,
                             int tb, void* stream) {
  using namespace repro;
  const int tma_c = map_y != nullptr;
  if (map_x == nullptr || map_w == nullptr ||
      (tma_c && !(tma_c_ok(y, ldy, bn) && plane_y % 8 == 0)))
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap m[3];
  memset(m, 0, sizeof(m));
  memcpy(&m[0], map_x, sizeof(CUtensorMap));
  memcpy(&m[1], map_w, sizeof(CUtensorMap));
  if (tma_c) memcpy(&m[2], map_y, sizeof(CUtensorMap));
  return launch_tiles<true>(m, nullptr, y, C, F, D, ldy, plane_y, E, 0, D,
                            bm, bn, ks, stages, group, tma_c, ta, tb,
                            stream);
}

// The wide design (repro::wide::grouped_wgmma): y (E, C, F) = x (E, C, D)
// . w (E, D, F), all row-major and contiguous, on the maps of
// repro_grouped_encode for the 128 x 256 x 64 tile (y's map is required:
// F a multiple of 8), `stages` deep (two at least), C tiles fastest within
// groups of `group`.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int repro_grouped_gemm_wide(const void* map_x, const void* map_w,
                            const void* map_y, int E, int C, int D, int F,
                            int stages, int group, void* stream) {
  using namespace repro;
  if (map_x == nullptr || map_w == nullptr || map_y == nullptr || E < 1 ||
      C <= 0 || D <= 0 || F <= 0 || stages < 2 || group < 1)
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap m[3];
  memcpy(&m[0], map_x, sizeof(CUtensorMap));
  memcpy(&m[1], map_w, sizeof(CUtensorMap));
  memcpy(&m[2], map_y, sizeof(CUtensorMap));
  return wide::launch<256>(m, E, C, D, F, stages, group,
                          static_cast<cudaStream_t>(stream));
}

#else

// y (E, C, F) = x (E, C, D) . w (E, D, F), all contiguous row-major, on a
// bc x bf x bk thread-block tile of the CUDA-core kernel.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int repro_grouped_gemm(const void* x, const void* w, void* y, int E, int C,
                       int D, int F, int bc, int bf, int bk, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0) return cudaErrorInvalidValue;
  const int64_t sx = static_cast<int64_t>(C) * D;
  const int64_t sw = static_cast<int64_t>(D) * F;
  const int64_t sy = static_cast<int64_t>(C) * F;
  // one raster group holds every C tile of an expert: blocks of the same F
  // columns share that expert's weights
  return repro::gemm_tile_groups(
      static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
      static_cast<float*>(y), C, F, 0, D, D, F, F, E, sx, sw, sy, bc, bf, bk,
      C, stream);
}

#endif

const char* repro_cuda_error_string(int code) {
#if defined(REPRO_GEMM_BF16)
  if (code >= repro::kDriverErrorBase)
    return "cuTensorMapEncodeTiled failed (its CUresult = code - 100000)";
#endif
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
