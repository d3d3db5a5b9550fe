// The int8 GEMM on Hopper's tensor cores: wgmma s8 x s8 -> s32 fed by TMA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gemm.py for int8
// operands, as wgmma_gemm.cuh does for bf16:
//   * gemm_k_inner (:56, body _k_inner_kernel :43), output-stationary, the
//     B3A2C0 analogue: one launch, k0 = 0, k1 = K; every block owns one
//     bm x bn tile of C, keeps its int32 sum in registers over all of K and
//     writes C once.
//   * _k_step_call (:89) driven by gemm_k_outer (:113), C streamed, the
//     C3B2A0/B3C2A0 analogue: one launch per k block [k0, k0 + bk); every
//     block reads its int32 C tile, adds A_k.B_k and writes it back.  C is
//     int32, so the per-pass rounding of ref.gemm_ref_streamed is exact.
// The plan's (bm, bn, bk) stays the thread-block tile.  The sums wrap in
// int32 as the JAX kernel's preferred_element_type=int32 does (no
// .satfinite); no shape in the repo comes near: 8960 x 128 x 128 < 2^31.
//
// What bounds it on an H100.  k-inner at Qwen2-1.5B's shapes is bound by
// operations: 2*M*N*K over the 1,979 TOP/s dense int8 tensor-core rate,
// which only wgmma reaches (the CUDA cores' exact int32 multiply-add, the
// route before this one, ran at 15-21 TOP/s).  k-outer is bound by its own
// C stream: int32 C read and written once per pass.
//
// The design.
//   * 8-bit wgmma takes both operands K-major from shared memory (no
//     transpose bit for .s8).  A (M, K) row-major is K-major already; B
//     (K, N) row-major is not, so the wrapper first writes Bt (N, K) with
//     repro_transpose_s8 below, once per call (all k-outer passes share
//     it), rows padded to 16 bytes so that TMA can read any K.
//   * Math: wgmma.mma_async m64nNk32 (WgmmaS8), int32 accumulators in
//     registers.  One consumer warpgroup per 64 x N unit of the tile, N = NW
//     = min(max(bn, 64), 256); more units than two warpgroups run in rounds,
//     each streaming K again (as wgmma_gemm.cuh).  bm < 64 still issues m64:
//     accumulator rows >= bm are never stored, and the A rows past the band
//     that such a read reaches lie in the same stage's Bt band (at least 64
//     rows of 128 bytes follow), so no pad is needed.
//   * Operands as TMA lays them out: both in 128-byte-swizzled boxes 128
//     int8 of K wide, so one k32 step advances a descriptor by 32 bytes, as
//     bf16's k16 step; a slab ks deep is ceil(ks/128) such bands of A (bmp
//     = max(bm, 8) rows) and of Bt (bnp = max(bn, 64) rows).  Every band
//     starts on 1024 bytes and no box dimension exceeds 256.
//   * Loads: one producer warp keeps a ring of `stages` slabs in flight on
//     full and empty mbarriers (kernels/gemm.py:int8_config picks the depth
//     and the stage count, mirroring GeomS8).
//   * Ragged edges: boxes past M, N or K fill with zero (exact for
//     integers); stores past M or N are skipped.  A box's inner coordinate
//     falls on 16 bytes: a slab that starts off a multiple of 16 loads from
//     the 16-aligned k below it, and a slab shallower than one k32 step (ks
//     < 32) has the columns of A and Bt outside its own k range zeroed in
//     shared memory before the product.
//   * Epilogue.  C goes through a bm x bn int32 tile in shared memory, in
//     128-byte-swizzled boxes of 32 columns when bm >= 8 and bn >= 32 (else
//     unswizzled boxes of bn columns): the consumers write their sums there
//     as 8-byte pairs and one thread stores the tile by TMA, clipped at M and
//     N.  k-outer's producer first loads the block's C tile by TMA, before
//     the first slab, and the consumers add their sums to it.  C rows TMA
//     cannot take (row stride not a multiple of 16 bytes, or bn < 4) are
//     read and written directly from the registers.
//   * Order: m tiles fastest within groups of `group` (raster_group).
//
// The host encodes the three tensor maps once per wrapper call
// (repro_gemm_s8_encode, maps of A, Bt and C) and passes them by value to
// every launch; a k-outer pass differs only in k0.

#pragma once

#include "wgmma_gemm.cuh"

namespace repro {
namespace {

constexpr int kS8BoxK = 128;  // 128 int8 of K: one 128-byte swizzle row
constexpr int kS8CCols = 32;  // 32 int32 of C: one 128-byte swizzle row

// The shared-memory layout of a bm x bn tile staged ks deep.  One stage:
// A as nkc = ceil(ks/128) bands of bmp x 128 bytes, then Bt as nkc bands of
// bnp x 128 bytes.  After the stages: the int32 C tile (c_tile), then the
// mbarriers (a full and an empty one per stage, one for the C tile).  The
// C tile is boxes of c_rows x c_cols.  Mirrored by
// kernels/gemm.py:int8_config.
struct GeomS8 {
  int bmp, bnp, nkc, a_bytes, stage_bytes, c_rows, c_cols, c_rows_log2,
      c_cols_log2, c_bytes;
  bool c_swizzle;
  __host__ __device__ GeomS8(int bm, int bn, int ks, bool c_tile) {
    bmp = bm < 8 ? 8 : bm;
    bnp = bn < 64 ? 64 : bn;
    nkc = (ks + kS8BoxK - 1) / kS8BoxK;
    a_bytes = nkc * bmp * 128;
    stage_bytes = a_bytes + nkc * bnp * 128;
    c_swizzle = bm >= 8 && bn >= kS8CCols;
    c_rows = bm < kMaxBoxRows ? bm : kMaxBoxRows;
    c_cols = c_swizzle ? kS8CCols : (bn < kMaxBoxRows ? bn : kMaxBoxRows);
    for (c_rows_log2 = 0; (1 << c_rows_log2) < c_rows; ++c_rows_log2) {
    }
    for (c_cols_log2 = 0; (1 << c_cols_log2) < c_cols; ++c_cols_log2) {
    }
    // rounded up to keep the mbarriers aligned
    c_bytes = c_tile ? (bm * bn * 4 + 127) / 128 * 128 : 0;
  }
  __host__ __device__ int smem(int stages) const {
    return stages * stage_bytes + c_bytes + 16 * stages + 8;
  }
};

// C[i0:i0+bm, j0:j0+bn] (+)= A[i0:, k0:k1] . Bt[j0:, k0:k1]^T for the tile
// of this block, in slabs ks deep.  NW: the instruction's N; W: consumer
// warpgroups (warps 0 .. 4W-1); warp 4W is the producer.  Cin, when not
// null, is Cout (k-outer adds to C in place).  tma_c: C goes through the C
// tile, loaded (k-outer) and stored by TMA on map_c.
template <int NW, int W>
__global__ void __launch_bounds__(W * 128 + 32, W == 1 && NW <= 128 ? 3 : 1)
wgmma_gemm_s8(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_c, const int* Cin,
              int* Cout, int M, int N, int k0, int k1, int64_t ldc, int bm,
              int bn, int ks, int stages, int gm, int gn, int group,
              int tma_c) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const GeomS8 g(bm, bn, ks, tma_c);
  unsigned char* ctile = smem + stages * g.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ctile + g.c_bytes);
  uint64_t* empty = full + stages;
  uint64_t* cbar = empty + stages;

  // grouped order: m tiles fastest inside a group of `group` m tiles
  const int per_group = group * gn;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * group;
  const int gsize = min(gm - first_m, group);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int i0 = (first_m + in_group % gsize) * bm;
  const int j0 = in_group / gsize * bn;

  const int pieces = (k1 - k0 + ks - 1) / ks;
  const int units_n = g.bnp / NW;
  const int units = (g.bmp + 63) / 64 * units_n;
  const int rounds = (units + W - 1) / W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // the swizzle atoms assume a 1024-byte aligned base
    if (smem_u32(smem) % 1024 != 0) __trap();
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * W);
    }
    mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * W) {
    // producer: one thread issues the C tile (k-outer) and every box of
    // every slab
    if (lane != 0) return;
    if (tma_c && Cin != nullptr) {
      mbar_expect_tx(cbar, bm * bn * 4);
      for (int m = 0; m < bm; m += g.c_rows)
        for (int n = 0; n < bn; n += g.c_cols)
          tma_load<false>(&map_c, ctile + (m * bn + n * g.c_rows) * 4, cbar,
                          j0 + n, i0 + m, 0);
    }
    int stage = 0, phase = 0;
    for (int r = 0; r < rounds; ++r) {
      for (int p = 0; p < pieces; ++p) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * g.stage_bytes;
        mbar_expect_tx(&full[stage], g.stage_bytes);
        const int kk = (k0 + p * ks) & ~15;
        for (int c = 0; c < g.nkc; ++c) {
          for (int m = 0; m < g.bmp; m += kMaxBoxRows)
            tma_load<false>(&map_a, st + (c * g.bmp + m) * 128, &full[stage],
                            kk + c * kS8BoxK, i0 + m, 0);
          for (int n = 0; n < g.bnp; n += kMaxBoxRows)
            tma_load<false>(&map_b, st + g.a_bytes + (c * g.bnp + n) * 128,
                            &full[stage], kk + c * kS8BoxK, j0 + n, 0);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg runs unit r*W + wg of each round
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int k32 = (ks + 31) / 32;
  int stage = 0, phase = 0;
  for (int r = 0; r < rounds; ++r) {
    const int u = r * W + wg;
    const bool active = u < units;
    const int um = u / units_n, un = u % units_n;
    int acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0;

    for (int p = 0; p < pieces; ++p) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * g.stage_bytes;
      if (ks < 32) {
        // a slab shallower than one k32 step: zero the first 32 columns of
        // A and Bt outside [lo, hi), which hold the neighbouring slabs'
        // values
        const int lo = (k0 + p * ks) & 15;
        const int hi = lo + min(ks, k1 - (k0 + p * ks));
        for (int e = t; e < (g.bmp + g.bnp) * 32; e += 128) {
          const int row = e / 32, col = e % 32;
          if (col >= lo && col < hi) continue;
          // Bt's rows follow A's: one band of each when ks < 128
          st[row * 128 + (((col >> 4) ^ (row & 7)) << 4) + (col & 15)] = 0;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      if (active) {
        const uint32_t a0 = smem_u32(st) + um * 64 * 128;
        const uint32_t b0 = smem_u32(st) + g.a_bytes + un * NW * 128;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kt = 0; kt < k32; ++kt) {
          // band kt/4 of each operand, 32 bytes (32 k) per step inside it
          const uint64_t da = sw128_desc(
              a0 + (kt / 4) * g.bmp * 128 + (kt % 4) * 32, 16, 1024);
          const uint64_t db = sw128_desc(
              b0 + (kt / 4) * g.bnp * 128 + (kt % 4) * 32, 16, 1024);
          WgmmaS8<NW>::mma(acc, da, db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (!active) continue;

    // epilogue: thread t holds rows 16*(t/32) + (t%32)/4 (+ 8) and columns
    // 8j + 2*(t%4) (+ 1) of the 64 x NW unit
    const int row_l = um * 64 + 16 * (t / 32) + (t % 32) / 4;
    const int col_l = un * NW + 2 * (t % 4);
    if (tma_c && Cin != nullptr && r == 0) mbar_wait(cbar, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = row_l + 8 * h;
      if (rl >= bm) continue;
      if (tma_c) {
        // the C tile (see GeomS8); TMA stores only what lies inside C.
        // k-outer reads eight pairs of the row's C values, all loads in
        // flight together, then writes their sums.
        const int br = rl & (g.c_rows - 1);
        unsigned char* rowp =
            ctile + (rl >> g.c_rows_log2) * g.c_rows * bn * 4 +
            (g.c_swizzle ? br * 128 : br * g.c_cols * 4);
#pragma unroll
        for (int jb = 0; jb < NW / 8; jb += 8) {
          int2* at[8];
          int2 cv[8];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cl = col_l + 8 * (jb + jj);
            const int bc = cl & (g.c_cols - 1);
            at[jj] = reinterpret_cast<int2*>(
                rowp + (cl >> g.c_cols_log2) * g.c_rows * g.c_cols * 4 +
                (g.c_swizzle ? (((bc >> 2) ^ (br & 7)) << 4) + (bc & 3) * 4
                             : bc * 4));
            cv[jj] = Cin != nullptr && cl < bn ? *at[jj] : make_int2(0, 0);
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jb + jj;
            if (col_l + 8 * j >= bn) continue;
            *at[jj] = make_int2(acc[4 * j + 2 * h] + cv[jj].x,
                                acc[4 * j + 2 * h + 1] + cv[jj].y);
          }
        }
        continue;
      }
      const int row = i0 + rl;
      if (row >= M) continue;
      // Cin, when given, is Cout
      int* crow = Cout + static_cast<int64_t>(row) * ldc + j0;
      const int cend = min(bn, N - j0);  // columns inside the tile and C
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int cl = col_l + 8 * j;
        if (cl < cend)
          crow[cl] = acc[4 * j + 2 * h] + (Cin != nullptr ? crow[cl] : 0);
        if (cl + 1 < cend)
          crow[cl + 1] =
              acc[4 * j + 2 * h + 1] + (Cin != nullptr ? crow[cl + 1] : 0);
      }
    }
  }
  if (!tma_c) return;
  // every consumer's part of the C tile is in shared memory: one thread
  // stores the tile and waits until TMA has read it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 3, %0;\n" ::"r"(W * 128) : "memory");
  if (threadIdx.x != 0) return;
  for (int m = 0; m < bm; m += g.c_rows)
    for (int n = 0; n < bn; n += g.c_cols)
      tma_store<false>(&map_c, ctile + (m * bn + n * g.c_rows) * 4, j0 + n,
                       i0 + m, 0);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Bt[n, k] = B[k, n] for k < K, and 0 for K <= k < Kp (the pad of Bt's
// rows, Kp a multiple of 16), one 64 x 64 tile a block through shared
// memory: each thread loads 16 bytes of one B row (one 16-byte load when
// vec_b: B's base and row stride on 16 bytes, else bytes) and stores 16
// bytes of one Bt row.  Bound by bytes: K*N read and N*Kp written.
__global__ void __launch_bounds__(256)
transpose_s8(const int8_t* __restrict__ B, int8_t* __restrict__ Bt, int K,
             int N, int Kp, int64_t ldb, int64_t ldbt, int vec_b) {
  __shared__ __align__(16) uint8_t tile[64][80];  // rows 16-byte aligned
  const int n0 = static_cast<int>(blockIdx.x) * 64;
  const int k0 = static_cast<int>(blockIdx.y) * 64;
  const int t = threadIdx.x;
  {
    const int kr = t >> 2, nc = (t & 3) * 16;
    const int k = k0 + kr, n = n0 + nc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K) {
      const int8_t* src = B + static_cast<int64_t>(k) * ldb + n;
      if (vec_b && n + 16 <= N) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16 && n + i < N; ++i)
          w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                      << (8 * (i % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(&tile[kr][nc]) = v;
  }
  __syncthreads();
  const int nr = t >> 2, kc = (t & 3) * 16;
  const int n = n0 + nr, k = k0 + kc;
  if (n >= N || k >= Kp) return;  // Kp % 16 == 0: all 16 bytes inside
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i / 4] |= static_cast<uint32_t>(tile[kc + i][nr]) << (8 * (i % 4));
  *reinterpret_cast<uint4*>(Bt + static_cast<int64_t>(n) * ldbt + k) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// Host side

int s8_encode(const void* A, const void* Bt, const void* C, int M, int N,
              int K, int64_t lda, int64_t ldbt, int64_t ldc, int bm, int bn,
              int ks, void* maps) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || ks <= 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(Bt)) %
          16 != 0 || lda % 16 != 0 || ldbt % 16 != 0)
    return cudaErrorMisalignedAddress;
  const bool tma_c = tma_c_ok(C, ldc, bn, 4);
  const GeomS8 g(bm, bn, ks, tma_c);
  alignas(64) CUtensorMap m[3];
  memset(m, 0, sizeof(m));
  int e = encode_map(&m[0], A, M, K, lda, kS8BoxK,
                     g.bmp < kMaxBoxRows ? g.bmp : kMaxBoxRows,
                     CU_TENSOR_MAP_SWIZZLE_128B, 0, 0,
                     CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (e == 0)
    e = encode_map(&m[1], Bt, N, K, ldbt, kS8BoxK,
                   g.bnp < kMaxBoxRows ? g.bnp : kMaxBoxRows,
                   CU_TENSOR_MAP_SWIZZLE_128B, 0, 0,
                   CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (e == 0 && tma_c)
    e = encode_map(&m[2], C, M, N, ldc, g.c_cols, g.c_rows,
                   g.c_swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_NONE,
                   0, 0, CU_TENSOR_MAP_DATA_TYPE_INT32, 4);
  if (e == 0) memcpy(maps, m, sizeof(m));
  return e;
}

template <int NW, int W>
int launch_s8_kernel(const CUtensorMap* m, const int* cin, int* cout, int M,
                     int N, int k0, int k1, int64_t ldc, int bm, int bn,
                     int ks, int stages, int gm, int gn, int group, int tma_c,
                     dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wgmma_gemm_s8<NW, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgmmaMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  wgmma_gemm_s8<NW, W><<<grid, W * 128 + 32, smem, stream>>>(
      m[0], m[1], m[2], cin, cout, M, N, k0, k1, ldc, bm, bn, ks, stages, gm,
      gn, group, tma_c);
  return cudaGetLastError();
}

// One launch over the (M/bm) x (N/bn) tiles for K in [k0, k1), on the maps
// of s8_encode (m[2] read only when tma_c).  kernels/gemm.py:int8_config
// picks ks and stages and refuses what does not fit first.
int launch_s8(const CUtensorMap* m, const void* Cin, void* Cout, int M,
              int N, int K, int64_t ldc, int k0, int k1, int bm, int bn,
              int ks, int stages, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k0 < 0 || k1 <= k0 || k1 > K ||
      stages < 1 || group < 1 || bm <= 0 || bn <= 0 || ks <= 0 ||
      (bm & (bm - 1)) || (bn & (bn - 1)) || (ks & (ks - 1)) ||
      (Cin != nullptr && Cin != Cout))
    return cudaErrorInvalidValue;
  const int tma_c = tma_c_ok(Cout, ldc, bn, 4);
  const GeomS8 g(bm, bn, ks, tma_c);
  const int smem = g.smem(stages);
  if (smem > kWgmmaMaxSmem) return cudaErrorInvalidValue;
  const int64_t gm = (static_cast<int64_t>(M) + bm - 1) / bm;
  const int64_t gn = (static_cast<int64_t>(N) + bn - 1) / bn;
  if (gm * gn > 2147483647LL) return cudaErrorInvalidValue;
  if (group > gm) group = static_cast<int>(gm);
  if (group * gn > 2147483647LL) group = 1;
  const auto* cin = static_cast<const int*>(Cin);
  auto* cout = static_cast<int*>(Cout);
  const int nw = g.bnp >= 256 ? 256 : g.bnp;
  const int units = (g.bmp + 63) / 64 * (g.bnp / nw);
  const int w = units < 2 ? 1 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(gm * gn));
#define REPRO_S8_CASE(NW_, W_)                                               \
  if (nw == NW_ && w == W_)                                                  \
    return launch_s8_kernel<NW_, W_>(m, cin, cout, M, N, k0, k1, ldc, bm,    \
                                     bn, ks, stages, static_cast<int>(gm),   \
                                     static_cast<int>(gn), group, tma_c,     \
                                     grid, smem, s);
  REPRO_S8_CASE(64, 1) REPRO_S8_CASE(64, 2)
  REPRO_S8_CASE(128, 1) REPRO_S8_CASE(128, 2)
  REPRO_S8_CASE(256, 1) REPRO_S8_CASE(256, 2)
#undef REPRO_S8_CASE
  return cudaErrorInvalidValue;
}

// Bt (N, Kp) from B (K, N) with row strides ldb and ldbt (ldbt >= Kp, both
// in bytes); Kp = K rounded up to 16.
int transpose_s8_launch(const void* B, void* Bt, int K, int N, int64_t ldb,
                        int64_t ldbt, void* stream) {
  const int Kp = (K + 15) / 16 * 16;
  if (K <= 0 || N <= 0 || ldbt < Kp || ldbt % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Bt) % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t gy = (Kp + 63) / 64;
  if (gy > 65535) return cudaErrorInvalidValue;
  const int vec_b =
      ldb % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((N + 63) / 64),
                  static_cast<unsigned>(gy));
  transpose_s8<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(B), static_cast<int8_t*>(Bt), K, N, Kp, ldb,
      ldbt, vec_b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro
