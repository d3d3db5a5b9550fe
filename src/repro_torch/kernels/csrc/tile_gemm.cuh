// The f32 GEMM on Hopper's CUDA cores, shared by gemm.cu and grouped_gemm.cu
// (their f32 builds; bf16 and the 8-bit integers run on the tensor cores).
//
// tile_gemm computes, for group z = blockIdx.z,
//   Cout_z[i0:i0+bm, j0:j0+bn] = (Cin_z +) A_z[i0:i0+bm, k0:k1] . B_z[k0:k1, j0:j0+bn]
// where A_z = A + z * plane_a (likewise B and C).  A plain GEMM is one group
// (gridDim.z = 1); the grouped GEMM of the MoE experts is one group per
// expert.  k-inner is one launch over [0, K); k-outer one launch per k
// block with Cin = Cout.  The f32 sum of the products is kept in registers
// and Cin, when not null, is added to it once, at the end: per pass the
// function is f32(Cin + A_k . B_k), as the Pallas kernel computes it.
//
// What bounds it on an H100: at the planner's tiles and Qwen2-1.5B's shapes
// the products sit far above the card's ridge point, so the bound is the
// 67 TFLOP/s FP32 rate of the CUDA cores (FFMA only: TF32 keeps ten bits of
// mantissa and would not compute the f32 function).  Reaching it means
// issuing an FFMA in almost every cycle of every SM sub-partition, so the
// design spends as few other instructions as it can per multiply-add:
//
//   * Register tile.  Each thread owns an RM x RN tile of C: rows ty + i*TY
//     and RN/4 column fragments 4 wide, bn/(RN/4) columns apart (8x8 at
//     64x128 with 128 threads, 4x8 at 32x64 with 64).  Four k steps cost
//     one LDS.128 of each of the thread's RM rows of A (four k each) and
//     per step RN/4 LDS.128 of B, for 4 * RM * RN FFMA: 16 loads for 256
//     FFMA at 8x8; the next group's A and the next step's B load while
//     this step multiplies.  A warp covers 4 x 8 threads where the tile
//     allows, and A's rows in shared memory are ks + 4 floats long, so
//     each fragment load of the warp reads distinct banks or broadcasts.
//     A narrow tile (under 2,048 elements of C: decode's and the MoE
//     experts' 8x128) runs 128 threads of smaller tiles (2x4), because its
//     launches have few blocks and one warp a block would leave three of
//     an SM's four schedulers idle.  Sides below 4 use 2- or 1-wide B
//     fragments, very wide tiles more than two; at most 64 accumulators
//     and 256 threads.
//   * Operand staging.  The plan's bk slab is staged ks = min(bk, 32) deep
//     at a time (less when the ring would not fit) through a ring of
//     `stages` shared-memory stages (3; a k-outer pass at most as many as
//     its sub-slabs hold, at least 2) filled by cp.async, so the next
//     sub-slab loads while this one is multiplied and one __syncthreads a
//     sub-slab orders the ring.  A's bm x ks block and B's ks x bn block
//     keep their row-major layout and go as 16-byte cp.async where the
//     rows and base are 16-byte aligned, else as 4-byte ones (Table-2's K
//     = 27 rows of 108 bytes, strided views).  A stored K-major instead
//     (A^T, transposed on the way in) needs a 4-byte copy per element,
//     and those copies, one per A element against one per four of B,
//     held back the planner's narrow-n tiles (32x64, 64x32) more than the
//     K-major fragments sped up 64x128 (PERF.md §6).  Loads past M, N or
//     k1 read zero (the copy's source size is cut to what lies inside),
//     so ragged M, N and K need no padded copies, and a k-outer pass never
//     reads the next pass's columns.
//   * Epilogue.  A k-outer block issues its Cin tile's copies into shared
//     memory with the first refill of the ring, so they overlap the
//     product.  C is stored from registers as float4 where C's rows and base
//     are 16-byte aligned, else per element; stores past M or N are skipped.
//   * Order.  Blocks walk M fastest within groups of `group` m tiles
//     (kernels/gemm.py:raster_group), so the B panels a group shares are
//     read from device memory about once per group.
//   * Occupancy.  At 64x128 a block of 128 threads claims 76,800 B
//     (k-inner) or 109,568 B (k-outer, with its C tile); ptxas gives it
//     about 255 registers, two blocks an SM.  At 32x64, 64 threads and
//     38,400 B (k-inner).
//
// The register tile, sub-slab depth and stage count follow from (bm, bn,
// bk) alone (tile_config); kernels/gemm.py:launch_config mirrors the rule.
// The planner's tiles have instantiations with every extent fixed at
// compile time (REPRO_TILE_FIXED), so that shared-memory offsets are
// immediates; every other register tile runs one with run-time extents
// (REPRO_TILE_ANY), whose address arithmetic costs FFMA issue slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

// Everything here has internal linkage: each library that includes the
// header keeps its own kernels and its own `configured` flags.  With external
// linkage the flags become process-wide unique symbols, so the first library
// to configure an instantiation would leave the other's copy of the kernel
// without its shared-memory attribute, and that copy's launches would fail.
namespace repro {
namespace {

// A block may claim 227 KB of dynamic shared memory on Hopper.
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxThreads = 256;
// accumulators one thread keeps, at most
constexpr int kMaxAcc = 64;
// floats after each row of A's sub-slab in a stage (see a_row)
constexpr int kPadA = 4;

__host__ __device__ constexpr int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// floats of one row of A's sub-slab in a stage: ks + 4 (16-byte rows whose
// starts fall four banks apart), or ks itself below four
__host__ __device__ constexpr int a_row(int ks) {
  return ks >= 4 ? ks + kPadA : ks;
}

struct RegTile {
  int rm, rn;
};

// The register tile of one thread for a bm x bn block tile (powers of two,
// bm * bn <= kMaxAcc * kMaxThreads): 64 accumulators from 8,192 elements of
// C, 32 from 2,048, else 128 threads (a narrow tile, as decode and the MoE
// experts give it, has few blocks: its threads must fill the SM's four
// schedulers); split as square as it goes, rn >= rm, at most 8 a side
// unless the other side is too short for that, and never more than 256
// threads.
__host__ __device__ constexpr RegTile reg_tile(int bm, int bn) {
  const int e = bm * bn;
  int acc = e >= 8192 ? 64 : e >= 2048 ? 32 : e >= 128 ? e / 128 : 1;
  acc = imin(acc, imin(8, bm) * imin(8, bn));
  if (e / acc > kMaxThreads) acc = e / kMaxThreads;
  // the wider side of a split as square as the powers of two allow
  int rn = imin(imin(8, bn), 1 << ((ilog2(acc) + 1) / 2));
  int rm = acc / rn;
  if (rm > bm) {
    rm = bm;
    rn = acc / bm;
  }
  return {rm, rn};
}

struct TileCfg {
  int rm, rn, threads, ks, stages;
  int stage_floats;  // one stage: bm rows of A (ks + 4), ks rows of B (bn)
  int c_floats;      // the C tile a k-outer block stages
  int smem;          // bytes of dynamic shared memory
};

// The block that runs a bm x bn x bk tile, with a C tile when with_c
// (k-outer); returns 0, or cudaErrorInvalidValue for a tile it does not
// take.  Mirrored by kernels/gemm.py:launch_config.
inline int tile_config(int bm, int bn, int bk, bool with_c, TileCfg* cfg) {
  const bool pow2 = bm > 0 && bn > 0 && bk > 0 && (bm & (bm - 1)) == 0 &&
                    (bn & (bn - 1)) == 0 && (bk & (bk - 1)) == 0;
  if (!pow2) return cudaErrorInvalidValue;
  const int64_t e = static_cast<int64_t>(bm) * bn;
  if (e > kMaxAcc * kMaxThreads) return cudaErrorInvalidValue;
  const RegTile r = reg_tile(bm, bn);
  TileCfg c{};
  c.rm = r.rm;
  c.rn = r.rn;
  c.threads = (bm / r.rm) * (bn / r.rn);
  c.ks = imin(32, bk);
  c.stages = with_c ? imin(3, imax(2, bk / c.ks)) : 3;
  c.c_floats = with_c ? round4(bm * bn) : 0;
  for (;;) {
    c.stage_floats = round4(bm * a_row(c.ks)) + c.ks * round4(bn);
    c.smem = (c.stages * c.stage_floats + c.c_floats) * 4;
    if (c.smem <= kMaxSmemBytes) break;
    if (c.stages > 2)
      --c.stages;
    else if (c.ks > 1)
      c.ks /= 2;
    else
      return cudaErrorInvalidValue;
  }
  *cfg = c;
  return 0;
}

// What one launch needs besides the instantiation's constants.
struct TileArgs {
  const float* A;
  const float* B;
  const float* Cin;  // null (k-inner) or Cout (a k-outer pass)
  float* Cout;
  int64_t lda, ldb, ldc;
  int64_t plane_a, plane_b, plane_c;  // group strides (elements)
  int M, N, k0, k1;
  int bm_log2, bn_log2, ks_log2, stages;
  int gm, gn, group;  // m tiles, n tiles, m tiles per raster group
  int a_vec;          // A's rows, base and sub-slabs 16-byte aligned
  int b_vec;          // B's rows and base 16-byte aligned
  int c_vec;          // C's rows and base 16-byte aligned
};

// Wait until every group but the newest stages - 2 has landed (stages is
// 2 or 3).
__device__ __forceinline__ void cp_wait_ring(int stages) {
  if (stages == 3)
    cp_wait<1>();
  else
    cp_wait<0>();
}

// Rows [0, 2^rows_log2) x columns [0, 2^cols_log2) of the row-major block
// at src (row stride ld; its first rows_valid rows and cols_valid columns
// lie inside the matrix) into dst (row stride sd), in V-wide copies (V = 4:
// 16-byte aligned rows; 1: any) by the block's 2^t_log2 threads; copies
// that fall outside read zero.
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, int sd, const float* src,
                                          int64_t ld, int rows_log2,
                                          int cols_log2, int rows_valid,
                                          int cols_valid, int tid,
                                          int t_log2) {
  constexpr int v_log2 = V == 4 ? 2 : 0;
  const int q_log2 = cols_log2 - v_log2;          // copies per row
  const int qw_log2 = imin(q_log2, t_log2);       // ... per sweep row
  const int kr_log2 = t_log2 - qw_log2;           // rows per sweep
  const int qc = tid & ((1 << qw_log2) - 1);
  const int kr = tid >> qw_log2;
  const int nq = 1 << (q_log2 - qw_log2);
  const int nr = imax(1, (1 << rows_log2) >> kr_log2);
#pragma unroll
  for (int j = 0; j < nq; ++j) {
    const int col = (qc + (j << qw_log2)) << v_log2;
    const int cb = 4 * imax(0, imin(V, cols_valid - col));
#pragma unroll
    for (int l = 0; l < nr; ++l) {
      const int r = kr + (l << kr_log2);
      if (r < (1 << rows_log2)) {
        const int bytes = r < rows_valid ? cb : 0;
        const float* s = bytes ? src + r * ld + col : src;
        if constexpr (V == 4)
          cp_async16(dst + r * sd + col, s, bytes);
        else
          cp_async4(dst + r * sd + col, s, bytes);
      }
    }
  }
}

// RM x RN: one thread's register tile; KS, BM, BN: the sub-slab depth and
// block tile when fixed at compile time, 0 when read from the arguments.
// Threads form a TY x TX grid (TY = bm / RM, TX = bn / RN); thread (ty, tx)
// owns rows ty + i * TY (i < RM) and columns d * TX * VN + tx * VN + u.
// Cin may alias Cout: each block reads its C tile before it writes it.
template <int RM, int RN, int KS, int BM, int BN>
__global__ void __launch_bounds__(kMaxThreads)
tile_gemm(const TileArgs p) {
  constexpr int VN = RN < 4 ? RN : 4, CN = RN / VN;
  constexpr int vn_log2 = ilog2(VN);
  extern __shared__ __align__(16) float smem[];

  const int bm_log2 = BM ? ilog2(BM) : p.bm_log2;
  const int bn_log2 = BN ? ilog2(BN) : p.bn_log2;
  const int ks_log2 = KS ? ilog2(KS) : p.ks_log2;
  const int bn = 1 << bn_log2, ks = 1 << ks_log2;
  const int ty_log2 = bm_log2 - ilog2(RM), tx_log2 = bn_log2 - ilog2(RN);
  const int t_log2 = ty_log2 + tx_log2;
  const int sa = a_row(ks), sb = round4(bn);
  const int a_floats = round4(sa << bm_log2);  // A's part of a stage
  const int stage = a_floats + ks * sb;
  const int stages = p.stages;
  // blockDim.x is 2^t_log2: the mask lets the compiler see tid's range
  const int tid = threadIdx.x & ((1 << t_log2) - 1);

  // a warp covers wy x wx threads of the grid (4 x 8 where the grid allows)
  const int wx_log2 =
      t_log2 >= 5 ? imin(tx_log2, imax(3, 5 - ty_log2)) : tx_log2;
  const int wy_log2 = t_log2 >= 5 ? 5 - wx_log2 : ty_log2;
  const int lane = tid & 31, warp = tid >> 5;
  const int wpx_log2 = tx_log2 - wx_log2;  // warps along x
  const int tx = ((warp & ((1 << wpx_log2) - 1)) << wx_log2) |
                 (lane & ((1 << wx_log2) - 1));
  const int ty = ((warp >> wpx_log2) << wy_log2) | (lane >> wx_log2);

  // m tiles fastest inside a raster group of `group` m tiles
  const int bx = static_cast<int>(blockIdx.x);
  const int per_group = p.group * p.gn;
  const int first_m = bx / per_group * p.group;
  const int gsize = min(p.gm - first_m, p.group);
  const int in_group = bx - bx / per_group * per_group;
  const int i0 = (first_m + in_group % gsize) << bm_log2;
  const int j0 = (in_group / gsize) << bn_log2;

  const int64_t z = blockIdx.z;
  const float* Cin = p.Cin == nullptr ? nullptr : p.Cin + z * p.plane_c;
  float* Cout = p.Cout + z * p.plane_c;
  const int k1 = p.k1;
  const int rows_valid = p.M - i0, cols_valid = p.N - j0;
  const float* Ablk = p.A + z * p.plane_a + static_cast<int64_t>(i0) * p.lda;
  const float* Bblk = p.B + z * p.plane_b + j0;

  // one sub-slab [kb, kb + ks) into stage st: A's bm x ks block and B's
  // ks x bn block, each row-major, zero past M, N and k1
  auto load_slab = [&](int kb, float* st) {
    const int k_valid = k1 - kb;
    const float* asrc = Ablk + kb;
    if (p.a_vec)
      copy_rows<4>(st, sa, asrc, p.lda, bm_log2, ks_log2, rows_valid,
                   k_valid, tid, t_log2);
    else
      copy_rows<1>(st, sa, asrc, p.lda, bm_log2, ks_log2, rows_valid,
                   k_valid, tid, t_log2);
    float* bs = st + a_floats;
    const float* bsrc = Bblk + static_cast<int64_t>(kb) * p.ldb;
    if (p.b_vec)
      copy_rows<4>(bs, sb, bsrc, p.ldb, ks_log2, bn_log2, k_valid,
                   cols_valid, tid, t_log2);
    else
      copy_rows<1>(bs, sb, bsrc, p.ldb, ks_log2, bn_log2, k_valid,
                   cols_valid, tid, t_log2);
  };

  float* cs = smem + stages * stage;  // the C tile (k-outer), bm x bn
  auto load_c = [&]() {
    const float* csrc = Cin + static_cast<int64_t>(i0) * p.ldc + j0;
    if (p.c_vec && bn_log2 >= 2)
      copy_rows<4>(cs, bn, csrc, p.ldc, bm_log2, bn_log2, rows_valid,
                   cols_valid, tid, t_log2);
    else
      copy_rows<1>(cs, bn, csrc, p.ldc, bm_log2, bn_log2, rows_valid,
                   cols_valid, tid, t_log2);
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  const int pieces =
      k1 > p.k0 ? (k1 - p.k0 + ks - 1) >> ks_log2 : 0;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < pieces) load_slab(p.k0 + (s << ks_log2), smem + s * stage);
    cp_commit();
  }
  int rd = 0, wr = stages - 1;
  for (int t = 0; t < pieces; ++t) {
    cp_wait_ring(stages);  // sub-slab t has landed (this thread's copies)
    __syncthreads();       // ... everyone's; and stage wr is free again
    const int nt = t + stages - 1;
    if (nt < pieces) load_slab(p.k0 + (nt << ks_log2), smem + wr * stage);
    if (t == 0 && Cin != nullptr) load_c();
    cp_commit();

    // four k steps at a time: one LDS.128 of each of the thread's RM rows
    // of A, then per k step CN LDS.128 of B and RM x RN FFMA; the next
    // group's A and the next step's B load while this step multiplies
    const float* pa = smem + rd * stage + ty * sa;
    const float* pb = smem + rd * stage + a_floats + (tx << vn_log2);
    float a[2][RM][4], b[2][RN];
    auto load_a = [&](float (&f)[RM][4], int kq) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float* row = pa + ((i * sa) << ty_log2) + kq;
        if (KS >= 4 || ks >= 4) {
          ld_frag<4>(f[i], row);
        } else {  // sub-slabs of 1 or 2 k: rows of that many floats
          f[i][0] = row[0];
          if (ks > 1) f[i][1] = row[1];
        }
      }
    };
    auto load_b = [&](float (&f)[RN], int k) {
#pragma unroll
      for (int d = 0; d < CN; ++d)
        ld_frag<VN>(f + d * VN, pb + k * sb + (d << (tx_log2 + vn_log2)));
    };
    // the steps of one group of four from fragments f, prefetching g
    auto group = [&](float (&f)[RM][4], float (&g)[RM][4], int kq) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = kq + u;
        if (k < ks) {
          if (u == 0 && kq + 4 < ks) load_a(g, kq + 4);
          if (k + 1 < ks) load_b(b[(u + 1) & 1], k + 1);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              acc[i][j] = fmaf(f[i][u], b[u & 1][j], acc[i][j]);
        }
      }
    };
    load_a(a[0], 0);
    load_b(b[0], 0);
#pragma unroll(KS ? (KS + 7) / 8 : 1)
    for (int kq = 0; kq < ks; kq += 8) {
      group(a[0], a[1], kq);
      group(a[1], a[0], kq + 4);
    }
    rd = rd + 1 == stages ? 0 : rd + 1;
    wr = wr + 1 == stages ? 0 : wr + 1;
  }
  if (Cin != nullptr) {
    if (pieces == 0) {
      load_c();
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = ty + (i << ty_log2);
    if (row >= rows_valid) continue;
    float* out = Cout + static_cast<int64_t>(i0 + row) * p.ldc + j0;
    const float* cin = cs + row * bn;
#pragma unroll
    for (int d = 0; d < CN; ++d) {
      const int col = (d << (tx_log2 + vn_log2)) + (tx << vn_log2);
      float o[VN];
      if (Cin != nullptr) ld_frag<VN>(o, cin + col);
#pragma unroll
      for (int u = 0; u < VN; ++u)
        o[u] = Cin != nullptr ? o[u] + acc[i][d * VN + u]
                              : acc[i][d * VN + u];
      if constexpr (VN == 4) {
        if (p.c_vec && col + 4 <= cols_valid) {
          *reinterpret_cast<float4*>(out + col) =
              make_float4(o[0], o[1], o[2], o[3]);
          continue;
        }
      }
#pragma unroll
      for (int u = 0; u < VN; ++u)
        if (col + u < cols_valid) out[col + u] = o[u];
    }
  }
}

template <int RM, int RN, int KS, int BM, int BN>
cudaError_t launch_tile(const TileArgs& args, dim3 grid, int threads,
                        int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_gemm<RM, RN, KS, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    // several blocks share an SM: ask for all of its memory as shared
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tile_gemm<RM, RN, KS, BM, BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  tile_gemm<RM, RN, KS, BM, BN><<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Host-side dispatch over `groups` independent products
//   Cout_z = (Cin_z +) A_z[:, k0:k1] . B_z[k0:k1, :]   (M x N each)
// with row strides lda/ldb/ldc and group strides plane_a/b/c, on a
// bm x bn x bk tile; blocks walk M fastest within groups of `group` m
// tiles.  Returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for arguments or a tile it does not take.
inline int gemm_tile_groups(const float* A, const float* B, const float* Cin,
                            float* Cout, int M, int N, int k0, int k1,
                            int64_t lda, int64_t ldb, int64_t ldc, int groups,
                            int64_t plane_a, int64_t plane_b, int64_t plane_c,
                            int bm, int bn, int bk, int group, void* stream) {
  if (M < 0 || N < 0 || k0 < 0 || k1 < k0 || groups < 0)
    return cudaErrorInvalidValue;
  TileCfg cfg;
  if (tile_config(bm, bn, bk, Cin != nullptr, &cfg) != 0)
    return cudaErrorInvalidValue;
  const int64_t gm = (static_cast<int64_t>(M) + bm - 1) / bm;
  const int64_t gn = (static_cast<int64_t>(N) + bn - 1) / bn;
  if (gm * gn > 2147483647LL || groups > 65535) return cudaErrorInvalidValue;
  if (M == 0 || N == 0 || groups == 0) return cudaSuccess;
  TileArgs a;
  a.A = A;
  a.B = B;
  a.Cin = Cin;
  a.Cout = Cout;
  a.lda = lda;
  a.ldb = ldb;
  a.ldc = ldc;
  a.plane_a = plane_a;
  a.plane_b = plane_b;
  a.plane_c = plane_c;
  a.M = M;
  a.N = N;
  a.k0 = k0;
  a.k1 = k1;
  a.bm_log2 = ilog2(bm);
  a.bn_log2 = ilog2(bn);
  a.ks_log2 = ilog2(cfg.ks);
  a.stages = cfg.stages;
  a.gm = static_cast<int>(gm);
  a.gn = static_cast<int>(gn);
  a.group = static_cast<int>(group < 1 ? 1 : group > gm ? gm : group);
  a.a_vec = cfg.ks % 4 == 0 && k0 % 4 == 0 && lda % 4 == 0 &&
            plane_a % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  a.b_vec = bn % 4 == 0 && ldb % 4 == 0 && plane_b % 4 == 0 &&
            reinterpret_cast<uintptr_t>(B) % 16 == 0;
  a.c_vec = ldc % 4 == 0 && plane_c % 4 == 0 &&
            reinterpret_cast<uintptr_t>(Cout) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(Cin) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(gm * gn), 1,
                  static_cast<unsigned>(groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
// the planner's tiles (f32: 32x64, 64x32 and 8x128; 64x128 and 128x128
// where a caller asks for them; 32x128 the served grouped GEMM's), extents
// fixed at compile time
#define REPRO_TILE_FIXED(BM_, BN_, KS_)                                      \
  if (bm == BM_ && bn == BN_ && cfg.ks == KS_)                               \
    return launch_tile<reg_tile(BM_, BN_).rm, reg_tile(BM_, BN_).rn, KS_,   \
                       BM_, BN_>(a, grid, cfg.threads, cfg.smem, s);
  REPRO_TILE_FIXED(64, 128, 32) REPRO_TILE_FIXED(128, 128, 32)
  REPRO_TILE_FIXED(32, 64, 32) REPRO_TILE_FIXED(64, 32, 32)
  REPRO_TILE_FIXED(8, 128, 32) REPRO_TILE_FIXED(32, 128, 32)
#undef REPRO_TILE_FIXED
// every register tile reg_tile gives a tile launch_config takes, extents
// read at run time
#define REPRO_TILE_ANY(RM_, RN_)                                             \
  if (cfg.rm == RM_ && cfg.rn == RN_)                                        \
    return launch_tile<RM_, RN_, 0, 0, 0>(a, grid, cfg.threads, cfg.smem, s);
  REPRO_TILE_ANY(1, 1) REPRO_TILE_ANY(1, 2) REPRO_TILE_ANY(1, 4)
  REPRO_TILE_ANY(1, 8) REPRO_TILE_ANY(1, 16) REPRO_TILE_ANY(1, 32)
  REPRO_TILE_ANY(1, 64)
  REPRO_TILE_ANY(2, 1) REPRO_TILE_ANY(2, 2) REPRO_TILE_ANY(2, 4)
  REPRO_TILE_ANY(2, 8) REPRO_TILE_ANY(2, 16) REPRO_TILE_ANY(2, 32)
  REPRO_TILE_ANY(4, 1) REPRO_TILE_ANY(4, 2) REPRO_TILE_ANY(4, 8)
  REPRO_TILE_ANY(4, 16)
  REPRO_TILE_ANY(8, 1) REPRO_TILE_ANY(8, 2) REPRO_TILE_ANY(8, 4)
  REPRO_TILE_ANY(8, 8)
  REPRO_TILE_ANY(16, 1) REPRO_TILE_ANY(16, 2) REPRO_TILE_ANY(16, 4)
  REPRO_TILE_ANY(32, 1) REPRO_TILE_ANY(32, 2)
  REPRO_TILE_ANY(64, 1)
#undef REPRO_TILE_ANY
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
