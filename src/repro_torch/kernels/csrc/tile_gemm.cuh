// The thread-block tile GEMM shared by gemm.cu and grouped_gemm.cu: their
// f32 builds (bf16 and int8 run on the tensor cores, wgmma_gemm.cuh and
// wgmma_s8.cuh).
//
// tile_gemm<T, RM, RN> computes, for group z = blockIdx.z,
//   C_z[i0:i0+bm, j0:j0+bn] (+)= A_z[i0:i0+bm, :K] . B_z[:K, j0:j0+bn]
// where A_z = A + z * group_stride_a (likewise B and C).  A plain GEMM is
// one group (stride 0, gridDim.z = 1); the grouped GEMM of the MoE experts
// is one group per expert.  Every block loops over K in bk slabs staged
// through shared memory and keeps its f32 accumulator in registers; Cin,
// when not null, is added before the one rounding to Out.
//
// Ragged edges are masked: loads outside A or B read zero (zero K padding
// is exact) and stores outside C are skipped, so any (M, N, K) runs on any
// accepted tile without padded copies.
//
// Each thread owns an RM x RN register tile of C, so one k step costs
// RM + RN shared-memory reads for RM * RN multiply-adds; a warp reads one A
// value (broadcast) and 32 consecutive B values (no bank conflicts).  The
// products run on the CUDA cores (FP32 FMA; no tensor cores, no TF32).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  using Acc = float;
  using Out = __nv_bfloat16;
  __device__ __forceinline__ static __nv_bfloat16 zero() {
    return __float2bfloat16(0.0f);
  }
  __device__ __forceinline__ static float up(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static float from_out(__nv_bfloat16 c) {
    return __bfloat162float(c);
  }
  // round to nearest even, as jnp .astype and torch .to do
  __device__ __forceinline__ static __nv_bfloat16 to_out(float v) {
    return __float2bfloat16(v);
  }
};

template <> struct Elem<float> {
  using Acc = float;
  using Out = float;
  __device__ __forceinline__ static float zero() { return 0.0f; }
  __device__ __forceinline__ static float up(float x) { return x; }
  __device__ __forceinline__ static float from_out(float c) { return c; }
  __device__ __forceinline__ static float to_out(float v) { return v; }
};

// Threads form a TY x TX grid (TX = 2^tx_log2 columns); thread (ty, tx)
// owns rows ty + i*TY (i < RM) and columns tx + j*TX (j < RN) of the tile.
// Cin may alias Cout: each thread reads and writes only its own elements.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kMaxThreads)
tile_gemm(const T* __restrict__ A, const T* __restrict__ B,
          const typename Elem<T>::Out* Cin, typename Elem<T>::Out* Cout,
          int M, int N, int K, int64_t lda, int64_t ldb, int64_t ldc,
          int64_t group_stride_a, int64_t group_stride_b,
          int64_t group_stride_c, int bm_log2, int bn_log2, int bk_log2,
          int tx_log2) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bn = 1 << bn_log2, bk = 1 << bk_log2;
  T* As = reinterpret_cast<T*>(smem);            // bm x bk, row-major
  T* Bs = As + ((1 << bm_log2) << bk_log2);      // bk x bn, row-major

  const int64_t z = blockIdx.z;
  A += z * group_stride_a;
  B += z * group_stride_b;
  Cout += z * group_stride_c;
  if (Cin != nullptr) Cin += z * group_stride_c;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int TX = 1 << tx_log2;
  const int TY = nthreads >> tx_log2;
  const int tx = tid & (TX - 1);
  const int ty = tid >> tx_log2;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) << bm_log2;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) << bn_log2;
  const int a_elems = 1 << (bm_log2 + bk_log2);
  const int b_elems = 1 << (bk_log2 + bn_log2);

  Acc acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < a_elems; e += nthreads) {
      const int64_t gr = i0 + (e >> bk_log2);
      const int gc = k0 + (e & (bk - 1));
      As[e] = (gr < M && gc < K) ? A[gr * lda + gc] : E::zero();
    }
    for (int e = tid; e < b_elems; e += nthreads) {
      const int gr = k0 + (e >> bn_log2);
      const int64_t gc = j0 + (e & (bn - 1));
      Bs[e] = (gr < K && gc < N) ? B[gr * ldb + gc] : E::zero();
    }
    __syncthreads();
    const int kspan = min(bk, K - k0);
    for (int kk = 0; kk < kspan; ++kk) {
      Acc a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = E::up(As[((ty + i * TY) << bk_log2) + kk]);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        b[j] = E::up(Bs[(kk << bn_log2) + tx + j * TX]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = i0 + ty + i * TY;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int64_t c = j0 + tx + j * TX;
      if (c >= N) continue;
      Acc v = acc[i][j];
      if (Cin != nullptr) v = E::from_out(Cin[r * ldc + c]) + v;
      Cout[r * ldc + c] = E::to_out(v);
    }
  }
}

template <typename T, int RM, int RN>
cudaError_t launch_tile(const T* A, const T* B,
                        const typename Elem<T>::Out* Cin,
                        typename Elem<T>::Out* Cout, int M, int N, int K,
                        int64_t lda, int64_t ldb, int64_t ldc, int64_t sa,
                        int64_t sb, int64_t sc, int bm_log2, int bn_log2,
                        int bk_log2, int tx_log2, dim3 grid, int threads,
                        size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_gemm<T, RM, RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  tile_gemm<T, RM, RN><<<grid, threads, smem, stream>>>(
      A, B, Cin, Cout, M, N, K, lda, ldb, ldc, sa, sb, sc, bm_log2, bn_log2,
      bk_log2, tx_log2);
  return cudaGetLastError();
}

inline int log2_exact(int x) {
  if (x <= 0 || (x & (x - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Host-side dispatch over `groups` independent M x N x K products: derive
// the thread grid and per-thread register tile from the run-time tile, then
// pick the matching instantiation.  Mirrors kernels/gemm.py:launch_config,
// which rejects the same tiles up front.
template <typename T>
int gemm_tile_groups(const void* A, const void* B, const void* Cin,
                     void* Cout, int M, int N, int K, int64_t lda,
                     int64_t ldb, int64_t ldc, int groups, int64_t sa,
                     int64_t sb, int64_t sc, int bm, int bn, int bk,
                     void* stream) {
  using Out = typename Elem<T>::Out;
  const int bm_log2 = log2_exact(bm), bn_log2 = log2_exact(bn),
            bk_log2 = log2_exact(bk);
  if (bm_log2 < 0 || bn_log2 < 0 || bk_log2 < 0) return cudaErrorInvalidValue;
  if (M < 0 || N < 0 || K < 0 || groups < 0) return cudaErrorInvalidValue;
  const int threads = bm * bn < kMaxThreads ? bm * bn : kMaxThreads;
  const int tx = bn < 32 ? bn : 32;
  const int ty = threads / tx;
  const int rm = bm / ty, rn = bn / tx;
  const size_t smem = (static_cast<size_t>(bm) * bk +
                       static_cast<size_t>(bk) * bn) * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const int64_t gy = (static_cast<int64_t>(M) + bm - 1) / bm;
  const int64_t gx = (static_cast<int64_t>(N) + bn - 1) / bn;
  if (gy > 65535 || gx > 2147483647LL || groups > 65535)
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0 || groups == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(groups));
  const int tx_log2 = log2_exact(tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const Out* cin = static_cast<const Out*>(Cin);
  Out* cout = static_cast<Out*>(Cout);
#define REPRO_TILE_CASE(RM_, RN_)                                            \
  if (rm == RM_ && rn == RN_)                                                \
    return launch_tile<T, RM_, RN_>(a, b, cin, cout, M, N, K, lda, ldb, ldc, \
                                    sa, sb, sc, bm_log2, bn_log2, bk_log2,   \
                                    tx_log2, grid, threads, smem, s);
  REPRO_TILE_CASE(1, 1) REPRO_TILE_CASE(1, 2) REPRO_TILE_CASE(1, 4)
  REPRO_TILE_CASE(1, 8) REPRO_TILE_CASE(1, 16) REPRO_TILE_CASE(1, 32)
  REPRO_TILE_CASE(2, 1) REPRO_TILE_CASE(2, 2) REPRO_TILE_CASE(2, 4)
  REPRO_TILE_CASE(2, 8) REPRO_TILE_CASE(2, 16) REPRO_TILE_CASE(2, 32)
  REPRO_TILE_CASE(4, 1) REPRO_TILE_CASE(4, 2) REPRO_TILE_CASE(4, 4)
  REPRO_TILE_CASE(4, 8) REPRO_TILE_CASE(4, 16)
  REPRO_TILE_CASE(8, 1) REPRO_TILE_CASE(8, 2) REPRO_TILE_CASE(8, 4)
  REPRO_TILE_CASE(8, 8)
  REPRO_TILE_CASE(16, 1) REPRO_TILE_CASE(16, 2) REPRO_TILE_CASE(16, 4)
  REPRO_TILE_CASE(32, 1) REPRO_TILE_CASE(32, 2)
  REPRO_TILE_CASE(64, 1)
#undef REPRO_TILE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

#if defined(REPRO_GEMM_BF16)
typedef __nv_bfloat16 ReproElem;
#elif defined(REPRO_GEMM_F32)
typedef float ReproElem;
#else
#error "define one of REPRO_GEMM_BF16, REPRO_GEMM_F32"
#endif
