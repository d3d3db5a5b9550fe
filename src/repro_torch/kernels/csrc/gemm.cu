// Tiled GEMM kernels for Hopper (sm_90a): the two loop orders the planner
// chooses between, with the plan's (bm, bn, bk) as the thread-block tile.
//
// bf16 runs on the tensor cores (wgmma fed by TMA, wgmma_gemm.cuh), and so
// does int8 (wgmma s8 -> s32 on a K-major copy of B, wgmma_s8.cuh); each
// header's note gives its design and what bounds it.  f32 runs on the CUDA
// cores (tile_gemm.cuh), as described below.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gemm.py:
//   * gemm_k_inner (:56, body _k_inner_kernel :43): output-stationary, k
//     innermost, the B3A2C0 analogue.  Here: one launch; every block owns one
//     (bm, bn) tile of C, loops over K in bk slabs staged through shared
//     memory, keeps the f32 (int32 for int8) accumulator in registers and
//     writes C once.
//   * _k_step_call (:89, body _k_step_kernel :82), driven by gemm_k_outer
//     (:113): C streamed, the C3B2A0/B3C2A0 analogue.  Here: the same kernel
//     run once per k block; each block reads its C tile, adds its A_k.B_k in
//     f32 (int32) and writes C back rounded to C's dtype: the per-pass
//     rounding of ref.gemm_ref_streamed.
//
// What bounds the f32 build on an H100: at the planner's tiles the products
// are far above the card's ridge point, so the bound is arithmetic, the
// 67 TFLOP/s FP32 rate of the CUDA cores (FFMA only; TF32 would not compute
// the f32 function).  tile_gemm.cuh's note gives the design that keeps them
// fed: register tiles read as LDS.128 fragments from A's and B's sub-slabs,
// a cp.async ring of sub-slabs ks deep inside the plan's bk, and blocks
// walked M fastest in raster groups.  Ragged edges
// are masked inside the kernel (loads past M, N or k1 read zero, stores
// past M or N are skipped), so any (M, N, K) runs on the plan's tile
// without padded copies.  This file is its plain-GEMM entry point, one
// group; k-outer passes [k0, k1) to each launch instead of offset operands.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_GEMM_<BF16|F32|INT8> gemm.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py: the bf16 one exports repro_gemm_wgmma_encode and
// repro_gemm_wgmma, the int8 one repro_gemm_s8_encode, repro_gemm_s8 and
// repro_transpose_s8, the f32 one repro_gemm_tile.

#if defined(REPRO_GEMM_BF16)
#include "wgmma_gemm.cuh"
#elif defined(REPRO_GEMM_INT8)
#include "wgmma_s8.cuh"
#else
#include "tile_gemm.cuh"
#endif

extern "C" {

#if defined(REPRO_GEMM_BF16)

// Encode the tensor maps of A (M, K), B (K, N) and C (M, N), bf16, for a
// bm x bn tile staged ks deep, in the layout (ta, tb) (the instruction's
// transpose bits): ta = 0, A row-major with row stride lda; ta = 1, A read
// in place as A^T's row-major storage (K, M), row stride lda (A is the
// .t() of a row-major matrix); tb = 1, B row-major with row stride ldb;
// tb = 0, B read as B^T's storage (N, K).  C is row-major with row stride
// ldc.  Writes three CUtensorMap (384 bytes) to `maps`.  A's and B's stored
// rows need a multiple of 8 elements and 16-byte aligned bases; C's map is
// left empty when C has neither (the kernel then writes C directly).
// Returns 0, a CUDA error code, or 100000 + the CUresult of
// cuTensorMapEncodeTiled.
int repro_gemm_wgmma_encode(const void* A, const void* B, const void* C,
                            int M, int N, int K, int64_t lda, int64_t ldb,
                            int64_t ldc, int bm, int bn, int ks, int ta,
                            int tb, void* maps) {
  return repro::wgmma_encode(A, B, C, M, N, K, lda, ldb, ldc, bm, bn, ks, ta,
                             tb, maps);
}

// Cout = Cin + A[:, k0:k1] . B[k0:k1, :] (Cin null, or Cout) over the
// bm x bn tiles, in slabs ks deep through `stages` shared-memory stages, on
// the maps of repro_gemm_wgmma_encode for the same layout (ta, tb); blocks
// walk M fastest within groups of `group` m tiles, and an MN-major A's
// k-inner launch walks them persistently.  The layouts taken:
// (0, 1), (1, 1) and (0, 0).  k-inner is one call over [0, K); k-outer one
// call per k block with Cin = Cout.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int repro_gemm_wgmma(const void* maps, const void* Cin, void* Cout, int M,
                     int N, int K, int64_t ldc, int k0, int k1, int bm,
                     int bn, int ks, int stages, int group, int ta, int tb,
                     void* stream) {
  alignas(64) CUtensorMap m[3];
  memcpy(m, maps, sizeof(m));
  return repro::launch_tiles<false>(m, Cin, Cout, M, N, K, ldc, 0, 1, k0, k1,
                                    bm, bn, ks, stages, group,
                                    repro::tma_c_ok(Cout, ldc, bn), ta, tb,
                                    stream);
}

#elif defined(REPRO_GEMM_INT8)

// Encode the tensor maps of A (M, K) int8 row-major with row stride lda,
// Bt (N, K) int8, B transposed (repro_transpose_s8), with row stride ldbt,
// and C (M, N) int32 with row stride ldc, for a bm x bn tile staged ks
// deep; writes three CUtensorMap (384 bytes) to `maps`.  A and Bt need
// rows of a multiple of 16 bytes and 16-byte aligned bases; C's map is left
// empty when C has neither (the kernel then writes C directly).  Returns 0,
// a CUDA error code, or 100000 + the driver's CUresult.
int repro_gemm_s8_encode(const void* A, const void* Bt, const void* C, int M,
                         int N, int K, int64_t lda, int64_t ldbt, int64_t ldc,
                         int bm, int bn, int ks, void* maps) {
  return repro::s8_encode(A, Bt, C, M, N, K, lda, ldbt, ldc, bm, bn, ks,
                          maps);
}

// Cout = Cin + A[:, k0:k1] . B[k0:k1, :] (Cin null, or Cout) in int32 over
// the bm x bn tiles, in slabs ks deep through `stages` shared-memory
// stages, on the maps of repro_gemm_s8_encode; blocks walk M fastest
// within groups of `group` m tiles.  k-inner is one call over [0, K);
// k-outer one call per k block with Cin = Cout.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int repro_gemm_s8(const void* maps, const void* Cin, void* Cout, int M, int N,
                  int K, int64_t ldc, int k0, int k1, int bm, int bn, int ks,
                  int stages, int group, void* stream) {
  alignas(64) CUtensorMap m[3];
  memcpy(m, maps, sizeof(m));
  return repro::launch_s8(m, Cin, Cout, M, N, K, ldc, k0, k1, bm, bn, ks,
                          stages, group, stream);
}

// Bt (N, K) = B (K, N)^T, int8, B's rows ldb bytes apart and Bt's ldbt
// (a multiple of 16, at least K rounded up to 16); Bt's columns K .. up to
// that rounding are zeroed.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int repro_transpose_s8(const void* B, void* Bt, int K, int N, int64_t ldb,
                       int64_t ldbt, void* stream) {
  return repro::transpose_s8_launch(B, Bt, K, N, ldb, ldbt, stream);
}

#else

// Cout = (Cin +) A[:, k0:k1] . B[k0:k1, :] in f32 over an M x N product
// (Cin null, or Cout), row-major strides lda/ldb/ldc, on a bm x bn x bk
// tile; blocks walk M fastest within groups of `group` m tiles.  k-inner is
// one call over [0, K); k-outer one call per k block with Cin = Cout.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int repro_gemm_tile(const void* A, const void* B, const void* Cin, void* Cout,
                    int M, int N, int k0, int k1, int64_t lda, int64_t ldb,
                    int64_t ldc, int bm, int bn, int bk, int group,
                    void* stream) {
  return repro::gemm_tile_groups(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(Cin), static_cast<float*>(Cout), M, N, k0,
      k1, lda, ldb, ldc, 1, 0, 0, 0, bm, bn, bk, group, stream);
}

#endif

const char* repro_cuda_error_string(int code) {
#if defined(REPRO_GEMM_BF16) || defined(REPRO_GEMM_INT8)
  if (code >= repro::kDriverErrorBase)
    return "cuTensorMapEncodeTiled failed (driver CUresult = code - 100000)";
#endif
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
