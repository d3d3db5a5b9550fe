// Tiled GEMM kernels for Hopper (sm_90a): the two loop orders the planner
// chooses between, with the plan's (bm, bn, bk) as the thread-block tile.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gemm.py:
//   * gemm_k_inner (:56, body _k_inner_kernel :43): output-stationary, k
//     innermost, the B3A2C0 analogue.  Here: one launch; every block owns one
//     (bm, bn) tile of C, loops over K in bk slabs staged through shared
//     memory, keeps the f32 (int32 for int8) accumulator in registers and
//     writes C once.
//   * _k_step_call (:89, body _k_step_kernel :82), driven by gemm_k_outer
//     (:113): C streamed, the C3B2A0/B3C2A0 analogue.  Here: the same kernel
//     run once per k block with K = bk and C passed as its input; each block
//     reads its C tile, adds its A_k.B_k in f32 (int32) and writes C back
//     rounded to C's dtype: the per-pass rounding of ref.gemm_ref_streamed.
//
// What bounds it on an H100: at the planner's tiles the products are far
// above the card's ridge point (about 295 flop per byte in bf16), so the
// bound is arithmetic.  This first version multiplies on the CUDA cores
// (FP32 FMA, exact int32 multiply-add; no tensor cores, no TF32), so it runs
// against the 67 TFLOP/s FP32 rate, not the 989 TFLOP/s bf16 tensor-core
// rate; wgmma and TMA are later work.  Its design keeps the CUDA cores fed:
// each thread owns an RM x RN register tile of C, so one k step costs RM + RN
// shared-memory reads for RM * RN multiply-adds; a warp reads one A value
// (broadcast) and 32 consecutive B values (no bank conflicts).
//
// Ragged edges are masked: loads outside A or B read zero (zero K padding is
// exact) and stores outside C are skipped, so any (M, N, K) runs on the
// plan's tile without padded copies.
//
// The tile kernel itself is tile_gemm.cuh's (shared with grouped_gemm.cu);
// this file is its plain-GEMM entry point, one group.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_GEMM_<BF16|F32|INT8> gemm.cu
// One shared library per element type, each exporting the same plain C
// interface (repro_gemm_tile), loaded with ctypes by kernels/build.py.

#include "tile_gemm.cuh"

extern "C" {

// C = A.B (Cin null) or C = round(Cin + A.B) over an M x N x K problem with
// row-major strides lda/ldb/ldc, on a bm x bn x bk thread-block tile.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int repro_gemm_tile(const void* A, const void* B, const void* Cin, void* Cout,
                    int M, int N, int K, int64_t lda, int64_t ldb, int64_t ldc,
                    int bm, int bn, int bk, void* stream) {
  return repro::gemm_tile_groups<ReproElem>(A, B, Cin, Cout, M, N, K, lda,
                                            ldb, ldc, 1, 0, 0, 0, bm, bn, bk,
                                            stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
