// Grouped (per-expert) GEMM for the MoE experts on Hopper (sm_90a):
// y[e] = x[e] . w[e] for every expert e in one launch.
//
// Replaces the Pallas TPU kernel grouped_gemm_kernel of
// src/repro/kernels/grouped_gemm.py:37 (body _grouped_kernel :23).  That
// kernel walks a (E, C/bc, F/bf, D/bk) grid in order on one core and carries
// its f32 sum across the sequential D axis in a VMEM scratch; Hopper's
// blocks run in parallel and in no order, so here the D loop runs inside
// the block instead: one thread block per (expert, C tile, F tile), with
// blockIdx.z the expert, loops over D in bk slabs staged through shared
// memory and keeps the f32 accumulator in registers.  That is
// tile_gemm.cuh's kernel with a per-expert offset on x, w and y.  The
// function is the JAX kernel's: an f32 sum over D, rounded once to x's
// dtype; only the order of the sum differs.
//
// Tile: the JAX default 128/128/512 stages (128*512 + 512*128) * 2 B =
// 262,144 B of shared memory in bf16, over the 232,448 B a Hopper block may
// claim.  kernels/grouped_gemm.py picks bc = the smallest power of two
// >= min(C, 128), bf = 128 and bk = 256 (bf16) or 128 (f32): at most
// 131,072 B.
//
// What bounds it on an H100: at serving's decode shapes (C = 8 slots per
// sequence) each call reads every expert's weights once, 40 * 1536 * 512 *
// 2 B = 62.9 MB, for 2 * 40 * 32 * 1536 * 512 = 2.0 GFLOP: far below the
// ~295 flop/byte ridge, so the bound is bytes (18.8 us at 3.35 TB/s).  This
// first version stages the weights through shared memory with scalar loads
// and multiplies on the CUDA cores; vectorised TMA loads and wgmma are later
// work.
//
// Ragged edges (C any multiple of 8, F and D not multiples of the tile) are
// masked: zero loads, skipped stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_GEMM_<BF16|F32> grouped_gemm.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py.

#include "tile_gemm.cuh"

extern "C" {

// y (E, C, F) = x (E, C, D) . w (E, D, F), all contiguous row-major, on a
// bc x bf x bk thread-block tile.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int repro_grouped_gemm(const void* x, const void* w, void* y, int E, int C,
                       int D, int F, int bc, int bf, int bk, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0) return cudaErrorInvalidValue;
  const int64_t sx = static_cast<int64_t>(C) * D;
  const int64_t sw = static_cast<int64_t>(D) * F;
  const int64_t sy = static_cast<int64_t>(C) * F;
  return repro::gemm_tile_groups<ReproElem>(x, w, nullptr, y, C, F, D, D, F,
                                            F, E, sx, sw, sy, bc, bf, bk,
                                            stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
