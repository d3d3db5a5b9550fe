// Grouped (per-expert) GEMM for the MoE experts on Hopper (sm_90a):
// y[e] = x[e] . w[e] for every expert e in one launch.
//
// Replaces the Pallas TPU kernel grouped_gemm_kernel of
// src/repro/kernels/grouped_gemm.py:37 (body _grouped_kernel :23).  That
// kernel walks a (E, C/bc, F/bf, D/bk) grid in order on one core and carries
// its f32 sum across the sequential D axis in a VMEM scratch; Hopper's
// blocks run in parallel and in no order, so here the D loop runs inside
// the block instead: one thread block per (expert, C tile, F tile), with
// blockIdx.z the expert, loops over D and keeps the f32 accumulator in
// registers.  The function is the JAX kernel's: an f32 sum over D, rounded
// once to x's dtype; only the order of the sum differs.
//
// What bounds it on an H100: bytes.  At serving's decode shapes (C = 32:
// max_batch 4 x capacity 8) each call reads every expert's weights once,
// 40 * 1536 * 512 * 2 B = 62.9 MB, for 2 * 40 * 32 * 1536 * 512 = 2.0 GFLOP:
// far below the ~295 flop/byte ridge, so the bound is 18.8 us at 3.35 TB/s.
// What matters is keeping enough weight bytes in flight: about 3.35 TB/s x
// ~1 us of latency, 3.4 MB over 132 SMs, so at least ~25 KB per SM.
//
// bf16 (the served dtype): wgmma fed by TMA, the kernel body of
// wgmma_gemm.cuh (its note gives the ring, the m64nNk16 products and the
// epilogue) instantiated as grouped_wgmma, with
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
//     wgmma_gemm.cuh's layouts: dx = dy.w^T reads w^T's storage (w) as a
//     K-major B, dw = x^T.dy reads x as an MN-major A, whose blocks walk
//     the tiles of every expert persistently (its products are four
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
// kernels/build.py: the bf16 one exports repro_grouped_encode and
// repro_grouped_gemm_wgmma, the f32 one repro_grouped_gemm.

#if defined(REPRO_GEMM_BF16)
#include "wgmma_gemm.cuh"
#else
#include "tile_gemm.cuh"
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
