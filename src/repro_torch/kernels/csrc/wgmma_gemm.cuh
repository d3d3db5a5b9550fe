// The bf16 GEMM on Hopper's tensor cores: wgmma fed by TMA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gemm.py for bf16
// operands:
//   * gemm_k_inner (:56, body _k_inner_kernel :43), output-stationary, the
//     B3A2C0 analogue: one launch, k0 = 0, k1 = K; every block owns one
//     bm x bn tile of C, loops over K inside the block and writes C once.
//   * _k_step_call (:89) driven by gemm_k_outer (:113), C streamed, the
//     C3B2A0/B3C2A0 analogue: one launch per k block [k0, k0 + bk); every
//     block reads its C tile, adds A_k.B_k in f32 and writes C rounded to
//     bf16, the per-pass rounding of ref.gemm_ref_streamed.  The passes are
//     not fused: streaming C once per pass is what the variant is.
// The plan's (bm, bn, bk) stays the thread-block tile, as in tile_gemm.cuh
// (which keeps the f32 builds: the GEMM and the grouped GEMM).  The
// bf16 grouped (MoE expert) GEMM runs the same kernel body with the expert
// as blockIdx.z and rank-3 tensor maps (grouped_gemm.cu gives its design).
// The bf16 flash attention kernel (flash_attention.cu) uses the helpers
// below (mbarriers, TMA loads, descriptors, Wgmma and the register-A form
// WgmmaRS), not the GEMM body; so does the int8 GEMM (wgmma_s8.cuh, with
// WgmmaS8 and encode_map's element types), whose operands are both
// K-major.
//
// What bounds it on an H100.  k-inner at Qwen2-1.5B's shapes (M = 4096,
// K = 1536 or 8960) is bound by operations: 2*M*N*K over the 989 TFLOP/s
// bf16 tensor-core rate, which only wgmma reaches.  At decode (M = 4, the
// served logits GEMM) it is bound by bytes: the (K, N) weight streamed once
// at 3.35 TB/s.  k-outer is bound by its own C stream: C read and written
// once per pass, ceil(K/bk) passes (at the planner's 64x128x128 tile for
// the five Qwen2-1.5B GEMMs about 35.9 GB, 10.7 ms, above torch.matmul by
// the variant's definition).
//
// The design.
//   * Math: wgmma.mma_async m64nNk16, bf16 x bf16 -> f32 in registers.  One
//     consumer warpgroup (128 threads) per 64 x N unit of the tile, N = NW
//     = min(max(bn, 64), 256); a tile of more units than its warpgroups
//     hold (two of N <= 128, one of N = 256, whose 128 accumulators a
//     thread would otherwise spill: bm > 128, or bn >= 256 with bm > 64)
//     runs them in rounds, each round streaming K again.  bm < 64 still issues m64: accumulator rows >= bm
//     are never stored, and the rows they read stay inside the block's
//     shared memory (an over-read pad follows the stages).
//   * Operands as TMA lays them out: A (M, K) row-major is K-major, B (K, N)
//     row-major is MN-major (the transpose bit of the instruction).  Both
//     are staged in 128-byte-swizzled boxes 64 bf16 wide, so a bk = 128
//     slab of A is two boxes per row band and a bn = 128 slab of B two
//     boxes; the descriptors name the same 128-byte swizzle, every box
//     starts on 1024 bytes, and no box dimension exceeds 256.
//   * Loads: one producer warp keeps a ring of `stages` shared-memory slabs
//     in flight with cp.async.bulk.tensor, each completing on a full
//     mbarrier; consumers release a slab on its empty mbarrier once their
//     wgmma on it has retired.  A slab is the plan's bk deep, or a power of
//     two below it when two slabs would not fit in shared memory
//     (kernels/gemm.py:wgmma_config picks the depth and the stage count).
//   * Ragged edges: boxes past M, N or K fill with zero (exact: zero K
//     padding adds nothing), stores past M or N are skipped, so no padded
//     copies.  A box's inner coordinate must fall on 16 bytes (8 bf16):
//     a tile narrower than 8 columns loads B from the 8-aligned column
//     below its own and stores from that offset, and a slab shallower than
//     8 loads from the 8-aligned k below it.  A slab shallower than one k16
//     step (bk < 16) has the columns of A and rows of B outside its own k
//     range zeroed in shared memory before the product.
//   * Epilogue.  C goes through a bm x bn tile in shared memory, swizzled
//     like the operands: the consumers write their rounded sums there and
//     one thread stores the tile by TMA (clipped at M and N).  k-outer's
//     producer first loads the block's C tile by TMA, before the first
//     slab, so the C read overlaps the A and B loads and the product, and
//     the consumers add their accumulators to it in f32 before the one
//     rounding.  Whole-row TMA transfers matter: loading and storing C as
//     each thread's 4-byte fragments (16 bytes of a row per instruction)
//     made a k-outer pass several times slower than streaming the same C
//     once.  The epilogue's addresses come from shifts and masks, and each
//     row's C values are all read before any sum is written back; with
//     per-element divisions it had taken most of a k-outer block's time.
//     C rows that are not 16-byte aligned, or a tile under 8 columns, are
//     read and written directly from the registers instead.
//   * Order: blocks walk M fastest within groups of `group` m tiles
//     (kernels/gemm.py:raster_group picks it), so the B columns a group
//     shares are read from device memory about once per group, not once
//     per m tile.
//
// The host encodes the three tensor maps once per wrapper call
// (repro_gemm_wgmma_encode) and passes them by value to every launch as
// __grid_constant__ parameters; a k-outer pass differs only in k0.
// cuTensorMapEncodeTiled is a driver call, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// TMA takes row strides that are multiples of 16 bytes and 16-byte aligned
// bases; kernels/gemm.py copies an operand that has neither into an
// aligned buffer first (a counted copy in the wrapper, not a kernel).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Internal linkage, as in tile_gemm.cuh: each library keeps its own kernels
// and `configured` flags.
namespace repro {
namespace {

constexpr int kWgmmaMaxSmem = 232448;  // a Hopper block's dynamic limit
constexpr int kBoxCols = 64;           // 64 bf16 = one 128-byte swizzle row
constexpr int kMaxBoxRows = 256;       // TMA's largest box dimension

// The shared-memory layout, for a bm x bn tile and a slab ks deep.  One
// stage: A as ceil(ks/64) bands of bmp x 64 (bmp = max(bm, 8) rows, so a
// band is whole 1024-byte swizzle atoms), then B as max(bn, 64)/64 bands of
// bkp x 64 (bkp = max(ks, 16) rows, one k16 step at least).  After the
// stages: the bm x bn C tile (c_tile: C's rows readable by TMA), the pad
// that an m64 read of a band shorter than 64 rows reaches into, and the
// mbarriers (a full and an empty one per stage, one for the C tile).  The C tile is boxes of
// c_rows x c_cols: 64 columns with the 128-byte swizzle when bm >= 8 and
// bn >= 64 (the epilogue's row-strided accesses then hit distinct banks),
// else min(bn, 256) columns unswizzled.  The base is 1024-byte aligned.
// Mirrored by kernels/gemm.py:wgmma_config.
struct Geom {
  int bmp, nkc, bkp, ncc, a_bytes, b_bytes, stage_bytes, c_rows, c_cols,
      c_rows_log2, c_cols_log2, c_bytes, pad;
  bool c_swizzle;
  __host__ __device__ Geom(int bm, int bn, int ks, bool c_tile) {
    bmp = bm < 8 ? 8 : bm;
    nkc = (ks + kBoxCols - 1) / kBoxCols;
    bkp = ks < 16 ? 16 : ks;
    ncc = (bn < kBoxCols ? kBoxCols : bn) / kBoxCols;
    a_bytes = nkc * bmp * 128;
    b_bytes = ncc * bkp * 128;
    stage_bytes = a_bytes + b_bytes;
    c_swizzle = bm >= 8 && bn >= kBoxCols;
    c_rows = bm < kMaxBoxRows ? bm : kMaxBoxRows;
    c_cols = c_swizzle ? kBoxCols : (bn < kMaxBoxRows ? bn : kMaxBoxRows);
    for (c_rows_log2 = 0; (1 << c_rows_log2) < c_rows; ++c_rows_log2) {
    }
    for (c_cols_log2 = 0; (1 << c_cols_log2) < c_cols; ++c_cols_log2) {
    }
    // rounded up to keep what follows aligned
    c_bytes = c_tile ? (bm * bn * 2 + 127) / 128 * 128 : 0;
    pad = bmp < 64 ? (64 - bmp) * 128 : 0;
  }
  __host__ __device__ int smem(int stages) const {
    return stages * stage_bytes + c_bytes + pad + 16 * stages + 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  No wait in a
// working launch lasts a second; one that lasts 2^34 cycles (about ten
// seconds) is a broken pipeline, and traps, so that the launch fails with
// an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// One box at (c0, c1) of a rank-2 map, or at (c0, c1, e) of a rank-3 map
// (G: the grouped GEMM, e the expert), completing on `bar`.
template <bool G>
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1,
                                         int e) {
  if constexpr (G)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(e) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1) : "memory");
}

// One box at (c0, c1, c2, c3) of a rank-4 map (flash attention's (D, S, H,
// B) operands), completing on `bar`.
__device__ __forceinline__ void tma_load4(const CUtensorMap* map, void* dst,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// The store counterpart of tma_load, in the calling thread's bulk group.
template <bool G>
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int e) {
  if constexpr (G)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(e) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// One m64nNk16 product, D += A.B (D = A.B when scale_d is 0), f32
// accumulators d[0 .. N/2), A K-major from shared memory.  TB = 1: B
// MN-major (the transpose bit; the GEMMs' B, (K, N) row-major); TB = 0: B
// K-major (flash attention's k tile, whose rows are contiguous in the
// product's depth).
template <int N, int TB = 1> struct Wgmma;

template <int TB>
struct Wgmma<64, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<128, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<256, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

// The same product with A from registers (the RS form): a[0..3] hold the
// thread's bf16 pairs of the 64 x 16 A slice in the accumulator layout of a
// 64 x 16 tile (rows 16*warp + lane/4 (+ 8), columns 2*(lane%4) (+ 8)); B
// MN-major.  Flash attention feeds its probabilities this way.
template <int N> struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The 8-bit product, m64nNk32 s8 x s8 -> s32, D += A.B (D = A.B when
// scale_d is 0), int accumulators d[0 .. N/2) in the layout of Wgmma's.
// Both operands K-major from shared memory: the instruction has no transpose
// for 8-bit types, so the int8 GEMM (wgmma_s8.cuh) stages B transposed.  No
// .satfinite: the sum wraps in int32, as the JAX kernel's int32 accumulator
// does.  One k32 step is 32 bytes, as bf16's k16 step.
template <int N> struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int* d, uint64_t da, uint64_t db,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int* d, uint64_t da, uint64_t db,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ __forceinline__ static void mma(int* d, uint64_t da, uint64_t db,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
          "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
          "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
          "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// C[i0:i0+bm, j0:j0+bn] (+)= A[i0:, k0:k1] . B[k0:k1, j0:] for the tile of
// this block, in slabs ks deep.  NW: the instruction's N; W: consumer
// warpgroups (warps 0 .. 4W-1); warp 4W is the producer.  Cin, when not
// null, is added before the one rounding to Cout; it is Cout (k-outer
// updates C in place).  tma_c: C goes through the block's C tile in shared
// memory, loaded (k-outer) and stored by TMA on map_c; else each thread
// reads and writes its own elements of C directly.  G: the grouped GEMM,
// one product per expert e = blockIdx.z: the maps are rank 3 with e their
// outer coordinate, so every box fills and clips at its own expert's
// edges, and a direct store of C starts c_plane elements per expert in.
template <int NW, int W, bool G>
__device__ __forceinline__ void wgmma_tiles(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const CUtensorMap& map_c, const __nv_bfloat16* Cin,
    __nv_bfloat16* Cout, int M, int N, int k0, int k1, int64_t ldc,
    int64_t c_plane, int bm, int bn, int ks, int stages, int gm, int gn,
    int group, int tma_c, int pairs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Geom g(bm, bn, ks, tma_c);
  const int e = G ? static_cast<int>(blockIdx.z) : 0;
  unsigned char* ctile = smem + stages * g.stage_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ctile + g.c_bytes + g.pad);
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
  const int units_n = (bn < kBoxCols ? kBoxCols : bn) / NW;
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
      mbar_expect_tx(cbar, bm * bn * 2);
      for (int m = 0; m < bm; m += g.c_rows)
        for (int n = 0; n < bn; n += g.c_cols)
          tma_load<G>(&map_c, ctile + (m * bn + n * g.c_rows) * 2, cbar,
                      j0 + n, i0 + m, e);
    }
    int stage = 0, phase = 0;
    for (int r = 0; r < rounds; ++r) {
      for (int p = 0; p < pieces; ++p) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * g.stage_bytes;
        mbar_expect_tx(&full[stage], g.stage_bytes);
        const int kk = (k0 + p * ks) & ~7;
        for (int c = 0; c < g.nkc; ++c)
          for (int m = 0; m < g.bmp; m += kMaxBoxRows)
            tma_load<G>(&map_a, st + (c * g.bmp + m) * 128, &full[stage],
                        kk + c * kBoxCols, i0 + m, e);
        for (int c = 0; c < g.ncc; ++c)
          for (int k = 0; k < g.bkp; k += kMaxBoxRows)
            tma_load<G>(&map_b, st + g.a_bytes + (c * g.bkp + k) * 128,
                        &full[stage], (j0 & ~7) + c * kBoxCols, kk + k, e);
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
  const int k16 = (ks + 15) / 16;
  int stage = 0, phase = 0;
  for (int r = 0; r < rounds; ++r) {
    const int u = r * W + wg;
    const bool active = u < units;
    const int um = u / units_n, un = u % units_n;
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;

    for (int p = 0; p < pieces; ++p) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * g.stage_bytes;
      if (ks < 16) {
        // a slab shallower than one k16 step: zero A's columns and B's
        // rows outside [lo, hi), which hold the neighbouring slabs' values
        const int lo = (k0 + p * ks) & 7;
        const int hi = lo + min(ks, k1 - (k0 + p * ks));
        for (int e = t; e < g.bmp * 16; e += 128) {
          const int row = e / 16, col = e % 16;
          if (col < lo || col >= hi)
            *reinterpret_cast<__nv_bfloat16*>(
                st + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
                (col & 7) * 2) = __float2bfloat16(0.0f);
        }
        for (int e = t; e < g.ncc * 16 * 64; e += 128) {
          const int c = e / (16 * 64), row = e / 64 % 16;
          if (row < lo || row >= hi)
            reinterpret_cast<__nv_bfloat16*>(
                st + g.a_bytes + (c * g.bkp + row) * 128)[e % 64] =
                __float2bfloat16(0.0f);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      if (active) {
        const uint32_t a0 = smem_u32(st) + um * 64 * 128;
        const uint32_t b0 =
            smem_u32(st) + g.a_bytes + un * (NW / kBoxCols) * g.bkp * 128;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kt = 0; kt < k16; ++kt) {
          // A: band kt/4, 32 bytes (16 columns) per k16 step inside it;
          // B: 16 rows of 128 bytes per k16 step, bands bkp * 128 apart
          const uint64_t da = sw128_desc(
              a0 + (kt / 4) * g.bmp * 128 + (kt % 4) * 32, 16, 1024);
          const uint64_t db =
              sw128_desc(b0 + kt * 16 * 128, g.bkp * 128, 1024);
          Wgmma<NW>::mma(acc, da, db);
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
    // 8j + 2*(t%4) (+ 1) of the 64 x NW unit, which starts j0 % 8 columns
    // before the tile when bn < 8.  Addresses come from one row pointer or
    // offset per row and shifts and masks per column step (every size here
    // is a power of two): per-element divisions and 64-bit products had
    // cost a k-outer block most of its time.
    const int row_l = um * 64 + 16 * (t / 32) + (t % 32) / 4;
    const int col_l = un * NW + 2 * (t % 4) - (j0 & 7);
    if (tma_c && Cin != nullptr && r == 0) mbar_wait(cbar, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = row_l + 8 * h;
      if (rl >= bm) continue;
      if (tma_c) {
        // the C tile in shared memory (see Geom); TMA stores only what
        // lies inside C.  k-outer reads the row's C values first, all
        // loads in flight together, then writes the sums.
        const int br = rl & (g.c_rows - 1);
        unsigned char* rowp =
            ctile + (rl >> g.c_rows_log2) * g.c_rows * bn * 2 +
            (g.c_swizzle ? br * 128 : br * g.c_cols * 2);
        int off[NW / 8];
        __nv_bfloat162 cv[NW / 8];
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int bc = (col_l + 8 * j) & (g.c_cols - 1);
          off[j] = ((col_l + 8 * j) >> g.c_cols_log2) * g.c_rows * g.c_cols *
                       2 +
                   (g.c_swizzle ? (((bc >> 3) ^ (br & 7)) << 4) + (bc & 7) * 2
                                : bc * 2);
          cv[j] = Cin != nullptr && col_l + 8 * j < bn
                      ? *reinterpret_cast<const __nv_bfloat162*>(rowp + off[j])
                      : __floats2bfloat162_rn(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          if (col_l + 8 * j >= bn) continue;
          const float2 c2 = __bfloat1622float2(cv[j]);
          *reinterpret_cast<__nv_bfloat162*>(rowp + off[j]) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] + c2.x,
                                    acc[4 * j + 2 * h + 1] + c2.y);
        }
        continue;
      }
      const int row = i0 + rl;
      if (row >= M) continue;
      // Cin, when given, is Cout
      __nv_bfloat16* crow =
          Cout + e * c_plane + static_cast<int64_t>(row) * ldc + j0;
      const int cend = min(bn, N - j0);  // columns inside the tile and C
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int cl = col_l + 8 * j;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const bool in0 = cl >= 0 && cl < cend;
        const bool in1 = cl + 1 >= 0 && cl + 1 < cend;
        if (pairs && in1) {
          __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(crow + cl);
          if (Cin != nullptr) {
            const float2 c2 = __bfloat1622float2(*at);
            v0 += c2.x;
            v1 += c2.y;
          }
          *at = __floats2bfloat162_rn(v0, v1);
        } else {
          if (in0) {
            if (Cin != nullptr) v0 += __bfloat162float(crow[cl]);
            crow[cl] = __float2bfloat16(v0);
          }
          if (in1) {
            if (Cin != nullptr) v1 += __bfloat162float(crow[cl + 1]);
            crow[cl + 1] = __float2bfloat16(v1);
          }
        }
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
      tma_store<G>(&map_c, ctile + (m * bn + n * g.c_rows) * 2, j0 + n,
                   i0 + m, e);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The GEMM (k-inner, or one k-outer pass) and the grouped GEMM: the same
// body, two kernels, so that a profile tells them apart.  One warpgroup
// with N <= 128 keeps its registers to what three blocks per SM allow, so
// that short-lived blocks (k-outer's passes, the grouped GEMM's) overlap;
// wider or two-warpgroup tiles need every register a block can have.
#define REPRO_WGMMA_KERNEL(NAME, G_)                                         \
  template <int NW, int W>                                                   \
  __global__ void __launch_bounds__(W * 128 + 32,                            \
                                    W == 1 && NW <= 128 ? 3 : 1)             \
  NAME(const __grid_constant__ CUtensorMap map_a,                            \
       const __grid_constant__ CUtensorMap map_b,                            \
       const __grid_constant__ CUtensorMap map_c,                            \
       const __nv_bfloat16* Cin, __nv_bfloat16* Cout, int M, int N, int k0,  \
       int k1, int64_t ldc, int64_t c_plane, int bm, int bn, int ks,         \
       int stages, int gm, int gn, int group, int tma_c, int pairs) {        \
    wgmma_tiles<NW, W, G_>(map_a, map_b, map_c, Cin, Cout, M, N, k0, k1,     \
                           ldc, c_plane, bm, bn, ks, stages, gm, gn, group,  \
                           tma_c, pairs);                                    \
  }
REPRO_WGMMA_KERNEL(wgmma_gemm, false)
REPRO_WGMMA_KERNEL(grouped_wgmma, true)
#undef REPRO_WGMMA_KERNEL

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Errors of cuTensorMapEncodeTiled come back as kDriverErrorBase + CUresult.
constexpr int kDriverErrorBase = 100000;

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix with row stride ld, in boxes of
// box_cols x box_rows, zero fill past the extent; elements of `type`,
// `size` bytes each (bf16 unless said otherwise; the int8 GEMM's operands
// are UINT8, raw bytes, whose zero fill is exact, and its C is INT32).
// With depth > 0: a stack of `depth` such matrices `plane` elements apart,
// as a rank-3 map whose boxes are one matrix deep, so that a box fills and
// clips at its own matrix's edges (the grouped GEMM's experts).
int encode_map(CUtensorMap* map, const void* base, int rows, int cols,
               int64_t ld, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle, int depth = 0,
               int64_t plane = 0,
               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               int size = 2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * size,
                                 static_cast<cuuint64_t>(plane) * size};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type,
                        depth > 0 ? 3 : 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + static_cast<int>(r);
}

// Whether C, of `size`-byte elements (bf16 unless said otherwise), goes
// through shared memory and TMA: 16-byte rows and base, and a tile at
// least 16 bytes wide.
bool tma_c_ok(const void* C, int64_t ldc, int bn, int size = 2) {
  return C != nullptr && bn * size >= 16 && ldc * size % 16 == 0 &&
         reinterpret_cast<uintptr_t>(C) % 16 == 0;
}

int wgmma_encode(const void* A, const void* B, const void* C, int M, int N,
                 int K, int64_t lda, int64_t ldb, int64_t ldc, int bm, int bn,
                 int ks, void* maps) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || ks <= 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) %
          16 != 0 || lda % 8 != 0 || ldb % 8 != 0)
    return cudaErrorMisalignedAddress;
  const Geom g(bm, bn, ks, tma_c_ok(C, ldc, bn));
  alignas(64) CUtensorMap m[3];
  memset(m, 0, sizeof(m));
  int e = encode_map(&m[0], A, M, K, lda, kBoxCols,
                     g.bmp < kMaxBoxRows ? g.bmp : kMaxBoxRows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = encode_map(&m[1], B, K, N, ldb, kBoxCols,
                   g.bkp < kMaxBoxRows ? g.bkp : kMaxBoxRows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0 && tma_c_ok(C, ldc, bn))
    e = encode_map(&m[2], C, M, N, ldc, g.c_cols, g.c_rows,
                   g.c_swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0) memcpy(maps, m, sizeof(m));
  return e;
}

template <int NW, int W, bool G>
int launch_wgmma(const CUtensorMap* m, const __nv_bfloat16* cin,
                 __nv_bfloat16* cout, int M, int N, int k0, int k1,
                 int64_t ldc, int64_t c_plane, int bm, int bn, int ks,
                 int stages, int gm, int gn, int group, int tma_c, int pairs,
                 dim3 grid, int smem, cudaStream_t stream) {
  // only the kernel this library launches is instantiated
  auto* kernel = [] {
    if constexpr (G)
      return grouped_wgmma<NW, W>;
    else
      return wgmma_gemm<NW, W>;
  }();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaMaxSmem);
    // the grouped GEMM's blocks are sized to share an SM (see
    // grouped_gemm.cu): ask for all of its memory as shared memory
    if (e == cudaSuccess && G)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<grid, W * 128 + 32, smem, stream>>>(
      m[0], m[1], m[2], cin, cout, M, N, k0, k1, ldc, c_plane, bm, bn, ks,
      stages, gm, gn, group, tma_c, pairs);
  return cudaGetLastError();
}

// One launch over the (M/bm) x (N/bn) tiles of each of `experts` products
// (G: the grouped GEMM, rank-3 maps, the expert on blockIdx.z; else one
// product) for K in [k0, k1), on the maps m[0..2] (m[2] read only when
// tma_c).  The caller (kernels/gemm.py:wgmma_config, or
// kernels/grouped_gemm.py:grouped_config) picks ks and stages and refuses
// what does not fit first.
template <bool G>
int launch_tiles(const CUtensorMap* m, const void* Cin, void* Cout, int M,
                 int N, int K, int64_t ldc, int64_t c_plane, int experts,
                 int k0, int k1, int bm, int bn, int ks, int stages,
                 int group, int tma_c, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k0 < 0 || k1 <= k0 || k1 > K ||
      stages < 1 || group < 1 || bm <= 0 || bn <= 0 || ks <= 0 ||
      (bm & (bm - 1)) || (bn & (bn - 1)) || (ks & (ks - 1)) ||
      (Cin != nullptr && Cin != Cout) || experts < 1 || experts > 65535 ||
      (G && Cin != nullptr))
    return cudaErrorInvalidValue;
  const Geom g(bm, bn, ks, tma_c);
  const int smem = g.smem(stages);
  if (smem > kWgmmaMaxSmem) return cudaErrorInvalidValue;
  const int64_t gm = (static_cast<int64_t>(M) + bm - 1) / bm;
  const int64_t gn = (static_cast<int64_t>(N) + bn - 1) / bn;
  if (gm * gn > 2147483647LL) return cudaErrorInvalidValue;
  if (group > gm) group = static_cast<int>(gm);
  if (group * gn > 2147483647LL) group = 1;
  // bf16 pairs (4-byte stores) need even columns at 4-byte addresses
  const int pairs = bn >= 8 && ldc % 2 == 0 && c_plane % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(Cout) % 4 == 0;
  const auto* cin = static_cast<const __nv_bfloat16*>(Cin);
  auto* cout = static_cast<__nv_bfloat16*>(Cout);
  const int nw = bn <= 64 ? 64 : (bn >= 256 ? 256 : bn);
  const int units = (g.bmp + 63) / 64 * ((bn < 64 ? 64 : bn) / nw);
  // two warpgroups of N = 256 would spill (kernels/gemm.py:wgmma_config)
  const int w = units < 2 || nw == 256 ? 1 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(gm * gn), 1,
                  static_cast<unsigned>(experts));
#define REPRO_WGMMA_CASE(NW_, W_)                                            \
  if (nw == NW_ && w == W_)                                                  \
    return launch_wgmma<NW_, W_, G>(m, cin, cout, M, N, k0, k1, ldc,        \
                                    c_plane, bm, bn, ks, stages,             \
                                    static_cast<int>(gm),                    \
                                    static_cast<int>(gn), group, tma_c,      \
                                    pairs, grid, smem, s);
  REPRO_WGMMA_CASE(64, 1) REPRO_WGMMA_CASE(64, 2)
  REPRO_WGMMA_CASE(128, 1) REPRO_WGMMA_CASE(128, 2)
  REPRO_WGMMA_CASE(256, 1)
#undef REPRO_WGMMA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
