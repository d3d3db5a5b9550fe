// Flash attention forward on Hopper (sm_90a): causal or full softmax
// attention over q, k, v of shape (B, S, H, D), online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention.py:68 (body _flash_kernel :29).  The
// function is that kernel's: scores scaled by D**-0.5; the causal mask keeps
// key j for query i when j <= i, on absolute positions from 0 (top-left
// aligned, also when Skv != S), and fills the rest with -1e30, not -inf; the
// running max m, sum l and f32 accumulator update once per key block; the
// output is acc / max(l, 1e-30) cast to q's type.
//
// Block independence.  The Pallas grid is (B*H, S/bq, Skv/bk) with the key
// axis sequential ("arbitrary"), carrying m, l and acc across grid steps in
// VMEM.  Hopper's blocks run in parallel and in no order, so here one
// thread block owns one (batch*head, query tile) and loops over the keys
// itself; m, l and acc live in registers.  With causal on, the key loop
// stops after the block that holds the tile's last query: every later key
// is masked for every row of the tile, and such a block would give p = 0
// and corr = 1, so skipping it is exact.
//
// Head dims.  Each route is compiled for a few widths D and takes the true
// head dim d <= D at run time (the smallest width that holds it): bf16 64,
// 128 and 256, f32 64, 128, 160, 192 and 256; columns past d read zero,
// which adds nothing to q.k, stores past d are skipped, and the scale is
// d**-0.5 of the true d.
//
// What bounds it on an H100: at the served prefill (S = 32) it moves a few
// hundred KB and is bound by bytes and launch latency; from S of a few
// hundred on, the 4*B*H*D*(visible pairs) operations dominate (at
// S = 4096, 24 heads, D = 64: 51.6 GFLOP against 50 MB), so the bound is
// operations: 989 TFLOP/s in bf16, which only the tensor cores reach, and
// 67 TFLOP/s in f32.  Both designs keep the S x Skv scores out of device
// memory (bytes O(S*D), not O(S^2)) and halve the causal work by the early
// stop.  Each element type has its own kernel (one library each):
//
// f32: the CUDA cores (flash_fwd below).  TF32 would not compute the f32
// function at the JAX tests' 1e-5, so f32 multiplies in FP32 FMA: every
// step is two small GEMMs, S = q.k^T over the head dim and O += p.v over the
// step's 64 keys, register-tiled like the f32 GEMM (tile_gemm.cuh).  q is
// scaled by d**-0.5 in f32 before the q.k product, as in the JAX kernel.
//   Threads.  128 threads (four warps) form a 16 x 8 grid; thread (ty, tx)
//   owns query rows ty + 16 i (i < RM), the step's keys tx + 8 j (j < 8)
//   and output columns 32 c + 4 tx + e.  A block is 16 RM query rows: RM = 4
//   (64 rows), or 2 (32 rows) where 64-row tiles would give fewer than two
//   blocks an SM (f32_rows: few heads at a few thousand positions, where
//   the causal tiles' unequal lengths leave SMs idle).  The softmax's rows
//   are the output's rows, so its max and rescale stay in registers: a
//   row's eight threads are eight lanes of one warp and combine their max
//   by three xor shuffles; l is kept per thread and summed at the end.
//   Products.  Every operand fetch is an LDS.128 of four consecutive
//   floats: per four head-dim columns, RM loads of q and 8 of k feed 32 RM
//   FFMA of the scores; per four keys, RM loads of p, then per key W / 32
//   loads of v feed 4 RM W / 32 FFMA of the output.  The next fragment
//   loads while this one multiplies.  q (rows of W + 4 floats) and K (rows
//   of 36) are read row-major along the head dim; rows start four banks
//   apart, so each load of a warp (four rows of q, eight keys of K) is free
//   of bank conflicts.  p goes through shared memory once a step (rows of
//   72 floats: a warp's scalar stores and LDS.128 both conflict-free); v
//   rows are read 128 contiguous bytes a warp.
//   Stream.  q is loaded once.  K and V stream through a ring of three
//   9,216-byte slots filled by cp.async: each step is W / 32 pieces of K
//   (64 keys x 32 columns), then pieces of V (the largest power of two of
//   keys, VS, whose rows of W fit a slot: 32 at W = 64, 16 at 128, 8
//   above), so two pieces are in flight while one multiplies, with one
//   __syncthreads a piece.  Copies are 16 bytes where every operand's base
//   and (batch, sequence, head) strides allow (an instantiation of their
//   own), else 4 bytes; the source size cuts each at Skv and at d, so what
//   lies past them lands as zero and S, Skv and d need not divide a tile.
//   Shared memory is q + p + the ring: 63,488 B at W = 64 to 112,640 B at
//   W = 256 for 64 rows, so two blocks share an SM at every width
//   (kernels/flash_attention.py:f32_config mirrors the numbers); ptxas
//   holds each instantiation under 255 registers without spilling.
//   Softmax.  exp(s - m) as exp2(s log2e - m log2e), one FFMA and one MUFU
//   op a score; the mask is applied only on a step that straddles the
//   diagonal or Skv, and the key loop stops at the diagonal.
//   Order.  The query tiles run longest first (blockIdx.x counts down the
//   tiles, heads fastest), as in the bf16 kernel: ceil(S / rows) * B * H
//   blocks, at most 2^31 - 1.
//
// bf16: the tensor cores, wgmma fed by TMA (flash_wgmma below; the TMA,
// mbarrier, descriptor and Wgmma helpers are wgmma_gemm.cuh's).
//   Tile.  One producer warpgroup, of which one thread issues every TMA
//   load, and NC consumer warpgroups of 64 query rows each (a block's
//   BQ = 64 * NC rows), one block per SM.  A consumer holds its 64 x BK
//   scores, their bf16 copy and its 64 x D accumulator in registers.
//   With NC = 2 ptxas gives each of the 384 threads 168 registers
//   (setmaxnreg did not raise that budget in the measured toolkit, 12.9):
//   D = 64 fits at BK = 128, D = 128 at BK = 64 (at BK = 128 it spilled
//   and ptxas serialized its wgmmas, C7512); the 256-wide accumulator (128
//   registers alone) spilled, so D = 256 runs NC = 1 (256 threads, up to
//   255 registers) at BK = 64.  The producer
//   loads the block's q tile once, then K and V through a ring of three
//   shared-memory slots on full and empty mbarriers, as the GEMM does.
//   Shared memory is q + 3 * (K + V), in 128-byte-swizzled boxes 64
//   columns wide: 112 KB at D = 64, 128 KB at D = 128, 224 KB at D = 256
//   (kernels/flash_attention.py:wgmma_config owns the numbers).
//   Pipeline.  Each consumer overlaps step j's softmax (CUDA cores, MUFU)
//   with step j-1's p.v (tensor cores): q.k^T of step j is issued and
//   waited for, p.v of step j-1 is issued and left in flight while the
//   softmax of step j runs, then the accumulator is rescaled and step
//   j-1's slot released.  A slot is thus held one step past its q.k^T,
//   hence three.  The two consumers of a block overlap each other too.
//   Scores.  S = q.k^T by wgmma m64nBKk16, bf16 x bf16 -> f32, A (q) and B
//   (k) both K-major in shared memory (k's rows are contiguous in D, so k^T
//   needs no transpose); all D/16 steps are issued, also past d (zero
//   columns add nothing; see issue_scores).  The scale d**-0.5 multiplies
//   the f32 scores, not q: a bf16 operand cannot carry the JAX kernel's
//   f32 q * scale, and the two differ only in rounding (at D = 64 and 256
//   the scale is a power of two).
//   Softmax.  In registers, on the accumulator fragment: each thread holds
//   two rows' worth of columns, and the four threads that share a row
//   combine their max by two xor shuffles; l is kept per thread and summed
//   across the four once, at the end (corr is the same for the whole row).
//   exp(scale * (s - m)) is exp2f(s * c - m * c), c = scale * log2(e), one
//   FMA and one MUFU op a score.  The mask is applied only on the blocks
//   that straddle the diagonal or the Skv edge, and a warpgroup skips a
//   block that lies wholly past its own rows' diagonal, and every block
//   when all its rows lie past S (exact, as above).
//   Values.  O += P.V by wgmma m64nDk16 with P from registers (the RS
//   form: the f32 score fragment, rounded to bf16 pairs, is already the A
//   fragment) and V MN-major from shared memory (the transpose bit).  The
//   JAX kernel keeps p in f32; rounding p to bf16 (unit roundoff 2^-8)
//   moves each weight by at most 2^-8 of itself, so each output by at most
//   2^-8 * sum(p |v|) / l <= 2^-8 max |v| (0.018 for N(0, 1) values up to
//   4.6), and much less in practice, as the errors' signs vary: inside the
//   bf16 tolerance of 3e-2, beside the output's own bf16 rounding (2^-8
//   relative).  l sums the f32 p.
//   Order.  The query tiles run longest first (blockIdx.x counts down the
//   tiles, heads fastest), so that the causal tail's short tiles fill the
//   132 SMs at the end instead of leaving long tiles to run alone.
//   Epilogue.  acc / max(l, 1e-30), rounded to bf16 and stored from the
//   registers to o (B, S, H, d), contiguous; rows past S and columns past
//   d are not stored.
//   Layout.  q, k and v are read in place through rank-4 tensor maps over
//   (D, S, H, B) with the tensors' own strides (a (B, H, S, D) tensor's
//   transposed view is no copy).  Columns past d and keys past Skv load as
//   TMA's zero fill.  TMA needs 16-byte row strides and bases: the wrapper
//   copies an operand without them (d not a multiple of 8, say) to aligned
//   rows first, and counts the copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_ELEM_<BF16|F32> flash_attention.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py: the f32 one (which includes cp_async.cuh) exports
// repro_flash_attention, the bf16 one repro_flash_encode (one tensor map)
// and repro_flash_attention_wgmma.

#if defined(REPRO_ELEM_BF16)
#include "wgmma_gemm.cuh"
#elif defined(REPRO_ELEM_F32)
#include "cp_async.cuh"
#else
#error "define one of REPRO_ELEM_BF16, REPRO_ELEM_F32"
#endif

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: each library keeps its own kernels and `configured`
// flags (see tile_gemm.cuh).
namespace repro {
namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernel's mask fill
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

#if defined(REPRO_ELEM_F32)

constexpr int kBK = 64;            // keys per step
constexpr int kThreads = 128;      // four warps, a 16 x 8 thread grid
constexpr int kTY = 16;            // threads down the rows
constexpr int kTX = 8;             // threads across a row (keys, columns)
constexpr int kRN = kBK / kTX;     // keys per thread (8)
constexpr int kSMs = 132;          // an H100 SXM's SMs
constexpr int kMinBlocks = 2;      // blocks an SM the launch bounds ask for
constexpr int kDS = 32;            // head-dim columns of one K piece
constexpr int kStages = 3;         // slots of the cp.async ring
constexpr int kLK = kDS + 4;       // row stride of a K piece (floats)
constexpr int kSlot = kBK * kLK;   // floats of one slot: a K or a V piece
constexpr int kLP = kBK + 8;       // row stride of the p tile

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}
// the largest power of two that divides x and is at most cap
__host__ __device__ constexpr int pow2_divisor(int x, int cap) {
  int p = 1;
  while (x % (2 * p) == 0 && 2 * p <= cap) p *= 2;
  return p;
}

// The geometry of the W-wide instantiation (mirrored by
// kernels/flash_attention.py:f32_config): the scaled q tile (rows of W + 4
// floats), the p tile, then kStages slots.  A step's K arrives in W / kDS
// pieces of kBK keys x kDS columns, its V in kBK / kVS pieces of kVS keys x
// W columns, kVS the largest power of two whose piece fits a slot.
template <int W, int RM>
struct F32Tile {
  static_assert(W % kDS == 0 && W % (4 * kTX) == 0,
                "widths are multiples of 32");
  static constexpr int kBQ = RM * kTY;               // query rows a block
  static constexpr int kLQ = W + 4;                 // row stride of q
  static constexpr int kVS = pow2_floor(kSlot / W);  // keys of a V piece
  static constexpr int kNK = W / kDS;                // K pieces a step
  static constexpr int kNV = kBK / kVS;              // V pieces a step
  static constexpr int kPieces = kNK + kNV;          // pieces a step
  static constexpr int kCN = W / (4 * kTX);  // 4-wide output fragments a thread
  static constexpr int kSmem =
      4 * (kBQ * kLQ + kBQ * kLP + kStages * kSlot);
};

// Calls f(r, col) for the V-float chunks (V = 4 or 1) of a ROWS x COLS
// block that thread tid owns: kCW threads across a row (the largest power
// of two that divides the row's chunks, at most kThreads), rows kThreads /
// kCW apart; no division.  The 16-byte chunks (a few a thread) unroll; the
// 4-byte ones (four times as many) stay a loop, whose addresses would
// otherwise take the accumulators' registers.
template <int ROWS, int COLS, int V, typename F>
__device__ __forceinline__ void for_chunks(int tid, F f) {
  constexpr int kChunks = COLS / V;
  constexpr int kCW = pow2_divisor(kChunks, kThreads);
  constexpr int kRW = kThreads / kCW;
  const int cq = tid & (kCW - 1), r0 = tid / kCW;
  auto visit = [&](int i, int j) {
    const int r = r0 + j * kRW;
    if (ROWS % kRW == 0 || r < ROWS) f(r, (cq + i * kCW) * V);
  };
  if constexpr (V == 4) {
#pragma unroll
    for (int i = 0; i < kChunks / kCW; ++i)
#pragma unroll
      for (int j = 0; j < (ROWS + kRW - 1) / kRW; ++j) visit(i, j);
  } else {
#pragma unroll 1
    for (int i = 0; i < kChunks / kCW; ++i)
#pragma unroll 1
      for (int j = 0; j < (ROWS + kRW - 1) / kRW; ++j) visit(i, j);
  }
}

// Rows [0, ROWS) x columns [0, COLS) of the row-major block at src (row
// stride ld elements) into dst (row stride SD floats) by cp.async, in
// 16-byte copies (VEC: src's base and row stride 16-byte aligned) or 4-byte
// ones; the source size is cut at rows_valid rows and cols_valid columns,
// so what lies past them lands as zero, and a copy of nothing names `safe`.
template <int ROWS, int COLS, int SD, bool VEC>
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int64_t ld, int rows_valid,
                                           int cols_valid, const float* safe,
                                           int tid) {
  if constexpr (VEC) {
    for_chunks<ROWS, COLS, 4>(tid, [&](int r, int col) {
      const int b = r < rows_valid ? 4 * max(0, min(4, cols_valid - col)) : 0;
      cp_async16(dst + r * SD + col, b ? src + r * ld + col : safe, b);
    });
  } else {
    for_chunks<ROWS, COLS, 1>(tid, [&](int r, int col) {
      const int b = r < rows_valid && col < cols_valid ? 4 : 0;
      cp_async4(dst + r * SD + col, b ? src + r * ld + col : safe, b);
    });
  }
}

// The (batch, head) index of this block, blockIdx.x % BH.  Read anew where
// it is needed: a value kept over the key loop would hold registers the
// accumulators need.
__device__ __forceinline__ int block_bh(int BH) {
  unsigned x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return static_cast<int>(x % static_cast<unsigned>(BH));
}

// Max and sum over the kTX = 8 threads of one query row (lanes that differ
// in their low three bits).  The xor butterfly leaves the value in each.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < kTX; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < kTX; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[i][j] += q[row i, dc .. dc + kDS) . k[key j, same columns] for one K
// piece: per four columns, kRM LDS.128 of q and kRN of k feed 4 kRM kRN
// FFMA, each fragment loaded while the one before it multiplies.  qp: row
// ty of q at column dc; kp: key tx of the piece.
template <int LQ, int kRM>
__device__ __forceinline__ void scores_piece(float (&s)[kRM][kRN],
                                             const float* qp,
                                             const float* kp) {
  constexpr int N = kDS / 4;
  float a[2][kRM][4], b[2][4];
  auto load_a = [&](float (&f)[kRM][4], int c4) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) ld_frag<4>(f[i], qp + i * 16 * LQ + c4);
  };
  load_a(a[0], 0);
  ld_frag<4>(b[0], kp);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      if (j == 0 && n + 1 < N) load_a(a[(n + 1) & 1], 4 * (n + 1));
      const int y = n * kRN + j, x = y + 1;
      if (x < N * kRN)
        ld_frag<4>(b[x & 1], kp + (x % kRN) * kTX * kLK + 4 * (x / kRN));
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[i][j] = fmaf(a[n & 1][i][u], b[y & 1][u], s[i][j]);
    }
}

// acc[i][.] += p[row i, keys kv .. kv + VS) . v[those keys, columns] for
// one V piece: per four keys, kRM LDS.128 of p, then per key CN LDS.128 of
// v feed 4 kRM CN FFMA, each fragment loaded while the one before it
// multiplies.  pp: row ty of p at key kv; vp: the piece's row 0 at column
// 4 tx.
template <int W, int VS, int CN, int kRM>
__device__ __forceinline__ void values_piece(float (&acc)[kRM][4 * CN],
                                             const float* pp,
                                             const float* vp) {
  constexpr int N = VS / 4;
  float a[2][kRM][4], b[2][4];
  auto load_a = [&](float (&f)[kRM][4], int k4) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) ld_frag<4>(f[i], pp + i * 16 * kLP + k4);
  };
  load_a(a[0], 0);
  ld_frag<4>(b[0], vp);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        if (u == 0 && c == 0 && n + 1 < N)
          load_a(a[(n + 1) & 1], 4 * (n + 1));
        const int y = (n * 4 + u) * CN + c, x = y + 1;
        if (x < N * 4 * CN)
          ld_frag<4>(b[x & 1], vp + (x / CN) * W + (x % CN) * 4 * kTX);
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * c + e] =
                fmaf(a[n & 1][i][u], b[y & 1][e], acc[i][4 * c + e]);
      }
}

// One block: query tile `tile` (16 kRM rows) of one (batch, head).  Thread
// (ty, tx) owns query rows ty + 16 i (i < kRM), the step's keys tx + 8 j
// (j < 8) and output columns 32 c + 4 tx + e (c < W / 32, e < 4); a warp
// is four rows of eight threads.  VEC: q, k and v take 16-byte copies;
// o_vec: o takes float4 stores.
template <int W, int kRM, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int Skv,
          int H, int BH, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
          int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
          int d, int causal, float scale, int o_vec) {
  using G = F32Tile<W, kRM>;
  constexpr int kBQ = G::kBQ;
  constexpr int LQ = G::kLQ, VS = G::kVS, NK = G::kNK, CN = G::kCN;
  constexpr int PS = G::kPieces;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // kBQ x LQ, scaled q
  float* Ps = Qs + kBQ * LQ;        // kBQ x kLP, the step's p
  float* ring = Ps + kBQ * kLP;     // kStages slots of kSlot floats

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & (kTX - 1);
  const int ty = (tid >> 5) * 4 + (lane >> 3);
  // longest tiles first: blockIdx.x counts the tiles down, heads fastest
  const int tiles = (S + kBQ - 1) / kBQ;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = tile * kBQ;
  int b = block_bh(BH), h = b % H;
  b /= H;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  // causal: keys past the tile's last query are masked for every row
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int steps = (kv_end + kBK - 1) / kBK;
  const int pieces = steps * PS;

  // piece t of the stream: step t / PS; first its NK pieces of K (kDS
  // columns each), then its pieces of V (VS keys each)
  auto load_piece = [&](int t, float* slot) {
    const int j = t / PS, p = t - j * PS;
    const int k0 = j * kBK;
    if (p < NK) {
      const int dc = p * kDS;
      copy_block<kBK, kDS, kLK, VEC>(slot, kb + k0 * kss + dc, kss,
                                     Skv - k0, d - dc, kb, tid);
    } else {
      const int kv = k0 + (p - NK) * VS;
      copy_block<VS, W, W, VEC>(slot, vb + kv * vss, vss, Skv - kv, d, vb,
                                tid);
    }
  };

  copy_block<kBQ, W, LQ, VEC>(Qs, qb + q0 * qss, qss, S - q0, d, qb, tid);
  cp_commit();
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < pieces) load_piece(t, ring + t * kSlot);
    cp_commit();
  }
  // q * scale in f32, as the JAX kernel scales it, before any product: each
  // thread scales the elements it copied, once they have landed
  cp_wait<kStages - 1>();
  if constexpr (VEC) {
    for_chunks<kBQ, W, 4>(tid, [&](int r, int col) {
      float4* e = reinterpret_cast<float4*>(Qs + r * LQ + col);
      float4 x = *e;
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *e = x;
    });
  } else {
    for_chunks<kBQ, W, 1>(tid,
                          [&](int r, int col) { Qs[r * LQ + col] *= scale; });
  }

  float m[kRM], l[kRM], acc[kRM][4 * CN], s[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * CN; ++c) acc[i][c] = 0.0f;
  }

  // the next piece of the stream: wait for it, then refill the slot the
  // last one used; returns the piece's slot
  int t = 0, rd = 0, wr = kStages - 1;
  auto next = [&]() {
    cp_wait<kStages - 2>();  // piece t has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slot wr is free, and the p
                             // tile written before it is visible
    if (t + kStages - 1 < pieces)
      load_piece(t + kStages - 1, ring + wr * kSlot);
    cp_commit();
    const float* slot = ring + rd * kSlot;
    ++t;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    wr = wr + 1 == kStages ? 0 : wr + 1;
    return slot;
  };

#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    const int k0 = j * kBK;
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int jj = 0; jj < kRN; ++jj) s[i][jj] = 0.0f;
#pragma unroll 1
    for (int p = 0; p < NK; ++p)
      scores_piece<LQ, kRM>(s, Qs + ty * LQ + p * kDS, next() + tx * kLK);

    // the online softmax of step j: mask only a step that straddles the
    // diagonal or Skv; p = exp(s - m_new) as exp2(s log2e - m_new log2e)
    // into shared memory for the values pieces; l is this thread's part of
    // its row's sum (corr is the row's)
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int jj = 0; jj < kRN; ++jj) {
          const int key = k0 + tx + kTX * jj;
          if (key >= Skv || (causal && key > q0 + ty + 16 * i))
            s[i][jj] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int jj = 1; jj < kRN; ++jj) mx = fmaxf(mx, s[i][jj]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = exp2f((m[i] - m_new) * kLog2e);
      const float mc = m_new * kLog2e;
      m[i] = m_new;
      float rs = 0.0f;
      float* prow = Ps + (ty + 16 * i) * kLP + tx;
#pragma unroll
      for (int jj = 0; jj < kRN; ++jj) {
        const float e = exp2f(fmaf(s[i][jj], kLog2e, -mc));
        rs += e;
        prow[kTX * jj] = e;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < 4 * CN; ++c) acc[i][c] *= corr;
    }

#pragma unroll 1
    for (int p = 0; p < G::kNV; ++p)
      values_piece<W, VS, CN, kRM>(acc, Ps + ty * kLP + p * VS,
                                   next() + 4 * tx);
  }

  // acc / max(l, 1e-30), rows < S, columns < d
  const int bh = block_bh(BH);
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const float den = fmaxf(row_sum(l[i]), 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    float* orow = o + (static_cast<int64_t>(row) * H + bh % H) * d +
                  static_cast<int64_t>(bh / H) * S * H * d;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int col = c * 4 * kTX + 4 * tx;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = acc[i][4 * c + e] / den;
      if (o_vec && col + 4 <= d) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) orow[col + e] = r[e];
      }
    }
  }
}

// 16-byte copies of a (B, S, H, D) operand need its base and its batch,
// sequence and head strides 16-byte aligned
inline bool rows16(const void* p, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         ss % 4 == 0 && sh % 4 == 0;
}

// Query rows a block: 64, or 32 where 64-row tiles would give fewer blocks
// than two an SM (S of a few thousand over a few heads): a causal call's
// tiles differ in length, and with few of them the longest leave SMs idle.
inline int f32_rows(int B, int S, int H) {
  return (static_cast<int64_t>(S) + 63) / 64 * B * H < 2 * kSMs ? 32 : 64;
}

template <int W, int RM, bool VEC>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        float* o, int B, int S, int Skv, int H, int d,
                        const int64_t* st, int causal, cudaStream_t stream) {
  using G = F32Tile<W, RM>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<W, RM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kSmem);
    // two blocks share an SM: ask for all of its memory as shared
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd<W, RM, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // d**-0.5 of the true head dim, rounded once to f32, as the JAX kernel's
  // Python float scale
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int64_t tiles = (static_cast<int64_t>(S) + G::kBQ - 1) / G::kBQ;
  // float4 stores need d % 4 == 0 and a 16-byte aligned o
  const int o_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  flash_fwd<W, RM, VEC><<<static_cast<unsigned>(tiles * B * H), kThreads,
                          G::kSmem, stream>>>(
      q, k, v, o, S, Skv, H, B * H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], d, causal != 0, scale, o_vec);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int B, int S, int Skv, int H, int d,
                       const int64_t* st, int causal, cudaStream_t stream) {
  // 16-byte copies when every operand allows them, else 4-byte ones
  const bool vec = rows16(q, st[0], st[1], st[2]) &&
                   rows16(k, st[3], st[4], st[5]) &&
                   rows16(v, st[6], st[7], st[8]);
  const bool r32 = f32_rows(B, S, H) == 32;
  if (vec)
    return r32 ? launch_rows<W, 2, true>(q, k, v, o, B, S, Skv, H, d, st,
                                         causal, stream)
               : launch_rows<W, 4, true>(q, k, v, o, B, S, Skv, H, d, st,
                                         causal, stream);
  return r32 ? launch_rows<W, 2, false>(q, k, v, o, B, S, Skv, H, d, st,
                                        causal, stream)
             : launch_rows<W, 4, false>(q, k, v, o, B, S, Skv, H, d, st,
                                        causal, stream);
}

#else  // REPRO_ELEM_BF16

// The shared-memory layout of one block at head-dim width W with BK keys
// per step: the q tile (W/64 bands of 128 rows x 128 bytes), then `stages`
// slots of K and V (each W/64 bands of BK rows x 128 bytes), then the
// mbarriers (q's, a full and an empty one per slot).  Every band starts on
// 1024 bytes, as the 128-byte swizzle atoms need.  Mirrored by
// kernels/flash_attention.py:wgmma_config.
struct FlashGeom {
  int q_bytes, kv_bytes, stage_bytes;
  __host__ __device__ FlashGeom(int width, int bk, int nc)
      : q_bytes(width * 64 * nc * 2),
        kv_bytes(width * bk * 2),
        stage_bytes(2 * width * bk * 2) {}
  __host__ __device__ int smem(int stages) const {
    return q_bytes + stages * stage_bytes + 8 * (1 + 2 * stages);
  }
};

// Max and sum over the four threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Issue S = q.k^T for one step as one wgmma group: W/16 k16 steps, both
// operands K-major in 64-column bands (q's 64 * NC rows apart, k's BK),
// 32 bytes (16 columns) per k16 step; the first step overwrites s.  Every
// step is issued, also past the head dim (zero columns add nothing): a
// branch around a wgmma made ptxas serialize the kernel's wgmmas (C7515),
// which cost more than the skipped steps saved (PERF.md).
template <int W, int BK, int NC>
__device__ __forceinline__ void issue_scores(float* s, uint32_t qa,
                                             uint32_t ka) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    const uint64_t da =
        sw128_desc(qa + (kt / 4) * 64 * NC * 128 + (kt % 4) * 32, 16, 1024);
    const uint64_t db =
        sw128_desc(ka + (kt / 4) * BK * 128 + (kt % 4) * 32, 16, 1024);
    Wgmma<BK, 0, 0>::mma(s, da, db, kt > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Issue O += P.V for one step as one wgmma group: P from registers, V
// MN-major at va, 16 key rows of 128 bytes per k16 step, its W/64 column
// bands BK * 128 bytes apart.
template <int W, int BK>
__device__ __forceinline__ void issue_values(float* acc, uint32_t (*pa)[4],
                                             uint32_t va) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt)
    WgmmaRS<W>::mma(acc, pa[kt], sw128_desc(va + kt * 16 * 128, BK * 128,
                                            1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The online softmax of one step's raw scores s (keys k0 .., rows row and
// row + 8 for this thread), in place: masked scores (past Skv, or past the
// row when causal; only checked on an edge step) become -1e30, the running
// max m moves to m_new, corr = exp(scale * (m - m_new)), s becomes
// p = exp(scale * (s - m_new)) in f32 and rs this thread's part of each
// row's sum of p.  The max is taken on the raw scores, which orders them
// as the scaled ones (scale > 0); every row sees key 0 in the first step,
// so m is finite from then on.
template <int BK>
__device__ __forceinline__ void softmax_step(float* s, float* m, float* corr,
                                             float* rs, float c, bool edge,
                                             int k0, int Skv, int causal,
                                             int row, int cl) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * hh + e];
        if (edge) {
          const int key = k0 + 8 * jj + cl + e;
          if (key >= Skv || (causal && key > row + 8 * hh)) x = kNegInf;
        }
        mx[hh] = fmaxf(mx[hh], x);
      }
  float mc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
    corr[hh] = exp2f((m[hh] - m_new) * c);
    m[hh] = m_new;
    mc[hh] = m_new * c;
    rs[hh] = 0.0f;
  }
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * hh + e];
        x = exp2f(fmaf(x, c, -mc[hh]));
        rs[hh] += x;
      }
}

// p in bf16 as wgmma's A fragments: k16 step kt is the accumulator's
// score pairs 8kt .. 8kt + 7, in order (rows r and r + 8, columns
// 2*(t%4) (+ 1) and + 8), which is the A layout of a 64 x 16 slice.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kt][i] = bf16_pair(s[8 * kt + 2 * i], s[8 * kt + 2 * i + 1]);
}

// One block: query tile `tile` of (batch, head) bh.  Warpgroups 0 .. NC-1
// consume (rows 64 wg .. 64 wg + 63 of the tile), warpgroup NC produces:
// one of its threads issues every load.  Thread t of a consumer holds
// accumulator rows 16*(t/32) + (t%32)/4 (+ 8) and columns 8j + 2*(t%4)
// (+ 1).
template <int W, int BK, int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_wgmma(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            __nv_bfloat16* __restrict__ o, int S, int Skv, int H, int BH,
            int d, int causal, int stages, float scale, int pairs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int BQ = 64 * NC;  // query rows per block
  const FlashGeom g(W, BK, NC);
  unsigned char* qs = smem;
  unsigned char* kv = smem + g.q_bytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + stages * g.stage_bytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + stages;

  // longest tiles first: blockIdx.x counts the tiles down, heads fastest
  const int tiles = (S + BQ - 1) / BQ;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = tile * BQ;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int steps = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;  // consumers 0 .. NC-1, producer NC

  if (threadIdx.x == 0) {
    // the swizzle atoms assume a 1024-byte aligned base
    if (smem_u32(smem) % 1024 != 0) __trap();
    mbar_init(qbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: one thread issues the q tile, then K and V step
    // by step
    if (warp == 4 * NC && lane == 0) {
      mbar_expect_tx(qbar, g.q_bytes);
      for (int c = 0; c < W / 64; ++c)
        tma_load4(&map_q, qs + c * BQ * 128, qbar, c * 64, q0, h, b);
      int stage = 0, phase = 0;
      for (int j = 0; j < steps; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = kv + stage * g.stage_bytes;
        mbar_expect_tx(&full[stage], g.stage_bytes);
        for (int c = 0; c < W / 64; ++c)
          tma_load4(&map_k, st + c * BK * 128, &full[stage], c * 64, j * BK, h,
                    b);
        for (int c = 0; c < W / 64; ++c)
          tma_load4(&map_v, st + g.kv_bytes + c * BK * 128, &full[stage],
                    c * 64, j * BK, h, b);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows row0 .. row0 + 63 of the tile
    const int t = threadIdx.x % 128;
    const int row0 = q0 + wg * 64;
    // keys any of this warpgroup's rows sees (none when all its rows lie
    // past S)
    const int wg_end =
        row0 >= S ? 0 : (causal ? min(kv_end, row0 + 64) : kv_end);
    const int rl = 16 * (t / 32) + (t % 32) / 4;
    const int cl = 2 * (t % 4);
    const float c = scale * kLog2e;         // exp(scale * x) = exp2(c * x)
    // the steps this warpgroup computes: those holding a key it sees
    const int mine = (wg_end + BK - 1) / BK;
    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float s[BK / 2];         // the step's scores, then its f32 p
    uint32_t pa[BK / 16][4];  // the previous step's p in bf16
    const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
    auto slot = [&](int j) {  // K of step j; its V follows at kv_bytes
      return smem_u32(kv + (j % stages) * g.stage_bytes);
    };
    auto edge = [&](int j) {  // the step straddles the diagonal or Skv
      return j * BK + BK > Skv || (causal && j * BK + BK - 1 > row0);
    };

    // Step j's softmax runs on the CUDA cores while step j-1's p.v runs on
    // the tensor cores: q.k^T of step j, then p.v of step j-1 issued and
    // left in flight over the softmax; step j-1's slot is released once
    // its p.v has retired.  (The softmax writes only registers that no
    // wgmma in flight names, so ptxas need not serialize the wgmmas.)
    mbar_wait(qbar, 0);
    if (mine > 0) {
      mbar_wait(&full[0], 0);
      issue_scores<W, BK, NC>(s, qa, slot(0));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      float corr[2], rs[2];
      softmax_step<BK>(s, m, corr, rs, c, edge(0), 0, Skv, causal,
                       row0 + rl, cl);
      l[0] = rs[0];
      l[1] = rs[1];
      pack_p<BK>(pa, s);
    }
    for (int j = 1; j < mine; ++j) {
      mbar_wait(&full[j % stages], (j / stages) & 1);
      issue_scores<W, BK, NC>(s, qa, slot(j));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      issue_values<W, BK>(acc, pa, slot(j - 1) + g.kv_bytes);
      float corr[2], rs[2];
      softmax_step<BK>(s, m, corr, rs, c, edge(j), j * BK, Skv, causal,
                       row0 + rl, cl);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + rs[hh];
#pragma unroll
      for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * jj + 2 * hh] *= corr[hh];
          acc[4 * jj + 2 * hh + 1] *= corr[hh];
        }
      pack_p<BK>(pa, s);
    }
    if (mine > 0) {
      issue_values<W, BK>(acc, pa, slot(mine - 1) + g.kv_bytes);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[(mine - 1) % stages]);
    }
    // the steps past this warpgroup's rows: wait for each (so that no slot
    // sees two of its arrivals in one phase) and release it untouched
    for (int j = mine; j < steps; ++j) {
      mbar_wait(&full[j % stages], (j / stages) & 1);
      if (lane == 0) mbar_arrive(&empty[j % stages]);
    }

    // epilogue: acc / max(l, 1e-30), rounded to bf16, rows < S, columns < d
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float den = fmaxf(quad_sum(l[hh]), 1e-30f);
      const int row = row0 + rl + 8 * hh;
      if (row >= S) continue;
      __nv_bfloat16* orow =
          o + ((static_cast<int64_t>(b) * S + row) * H + h) * d;
#pragma unroll
      for (int jj = 0; jj < W / 8; ++jj) {
        const int c = 8 * jj + cl;
        const float v0 = acc[4 * jj + 2 * hh] / den;
        const float v1 = acc[4 * jj + 2 * hh + 1] / den;
        if (pairs && c + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < d) orow[c] = __float2bfloat16(v0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// A rank-4 tensor map over a bf16 (B, S, H, D) operand read as (D, S, H, B):
// d columns, `rows` positions, `heads`, `batch`, with the given strides in
// elements (each a multiple of 8, the base 16-byte aligned), in boxes of 64
// columns (128 bytes, the 128-byte swizzle) by box_rows positions of one
// head; zero fill past the extents.
int encode_flash_map(CUtensorMap* map, const void* base, int d, int rows,
                     int heads, int batch, int64_t s_row, int64_t s_head,
                     int64_t s_batch, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + static_cast<int>(r);
}

template <int W, int BK, int NC>
int launch_flash(const CUtensorMap* mq, const CUtensorMap* mk,
                 const CUtensorMap* mv, void* o, int B, int S, int Skv,
                 int H, int d, int causal, int stages, cudaStream_t stream) {
  const int smem = FlashGeom(W, BK, NC).smem(stages);
  if (stages < 1 || smem > kWgmmaMaxSmem) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma<W, BK, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgmmaMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // d**-0.5 of the true head dim, rounded once to f32, as the JAX kernel's
  // Python float scale
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int64_t tiles = (static_cast<int64_t>(S) + 64 * NC - 1) / (64 * NC);
  // bf16 pairs (4-byte stores) need even row lengths and a 4-byte base
  const int pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0;
  flash_wgmma<W, BK, NC><<<static_cast<unsigned>(tiles * B * H),
                           (NC + 1) * 128, smem, stream>>>(
      *mq, *mk, *mv, static_cast<__nv_bfloat16*>(o), S, Skv, H, B * H, d,
      causal != 0, stages, scale, pairs);
  return cudaGetLastError();
}

#endif

}  // namespace
}  // namespace repro

extern "C" {

#if defined(REPRO_ELEM_F32)

// o (B, S, H, D), contiguous = attention of q (B, S, H, D) over k, v
// (B, Skv, H, D), each given by its (batch, sequence, head) strides in
// elements with unit stride on D.  D is 1 to 256: the 64-, 128-, 160-, 192-
// or 256-wide instantiation, the smallest that holds it
// (kernels/flash_attention.py:f32_width).  One block per 64 query rows of
// one (batch, head), or per 32 where that gives fewer than two blocks an SM
// (f32_rows): ceil(S / 64) * B * H < 2^31.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int Skv, int H, int D,
                          int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                          int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                          int64_t vsh, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || D <= 0 || D > 256)
    return cudaErrorInvalidValue;
  if ((static_cast<int64_t>(S) + 63) / 64 * B * H >
      2147483647LL)
    return cudaErrorInvalidValue;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_F32(W_)                                                  \
  if (D <= W_)                                                               \
    return repro::launch_f32<W_>(fq, fk, fv, fo, B, S, Skv, H, D, st,        \
                                 causal, s);
  REPRO_FLASH_F32(64) REPRO_FLASH_F32(128) REPRO_FLASH_F32(160)
  REPRO_FLASH_F32(192) REPRO_FLASH_F32(256)
#undef REPRO_FLASH_F32
  return cudaErrorInvalidValue;
}

#else  // REPRO_ELEM_BF16

// Encode the rank-4 tensor map of one bf16 (B, S, H, D) operand with
// (batch, sequence, head) strides in elements, in boxes of 64 columns by
// box_rows positions (128 for q, the step's keys for k and v).  Writes one
// CUtensorMap (128 bytes) to `map`.  Returns 0, a CUDA error code, or
// 100000 + the driver's CUresult.
int repro_flash_encode(void* map, const void* base, int d, int rows,
                       int heads, int batch, int64_t s_row, int64_t s_head,
                       int64_t s_batch, int box_rows) {
  if (d <= 0 || d > 256 || rows <= 0 || heads <= 0 || batch <= 0 ||
      box_rows <= 0 || box_rows > 256)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || s_row % 8 != 0 ||
      s_head % 8 != 0 || s_batch % 8 != 0)
    return cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap m;
  memset(&m, 0, sizeof(m));
  const int e = repro::encode_flash_map(&m, base, d, rows, heads, batch, s_row,
                                        s_head, s_batch, box_rows);
  if (e == 0) memcpy(map, &m, sizeof(m));
  return e;
}

// o (B, S, H, d), contiguous = attention of q (B, S, H, d) over k, v
// (B, Skv, H, d), read through the tensor maps mq (boxes of 64 * consumers
// rows), mk and mv (boxes of block_k rows), on the tensor cores.  width is
// the compiled head-dim width (64, 128 or 256) that holds d, block_k its
// keys per step (128, 64, 64), consumers its consumer warpgroups (2, 2,
// 1) and stages the K/V ring's depth; anything else is refused.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int repro_flash_attention_wgmma(const void* mq, const void* mk,
                                const void* mv, void* o, int B, int S,
                                int Skv, int H, int d, int width,
                                int block_k, int consumers, int stages,
                                int causal, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || d <= 0 || d > width ||
      consumers < 1 || consumers > 2)
    return cudaErrorInvalidValue;
  const int bq = 64 * consumers;
  if ((static_cast<int64_t>(S) + bq - 1) / bq * B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const auto* q = static_cast<const CUtensorMap*>(mq);
  const auto* k = static_cast<const CUtensorMap*>(mk);
  const auto* v = static_cast<const CUtensorMap*>(mv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 64 && block_k == 128 && consumers == 2)
    return repro::launch_flash<64, 128, 2>(q, k, v, o, B, S, Skv, H, d,
                                           causal, stages, s);
  if (width == 128 && block_k == 64 && consumers == 2)
    return repro::launch_flash<128, 64, 2>(q, k, v, o, B, S, Skv, H, d,
                                           causal, stages, s);
  if (width == 256 && block_k == 64 && consumers == 1)
    return repro::launch_flash<256, 64, 1>(q, k, v, o, B, S, Skv, H, d,
                                           causal, stages, s);
  return cudaErrorInvalidValue;
}

#endif

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
