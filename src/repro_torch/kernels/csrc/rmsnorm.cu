// Fused RMSNorm on Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale
// over the last axis, statistics in f32, the output in x's type.
//
// Replaces the Pallas TPU kernel rmsnorm of src/repro/kernels/rmsnorm.py:29
// (body _rmsnorm_kernel :22).  That kernel tiles rows by block_rows and
// keeps each row whole in VMEM, so it reads the row once; the function is
// the same here: the sum of squares in f32, rsqrt(sum / D + eps),
// (x * r) * scale with the scale widened to f32, rounded once to x's type.
// Only the order of the sum and the last bit of rsqrtf differ from the
// plain version's.
//
// The scale is read in its own type, bf16 or f32 (the models keep it in
// their compute dtype), and widened to f32 in registers, as the JAX
// kernel's body does (scale_ref[...].astype(jnp.float32)).  The widening
// is exact, so the output is the one an f32 copy of the scale gives; the
// wrapper launches no conversion kernel and allocates nothing but y.
//
// What bounds it on an H100: bytes.  Each row is read once and written once
// for 4 operations per element, far below the card's ~295 flop/byte ridge,
// so the bound is (2 * rows * D * elem + 4 * D) bytes over 3.35 TB/s.  Each
// row is read from device memory once on every path up to kMaxD (16384, in
// both types):
//
//   * direct: x's rows have unit column stride, D a multiple of 8 (bf16)
//     or 4 (f32), x's base, its row stride and y 16-byte aligned.  A group
//     of warps a row, each lane's 16-byte vectors of the row and of the
//     scale loaded into registers at once: up to 4 vectors a lane within 8
//     warps a row, up to kMaxVecs (8) past that (16 warps for 16384 f32);
//     with fewer rows than SMs (the served decode's 4 rows) up to 2 a lane
//     on up to 16 warps, which waits less on the one round trip.  The
//     partial sums meet in shared memory when a group has several warps.
//     On an H100 this beat the ring below on every aligned shape it was
//     timed at, from 256 to 32768 rows and from 1536 to 16384 wide, and it
//     has no ring to set up.
//   * element (the ring): unit column stride, any other base, row stride
//     or D (ragged widths, slices off 16 bytes).  Persistent blocks of 32
//     warps, one a SM, split into groups of 1-32 warps, each group a row
//     at a time: the fewest warps that keep a lane at kMaxVecs 16-byte
//     vectors of the row and leave room for two stages a group.  Each
//     group walks its rows through its own ring of up to kMaxStages
//     stages in shared memory: its leader fills a stage with one bulk
//     asynchronous copy (cp.async.bulk, completing on the stage's
//     mbarrier) of every 16-byte granule the row touches, and refills it
//     as soon as the group has read it, so its next rows land while this
//     one is reduced, scaled and stored, and no barrier spans the block.
//     The row sits at its own offset within 16 bytes in the stage; lanes
//     walk elements, neighbouring lanes neighbouring elements, so shared
//     memory and y see whole, conflict-free rows.  The scale is read into
//     shared memory once per block (one bulk copy when aligned).
//   * columns: x's row axis unit-stride and its last axis not (a transposed
//     x): a block copies 16 (f32) or 32 (bf16) rows' columns into shared
//     memory with 4-byte cp.async copies that read along the row axis (two
//     bf16 rows a word), a word stride of D | 1 keeping both the column
//     writes and the row reads free of bank conflicts, then normalises
//     each row (or pair) with one warp and writes y row-major.  Two blocks
//     a SM, each at most half the shared memory; narrower tiles for wider
//     rows.  Needs x's base and column stride in bytes 4-aligned.
//   * two-pass: D > kMaxD: a block a row, element loads, the row read
//     twice from device memory (once for the sum, once for the scaling).
//
// The launcher picks the path from the strides, the widths and the
// alignments; kernels/rmsnorm.py:path mirrors the rule, and copies x once
// only for a layout no path reads (neither axis unit-stride, or a columns
// layout that is misaligned or too wide for its tile).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_ELEM_<BF16|F32> rmsnorm.cu
// One shared library per element type of x, loaded with ctypes by
// kernels/build.py; each takes a bf16 or an f32 scale.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace repro {
namespace {

constexpr int kThreads = 256;             // columns, two-pass, direct
constexpr int kWarps = kThreads / 32;
constexpr int kRingThreads = 1024;        // ring blocks: 32 warps
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kDirectThreads = 512;       // direct blocks, at most
constexpr int kMaxD = 16384;              // the widest row read once
constexpr int kMaxVecs = 8;               // 16-byte vectors a lane, a row
constexpr int kMaxStages = 2;             // a group's stages (more: no faster)
constexpr int kDirectVecs = 4;            // direct: vectors a lane to 8 warps
constexpr int kFewVecs = 2;               // the same, fewer rows than SMs
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block
constexpr int kRedBytes = kRingWarps * 4;  // ring: partial sums
constexpr int kColumnsSmem = kSmemLimit / 2 - 1024;  // two blocks a SM
constexpr int kMaxDevices = 64;

// Loads widen to f32; stores round to the element type.
template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ __forceinline__ static float up(float x) { return x; }
  __device__ __forceinline__ static float down(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float up(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as jnp .astype and torch .to do
  __device__ __forceinline__ static __nv_bfloat16 down(float v) {
    return __float2bfloat16(v);
  }
};

// kVec scale values of type S at p (16-byte aligned for kVec elements of x:
// 32, 16 or 8 bytes), widened to f32.
template <typename S> struct Scale;
template <> struct Scale<float> {
  template <int kVec>
  __device__ __forceinline__ static void vec(const float* p, float* s) {
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p)[j];
      s[4 * j] = v.x;
      s[4 * j + 1] = v.y;
      s[4 * j + 2] = v.z;
      s[4 * j + 3] = v.w;
    }
  }
};
template <> struct Scale<__nv_bfloat16> {
  template <int kVec>
  __device__ __forceinline__ static void vec(const __nv_bfloat16* p,
                                             float* s) {
    using V = typename std::conditional<kVec == 8, uint4, uint2>::type;
    const V v = *reinterpret_cast<const V*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = __bfloat162float(e[j]);
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

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts 2^34 cycles (about ten seconds) is a broken pipeline, and traps,
// so that the launch fails with an error instead of holding the card.
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

// `bytes` (a multiple of 16) from 16-byte aligned src to 16-byte aligned
// shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// 4 bytes from src to shared dst, of which the first `bytes` (0 to 4) are
// read and the rest zeroed; src and dst 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

// One launch's ring, chosen by the launcher (plan_ring).  The block's
// warps form groups of warps_per_row warps; group g of block b takes row
// g * grid + b, then every (grid * groups)-th row after it, one row a
// stage of its own ring (neighbouring rows on neighbouring blocks).
struct Ring {
  int warps_per_row; // 1, or 4 to 32 (at most 15 groups of several)
  int groups;        // kRingWarps / warps_per_row
  int stages;        // a group's stages
  int row_bytes;     // a stage, a multiple of 16
  int scale_bytes;   // the scale's slot, a multiple of 16
  int stages_at;     // the first stage's offset in shared memory
};

// The bytes a row's bulk copy reads: every 16-byte granule the row
// touches, from the granule holding its first element; the row's element
// j then sits at (p % 16) + j * elem in the stage.  A granule never crosses
// a page, so the few bytes of a neighbour it holds at either end are
// mapped, and unused.
__device__ __forceinline__ uint32_t row_span(const void* p,
                                             uint32_t row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return static_cast<uint32_t>(((a + row_bytes + 15) & ~uintptr_t(15)) -
                               (a & ~uintptr_t(15)));
}

// The group's leader: row r's bulk copy into `stage`, on bar.
template <typename T>
__device__ __forceinline__ void fill_row(const T* xrow, int D,
                                         unsigned char* stage,
                                         uint64_t* bar) {
  const uint32_t bytes = row_span(xrow, D * sizeof(T));
  const uintptr_t a = reinterpret_cast<uintptr_t>(xrow) & ~uintptr_t(15);
  mbar_expect_tx(bar, bytes);
  bulk_load(stage, reinterpret_cast<const void*>(a), bytes, bar);
}

// Barrier among the group's nt threads (a warp: __syncwarp).
__device__ __forceinline__ void group_sync(int id, int nt) {
  if (nt == 32)
    __syncwarp();
  else
    bar_sync(id, nt);
}

// One row by the nt = 32 * wpr threads of its group (u: this thread's
// index in the group).  xrow: the row in device memory; stage: where it
// landed; red: the group's partial sums (wpr of them) for this row.
template <typename T, typename S>
__device__ __forceinline__ void norm_row(const T* xrow,
                                         const unsigned char* stage,
                                         T* yrow, const S* sc, int D,
                                         float eps, int u, int nt,
                                         float* red, int bar_id) {
  using E = Elem<T>;
  const T* xs = reinterpret_cast<const T*>(
      stage + (reinterpret_cast<uintptr_t>(xrow) & 15));
  float ss = 0.0f;
#pragma unroll 8
  for (int j = u; j < D; j += nt) {
    const float f = E::up(xs[j]);
    ss += f * f;
  }
  ss = warp_sum(ss);
  if (nt > 32) {
    if ((u & 31) == 0) red[u >> 5] = ss;
    bar_sync(bar_id, nt);
    ss = 0.0f;
    for (int i = 0; i < nt / 32; ++i) ss += red[i];
  }
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  auto out = [&](int j) {
    return E::down(E::up(xs[j]) * r * Elem<S>::up(sc[j]));
  };
  if constexpr (sizeof(T) == 2) {
    // bf16 y in 4-byte pairs from y's first 4-byte boundary, the
    // element before it and the one after the last pair alone
    const int p0 = static_cast<int>(
        (reinterpret_cast<uintptr_t>(yrow) >> 1) & 1);
    const int np = (D - p0) >> 1;
    if (u == 0 && p0) yrow[0] = out(0);
    if (u == 0 && ((D - p0) & 1)) yrow[D - 1] = out(D - 1);
#pragma unroll 4
    for (int m = u; m < np; m += nt) {
      const int j = p0 + 2 * m;
      __nv_bfloat162 v;
      v.x = out(j);
      v.y = out(j + 1);
      *reinterpret_cast<__nv_bfloat162*>(yrow + j) = v;
    }
  } else {
#pragma unroll 4
    for (int j = u; j < D; j += nt) yrow[j] = out(j);
  }
}

// The persistent ring.  Shared memory: [scale | partial sums | mbarriers:
// the groups' stages, then the scale's | stages, group by group].  No
// barrier spans the block after the start: each group waits only for its
// own rows and refills a stage as soon as its own warps have read it.
template <typename T, typename S>
__global__ void __launch_bounds__(kRingThreads)
rmsnorm_ring(const T* __restrict__ x, int64_t ldx,
             const S* __restrict__ scale, T* __restrict__ y, int rows,
             int D, float eps, Ring ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  S* sc = reinterpret_cast<S*>(smem);
  float* red = reinterpret_cast<float*>(smem + ring.scale_bytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ring.scale_bytes + kRedBytes);
  const int ns = ring.stages;
  const int nbar = ring.groups * ns;
  const int tid = threadIdx.x;
  const int nt = 32 * ring.warps_per_row;
  const int g = tid / nt;                     // this thread's group
  const int u = tid % nt;
  uint64_t* bars = full + g * ns;
  unsigned char* stages =
      smem + ring.stages_at + g * ns * ring.row_bytes;
  // a group's rows: first, first + step, ...
  const int64_t step = static_cast<int64_t>(gridDim.x) * ring.groups;
  const int64_t first = static_cast<int64_t>(g) * gridDim.x + blockIdx.x;
  const uint32_t scale_len = static_cast<uint32_t>(D) * sizeof(S);
  const bool scale_bulk =
      (reinterpret_cast<uintptr_t>(scale) & 15) == 0 && scale_len % 16 == 0;

  if (tid == 0) {
    for (int i = 0; i <= nbar; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && scale_bulk) {
    mbar_expect_tx(&full[nbar], scale_len);
    bulk_load(sc, scale, scale_len, &full[nbar]);
  }
  if (u == 0)
    for (int s = 0; s < ns; ++s) {
      const int64_t r = first + s * step;
      if (r < rows)
        fill_row<T>(x + r * ldx, D, stages + s * ring.row_bytes, &bars[s]);
    }
  if (!scale_bulk)
    for (int j = tid; j < D; j += kRingThreads) sc[j] = scale[j];
  __syncthreads();
  if (scale_bulk) mbar_wait(&full[nbar], 0);

  int it = 0;
  for (int64_t r = first; r < rows; r += step, ++it) {
    const int s = it % ns;
    unsigned char* stage = stages + s * ring.row_bytes;
    mbar_wait(&bars[s], (it / ns) & 1);
    norm_row<T, S>(x + r * ldx, stage, y + r * D, sc, D, eps, u, nt,
                   red + g * ring.warps_per_row, 1 + g);
    group_sync(1 + g, nt);  // the stage is read: refill it
    const int64_t next = r + ns * step;
    if (u == 0 && next < rows)
      fill_row<T>(x + next * ldx, D, stage, &bars[s]);
  }
}

// ---------------------------------------------------------------------------
// Direct: rows of whole 16-byte vectors, 16-byte aligned
// ---------------------------------------------------------------------------

// Each group of nt = 32 * wpr threads normalises one row (a block holds
// blockDim.x / nt groups, a block of 8 warps a row or more), the row's
// vectors in registers (NV a lane: up to kDirectVecs or kFewVecs, up to
// kMaxVecs for the widest rows; see launch_direct) and the scale loaded
// with them, before the sum (vector loads when the scale is 16-byte
// aligned, else element loads): one round trip to device memory, no ring
// to set up.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kDirectThreads)
rmsnorm_direct(const T* __restrict__ x, int64_t ldx,
               const S* __restrict__ scale, T* __restrict__ y, int rows,
               int D, float eps, int wpr) {
  using E = Elem<T>;
  constexpr int kV = 16 / sizeof(T);
  __shared__ float red[kDirectThreads / 32];
  const int nt = 32 * wpr;
  const int g = threadIdx.x / nt, u = threadIdx.x % nt;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / nt) + g;
  if (row >= rows) return;             // the whole group leaves together
  const int nv = D / kV;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
  const bool scale_vec = (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
  uint4 v[NV];
  float sv[NV][kV];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = u + i * nt;
    if (c < nv) {
      v[i] = xr[c];
      if (scale_vec) {
        Scale<S>::template vec<kV>(scale + c * kV, sv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) sv[i][j] = Elem<S>::up(scale[c * kV + j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (u + i * nt < nv) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = E::up(e[j]);
        ss += f * f;
      }
    }
  ss = warp_sum(ss);
  if (nt > 32) {
    if ((u & 31) == 0) red[threadIdx.x >> 5] = ss;
    bar_sync(1 + g, nt);
    ss = 0.0f;
    for (int i = 0; i < wpr; ++i) ss += red[g * wpr + i];
  }
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = u + i * nt;
    if (c < nv) {
      T* e = reinterpret_cast<T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < kV; ++j)
        e[j] = E::down(E::up(e[j]) * r * sv[i][j]);
      yr[c] = v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Columns: x[r, j] at x[r + j * ldx]
// ---------------------------------------------------------------------------

// A block takes tq words of rows (tq * P rows, P = 4 / sizeof(T) rows a
// word); shared memory is [tile: tq x (D | 1) words | scale in f32].
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_columns(const T* __restrict__ x, int64_t ldx,
                const S* __restrict__ scale, T* __restrict__ y, int rows,
                int D, float eps, int tq) {
  using E = Elem<T>;
  constexpr int P = 4 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = D | 1;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  float* sc = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(tq) * dp * 4 + 15) & ~size_t(15)));
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tq * P;
  const int lg = __ffs(tq) - 1;               // tq is a power of two
  for (int i = tid; i < tq * D; i += kThreads) {
    const int q = i & (tq - 1), j = i >> lg;
    const int64_t r = r0 + q * P;
    const int64_t left = rows - r;
    const int bytes = left >= P ? 4
                      : left > 0 ? static_cast<int>(left) * sizeof(T) : 0;
    cp_async4(tile + q * dp + j, bytes ? x + r + j * ldx : x, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = tid; j < D; j += kThreads) sc[j] = Elem<S>::up(scale[j]);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31;
  for (int q = tid >> 5; q < tq; q += kWarps) {
    const int64_t r = r0 + q * P;
    if (r >= rows) break;
    const uint32_t* w = tile + q * dp;
    float ss[P];
#pragma unroll
    for (int p = 0; p < P; ++p) ss[p] = 0.0f;
#pragma unroll 4
    for (int j = lane; j < D; j += 32) {
      const uint32_t v = w[j];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float f = E::up(e[p]);
        ss[p] += f * f;
      }
    }
    float rr[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      rr[p] = rsqrtf(warp_sum(ss[p]) / static_cast<float>(D) + eps);
    const int np = rows - r >= P ? P : static_cast<int>(rows - r);
#pragma unroll 4
    for (int j = lane; j < D; j += 32) {
      const uint32_t v = w[j];
      const T* e = reinterpret_cast<const T*>(&v);
      const float s = sc[j];
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p < np) y[(r + p) * D + j] = E::down(E::up(e[p]) * rr[p] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// Two passes, D > kMaxD: a block a row
// ---------------------------------------------------------------------------

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_two_pass(const T* __restrict__ x, int64_t ldx,
                 const S* __restrict__ scale, T* __restrict__ y, int rows,
                 int D, float eps) {
  using E = Elem<T>;
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  int n = 0;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x, ++n) {
    const T* xr = x + r * ldx;
    float ss = 0.0f;
    for (int j = tid; j < D; j += kThreads) {
      const float f = E::up(xr[j]);
      ss += f * f;
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) red[n & 1][tid >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int i = 0; i < kWarps; ++i) ss += red[n & 1][i];
    const float rr = rsqrtf(ss / static_cast<float>(D) + eps);
    for (int j = tid; j < D; j += kThreads)
      y[r * D + j] = E::down(E::up(xr[j]) * rr * Elem<S>::up(scale[j]));
  }
}

// ---------------------------------------------------------------------------
// The launcher
// ---------------------------------------------------------------------------

int round16(int64_t b) { return static_cast<int>((b + 15) & ~int64_t(15)); }

int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Lets `kernel` take up to kSmemLimit bytes of dynamic shared memory on the
// current device, once a device.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// mbarriers a ring block may need: every group's stages and the scale's
constexpr int kBarBytes = (8 * (kRingWarps * kMaxStages + 1) + 15) / 16 * 16;

// The fewest warps a row (1 to 32) that keep a lane at kMaxVecs 16-byte
// vectors of a row of `bytes`.
int warps_per_row(int bytes) {
  const int nv = (bytes + 15) / 16;
  int wpr = 1;
  while (wpr < kRingWarps && nv > 32 * wpr * kMaxVecs) wpr *= 2;
  return wpr;
}

// The ring for rows x D (elements of esz bytes, a scale of ssz): the
// fewest warps a row that keep a lane at kMaxVecs 16-byte vectors of it
// and leave room for two stages a group (a stage holds every granule a
// row touches); as many stages as fit, up to kMaxStages and no more than
// a group has rows; one block a SM, or one a row when there are fewer rows
// than SMs.  Writes the blocks to *grid and the dynamic shared memory to
// *smem.
Ring plan_ring(int rows, int D, int esz, int ssz, int sms, int* grid,
               int* smem) {
  Ring ring;
  ring.row_bytes = round16(int64_t(D) * esz) + 16;
  ring.scale_bytes = round16(int64_t(D) * ssz);
  ring.stages_at = ring.scale_bytes + kRedBytes + kBarBytes;
  const int avail = kSmemLimit - ring.stages_at;
  int wpr = warps_per_row(D * esz);
  // a group of several warps meets on named barrier 1 + g: 15 at most
  while (wpr > 1 && kRingWarps / wpr > 15) wpr *= 2;
  while (wpr < kRingWarps &&
         avail / (kRingWarps / wpr * ring.row_bytes) < 2)
    wpr *= 2;
  ring.warps_per_row = wpr;
  ring.groups = kRingWarps / wpr;
  *grid = rows < sms ? rows : sms;
  const int64_t lanes = int64_t(*grid) * ring.groups;
  const int64_t per = (rows + lanes - 1) / lanes;
  int ns = avail / (ring.groups * ring.row_bytes);
  if (ns > kMaxStages) ns = kMaxStages;
  if (ns > per) ns = static_cast<int>(per);
  ring.stages = ns < 1 ? 1 : ns;
  *smem = ring.stages_at + ring.groups * ring.stages * ring.row_bytes;
  return ring;
}

template <typename T, typename S>
cudaError_t launch_ring(const void* x, int64_t ldx, const void* scale,
                        void* y, int rows, int D, float eps,
                        cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int grid = 0, smem = 0;
  const Ring ring = plan_ring(rows, D, sizeof(T), sizeof(S), sm_count(),
                              &grid, &smem);
  auto kernel = rmsnorm_ring<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(kernel, done);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kRingThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps, ring);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_direct(const void* x, int64_t ldx, const void* scale,
                          void* y, int rows, int D, float eps,
                          cudaStream_t stream) {
  // Fewer rows than SMs wait on one round trip: up to kFewVecs vectors a
  // lane on up to kDirectThreads threads a row.  Else up to kDirectVecs a
  // lane within kWarps warps a row, a wider row up to kMaxVecs a lane (on
  // up to kDirectThreads threads, which hold a kMaxD row).  8 warps a
  // block or more.
  const int nv = D * static_cast<int>(sizeof(T)) / 16;
  const bool few = rows < sm_count();
  const int vecs = few ? kFewVecs : kDirectVecs;
  const int cap = few ? kDirectThreads / 32 : kWarps;
  int wpr = 1;
  while (wpr < cap && nv > 32 * wpr * vecs) wpr *= 2;
  while (nv > 32 * wpr * kMaxVecs) wpr *= 2;
  const int threads = wpr > kWarps ? 32 * wpr : kThreads;
  const int per_block = threads / (32 * wpr);
  const int per_lane = (nv + 32 * wpr - 1) / (32 * wpr);
  auto kernel = per_lane <= 1   ? rmsnorm_direct<T, S, 1>
                : per_lane <= 2 ? rmsnorm_direct<T, S, 2>
                : per_lane <= 4 ? rmsnorm_direct<T, S, 4>
                                : rmsnorm_direct<T, S, kMaxVecs>;
  kernel<<<(rows + per_block - 1) / per_block, threads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps, wpr);
  return cudaGetLastError();
}

// Words of rows a columns block takes: 16, 8, 4, 2 or 1, the most whose
// tile and f32 scale fit in kColumnsSmem; 0 if none does.
int columns_words(int D) {
  for (int tq = 16; tq >= 1; tq /= 2)
    if (round16(int64_t(tq) * (D | 1) * 4) + int64_t(D) * 4 <= kColumnsSmem)
      return tq;
  return 0;
}

template <typename T, typename S>
cudaError_t launch_columns(const void* x, int64_t ldx, const void* scale,
                           void* y, int rows, int D, float eps,
                           cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int tq = columns_words(D);
  if (tq == 0) return cudaErrorInvalidValue;
  const int per_block = tq * static_cast<int>(4 / sizeof(T));
  const int grid = (rows + per_block - 1) / per_block;
  const int smem = round16(int64_t(tq) * (D | 1) * 4) + D * 4;
  auto kernel = rmsnorm_columns<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(kernel, done);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps, tq);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_two_pass(const void* x, int64_t ldx, const void* scale,
                            void* y, int rows, int D, float eps,
                            cudaStream_t stream) {
  rmsnorm_two_pass<T, S><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

bool aligned(const void* p, int a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// The path for x's type T and the scale's type S (see the note at the top).
template <typename T, typename S>
int dispatch(const void* x, int64_t row_stride, int64_t col_stride,
             const void* scale, void* y, int rows, int D, float eps,
             cudaStream_t s) {
  constexpr int esz = sizeof(T);
  if (col_stride == 1) {
    if (D > kMaxD)
      return launch_two_pass<T, S>(x, row_stride, scale, y, rows, D, eps, s);
    const bool vec = aligned(x, 16) && aligned(y, 16) &&
                     D % (16 / esz) == 0 &&
                     (rows == 1 || (row_stride * esz) % 16 == 0);
    if (vec)
      return launch_direct<T, S>(x, row_stride, scale, y, rows, D, eps, s);
    return launch_ring<T, S>(x, row_stride, scale, y, rows, D, eps, s);
  }
  if (row_stride == 1 && aligned(x, 4) && (col_stride * esz) % 4 == 0)
    return launch_columns<T, S>(x, col_stride, scale, y, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

#if defined(REPRO_ELEM_BF16)
typedef __nv_bfloat16 ReproElem;
#elif defined(REPRO_ELEM_F32)
typedef float ReproElem;
#else
#error "define one of REPRO_ELEM_BF16, REPRO_ELEM_F32"
#endif

extern "C" {

// y (rows, D), contiguous, = rmsnorm of x, whose element (r, j) is
// x[r * row_stride + j * col_stride] (in elements), with a contiguous scale
// (D,) in bf16 (scale_bf16 != 0) or f32.  col_stride 1 takes any row
// stride; row_stride 1 takes a col_stride whose bytes are a multiple of 4
// (x 4-byte aligned, D small enough for a columns tile); any other layout
// is refused.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int repro_rmsnorm(const void* x, int64_t row_stride, int64_t col_stride,
                  const void* scale, void* y, int rows, int D, float eps,
                  int scale_bf16, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scale_bf16
             ? repro::dispatch<ReproElem, __nv_bfloat16>(
                   x, row_stride, col_stride, scale, y, rows, D, eps, s)
             : repro::dispatch<ReproElem, float>(
                   x, row_stride, col_stride, scale, y, rows, D, eps, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
