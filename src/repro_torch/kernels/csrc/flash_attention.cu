// Flash attention forward on Hopper (sm_90a): causal or full softmax
// attention over q, k, v of shape (B, S, H, D), online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention.py:68 (body _flash_kernel :29).  The
// function is that kernel's: q is scaled by D**-0.5 in f32 before the q.k
// product; the causal mask keeps key j for query i when j <= i, on absolute
// positions from 0 (top-left aligned, also when Skv != S), and fills the
// rest with -1e30, not -inf; the running max m, sum l and f32 accumulator
// update once per key block; the output is acc / max(l, 1e-30) cast to q's
// type.  Only the order of the sums differs.
//
// Block independence.  The Pallas grid is (B*H, S/bq, Skv/bk) with the key
// axis sequential ("arbitrary"), carrying m, l and acc across grid steps in
// VMEM.  Hopper's blocks run in parallel and in no order, so here one
// thread block owns one (batch*head, 64-query tile) and loops over the keys
// itself, 64 at a time; m and l live in registers (one copy per query row,
// held by the 16 threads that share the row) and so does acc.
//
// Head dims.  The kernel is compiled for the widths D = 64, 128 and 256 and
// takes the true head dim d <= D at run time: d <= 64 runs the 64-wide
// instantiation, 64 < d <= 128 the 128-wide one, 128 < d <= 256 the
// 256-wide one.  Loads past d read zero, which adds nothing to q.k, stores
// past d are skipped, and the scale is d**-0.5 of the true d.
//
// Layout.  q, k and v are read in their (B, S, H, D) layout through the
// batch, sequence and head strides the wrapper passes (D has unit stride);
// nothing is copied into the Pallas wrapper's (B*H, S, D) layout.  The
// output is written contiguous (B, S, H, D).
//
// Tiles.  The JAX 128 x 128 blocks are a VMEM choice: in f32 with D = 128
// the q, k and v tiles alone would take 192 KB of the 227 KB a block may
// claim.  This kernel stages a 64 x D query tile (scaled, f32), a 64 x D key
// tile and a 64 x D value tile in shared memory as f32, plus the 64 x 64
// probabilities: 70,144 B at D = 64, 119,296 B at D = 128, 217,600 B at
// D = 256 (of the 232,448 a block may claim).  The q and k
// rows are padded to D + 1 floats and the p rows to 80, so the reads below
// are free of bank conflicts.  256 threads form a 16 x 16 grid; thread
// (ty, tx) owns query rows ty + 16i (i < 4), score columns tx + 16j (j < 4)
// and output columns tx + 16c (c < D/16).  Rows and keys past S or Skv are
// masked, so S and Skv need not divide the tile.  Blocks run on a
// (B*H, ceil(S/64)) grid: B*H on gridDim.x (up to 2^31 - 1), the query
// tiles on gridDim.y (up to 65,535, so S up to 4,194,240).
//
// Masked blocks.  With causal on, the key loop stops after the block that
// holds the tile's last query: every later key is masked for every row of
// the tile, and such a block would give p = 0 and corr = 1, so skipping it
// is exact.
//
// What bounds it on an H100: at the served prefill (S = 32) it moves a few
// hundred KB and is bound by bytes and launch latency; from S of a few
// hundred on, the 4*B*H*D*(visible pairs) operations dominate (at
// S = 4096, 24 heads, D = 64: 51.6 GFLOP against 50 MB), so the bound is
// operations.  The design keeps the S x Skv scores out of device memory
// (bytes O(S*D), not O(S^2)) and halves the causal work by the early stop.
// This first version computes in f32 on the CUDA cores (expf, not __expf,
// so f32 holds the JAX tests' 1e-5), against the 67 TFLOP/s f32 rate, not
// the 989 TFLOP/s bf16 tensor cores; wgmma is later work.  A bf16 wgmma of
// q.k must then apply the scale to the scores, since the JAX kernel scales
// q in f32 before the product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_ELEM_<BF16|F32> flash_attention.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: each library keeps its own kernels and `configured`
// flags (see tile_gemm.cuh).
namespace repro {
namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per step
constexpr int kThreads = 256;     // a 16 x 16 thread grid
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr int kLP = kBK + 16;     // padded row stride of the p tile
constexpr float kNegInf = -1e30f;

// Loads widen to f32; stores round to the element type.
template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ __forceinline__ static float up(float x) { return x; }
  __device__ __forceinline__ static void put(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float up(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as jnp .astype and torch .to do
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// Max and sum over the 16 threads of one half-warp (the threads of one
// query row).  The xor butterfly leaves the same value in every lane.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * kLP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Skv, int H,
          int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
          int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int d,
          int causal, float scale) {
  static_assert(D % 32 == 0, "the padded rows assume D % 32 == 0");
  using E = Elem<T>;
  constexpr int kLD = D + 1;      // padded row stride of the q and k tiles
  constexpr int kOut = D / 16;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // kBQ x kLD, scaled q
  float* Ks = Qs + kBQ * kLD;     // kBK x kLD
  float* Vs = Ks + kBK * kLD;     // kBK x D
  float* Ps = Vs + kBK * D;       // kBQ x kLP, probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    Qs[r * kLD + c] =
        qi < S && c < d ? E::up(qb[qi * qss + c]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  // causal: keys past the tile's last query are masked for every row
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the last step's readers of Ks, Vs and Ps are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kj = k0 + r;
      const bool in = kj < Skv && c < d;
      Ks[r * kLD + c] = in ? E::up(kb[kj * kss + c]) : 0.0f;
      Vs[r * D + c] = in ? E::up(vb[kj * vss + c]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty + 16 * i) * kLD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = Ks[(tx + 16 * j) * kLD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= Skv || (causal && kj > qi)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        Ps[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * S + qi) * H + h) * d;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      if (tx + 16 * c < d) E::put(orow + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Skv, int H, int d, const int64_t* st,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // d**-0.5 of the true head dim, rounded once to f32, as the JAX kernel's
  // Python float scale
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], d, causal != 0,
      scale);
  return cudaGetLastError();
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

// o (B, S, H, D), contiguous = attention of q (B, S, H, D) over k, v
// (B, Skv, H, D), each given by its (batch, sequence, head) strides in
// elements with unit stride on D.  D is 1 to 256 (the 64-, 128- or 256-wide
// instantiation, the smallest that holds it).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int Skv, int H, int D,
                          int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                          int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                          int64_t vsh, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || D <= 0 || D > 256)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * H > 2147483647LL ||
      (static_cast<int64_t>(S) + repro::kBQ - 1) / repro::kBQ > 65535)
    return cudaErrorInvalidValue;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return repro::launch<ReproElem, 64>(q, k, v, o, B, S, Skv, H, D, st,
                                        causal, s);
  if (D <= 128)
    return repro::launch<ReproElem, 128>(q, k, v, o, B, S, Skv, H, D, st,
                                         causal, s);
  return repro::launch<ReproElem, 256>(q, k, v, o, B, S, Skv, H, D, st,
                                       causal, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
