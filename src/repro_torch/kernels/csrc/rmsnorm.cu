// Fused RMSNorm on Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale
// over the last axis, statistics in f32, the output in x's type.
//
// Replaces the Pallas TPU kernel rmsnorm of src/repro/kernels/rmsnorm.py:29
// (body _rmsnorm_kernel :22).  That kernel tiles rows by block_rows and
// keeps each row whole in VMEM; the function is the same here: the sum of
// squares in f32, rsqrt(sum / D + eps), (x * r) * scale with scale in f32,
// rounded once to x's type.  Only the order of the sum and the last bit of
// rsqrtf differ from the plain version's.
//
// The scale is read in its own type, bf16 or f32 (the models keep it in
// their compute dtype), and widened to f32 in registers, as the JAX
// kernel's body does (scale_ref[...].astype(jnp.float32)).  The widening
// is exact, so the output is the one an f32 copy of the scale gives; the
// wrapper launches no conversion kernel and allocates nothing but y.
//
// What bounds it on an H100: bytes.  Each row is read once and written once
// for 4 operations per element, far below the card's ~295 flop/byte ridge,
// so the bound is (2 * rows * D * elem + 4 * D) bytes over 3.35 TB/s.  The
// design reads each row from device memory once: one warp per row, 16-byte
// loads, the row kept in registers between the sum of squares and the
// scaling (D = 1536 in bf16: six 16-byte vectors, 48 values, per lane), the
// sum reduced across the warp with shuffles, 16-byte stores.  8 rows (warps)
// per block of 256 threads; rows need not divide anything.
//
// Three paths, chosen by the launcher (kernels/rmsnorm.py:path mirrors the
// rule; a scale whose base is not 16-byte aligned takes the scalar path
// rather than being copied):
//   * registers: x, y and scale 16-byte aligned, D a multiple of 8 (bf16)
//     or 4 (f32), so every row is a whole number of aligned 16-byte
//     vectors, and at most 32 vectors per lane (D <= 8192 in bf16, 4096 in
//     f32): the row is read once and held in registers, as above.
//   * two-pass: the same alignment, a wider row (kimi-k2's d_model 7168 in
//     f32): the row is read twice from device memory, once for the sum of
//     squares and once for the scaling, in 16-byte vectors.
//   * scalar: D not a multiple of the vector width, or a base that is not
//     16-byte aligned: element loads, lane j taking elements j, j + 32, ...,
//     the last group masked at D, and the row read twice as above.
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

constexpr int kWarps = 8;         // rows per block
constexpr int kMaxVecs = 32;      // 16-byte vectors per lane, at most

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

// The scale, read in its own type S and widened to f32: kVec values at a
// 16-byte aligned vector index (the register and two-pass vector paths),
// or one value.
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
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};
template <> struct Scale<__nv_bfloat16> {
  // kVec bf16 values: 16 bytes (kVec = 8, bf16 x) or 8 (kVec = 4, f32 x)
  template <int kVec>
  __device__ __forceinline__ static void vec(const __nv_bfloat16* p,
                                             float* s) {
    using V = typename std::conditional<kVec == 8, uint4, uint2>::type;
    const V v = *reinterpret_cast<const V*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = __bfloat162float(e[j]);
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// NV: 16-byte vectors per lane the row needs, rounded up to a compiled
// count; lanes past the row's last vector hold nothing.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ y, int rows, int D, float eps) {
  using E = Elem<T>;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= rows) return;            // the whole warp leaves together
  const int nvec = D / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4 buf[NV];
  // A short row (the served 4 and 32 rows of 1536) is latency-bound: its
  // scale is loaded with x, before the reduction, rather than after it.
  constexpr bool kEarlyScale = NV * kVec <= 64;
  float early[kEarlyScale ? NV : 1][kVec];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      buf[i] = xr[vi];
      if constexpr (kEarlyScale)
        Scale<S>::template vec<kVec>(scale + vi * kVec, early[i]);
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = E::up(e[j]);
        ss += f * f;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      float late[kVec];
      const float* s = late;
      if constexpr (kEarlyScale)
        s = early[i];
      else
        Scale<S>::template vec<kVec>(scale + vi * kVec, late);
      T* e = reinterpret_cast<T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) E::put(e + j, E::up(e[j]) * r * s[j]);
      yr[vi] = buf[i];
    }
  }
}

// The two-pass paths: one warp per row, which is read once for the sum of
// squares and once more for the scaling.  kVecLoads: 16-byte vectors (the
// row a whole number of aligned vectors); else one element per lane per
// step, masked at D.
template <typename T, typename S, bool kVecLoads>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_two_pass(const T* __restrict__ x, const S* __restrict__ scale,
                 T* __restrict__ y, int rows, int D, float eps) {
  using E = Elem<T>;
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nvec = D / kVec;
  float ss = 0.0f;
  if (kVecLoads) {
    for (int vi = lane; vi < nvec; vi += 32) {
      const uint4 v = reinterpret_cast<const uint4*>(xr)[vi];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = E::up(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float f = E::up(xr[c]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  if (kVecLoads) {
    for (int vi = lane; vi < nvec; vi += 32) {
      uint4 v = reinterpret_cast<const uint4*>(xr)[vi];
      T* e = reinterpret_cast<T*>(&v);
      float sc[kVec];
      Scale<S>::template vec<kVec>(scale + vi * kVec, sc);
#pragma unroll
      for (int j = 0; j < kVec; ++j) E::put(e + j, E::up(e[j]) * r * sc[j]);
      reinterpret_cast<uint4*>(yr)[vi] = v;
    }
  } else {
    for (int c = lane; c < D; c += 32)
      E::put(yr + c, E::up(xr[c]) * r * Scale<S>::one(scale + c));
  }
}

template <typename T, typename S, int NV>
cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                   int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_rows<T, S, NV><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename S, bool kVecLoads>
cudaError_t launch_two_pass(const void* x, const void* scale, void* y,
                            int rows, int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_two_pass<T, S, kVecLoads><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

// The path for x's type T and the scale's type S (see the note at the top).
template <typename T, typename S>
int dispatch(const void* x, const void* scale, void* y, int rows, int D,
             float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(scale) |
                          reinterpret_cast<uintptr_t>(y);
  if (align % 16 != 0 || D % kVec != 0)
    return launch_two_pass<T, S, false>(x, scale, y, rows, D, eps, s);
  const int per_lane = (D / kVec + 31) / 32;
  if (per_lane > kMaxVecs)
    return launch_two_pass<T, S, true>(x, scale, y, rows, D, eps, s);
#define REPRO_NV_CASE(NV_)                                                   \
  if (per_lane <= NV_) return launch<T, S, NV_>(x, scale, y, rows, D, eps, s);
  REPRO_NV_CASE(1) REPRO_NV_CASE(2) REPRO_NV_CASE(4) REPRO_NV_CASE(6)
  REPRO_NV_CASE(8) REPRO_NV_CASE(12) REPRO_NV_CASE(16) REPRO_NV_CASE(24)
  REPRO_NV_CASE(kMaxVecs)
#undef REPRO_NV_CASE
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

// y (rows, D) = rmsnorm of x (rows, D), both contiguous, with a scale (D,)
// in bf16 (scale_bf16 != 0) or f32, contiguous.  Any D and any base: the
// path follows from D and the alignment of x, y and scale (see the note at
// the top).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int repro_rmsnorm(const void* x, const void* scale, void* y, int rows, int D,
                  float eps, int scale_bf16, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scale_bf16
             ? repro::dispatch<ReproElem, __nv_bfloat16>(x, scale, y, rows, D,
                                                         eps, s)
             : repro::dispatch<ReproElem, float>(x, scale, y, rows, D, eps,
                                                 s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
