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
// What bounds it on an H100: bytes.  Each row is read once and written once
// for 4 operations per element, far below the card's ~295 flop/byte ridge,
// so the bound is (2 * rows * D * elem + 4 * D) bytes over 3.35 TB/s.  The
// design reads each row from device memory once: one warp per row, 16-byte
// loads, the row kept in registers between the sum of squares and the
// scaling (D = 1536 in bf16: six 16-byte vectors, 48 values, per lane), the
// sum reduced across the warp with shuffles, 16-byte stores.  8 rows (warps)
// per block of 256 threads; rows need not divide anything.
//
// D must be a multiple of 8 (bf16) or 4 (f32), so a row is a whole number
// of 16-byte vectors, and at most 32 vectors per lane: D <= 8192 in bf16,
// 4096 in f32.  The launcher refuses anything else, as kernels/rmsnorm.py
// does first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DREPRO_ELEM_<BF16|F32> rmsnorm.cu
// One shared library per element type, loaded with ctypes by
// kernels/build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// NV: 16-byte vectors per lane the row needs, rounded up to a compiled
// count; lanes past the row's last vector hold nothing.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
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
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      buf[i] = xr[vi];
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
      const float4* sc = reinterpret_cast<const float4*>(scale + vi * kVec);
      T* e = reinterpret_cast<T*>(&buf[i]);
#pragma unroll
      for (int j4 = 0; j4 < kVec / 4; ++j4) {
        const float4 s4 = sc[j4];
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          E::put(e + 4 * j4 + j, E::up(e[4 * j4 + j]) * r * s[j]);
      }
      yr[vi] = buf[i];
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                   int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_rows<T, NV><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), rows, D, eps);
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

// y (rows, D) = rmsnorm of x (rows, D), both contiguous and 16-byte
// aligned, with an f32 scale (D,), also aligned.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int repro_rmsnorm(const void* x, const void* scale, void* y, int rows, int D,
                  float eps, void* stream) {
  constexpr int kVec = 16 / sizeof(ReproElem);
  if (rows <= 0 || D <= 0 || D % kVec != 0) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(scale) |
                          reinterpret_cast<uintptr_t>(y);
  if (align % 16 != 0) return cudaErrorMisalignedAddress;
  const int per_lane = (D / kVec + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_NV_CASE(NV_)                                                   \
  if (per_lane <= NV_)                                                       \
    return repro::launch<ReproElem, NV_>(x, scale, y, rows, D, eps, s);
  REPRO_NV_CASE(1) REPRO_NV_CASE(2) REPRO_NV_CASE(4) REPRO_NV_CASE(6)
  REPRO_NV_CASE(8) REPRO_NV_CASE(12) REPRO_NV_CASE(16) REPRO_NV_CASE(24)
  REPRO_NV_CASE(repro::kMaxVecs)
#undef REPRO_NV_CASE
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
