// Shared helpers of the port's CUDA kernels (sm_90a, bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace wmma = nvcuda::wmma;

#define EET_TRY(...)                                    \
  do {                                                  \
    cudaError_t eet_err_ = (__VA_ARGS__);               \
    if (eet_err_ != cudaSuccess) return eet_err_;       \
  } while (0)

extern "C" const char* eet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round a float to the nearest bf16 value, kept as float
__device__ __forceinline__ float bf16r(float v) { return bf2f(f2bf(v)); }

// Element types: a kernel templated on T computes in float and rounds to
// T where the TPU kernel holds a T value (no rounding for float).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return f2bf(v); }
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// SiLU and sigmoid as the TPU kernel writes them in its compute type:
// v / (1 + exp(-v)) and 1 / (1 + exp(-v)), each op rounded to T
template <typename T> __device__ __forceinline__ float silu_t(float v) {
  float d = rnd<T>(1.f + rnd<T>(expf(-v)));
  return rnd<T>(v / d);
}
template <typename T> __device__ __forceinline__ float sigmoid_t(float v) {
  float d = rnd<T>(1.f + rnd<T>(expf(-v)));
  return rnd<T>(1.f / d);
}

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for float)
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = bf2f(e[q]);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) e[q] = f2bf(f[q]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
