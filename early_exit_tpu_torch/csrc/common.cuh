// Shared helpers of the port's CUDA kernels (sm_90a, bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace wmma = nvcuda::wmma;

#define EET_TRY(expr)                                   \
  do {                                                  \
    cudaError_t eet_err_ = (expr);                      \
    if (eet_err_ != cudaSuccess) return eet_err_;       \
  } while (0)

extern "C" const char* eet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round a float to the nearest bf16 value, kept as float
__device__ __forceinline__ float bf16r(float v) { return bf2f(f2bf(v)); }

// SiLU and sigmoid as the TPU kernel writes them in bf16:
// v / (1 + exp(-v)) and 1 / (1 + exp(-v)), each op rounded to bf16
__device__ __forceinline__ float silu_bf16(float v) {
  float d = bf16r(1.f + bf16r(expf(-v)));
  return bf16r(v / d);
}
__device__ __forceinline__ float sigmoid_bf16(float v) {
  float d = bf16r(1.f + bf16r(expf(-v)));
  return bf16r(1.f / d);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
