// Float32 self-attention with a key mask, shared by attention.cu (the
// (B, H, T, dh) layout) and the float32 entry of conformer_block.cu (the
// packed (B*T, 3D) q|k|v rows): the layouts differ only in strides.
//
// One block per (64-query tile, head, item). K and V of the (item, head)
// sit in shared memory as float32; each warp takes one query at a time:
// lanes split the keys for the scores, the row's probabilities go
// through a per-warp strip of shared memory, and lane d sums column d of
// P V. Arithmetic, in this order and all in float32:
//   s = (q . k) * scale;  s = valid ? s : -1e9;  p = exp(s - max s);
//   p = p / sum p;  o = sum_t p[t] v[t]
// A row whose keys are all masked gets uniform p, the mean of v.
//
// Bound at B=128, H=8, T=249, dh=32: 4*T*T*dh FLOP per head, 8.1 GFLOP,
// 0.12 ms at 67 TFLOP/s (float32 outside the tensor cores); q, k, v in
// and o out are 0.13 GB in float32, 0.04 ms. Each FMA of the scores reads
// one float of K from shared memory and each FMA of P V two (the
// probability and V), which holds this design to about an eighth of the
// FMA rate (1.04 ms on an H100 at 700 W); two queries a warp would halve
// those reads.
#pragma once

#include "common.cuh"

constexpr int AF_WARPS = 8;
constexpr int AF_QTILE = 64;
constexpr size_t AF_SMEM_LIMIT = 232448;

template <int DH>
struct AttF32Layout {
  static constexpr int KLD = DH + 1;  // K row stride: lanes on distinct banks
  // K, V, one strip of T probabilities per warp, key validity
  __host__ __device__ static size_t bytes(int T) {
    return ((size_t)T * KLD + (size_t)T * DH + (size_t)AF_WARPS * T + T) * sizeof(float);
  }
  static int max_t() {
    int t = 1;
    while (bytes(t + 1) <= AF_SMEM_LIMIT) ++t;
    return t;
  }
};

// Strides in elements: *_bs between items, *_hs between heads, *_ts
// between frames. Keys t are valid where mask[b*T + t] != 0, or, with
// mask == nullptr, where t < lengths[b].
template <typename TIn, int DH>
__global__ void __launch_bounds__(AF_WARPS * 32)
attention_f32_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                     const TIn* __restrict__ v, const unsigned char* __restrict__ mask,
                     const int* __restrict__ lengths, float* __restrict__ out, int T,
                     long long in_bs, long long in_hs, long long in_ts, long long out_bs,
                     long long out_hs, long long out_ts, float scale) {
  static_assert(DH == 32, "one output column per lane");
  constexpr int KLD = AttF32Layout<DH>::KLD;
  extern __shared__ __align__(16) float af_smem[];
  float* Ks = af_smem;
  float* Vs = Ks + (size_t)T * KLD;
  float* Ps = Vs + (size_t)T * DH;
  float* valid = Ps + (size_t)AF_WARPS * T;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AF_QTILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long in0 = b * in_bs + h * in_hs;

  for (int idx = threadIdx.x; idx < T * DH; idx += blockDim.x) {
    const int t = idx / DH, d = idx % DH;
    Ks[t * KLD + d] = to_f(k[in0 + t * in_ts + d]);
    Vs[t * DH + d] = to_f(v[in0 + t * in_ts + d]);
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    valid[t] = (mask != nullptr ? mask[(size_t)b * T + t] != 0 : t < lengths[b]) ? 1.f : 0.f;
  __syncthreads();

  float* P = Ps + (size_t)warp * T;
  const int q_end = min(q0 + AF_QTILE, T);
  for (int qi = q0 + warp; qi < q_end; qi += AF_WARPS) {
    float qr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = to_f(q[in0 + qi * in_ts + d]);
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) {
      const float* kr = Ks + t * KLD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      s = valid[t] > 0.5f ? s * scale : -1e9f;
      P[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float z = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(P[t] - m);
      P[t] = e;
      z += e;
    }
    z = warp_sum(z);
    for (int t = lane; t < T; t += 32) P[t] = P[t] / z;
    __syncwarp();
    float o = 0.f;
    for (int t = 0; t < T; ++t) o = fmaf(P[t], Vs[t * DH + lane], o);
    out[b * out_bs + h * out_hs + qi * out_ts + lane] = o;
    __syncwarp();
  }
}

template <typename TIn>
static cudaError_t attention_f32(const TIn* q, const TIn* k, const TIn* v,
                                 const unsigned char* mask, const int* lengths, float* out,
                                 int B, int H, int T, long long in_bs, long long in_hs,
                                 long long in_ts, long long out_bs, long long out_hs,
                                 long long out_ts, float scale, cudaStream_t s) {
  const size_t bytes = AttF32Layout<32>::bytes(T);
  if (bytes > AF_SMEM_LIMIT) return cudaErrorInvalidValue;
  EET_TRY(cudaFuncSetAttribute(attention_f32_kernel<TIn, 32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  const dim3 grid((T + AF_QTILE - 1) / AF_QTILE, H, B);
  attention_f32_kernel<TIn, 32><<<grid, AF_WARPS * 32, bytes, s>>>(
      q, k, v, mask, lengths, out, T, in_bs, in_hs, in_ts, out_bs, out_hs, out_ts, scale);
  return cudaGetLastError();
}
