// One inference Conformer block for Hopper (sm_90a), in four entries: the
// bf16 profile, float32 (with either softmax dtype), W8A8 (int8 products
// in the bf16 profile), and bf16 compute with a float32 residual.
//
// Replaces the TPU kernel early_exit_tpu/ops/pallas/conformer_block.py
// (fused_block_apply -> _block_kernel, with compute_dtype bf16 or float32,
// residual_dtype and attn_softmax_dtype, and quantize="int8"), at any
// width but heads past 128: the wrapper pads d_model and d_ff to
// multiples of 16 and each head to an instantiated width with zero
// weights (`block_plan`), and every entry takes the true d_model for its
// LayerNorms and 1/sqrt of the true head width as its scale. That kernel keeps a whole block
// of two items resident in VMEM; a block's shared memory (227 KB) holds
// nothing of that size, so here one C entry launches a sequence of
// kernels on the caller's stream, with the intermediates in device
// memory:
//
//   LN -> GEMM(W1)+SiLU -> GEMM(W2) x + 0.5*y      macaron half-FFN
//   LN -> GEMM(Wqkv) -> attention -> GEMM(Wo) x + y   MHSA
//   LN -> GEMM(PW1) -> conv module -> GEMM(PW2) x + y
//   LN -> GEMM(W1)+SiLU -> GEMM(W2) x + 0.5*y      second half-FFN
//   final LN, padded rows zeroed
//
// Numerics follow the TPU kernel: LayerNorm with one-pass float32
// statistics, max(E[x^2] - mu^2, 0); every product in bf16 with float32
// accumulation, rounded to bf16 before the bf16 bias add; a bf16
// residual stream; bf16 SiLU/GLU op by op; depthwise conv accumulated in
// float32 tap by tap and rounded once; scores either bf16 (rounded,
// scaled in bf16, masked to -30000) or float32 (masked to -1e9).
//
// Bound on an H100 SXM at the main-path shape (B=128, T'=249, 31,872
// rows): ~5.38 MFLOP per row, ~171.5 GFLOP per block, ~0.17 ms at 989
// TFLOP/s dense bf16 -- compute-bound; the FFN intermediate (31,872 x
// 2048 bf16, ~130 MB written and read) adds ~0.08 ms of traffic at 3.35
// TB/s if it goes through device memory, as it does here.
//
// The ten products are 95% of those operations, and only wgmma reaches
// the card's tensor-core rate: they run through one persistent,
// warp-specialised kernel (gemm_bf16.cuh: TMA loads onto mbarriers into
// rings of four stages, wgmma.mma_async m64n256k16, epilogue from the
// accumulator registers). What the design still leaves
// on the table: the FFN and QKV intermediates go through device memory (a
// half-FFN in one kernel would keep the 130 MB on chip, and W1's SiLU
// epilogue with it); LayerNorm runs as its own pass instead of in the
// next GEMM's prologue; attention computes its scores three times to keep
// the TPU kernel's rounding points.
//
// The float32 entry runs the same chain on float32 tensors: a tiled FMA
// product in true float32 (no TF32), the float32 attention of
// attention_f32.cuh (register-tiled, K and V streamed, any T'), scores
// masked to -1e9. Its bound at the same shape
// is 171.5 GFLOP at 67 TFLOP/s (float32 outside the tensor cores),
// 2.6 ms.
//
// The W8A8 entry replaces the block's 10 products: the float input of
// each (the float32 LayerNorm, conv-module or float32-softmax attention
// output, or a bf16 activation) is quantized row by row (absmax -> sx =
// max(amax, 1e-8) / 127 -> rint(v / sx) clipped to +-127), multiplied
// int8 x int8 -> int32 on the tensor cores with the per-output-channel
// int8 weights, and rescaled in the epilogue: float(acc) * (sx * sw) +
// float32 bias -> one rounding to bf16 -> the fused SiLU / residual add.
// Scores, P V and the depthwise conv stay in the float path. Its products
// are 163 of the block's 171.5 G operations: 0.082 ms at 1,979 TOP/s int8
// plus 0.009 ms for the rest at 989 TFLOP/s, 0.091 ms; 25 MB of
// activations in and out at 3.35 TB/s are 0.01 ms. Design:
//   - the products run through gemm_s8.cuh: the bf16 product's persistent,
//     warp-specialised wgmma + TMA kernel with int8 operands
//     (m64n256k32 .s32.s8.s8, both operands K-major);
//   - five of the eight quantizations happen in the kernels that make the
//     values: the four LayerNorms (one warp a row, the row in registers
//     from the one read of x to the int8 store up to D 512, reread past
//     it: no float32 LayerNorm output goes through device memory) and the
//     conv module (a block's 32 rows wait in shared memory for their
//     absmax, where they fit beside its tile; at d 1024 it writes float32
//     rows and a pass quantizes them). The attention
//     output (a row's 8 heads are 8 blocks) and the W1 output (a row's
//     2048 columns are 8 tiles) keep a quantize pass each.

#include <type_traits>

#include "attention_f32.cuh"
#include "gemm_s8.cuh"

// The bf16 entry's ten products: gemm() of gemm_bf16.cuh, the W8A8
// entry's gemm_s8() of gemm_s8.cuh (both wgmma + TMA). The float32
// products below run on 256 threads a block.
constexpr int GTHREADS = 256;

// -------------------------------------------------------- float32 GEMM
// out[M, N] = epilogue(A[M, K] @ W[K, N] + bias[N]), FMA in float32 with
// the k index running in order. 128 x 128 x 8 tiles; each thread owns an
// 8 x 8 block of the tile as four 4 x 4 quadrants.
constexpr int FBM = 128, FBN = 128, FBK = 8;

// kRaggedN: N a multiple of 4 but not of 128 (a padded Conformer-S width,
// 576 or 144): the last column tile's loads past N read zeros and its
// stores past N are dropped. N % 128 == 0 runs the code it ran before.
template <int EPI, bool kRaggedN = false>
__global__ void __launch_bounds__(GTHREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* res, float* out, int M, int N,
                int K) {
  __shared__ __align__(16) float As[2][FBK][FBM];  // transposed: [k][m]
  __shared__ __align__(16) float Bs[2][FBK][FBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;  // A: 128 rows x 2 float4
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;   // W: 8 rows x 32 float4

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra, rb;
  auto load_tile = [&](int k0) {
    const int gm = m0 + a_row;
    ra = gm < M ? *reinterpret_cast<const float4*>(A + (size_t)gm * K + k0 + a_k)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = !kRaggedN || n0 + b_n < N
             ? *reinterpret_cast<const float4*>(W + (size_t)(k0 + b_k) * N + n0 + b_n)
             : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_tile = [&](int buf) {
    As[buf][a_k + 0][a_row] = ra.x;
    As[buf][a_k + 1][a_row] = ra.y;
    As[buf][a_k + 2][a_row] = ra.z;
    As[buf][a_k + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = rb;
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  const int KT = K / FBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load_tile((kt + 1) * FBK);
    compute(cur);
    if (kt + 1 < KT) store_tile(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int gn = n0 + jh * 64 + tx * 4;
      if (kRaggedN && gn >= N) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + gn);
      float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (EPI == EPI_RES || EPI == EPI_RES_HALF)
        rv = *reinterpret_cast<const float4*>(res + (size_t)gm * N + gn);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w}, rr[4] = {rv.x, rv.y, rv.z, rv.w};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = acc[i][jh * 4 + q] + bb[q];
        if (EPI == EPI_SILU) v = silu_t<float>(v);
        if (EPI == EPI_RES) v = rr[q] + v;
        if (EPI == EPI_RES_HALF) v = rr[q] + 0.5f * v;
        o[q] = v;
      }
      *reinterpret_cast<float4*>(out + (size_t)gm * N + gn) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <bool kRaggedN>
static void gemm_f32_launch(int epi, dim3 grid, const float* A, const float* W,
                            const float* bias, const float* res, float* out, int M, int N,
                            int K, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS: gemm_f32_kernel<EPI_BIAS, kRaggedN><<<grid, GTHREADS, 0, s>>>(A, W, bias, res, out, M, N, K); break;
    case EPI_SILU: gemm_f32_kernel<EPI_SILU, kRaggedN><<<grid, GTHREADS, 0, s>>>(A, W, bias, res, out, M, N, K); break;
    case EPI_RES: gemm_f32_kernel<EPI_RES, kRaggedN><<<grid, GTHREADS, 0, s>>>(A, W, bias, res, out, M, N, K); break;
    default: gemm_f32_kernel<EPI_RES_HALF, kRaggedN><<<grid, GTHREADS, 0, s>>>(A, W, bias, res, out, M, N, K); break;
  }
}

// K a multiple of 8, N of 4
static cudaError_t gemm_f32(int epi, const float* A, const float* W, const float* bias,
                            const float* res, float* out, int M, int N, int K,
                            cudaStream_t s) {
  if (K % FBK || N % 4) return cudaErrorInvalidValue;
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  if (N % FBN) gemm_f32_launch<true>(epi, grid, A, W, bias, res, out, M, N, K, s);
  else gemm_f32_launch<false>(epi, grid, A, W, bias, res, out, M, N, K, s);
  return cudaGetLastError();
}

// ------------------------------------------------------ row quantization
// q[r, :] = clip(rint(x[r, :] / sx[r]), -127, 127), sx[r] = max(absmax of
// the row, 1e-8) / 127. rint rounds half to even and the value is divided
// by the scale, as the TPU kernel does; an all-zero row gives sx =
// 1e-8/127 and q = 0. Three kernels quantize: the LayerNorm (four rows of
// the block's eight quantized inputs), the conv module (one) in the
// kernels that produce the values, and this pass for the attention output
// and the W1 output, whose rows span several blocks of their producers.
__device__ __forceinline__ float row_scale_of(float amax) {
  return fmaxf(amax, 1e-8f) * (float)(1.0 / 127.0);
}
__device__ __forceinline__ uint2 quantize8(const float (&f)[8], float scale) {
  union { int8_t b[8]; uint2 u; } o;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o.b[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(f[e], scale)), -127.f), 127.f);
  return o.u;
}

// One warp per row.
template <typename TIn>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ sx,
                     int rows, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const TIn* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int v = lane; v < K / 8; v += 32) {
    float f[8];
    load8(xr + v * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  const float scale = row_scale_of(warp_max(amax));
  if (lane == 0) sx[row] = scale;
  for (int v = lane; v < K / 8; v += 32) {
    float f[8];
    load8(xr + v * 8, f);
    *reinterpret_cast<uint2*>(q + (size_t)row * K + v * 8) = quantize8(f, scale);
  }
}

template <typename TIn>
static cudaError_t quantize_rows(const TIn* x, int8_t* q, float* sx, int rows, int K,
                                 cudaStream_t s) {
  quantize_rows_kernel<TIn><<<(rows + 7) / 8, 256, 0, s>>>(x, q, sx, rows, K);
  return cudaGetLastError();
}

// ----------------------------------------------------------- LayerNorm
// One warp per row, one-pass float32 statistics. With `lengths`, rows
// t >= lengths[b] are written as zeros. x and y may alias when their
// types agree. A row holds D values (the pitch, a multiple of 8) of which
// the first Dt are the model's: the columns past Dt of a padded layout
// are zeros in x, g and b, so the sums take them as they are and the
// statistics divide by Dt (the JAX kernel's mean over its true D), and
// the outputs there are zeros again.
constexpr int LN_THREADS = 256;
// MODE: LN_ONE_PASS (every entry), or, in the ablation library only
// (EET_ABLATE), LN_SCALE (x * g + b, no statistics) and LN_TWO_PASS
// (centred variance, one more pass over the row).
enum { LN_ONE_PASS = 0, LN_SCALE = 1, LN_TWO_PASS = 2 };

template <typename TIn, typename TOut, int MODE = LN_ONE_PASS>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const TIn* x, TOut* y, const float* __restrict__ g,
                  const float* __restrict__ b, int rows, int D, int Dt, float eps,
                  const int* __restrict__ lengths, int T) {
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const TIn* xr = x + (size_t)row * D;
  TOut* yr = y + (size_t)row * D;
  float mu = 0.f, rstd = 1.f;
  if constexpr (MODE != LN_SCALE) {
    float s = 0.f, ss = 0.f;
    for (int v = lane; v < D / 8; v += 32) {
      float e[8];
      load8(xr + v * 8, e);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s += e[q];
        ss += e[q] * e[q];
      }
    }
    s = warp_sum(s);
    mu = s / Dt;
    if constexpr (MODE == LN_TWO_PASS) {
      ss = 0.f;
      for (int v = lane; v < D / 8; v += 32) {
        float e[8];
        load8(xr + v * 8, e);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (v * 8 + q < Dt) ss += (e[q] - mu) * (e[q] - mu);
      }
      rstd = rsqrtf(warp_sum(ss) / Dt + eps);
    } else {
      ss = warp_sum(ss);
      rstd = rsqrtf(fmaxf(ss / Dt - mu * mu, 0.f) + eps);
    }
  }
  const bool zero = lengths != nullptr && (row % T) >= lengths[row / T];
  for (int v = lane; v < D / 8; v += 32) {
    float e[8], o[8];
    load8(xr + v * 8, e);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = v * 8 + q;
      o[q] = zero ? 0.f : MODE == LN_SCALE ? e[q] * g[c] + b[c] : (e[q] - mu) * rstd * g[c] + b[c];
    }
    store8(yr + v * 8, o);
  }
}

template <typename TIn, typename TOut, int MODE = LN_ONE_PASS>
static cudaError_t layer_norm(const TIn* x, TOut* y, const float* g, const float* b,
                              int rows, int D, int Dt, float eps, const int* lengths, int T,
                              cudaStream_t s) {
  const int per_block = LN_THREADS / 32;
  layer_norm_kernel<TIn, TOut, MODE><<<(rows + per_block - 1) / per_block, LN_THREADS, 0, s>>>(
      x, y, g, b, rows, D, Dt, eps, lengths, T);
  return cudaGetLastError();
}

// LayerNorm in float32 of a bf16 row, quantized on the way out: only the
// int8 row and its scale are written. One warp per row: lane l takes the
// row's 8-value chunks l, l + 32, l + 64, ... (values 8 l .. 8 l + 7, 256
// + 8 l .., a chunk past D / 8 is none). The arithmetic is the LayerNorm
// kernel's above with its contractions written out (every FMA the
// compiler forms there is an explicit __fmaf_rn here, every other
// operation rounded on its own), so the plain version can repeat it
// exactly: each lane sums its chunks' 8 values in order, chunk after
// chunk, then a butterfly over the warp; the statistics divide by Dt, the
// true width, as the LayerNorm kernel's do. Up to LNQ_MAX_D (two chunks a
// lane) the row stays in registers from the one read to the int8 store;
// a wider row (d 1024) is read three times, once for the sums, once for
// the absmax and once to quantize, by the same arithmetic (the row sits in
// L1 between the reads), so the values are the ones the plain version
// computes whatever the width.
constexpr int LNQ_CHUNKS = 2;
constexpr int LNQ_MAX_D = 8 * 32 * LNQ_CHUNKS;

__global__ void __launch_bounds__(LN_THREADS)
layer_norm_quantize_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ b, int8_t* __restrict__ q,
                           float* __restrict__ sx, int rows, int D, int Dt, float eps) {
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float e[LNQ_CHUNKS][8];
  bool has[LNQ_CHUNKS];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < LNQ_CHUNKS; ++c) {
    has[c] = lane + 32 * c < D / 8;
    if (has[c]) {
      load8(x + (size_t)row * D + (lane + 32 * c) * 8, e[c]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s = __fadd_rn(s, e[c][k]);
        ss = __fmaf_rn(e[c][k], e[c][k], ss);
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = __fdiv_rn(s, (float)Dt);
  const float var = fmaxf(__fmaf_rn(-mu, mu, __fdiv_rn(ss, (float)Dt)), 0.f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < LNQ_CHUNKS; ++c) {
    if (!has[c]) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = (lane + 32 * c) * 8 + k;
      e[c][k] = __fmaf_rn(__fmul_rn(__fsub_rn(e[c][k], mu), rstd), g[col], b[col]);
      amax = fmaxf(amax, fabsf(e[c][k]));
    }
  }
  const float scale = row_scale_of(warp_max(amax));
  if (lane == 0) sx[row] = scale;
#pragma unroll
  for (int c = 0; c < LNQ_CHUNKS; ++c)
    if (has[c])
      *reinterpret_cast<uint2*>(q + (size_t)row * D + (lane + 32 * c) * 8) =
          quantize8(e[c], scale);
}

// the same arithmetic on a row past LNQ_MAX_D, reread for each pass
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_quantize_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                                const float* __restrict__ b, int8_t* __restrict__ q,
                                float* __restrict__ sx, int rows, int D, int Dt, float eps) {
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int v = lane; v < D / 8; v += 32) {
    float e[8];
    load8(xr + v * 8, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s = __fadd_rn(s, e[k]);
      ss = __fmaf_rn(e[k], e[k], ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = __fdiv_rn(s, (float)Dt);
  const float var = fmaxf(__fmaf_rn(-mu, mu, __fdiv_rn(ss, (float)Dt)), 0.f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  auto normed = [&](int v, float (&e)[8]) {
    load8(xr + v * 8, e);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __fmaf_rn(__fmul_rn(__fsub_rn(e[k], mu), rstd), g[v * 8 + k], b[v * 8 + k]);
  };
  float amax = 0.f;
  for (int v = lane; v < D / 8; v += 32) {
    float e[8];
    normed(v, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(e[k]));
  }
  const float scale = row_scale_of(warp_max(amax));
  if (lane == 0) sx[row] = scale;
  for (int v = lane; v < D / 8; v += 32) {
    float e[8];
    normed(v, e);
    *reinterpret_cast<uint2*>(q + (size_t)row * D + v * 8) = quantize8(e, scale);
  }
}

// D (the pitch) a multiple of 8; Dt <= D the true width
static cudaError_t layer_norm_quantize(const bf16* x, const float* g, const float* b, int8_t* q,
                                       float* sx, int rows, int D, int Dt, float eps,
                                       cudaStream_t s) {
  if (D % 8 || Dt <= 0 || Dt > D) return cudaErrorInvalidValue;
  const int per_block = LN_THREADS / 32;
  const dim3 grid((rows + per_block - 1) / per_block);
  if (D <= LNQ_MAX_D)
    layer_norm_quantize_kernel<<<grid, LN_THREADS, 0, s>>>(x, g, b, q, sx, rows, D, Dt, eps);
  else
    layer_norm_quantize_wide_kernel<<<grid, LN_THREADS, 0, s>>>(x, g, b, q, sx, rows, D, Dt,
                                                               eps);
  return cudaGetLastError();
}

// ----------------------------------------------------------- attention
// One block per (64-query tile, head, item); each warp owns 16 query
// rows and keeps everything of them in registers, as mma.sync m16n8k16
// fragments (row g = lane/4 and g+8, columns 2*(lane%4) and +1 of each
// 8-wide tile). K and V of the (item, head) pass through shared memory
// in tiles of up to ATT_KT keys: K as rows (KT x DH), V transposed
// (DH x KT). Tp is T rounded up to 16; keys past T are zeros and, like
// every key t >= lengths[b], masked. A T' up to ATT_KT (the main path's
// 249) is one tile, loaded once for all three passes; a longer one
// streams its tiles through each pass, so no T' is too long.
//
// The softmax is the TPU kernel's, not an online one: an online softmax
// would round exp(s - m) against a running max and move the bf16
// rounding points that the TPU kernel and the plain version share. The
// scores are recomputed in three passes over the key tiles -- row max,
// then the sum of bf16(exp(s - m)), then p = bf16(e / z) into P V --
// and every sum runs over the keys in the same order whatever the tile
// size, so the result does not depend on it.
constexpr int ATT_WARPS = 4;
constexpr int ATT_KT = 256;
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
struct AttLayout {
  static constexpr int KLD = DH + 8;  // K row stride (bf16), conflict-free pair loads
  __host__ __device__ static int vld(int KT) { return KT + 8; }
  __host__ __device__ static size_t bytes(int KT) {
    return ((size_t)KT * KLD + (size_t)DH * vld(KT)) * sizeof(bf16);
  }
};

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_pair(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// TOut: bf16, or float for the W8A8 entry with a float32 softmax, whose
// o projection quantizes the unrounded P V. KT: keys per tile, a multiple
// of 16 (min(Tp, ATT_KT)). kSoftmax false (the ablation library only):
// P is the scaled, masked scores themselves, and the max and sum passes
// are not run.
template <int DH, typename TOut, bool kSoftmax = true>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                 TOut* __restrict__ out, int T, int D, int Tp, int KT, float scale,
                 int sm_bf16) {
  using L = AttLayout<DH>;
  constexpr int KLD = L::KLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + (size_t)KT * KLD;
  const int VLD = L::vld(KT);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q0 = (blockIdx.x * ATT_WARPS + warp) * 16;
  const int len = lengths[b];
  const size_t row3 = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row3 + h * DH;
  // a warp past the last query row computes nothing, but takes its part
  // in every tile load
  const bool active = q0 < T;
  const bool resident = Tp <= KT;

  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  // keys k0 .. k0+n-1 into Ks and, with_v, their values into Vt
  auto load_tile = [&](int k0, int n, bool with_v) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < n * VPR; idx += blockDim.x) {
      const int j = idx / VPR, v = idx % VPR, tk = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (tk < T) {
        kv = *reinterpret_cast<const uint4*>(base + tk * row3 + D + v * 8);
        if (with_v) vv = *reinterpret_cast<const uint4*>(base + tk * row3 + 2 * D + v * 8);
      }
      *reinterpret_cast<uint4*>(Ks + j * KLD + v * 8) = kv;
      if (with_v) {
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int q = 0; q < 8; ++q) Vt[(v * 8 + q) * VLD + j] = ve[q];
      }
    }
    __syncthreads();
  };
  if (resident) {
    load_tile(0, Tp, true);
    if (!active) return;  // no tile load follows
  }

  // Q as A fragments: rows r0 = q0+g and r1 = q0+g+8
  const int r0 = q0 + g, r1 = r0 + 8;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + t2;
    qa[kk][0] = r0 < T ? ld_pair(base + r0 * row3 + c) : 0u;
    qa[kk][1] = r1 < T ? ld_pair(base + r1 * row3 + c) : 0u;
    qa[kk][2] = r0 < T ? ld_pair(base + r0 * row3 + c + 8) : 0u;
    qa[kk][3] = r1 < T ? ld_pair(base + r1 * row3 + c + 8) : 0u;
  }

  const float neg = sm_bf16 ? bf16r(-30000.f) : -1e9f;
  // scaled, masked scores of keys n0 .. n0+7, at row j of the tile in
  // shared memory: s[0..1] row r0, s[2..3] row r1
  auto scores = [&](int j, int n0, float (&s)[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* kr = Ks + (j + g) * KLD + kk * 16 + t2;
      mma_16816(s, qa[kk], ld_pair(kr), ld_pair(kr + 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = sm_bf16 ? bf16r(bf16r(s[i]) * scale) : s[i] * scale;
      s[i] = n0 + t2 + (i & 1) < len ? v : neg;
    }
  };
  auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  float m0 = -INFINITY, m1 = -INFINITY;
  auto ex = [&](float v, float m) {
    return sm_bf16 ? bf16r(expf(bf16r(v - m))) : expf(v - m);
  };
  float z0 = 0.f, z1 = 0.f;
  if constexpr (kSoftmax) {
    for (int k0 = 0; k0 < Tp; k0 += KT) {
      const int n = min(KT, Tp - k0);
      if (!resident) load_tile(k0, n, false);
      if (!active) continue;
      for (int j = 0; j < n; j += 8) {
        float s[4];
        scores(j, k0 + j, s);
        m0 = fmaxf(m0, fmaxf(s[0], s[1]));
        m1 = fmaxf(m1, fmaxf(s[2], s[3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    for (int k0 = 0; k0 < Tp; k0 += KT) {
      const int n = min(KT, Tp - k0);
      if (!resident) load_tile(k0, n, false);
      if (!active) continue;
      for (int j = 0; j < n; j += 8) {
        float s[4];
        scores(j, k0 + j, s);
        z0 += ex(s[0], m0) + ex(s[1], m0);
        z1 += ex(s[2], m1) + ex(s[3], m1);
      }
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
    if (sm_bf16) {
      z0 = bf16r(z0);
      z1 = bf16r(z1);
    }
  }
  auto prob = [&](float v, float m, float z) {
    if constexpr (kSoftmax) return ex(v, m) / z;
    else return v;
  };

  float o[DH / 8][4] = {};
  for (int k0 = 0; k0 < Tp; k0 += KT) {
    const int n = min(KT, Tp - k0);
    if (!resident) load_tile(k0, n, true);
    if (!active) continue;
    for (int j = 0; j < n; j += 16) {
      float sa[4], sb[4];
      scores(j, k0 + j, sa);
      scores(j + 8, k0 + j + 8, sb);
      const uint32_t pa[4] = {
          pack_pair(prob(sa[0], m0, z0), prob(sa[1], m0, z0)),
          pack_pair(prob(sa[2], m1, z1), prob(sa[3], m1, z1)),
          pack_pair(prob(sb[0], m0, z0), prob(sb[1], m0, z0)),
          pack_pair(prob(sb[2], m1, z1), prob(sb[3], m1, z1))};
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const bf16* vr = Vt + (nt * 8 + g) * VLD + j + t2;
        mma_16816(o[nt], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = h * DH + nt * 8 + t2;
    if (r0 < T) store_pair(out + ((size_t)b * T + r0) * D + c, o[nt][0], o[nt][1]);
    if (r1 < T) store_pair(out + ((size_t)b * T + r1) * D + c, o[nt][2], o[nt][3]);
  }
}

template <int DH, typename TOut, bool kSoftmax>
static cudaError_t attention_dh(const bf16* qkv, const int* lengths, TOut* out, int B, int T,
                                int D, int H, float scale, int sm_bf16, cudaStream_t s) {
  const int Tp = (T + 15) / 16 * 16;
  const int KT = Tp < ATT_KT ? Tp : ATT_KT;
  const size_t bytes = AttLayout<DH>::bytes(KT);
  EET_TRY(cudaFuncSetAttribute(attention_kernel<DH, TOut, kSoftmax>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  const dim3 grid((T + 16 * ATT_WARPS - 1) / (16 * ATT_WARPS), H, B);
  attention_kernel<DH, TOut, kSoftmax><<<grid, ATT_WARPS * 32, bytes, s>>>(
      qkv, lengths, out, T, D, Tp, KT, scale, sm_bf16);
  return cudaGetLastError();
}

// D: the inner width H x DH of the q|k|v rows (3D a row) and of out (D a
// row), where DH is an instantiated head width: 16, 32, 48, 64 or 128
// (anything else: cudaErrorInvalidValue). A model's head of another width
// up to 128 is padded to the next of them in the fold (zero q, k and v
// columns, zero rows of Wo), and `scale` is 1/sqrt of its true width. At
// DH 128 the key tile (KT x 136) and the transposed values (128 x KT + 8)
// take 137 KB of shared memory at KT = 256, and a lane holds 64 float32
// sums of P V.
template <typename TOut, bool kSoftmax = true>
static cudaError_t attention(const bf16* qkv, const int* lengths, TOut* out, int B, int T,
                             int D, int H, float scale, int sm_bf16, cudaStream_t s) {
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  switch (D / H) {
    case 16: return attention_dh<16, TOut, kSoftmax>(qkv, lengths, out, B, T, D, H, scale, sm_bf16, s);
    case 32: return attention_dh<32, TOut, kSoftmax>(qkv, lengths, out, B, T, D, H, scale, sm_bf16, s);
    case 48: return attention_dh<48, TOut, kSoftmax>(qkv, lengths, out, B, T, D, H, scale, sm_bf16, s);
    case 64: return attention_dh<64, TOut, kSoftmax>(qkv, lengths, out, B, T, D, H, scale, sm_bf16, s);
    case 128: return attention_dh<128, TOut, kSoftmax>(qkv, lengths, out, B, T, D, H, scale, sm_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- conv module
// GLU over the PW1 output (rows, 2D) -> zero rows t >= len -> depthwise
// 'SAME' conv over time (float32 accumulation, one rounding to T) ->
// + bias -> folded BatchNorm -> SiLU (float32) -> TOut. One block per
// (time tile, channel tile, item); the GLU tile with its halo sits in
// shared memory. A block takes all D channels where the tile fits in
// shared memory (every width up to d 1024 in bf16, d 512 in float32) and
// else a run of CT of them, a multiple of 8 (`conv_channels`; 512 at d
// 1024 in float32 with k 31): the channels never mix, so the split
// changes no value. T is the compute type; TOut is T, float, or int8_t
// for the W8A8 entry: the unrounded float32 values of the block's 32
// rows wait in shared memory while a warp takes each row's absmax, and
// leave quantized, with their scales in sx, as the PW2 product reads
// them. A quantized output needs whole rows in one block; where they do
// not fit beside the GLU tile (d 1024 and k 31: 254 KB), the W8A8 entry
// writes float32 rows instead and quantizes them in a pass of their own.
constexpr int CONV_TT = 32, CONV_THREADS = 256;
// ABL (the ablation library only, 0 in every entry): bits of the parts
// taken out -- the GLU gate (a passes through), the depthwise conv (the
// centre row passes through), the SiLU.
enum { CV_NO_GLU = 1, CV_NO_DW = 2, CV_NO_SILU = 4 };

// Channels a conv block holds at width D: D where the tile fits, else the
// most that fit, a multiple of 8; 0 where a quantized output (whole rows)
// does not fit. The wrapper's plan (`block_plan`) repeats this rule.
static int conv_channels(int D, int ksize, int esize, bool quant) {
  const size_t per = (size_t)(CONV_TT + ksize - 1) * esize + (quant ? CONV_TT * 4 : 0);
  if (per * D <= SMEM_LIMIT) return D;
  return quant ? 0 : (int)(SMEM_LIMIT / per) / 8 * 8;
}

template <typename T_, typename TOut, int ABL = 0>
__global__ void __launch_bounds__(CONV_THREADS)
conv_module_kernel(const T_* __restrict__ g, const int* __restrict__ lengths,
                   const T_* __restrict__ dw, const float* __restrict__ dw_b,
                   const float* __restrict__ bn_scale, const float* __restrict__ bn_shift,
                   TOut* __restrict__ out, float* __restrict__ sx, int T, int D, int CT,
                   int ksize) {
  constexpr bool kQuant = std::is_same<TOut, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T_* tile = reinterpret_cast<T_*>(smem);
  const int b = blockIdx.z, t0 = blockIdx.x * CONV_TT, c0 = blockIdx.y * CT;
  const int len = lengths[b], padl = (ksize - 1) / 2;
  const int rows = CONV_TT + ksize - 1;
  const int nc = min(CT, D - c0);  // this block's channels
  float* ytile = reinterpret_cast<float*>(smem + (size_t)rows * CT * sizeof(T_));
  for (int idx = threadIdx.x; idx < rows * nc; idx += blockDim.x) {
    const int r = idx / nc, c = c0 + idx % nc, t = t0 - padl + r;
    float v = 0.f;
    if (t >= 0 && t < len) {
      const T_* gr = g + ((size_t)b * T + t) * 2 * D;
      v = ABL & CV_NO_GLU ? to_f(gr[c])
                          : rnd<T_>(to_f(gr[c]) * sigmoid_t<T_>(to_f(gr[D + c])));
    }
    tile[idx] = from_f<T_>(v);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < CONV_TT * nc; idx += blockDim.x) {
    const int r = idx / nc, cc = idx % nc, c = c0 + cc, t = t0 + r;
    if (t >= T) continue;
    float acc = 0.f;
    if (ABL & CV_NO_DW) acc = to_f(tile[(r + padl) * nc + cc]);
    else
      for (int j = 0; j < ksize; ++j) acc += to_f(tile[(r + j) * nc + cc]) * to_f(dw[j * D + c]);
    float y = rnd<T_>(acc) + dw_b[c];
    y = y * bn_scale[c] + bn_shift[c];
    if (!(ABL & CV_NO_SILU)) y = y / (1.f + expf(-y));
    if constexpr (kQuant) ytile[idx] = y;
    else out[((size_t)b * T + t) * D + c] = from_f<TOut>(y);
  }
  if constexpr (kQuant) {
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < CONV_TT && t0 + r < T; r += CONV_THREADS / 32) {
      const float* yr = ytile + r * D;
      float amax = 0.f;
      for (int c = lane; c < D; c += 32) amax = fmaxf(amax, fabsf(yr[c]));
      const float scale = row_scale_of(warp_max(amax));
      const size_t row = (size_t)b * T + t0 + r;
      if (lane == 0) sx[row] = scale;
      for (int v = lane; v < D / 8; v += 32) {
        float f[8];
        load8(yr + v * 8, f);
        *reinterpret_cast<uint2*>(out + row * D + v * 8) = quantize8(f, scale);
      }
    }
  }
}

template <typename T_, typename TOut, int ABL = 0>
static cudaError_t conv_module(const T_* g, const int* lengths, const T_* dw,
                               const float* dw_b, const float* bn_scale, const float* bn_shift,
                               TOut* out, float* sx, int B, int T, int D, int ksize,
                               cudaStream_t s) {
  constexpr bool kQuant = std::is_same<TOut, int8_t>::value;
  const int CT = conv_channels(D, ksize, sizeof(T_), kQuant);
  if (CT < 8 || D % 8) return cudaErrorInvalidValue;
  const size_t rows_bytes = (size_t)(CONV_TT + ksize - 1) * CT * sizeof(T_);
  const size_t bytes = rows_bytes + (kQuant ? (size_t)CONV_TT * CT * sizeof(float) : 0);
  EET_TRY(cudaFuncSetAttribute(conv_module_kernel<T_, TOut, ABL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  const dim3 grid((T + CONV_TT - 1) / CONV_TT, (D + CT - 1) / CT, B);
  conv_module_kernel<T_, TOut, ABL><<<grid, CONV_THREADS, bytes, s>>>(
      g, lengths, dw, dw_b, bn_scale, bn_shift, out, sx, T, D, CT, ksize);
  return cudaGetLastError();
}

// ------------------------------------------------------------ C entry
// Weight order (the wrapper's PARAM_ORDER):
enum {
  W_FFN1_LN_G, W_FFN1_LN_B, W_FFN1_W1, W_FFN1_B1, W_FFN1_W2, W_FFN1_B2,
  W_ATTN_LN_G, W_ATTN_LN_B, W_QKV, W_BQKV, W_O, W_BO,
  W_CONV_LN_G, W_CONV_LN_B, W_PW1, W_BPW1, W_DW, W_DW_B, W_BN_SCALE, W_BN_SHIFT, W_PW2, W_BPW2,
  W_FFN2_LN_G, W_FFN2_LN_B, W_FFN2_W1, W_FFN2_B1, W_FFN2_W2, W_FFN2_B2,
  W_FINAL_LN_G, W_FINAL_LN_B, W_COUNT
};

// Every entry takes the block's widths as its layout holds them
// (`block_plan` in the wrapper): D the residual's row (the pitch, a
// multiple of 16) of which Dt are the model's, H heads of DH (the
// instantiated width a head is padded to; the q|k|v rows are 3 H DH wide
// and the attention output H DH), F the FFN's width (padded to 16) and
// ksize; `scale` is 1/sqrt of the true head width. The flagship's layout
// pads nothing (D = Dt = 256, DH = 32, F = 2048).
//
// x, y: (B*T, D) bf16 (may not alias); lengths: (B,) int32;
// scratch: s_ln (B*T, D), s_big (B*T, max(F, 3 H DH)), s_att (B*T,
// max(D, H DH)), bf16.
extern "C" int eet_conformer_block_bf16(const void* x_, void* y_, const void* lengths_,
                                        int B, int T, int D, int Dt, int H, int DH, int F,
                                        int ksize, int sm_bf16, float scale, float eps,
                                        const void* const* w, void* s_ln_, void* s_big_,
                                        void* s_att_, void* stream_) {
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* y = static_cast<bf16*>(y_);
  const int* lengths = static_cast<const int*>(lengths_);
  bf16* s_ln = static_cast<bf16*>(s_ln_);
  bf16* s_big = static_cast<bf16*>(s_big_);
  bf16* s_att = static_cast<bf16*>(s_att_);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  auto bw = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  const int R = B * T, Di = H * DH;

  // macaron half-FFN: y = x + 0.5 * FFN(LN(x))
  EET_TRY(layer_norm(x, s_ln, fw(W_FFN1_LN_G), fw(W_FFN1_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_SILU, s_ln, bw(W_FFN1_W1), bw(W_FFN1_B1), nullptr, s_big, R, F, D, s));
  EET_TRY(gemm(EPI_RES_HALF, s_big, bw(W_FFN1_W2), bw(W_FFN1_B2), x, y, R, D, F, s));
  // MHSA
  EET_TRY(layer_norm(y, s_ln, fw(W_ATTN_LN_G), fw(W_ATTN_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_QKV), bw(W_BQKV), nullptr, s_big, R, 3 * Di, D, s));
  EET_TRY(attention(s_big, lengths, s_att, B, T, Di, H, scale, sm_bf16, s));
  EET_TRY(gemm(EPI_RES, s_att, bw(W_O), bw(W_BO), y, y, R, D, Di, s));
  // convolution module
  EET_TRY(layer_norm(y, s_ln, fw(W_CONV_LN_G), fw(W_CONV_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_PW1), bw(W_BPW1), nullptr, s_big, R, 2 * D, D, s));
  EET_TRY(conv_module(s_big, lengths, bw(W_DW), fw(W_DW_B), fw(W_BN_SCALE), fw(W_BN_SHIFT),
                      s_att, nullptr, B, T, D, ksize, s));
  EET_TRY(gemm(EPI_RES, s_att, bw(W_PW2), bw(W_BPW2), y, y, R, D, D, s));
  // second half-FFN, final LayerNorm with padded rows zeroed
  EET_TRY(layer_norm(y, s_ln, fw(W_FFN2_LN_G), fw(W_FFN2_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_SILU, s_ln, bw(W_FFN2_W1), bw(W_FFN2_B1), nullptr, s_big, R, F, D, s));
  EET_TRY(gemm(EPI_RES_HALF, s_big, bw(W_FFN2_W2), bw(W_FFN2_B2), y, y, R, D, F, s));
  EET_TRY(layer_norm(y, y, fw(W_FINAL_LN_G), fw(W_FINAL_LN_B), R, D, Dt, eps, lengths, T, s));
  return 0;
}

// ------------------------------------------- bf16 products, float32 residual
// y[i] = x[i] + w * d[i]: the float32 residual add of a bf16 branch output
// (w 1 or 0.5), the JAX kernel's x + half * y.astype(rdtype), one rounding
// of the exact value (w d is exact). n a multiple of 8.
__global__ void __launch_bounds__(256)
residual_add_kernel(const float* x, const bf16* __restrict__ d, float* y, float w, size_t n) {
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8; i < n;
       i += (size_t)gridDim.x * blockDim.x * 8) {
    float xv[8], dv[8];
    load8(x + i, xv);
    load8(d + i, dv);
#pragma unroll
    for (int q = 0; q < 8; ++q) xv[q] = __fmaf_rn(w, dv[q], xv[q]);
    store8(y + i, xv);
  }
}

static cudaError_t residual_add(const float* x, const bf16* d, float* y, float w, size_t n,
                                cudaStream_t s) {
  const size_t blocks = (n / 8 + 255) / 256;
  residual_add_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(x, d, y, w, n);
  return cudaGetLastError();
}

// The bf16 profile with a float32 residual stream (compute bf16, residual
// float32, either softmax dtype): the LayerNorms read the float32 stream
// and write bf16 (the products' inputs, as the JAX kernel casts them),
// the products and everything between them are the bf16 entry's, and each
// branch output, bf16, is added to the stream in float32 by
// residual_add; the final LayerNorm writes float32. The products'
// epilogues stay bf16: the three residual products write their branch
// output into s_ln, free by then, and residual_add takes it from there.
// x, y: (B*T, D) float32 (may not alias); scratch as the bf16 entry's.
extern "C" int eet_conformer_block_bf16_f32res(const void* x_, void* y_, const void* lengths_,
                                               int B, int T, int D, int Dt, int H, int DH,
                                               int F, int ksize, int sm_bf16, float scale,
                                               float eps, const void* const* w, void* s_ln_,
                                               void* s_big_, void* s_att_, void* stream_) {
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  const int* lengths = static_cast<const int*>(lengths_);
  bf16* s_ln = static_cast<bf16*>(s_ln_);
  bf16* s_big = static_cast<bf16*>(s_big_);
  bf16* s_att = static_cast<bf16*>(s_att_);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  auto bw = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  const int R = B * T, Di = H * DH;
  const size_t n = (size_t)R * D;

  EET_TRY(layer_norm(x, s_ln, fw(W_FFN1_LN_G), fw(W_FFN1_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_SILU, s_ln, bw(W_FFN1_W1), bw(W_FFN1_B1), nullptr, s_big, R, F, D, s));
  EET_TRY(gemm(EPI_BIAS, s_big, bw(W_FFN1_W2), bw(W_FFN1_B2), nullptr, s_ln, R, D, F, s));
  EET_TRY(residual_add(x, s_ln, y, 0.5f, n, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_ATTN_LN_G), fw(W_ATTN_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_QKV), bw(W_BQKV), nullptr, s_big, R, 3 * Di, D, s));
  EET_TRY(attention(s_big, lengths, s_att, B, T, Di, H, scale, sm_bf16, s));
  EET_TRY(gemm(EPI_BIAS, s_att, bw(W_O), bw(W_BO), nullptr, s_ln, R, D, Di, s));
  EET_TRY(residual_add(y, s_ln, y, 1.f, n, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_CONV_LN_G), fw(W_CONV_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_PW1), bw(W_BPW1), nullptr, s_big, R, 2 * D, D, s));
  EET_TRY(conv_module(s_big, lengths, bw(W_DW), fw(W_DW_B), fw(W_BN_SCALE), fw(W_BN_SHIFT),
                      s_att, nullptr, B, T, D, ksize, s));
  EET_TRY(gemm(EPI_BIAS, s_att, bw(W_PW2), bw(W_BPW2), nullptr, s_ln, R, D, D, s));
  EET_TRY(residual_add(y, s_ln, y, 1.f, n, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_FFN2_LN_G), fw(W_FFN2_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm(EPI_SILU, s_ln, bw(W_FFN2_W1), bw(W_FFN2_B1), nullptr, s_big, R, F, D, s));
  EET_TRY(gemm(EPI_BIAS, s_big, bw(W_FFN2_W2), bw(W_FFN2_B2), nullptr, s_ln, R, D, F, s));
  EET_TRY(residual_add(y, s_ln, y, 0.5f, n, s));
  EET_TRY(layer_norm(y, y, fw(W_FINAL_LN_G), fw(W_FINAL_LN_B), R, D, Dt, eps, lengths, T, s));
  return 0;
}

#ifdef EET_ABLATE
// The ablation library (this file built with -DEET_ABLATE into a library
// of its own; the production library has no such entry): the bf16 entry
// with parts of the block taken out, for timing by difference
// (`ablate_fused_block`). Bits, as the TPU kernel's `ablate` names them:
enum {
  AB_LN = 1,         // every LayerNorm: x * g + b, no statistics
  AB_LN2P = 2,       // every LayerNorm: centred two-pass variance
  AB_SOFTMAX = 4,    // P = the scaled, masked scores
  AB_SILU = 8,       // the FFNs' and the conv module's SiLU: identity
  AB_GLU = 16,       // the GLU gate: a passes through
  AB_DWCONV = 32,    // the depthwise conv: the centre row passes through
  AB_ATTN = 64,      // the whole MHSA module: four launches fewer
  AB_CONV = 128,     // the whole conv module: four launches fewer
  AB_FFN = 256       // both half-FFNs: six launches fewer (one copy more)
};

static cudaError_t ablate_ln(int ab, const bf16* x, bf16* y, const float* g, const float* b,
                             int R, int D, int Dt, float eps, const int* lengths, int T,
                             cudaStream_t s) {
  if (ab & AB_LN)
    return layer_norm<bf16, bf16, LN_SCALE>(x, y, g, b, R, D, Dt, eps, lengths, T, s);
  if (ab & AB_LN2P)
    return layer_norm<bf16, bf16, LN_TWO_PASS>(x, y, g, b, R, D, Dt, eps, lengths, T, s);
  return layer_norm(x, y, g, b, R, D, Dt, eps, lengths, T, s);
}

template <int ABL>
static cudaError_t ablate_conv_t(const bf16* g, const int* lengths, const bf16* dw,
                                 const float* dw_b, const float* bn_scale,
                                 const float* bn_shift, bf16* out, int B, int T, int D,
                                 int ksize, cudaStream_t s) {
  return conv_module<bf16, bf16, ABL>(g, lengths, dw, dw_b, bn_scale, bn_shift, out, nullptr,
                                      B, T, D, ksize, s);
}

static cudaError_t ablate_conv(int ab, const bf16* g, const int* lengths, const bf16* dw,
                               const float* dw_b, const float* bn_scale, const float* bn_shift,
                               bf16* out, int B, int T, int D, int ksize, cudaStream_t s) {
  const int cv = (ab & AB_GLU ? CV_NO_GLU : 0) | (ab & AB_DWCONV ? CV_NO_DW : 0) |
                 (ab & AB_SILU ? CV_NO_SILU : 0);
#define EET_CONV_CASE(k) \
  case k:                \
    return ablate_conv_t<k>(g, lengths, dw, dw_b, bn_scale, bn_shift, out, B, T, D, ksize, s);
  switch (cv) {
    EET_CONV_CASE(0) EET_CONV_CASE(1) EET_CONV_CASE(2) EET_CONV_CASE(3)
    EET_CONV_CASE(4) EET_CONV_CASE(5) EET_CONV_CASE(6) EET_CONV_CASE(7)
  }
#undef EET_CONV_CASE
  return cudaErrorInvalidValue;
}

// The bf16 entry's arguments, then the bits; with ablate 0 it launches
// exactly the bf16 entry's kernels with the same arguments.
extern "C" int eet_conformer_block_bf16_ablate(const void* x_, void* y_, const void* lengths_,
                                               int B, int T, int D, int Dt, int H, int DH,
                                               int F, int ksize, int sm_bf16, float scale,
                                               float eps, const void* const* w, void* s_ln_,
                                               void* s_big_, void* s_att_, void* stream_,
                                               int ab) {
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* y = static_cast<bf16*>(y_);
  const int* lengths = static_cast<const int*>(lengths_);
  bf16* s_ln = static_cast<bf16*>(s_ln_);
  bf16* s_big = static_cast<bf16*>(s_big_);
  bf16* s_att = static_cast<bf16*>(s_att_);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  auto bw = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  const int R = B * T, Di = H * DH;
  const int epi_w1 = ab & AB_SILU ? EPI_BIAS : EPI_SILU;

  if (ab & AB_FFN) {
    EET_TRY(cudaMemcpyAsync(y, x, (size_t)R * D * sizeof(bf16), cudaMemcpyDeviceToDevice, s));
  } else {
    EET_TRY(ablate_ln(ab, x, s_ln, fw(W_FFN1_LN_G), fw(W_FFN1_LN_B), R, D, Dt, eps, nullptr, T,
                      s));
    EET_TRY(gemm(epi_w1, s_ln, bw(W_FFN1_W1), bw(W_FFN1_B1), nullptr, s_big, R, F, D, s));
    EET_TRY(gemm(EPI_RES_HALF, s_big, bw(W_FFN1_W2), bw(W_FFN1_B2), x, y, R, D, F, s));
  }
  if (!(ab & AB_ATTN)) {
    EET_TRY(ablate_ln(ab, y, s_ln, fw(W_ATTN_LN_G), fw(W_ATTN_LN_B), R, D, Dt, eps, nullptr, T,
                      s));
    EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_QKV), bw(W_BQKV), nullptr, s_big, R, 3 * Di, D, s));
    if (ab & AB_SOFTMAX)
      EET_TRY((attention<bf16, false>(s_big, lengths, s_att, B, T, Di, H, scale, sm_bf16, s)));
    else
      EET_TRY(attention(s_big, lengths, s_att, B, T, Di, H, scale, sm_bf16, s));
    EET_TRY(gemm(EPI_RES, s_att, bw(W_O), bw(W_BO), y, y, R, D, Di, s));
  }
  if (!(ab & AB_CONV)) {
    EET_TRY(ablate_ln(ab, y, s_ln, fw(W_CONV_LN_G), fw(W_CONV_LN_B), R, D, Dt, eps, nullptr, T,
                      s));
    EET_TRY(gemm(EPI_BIAS, s_ln, bw(W_PW1), bw(W_BPW1), nullptr, s_big, R, 2 * D, D, s));
    EET_TRY(ablate_conv(ab, s_big, lengths, bw(W_DW), fw(W_DW_B), fw(W_BN_SCALE),
                        fw(W_BN_SHIFT), s_att, B, T, D, ksize, s));
    EET_TRY(gemm(EPI_RES, s_att, bw(W_PW2), bw(W_BPW2), y, y, R, D, D, s));
  }
  if (!(ab & AB_FFN)) {
    EET_TRY(ablate_ln(ab, y, s_ln, fw(W_FFN2_LN_G), fw(W_FFN2_LN_B), R, D, Dt, eps, nullptr, T,
                      s));
    EET_TRY(gemm(epi_w1, s_ln, bw(W_FFN2_W1), bw(W_FFN2_B1), nullptr, s_big, R, F, D, s));
    EET_TRY(gemm(EPI_RES_HALF, s_big, bw(W_FFN2_W2), bw(W_FFN2_B2), y, y, R, D, F, s));
  }
  EET_TRY(ablate_ln(ab, y, y, fw(W_FINAL_LN_G), fw(W_FINAL_LN_B), R, D, Dt, eps, lengths, T, s));
  return 0;
}
#endif  // EET_ABLATE

// The float32 entry. x, y: (B*T, D) float32 (may not alias); every weight
// float32, same order; scratch as above in float32. sm_bf16 0: scores
// masked to -1e9 and the float32 softmax of attention_f32.cuh; sm_bf16 1
// (float32 compute with the bf16 softmax, the JAX CLI's --compute_dtype
// float32 at inference): the same attention with the bf16 entry's score
// pipeline (its kLowp instantiation), P V in float32.
extern "C" int eet_conformer_block_f32(const void* x_, void* y_, const void* lengths_, int B,
                                       int T, int D, int Dt, int H, int DH, int F, int ksize,
                                       int sm_bf16, float scale, float eps,
                                       const void* const* w, void* s_ln_, void* s_big_,
                                       void* s_att_, void* stream_) {
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  const int* lengths = static_cast<const int*>(lengths_);
  float* s_ln = static_cast<float*>(s_ln_);
  float* s_big = static_cast<float*>(s_big_);
  float* s_att = static_cast<float*>(s_att_);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  const int R = B * T, Di = H * DH;
  const float* no_res = nullptr;

  EET_TRY(layer_norm(x, s_ln, fw(W_FFN1_LN_G), fw(W_FFN1_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm_f32(EPI_SILU, s_ln, fw(W_FFN1_W1), fw(W_FFN1_B1), no_res, s_big, R, F, D, s));
  EET_TRY(gemm_f32(EPI_RES_HALF, s_big, fw(W_FFN1_W2), fw(W_FFN1_B2), x, y, R, D, F, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_ATTN_LN_G), fw(W_ATTN_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm_f32(EPI_BIAS, s_ln, fw(W_QKV), fw(W_BQKV), no_res, s_big, R, 3 * Di, D, s));
  // q | k | v of a frame are one (3 Di) row of s_big; head h at column h*DH
  const long long in_bs = (long long)T * 3 * Di, out_bs = (long long)T * Di;
  if (sm_bf16)
    EET_TRY((attention_f32<float, true>(s_big, s_big + Di, s_big + 2 * Di, nullptr, lengths,
                                        s_att, B, H, T, DH, in_bs, DH, 3 * Di, out_bs, DH, Di,
                                        scale, s)));
  else
    EET_TRY(attention_f32<float>(s_big, s_big + Di, s_big + 2 * Di, nullptr, lengths, s_att, B,
                                 H, T, DH, in_bs, DH, 3 * Di, out_bs, DH, Di, scale, s));
  EET_TRY(gemm_f32(EPI_RES, s_att, fw(W_O), fw(W_BO), y, y, R, D, Di, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_CONV_LN_G), fw(W_CONV_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm_f32(EPI_BIAS, s_ln, fw(W_PW1), fw(W_BPW1), no_res, s_big, R, 2 * D, D, s));
  EET_TRY(conv_module<float, float>(s_big, lengths, fw(W_DW), fw(W_DW_B), fw(W_BN_SCALE),
                                    fw(W_BN_SHIFT), s_att, nullptr, B, T, D, ksize, s));
  EET_TRY(gemm_f32(EPI_RES, s_att, fw(W_PW2), fw(W_BPW2), y, y, R, D, D, s));
  EET_TRY(layer_norm(y, s_ln, fw(W_FFN2_LN_G), fw(W_FFN2_LN_B), R, D, Dt, eps, nullptr, T, s));
  EET_TRY(gemm_f32(EPI_SILU, s_ln, fw(W_FFN2_W1), fw(W_FFN2_B1), no_res, s_big, R, F, D, s));
  EET_TRY(gemm_f32(EPI_RES_HALF, s_big, fw(W_FFN2_W2), fw(W_FFN2_B2), y, y, R, D, F, s));
  EET_TRY(layer_norm(y, y, fw(W_FINAL_LN_G), fw(W_FINAL_LN_B), R, D, Dt, eps, lengths, T, s));
  return 0;
}

// The W8A8 entry. x, y: (B*T, D) bf16 (may not alias). w: the same order,
// with each of the 10 product weights as its transposed int8 twin (N, K)
// and each of their biases in float32; ws: the float32 per-output-channel
// scale row at each product weight's index (nullptr elsewhere). Scratch:
// s_q (B*T, max(F, D, H DH)) int8; s_sx (B*T) float32; s_big (B*T,
// max(F, 3 H DH)) and s_att (B*T, max(D, H DH)) bf16; s_f (B*T, max(D,
// H DH)) float32, with the float32 softmax or where the conv module's
// quantized rows do not fit in a block (conv_channels 0), nullptr
// otherwise.
extern "C" int eet_conformer_block_w8a8(const void* x_, void* y_, const void* lengths_, int B,
                                        int T, int D, int Dt, int H, int DH, int F, int ksize,
                                        int sm_bf16, float scale, float eps,
                                        const void* const* w, const void* const* ws,
                                        void* s_f_, void* s_q_, void* s_sx_, void* s_big_,
                                        void* s_att_, void* stream_) {
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* y = static_cast<bf16*>(y_);
  const int* lengths = static_cast<const int*>(lengths_);
  float* s_f = static_cast<float*>(s_f_);
  int8_t* s_q = static_cast<int8_t*>(s_q_);
  float* s_sx = static_cast<float*>(s_sx_);
  bf16* s_big = static_cast<bf16*>(s_big_);
  bf16* s_att = static_cast<bf16*>(s_att_);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  auto bw = [&](int i) { return static_cast<const bf16*>(w[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  const int R = B * T, Di = H * DH;
  const bool conv_split = conv_channels(D, ksize, sizeof(bf16), true) == 0;
  if ((!sm_bf16 || conv_split) && s_f == nullptr) return cudaErrorInvalidValue;
  // LayerNorm in float32, quantized rows in s_q / s_sx
  auto ln_q = [&](const bf16* v, int g, int b) {
    return layer_norm_quantize(v, fw(g), fw(b), s_q, s_sx, R, D, Dt, eps, s);
  };
  // out = epilogue(quantized s_q @ weight wi); bi: its bias
  auto mm = [&](int epi, int wi, int bi, const bf16* res, bf16* out, int N, int K) {
    return gemm_s8(epi, s_q, s_sx, static_cast<const int8_t*>(w[wi]),
                   static_cast<const float*>(ws[wi]), fw(bi), res, out, R, N, K, s);
  };
  auto ffn = [&](const bf16* v, bf16* out, int ln_g, int ln_b, int w1, int b1, int w2,
                 int b2) -> cudaError_t {
    EET_TRY(ln_q(v, ln_g, ln_b));
    EET_TRY(mm(EPI_SILU, w1, b1, nullptr, s_big, F, D));
    EET_TRY(quantize_rows(s_big, s_q, s_sx, R, F, s));
    return mm(EPI_RES_HALF, w2, b2, v, out, D, F);
  };

  EET_TRY(ffn(x, y, W_FFN1_LN_G, W_FFN1_LN_B, W_FFN1_W1, W_FFN1_B1, W_FFN1_W2, W_FFN1_B2));
  // MHSA: one quantized LayerNorm output feeds q, k and v
  EET_TRY(ln_q(y, W_ATTN_LN_G, W_ATTN_LN_B));
  EET_TRY(mm(EPI_BIAS, W_QKV, W_BQKV, nullptr, s_big, 3 * Di, D));
  if (sm_bf16) {
    EET_TRY(attention(s_big, lengths, s_att, B, T, Di, H, scale, 1, s));
    EET_TRY(quantize_rows(s_att, s_q, s_sx, R, Di, s));
  } else {
    EET_TRY(attention(s_big, lengths, s_f, B, T, Di, H, scale, 0, s));
    EET_TRY(quantize_rows(s_f, s_q, s_sx, R, Di, s));
  }
  EET_TRY(mm(EPI_RES, W_O, W_BO, y, y, D, Di));
  // convolution module, its output quantized as it is made (or, where its
  // rows do not fit in a block, written in float32 and quantized after)
  EET_TRY(ln_q(y, W_CONV_LN_G, W_CONV_LN_B));
  EET_TRY(mm(EPI_BIAS, W_PW1, W_BPW1, nullptr, s_big, 2 * D, D));
  if (conv_split) {
    EET_TRY(conv_module(s_big, lengths, bw(W_DW), fw(W_DW_B), fw(W_BN_SCALE), fw(W_BN_SHIFT),
                        s_f, nullptr, B, T, D, ksize, s));
    EET_TRY(quantize_rows(s_f, s_q, s_sx, R, D, s));
  } else {
    EET_TRY(conv_module(s_big, lengths, bw(W_DW), fw(W_DW_B), fw(W_BN_SCALE), fw(W_BN_SHIFT),
                        s_q, s_sx, B, T, D, ksize, s));
  }
  EET_TRY(mm(EPI_RES, W_PW2, W_BPW2, y, y, D, D));
  EET_TRY(ffn(y, y, W_FFN2_LN_G, W_FFN2_LN_B, W_FFN2_W1, W_FFN2_B1, W_FFN2_W2, W_FFN2_B2));
  EET_TRY(layer_norm(y, y, fw(W_FINAL_LN_G), fw(W_FINAL_LN_B), R, D, Dt, eps, lengths, T, s));
  return 0;
}

extern "C" int eet_conformer_block_param_count() { return W_COUNT; }

// The bf16 entry's product on its own, for checks and timing:
// out (M, N) = epilogue(bf16(a (M, K) @ w (K, N)) + bias (N)), epi one of
// 0 bias, 1 +SiLU, 2 res + y, 3 res + 0.5 y; res may be out.
extern "C" int eet_gemm_bf16(const void* a, const void* w, const void* bias, const void* res,
                             void* out, int M, int N, int K, int epi, void* stream_) {
  return gemm(epi, static_cast<const bf16*>(a), static_cast<const bf16*>(w),
              static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
              static_cast<bf16*>(out), M, N, K, static_cast<cudaStream_t>(stream_));
}

// The W8A8 entry's product on its own, for checks and timing:
// out (M, N) = epilogue(bf16(float(aq (M, K) @ wt (N, K)^T) * (sx (M) *
// sw (N)) + bias (N))), aq and wt int8, sx, sw and bias float32, epi as
// above; res may be out.
extern "C" int eet_gemm_s8(const void* aq, const void* sx, const void* wt, const void* sw,
                           const void* bias, const void* res, void* out, int M, int N, int K,
                           int epi, void* stream_) {
  return gemm_s8(epi, static_cast<const int8_t*>(aq), static_cast<const float*>(sx),
                 static_cast<const int8_t*>(wt), static_cast<const float*>(sw),
                 static_cast<const float*>(bias), static_cast<const bf16*>(res),
                 static_cast<bf16*>(out), M, N, K, static_cast<cudaStream_t>(stream_));
}

// The bf16 entries' LayerNorm on its own, for checks: x (rows, D) bf16,
// or float32 (in_f32: bf16 compute with a float32 residual) -> y (rows,
// D) bf16, every row normalized (none zeroed), statistics over the first
// Dt of the D values.
extern "C" int eet_layer_norm_bf16(const void* x, const void* g, const void* b, void* y,
                                   int rows, int D, int Dt, float eps, int in_f32,
                                   void* stream_) {
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (in_f32)
    return layer_norm(static_cast<const float*>(x), static_cast<bf16*>(y), gf, bf, rows, D, Dt,
                      eps, nullptr, 1, s);
  return layer_norm(static_cast<const bf16*>(x), static_cast<bf16*>(y), gf, bf, rows, D, Dt,
                    eps, nullptr, 1, s);
}

// The bf16 entries' attention on its own, for checks: qkv (B*T, 3 Di)
// bf16, the q|k|v rows the QKV product writes, heads of Di / H -> out
// (B*T, Di), bf16 or, out_f32 (the W8A8 entry with the float32 softmax),
// float32.
extern "C" int eet_block_attention(const void* qkv, const void* lengths, void* out, int B,
                                   int T, int Di, int H, float scale, int sm_bf16, int out_f32,
                                   void* stream_) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (out_f32)
    return attention(q, len, static_cast<float*>(out), B, T, Di, H, scale, sm_bf16, s);
  return attention(q, len, static_cast<bf16*>(out), B, T, Di, H, scale, sm_bf16, s);
}

// The W8A8 entry's LayerNorm + quantize on its own, for checks: x (rows,
// D) bf16 -> q (rows, D) int8 and sx (rows) float32, statistics over the
// first Dt of the D values.
extern "C" int eet_layer_norm_quantize(const void* x, const void* g, const void* b, void* q,
                                       void* sx, int rows, int D, int Dt, float eps,
                                       void* stream_) {
  return layer_norm_quantize(static_cast<const bf16*>(x), static_cast<const float*>(g),
                             static_cast<const float*>(b), static_cast<int8_t*>(q),
                             static_cast<float*>(sx), rows, D, Dt, eps,
                             static_cast<cudaStream_t>(stream_));
}
