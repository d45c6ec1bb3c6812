// The bf16 Conformer block's matrix product for Hopper (sm_90a):
//   out[M, N] = epilogue(bf16(A[M, K] @ W[K, N]) + bias[N])
// A, W, bias, res, out bf16; the sum float32. All ten products of the
// block go through this one kernel (W1 256->2048 +SiLU, W2 2048->256
// x+0.5y, QKV 256->768, Wo, PW1 256->512, PW2, each at M = B*T' rows).
//
// Bound: at M = 31,872 the ten products are 162.9 GFLOP, 0.165 ms at 989
// TFLOP/s dense bf16; only wgmma reaches that rate. At these shapes the
// tensor cores are not what holds a product back. W2 reads the 130 MB FFN
// intermediate from device memory, which alone is most of its time. The
// six products with K = 256 spend more on a tile's epilogue than on its
// products: 128 values a thread to round, bias, activate and store, on
// eight consumer warps a SM, through the pipe that converts to bf16 and
// evaluates exp and 1/x a quarter of a warp a cycle; with SiLU (W1, the
// largest of the ten) the epilogue is twice the products. Design:
//   - one persistent block per SM takes a contiguous run of 128 x 256
//     output tiles, column of tiles by column of tiles;
//   - two producer warps keep TMA loads (cp.async.bulk.tensor.2d, 128-byte
//     swizzle, completing on mbarriers) in flight into rings of four
//     stages of 64 k: one ring of W, [64 k][256 n] a stage, and one of
//     64-row A stages for each consumer warpgroup, so the next tile's
//     operands arrive while this tile's epilogue runs. (A cluster of two
//     blocks sharing W by TMA multicast was tried in the ring's place and
//     ran slower: the blocks of a pair then wait on each other);
//   - two consumer warpgroups take 64 rows of a tile each and run
//     wgmma.mma_async m64n256k16 on the stages that have arrived, the 128
//     float32 sums of a thread in registers (setmaxnreg moves registers
//     from the producer warpgroup to the consumers). They share W and
//     nothing else, so one's products may run under the other's epilogue
//     (making them take strict turns at the tensor cores ran slower: one
//     warpgroup that drains its wgmmas every 64 k does not fill them);
//   - A is the K-major operand. W stays (K, N) row-major as
//     fold_block_params lays it out and is the MN-major operand (the
//     instruction's transpose bit): no second copy of the weights in
//     device memory. A stage's W is four [64 k][64 n] TMA boxes;
//   - the epilogue runs from the accumulator registers in straight-line
//     code: each thread rounds its own sums to bf16, adds the bf16 bias
//     and applies SiLU, every rounding point on a pair of values with one
//     packed instruction (conversion, bf16x2 add or fma; the note above
//     silu_bf16x2 says why those round as the float32 arithmetic does). The rounding
//     points are bf16(acc), bf16(v + bias), then the epilogue op. The bf16
//     values pass through a per-warp strip of shared memory and leave as
//     256-byte row segments, 16 bytes a lane (bf16 pairs straight from the
//     fragments half-fill every 32-byte sector and took most of a short-K
//     product's time); x+y / x+0.5y are added on the way out, by the lane
//     that reads the residual (its loads started before the arithmetic that
//     hides them) and writes the result, so res may be out;
//   - no split over K and k in a fixed order per output tile: a row's
//     result does not depend on the rows beside it (the cascade packs
//     rows, the gate does not);
//   - ragged edges: TMA zero-fills rows past M, columns past N and k past
//     K on the way in; stores are guarded by row < M and column < N.
// The kernel is a template over the operand type: OpBf16 below, OpS8 for
// the W8A8 block's int8 products (gemm_s8.cuh), which share the schedule,
// the rings, the strips and the epilogue's bf16 tail.
// Tensor maps are encoded on the host by libcuda's
// cuTensorMapEncodeTiled (looked up in libcuda.so.1 at first use, so the
// build links nothing of it) and cached by (pointer, shape, box):
// a weight's map is made once, an activation's once per buffer.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <mutex>
#include <unordered_map>

#include "common.cuh"

enum { EPI_BIAS = 0, EPI_SILU = 1, EPI_RES = 2, EPI_RES_HALF = 3 };
// Flags beside an epilogue, for the int8 product only (gemm_s8.cuh):
// EPI_F32, the output (and the residual) float32, y not rounded (float32
// compute); with EPI_ROUND as well, y rounded once to bf16 before a
// float32 residual add (bf16 compute with a float32 residual).
enum { EPI_F32 = 4, EPI_ROUND = 8 };

constexpr int WG_BM = 128, WG_BN = 256, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int WG_THREADS = (WG_CONSUMERS + 1) * 128;
constexpr int WG_A_BYTES = 64 * WG_BK * 2;          // one warpgroup's [64 m][64 k]
constexpr int WG_BOX_BYTES = WG_BK * 64 * 2;        // one W box: [64 k][64 n]
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;       // four of them: [64 k][256 n]
// a consumer warp's 16 x 128 outputs (half its columns) on their way out,
// 16-byte chunks XOR-swizzled by row so that the fragment stores and the
// row reads are conflict-free
constexpr int WG_STRIP_BYTES = WG_CONSUMERS * 4 * 16 * 128 * 2;
// mbarriers: W full / empty, and A full / empty per consumer warpgroup
constexpr int WG_BARS = 2 * WG_STAGES * (1 + WG_CONSUMERS);
// W stages, A stages, strips, mbarriers, slack to align the stages to the
// swizzle's 1024 bytes
constexpr int WG_SMEM = WG_STAGES * (WG_B_BYTES + WG_CONSUMERS * WG_A_BYTES) + WG_STRIP_BYTES +
                        WG_BARS * 8 + 1024;
static_assert(WG_SMEM <= 232448, "the shared memory a block can opt in to");

// The epilogue's arithmetic on pairs. Conversions to bf16 and exp / rcp
// share a pipe that takes a quarter of a warp a cycle, and with eight
// consumer warps a SM little hides an instruction's latency, so every
// rounding point handles two values with one packed instruction.
//
// bf16(a + b) of bf16 values a, b is __hadd2: the packed bf16 add rounds
// the exact sum once. The float32 sum rounded to bf16, as the plain version
// and the TPU kernel have it, is the same value: the float32 sum is exact
// unless the exponents are 16 or more apart, and then the smaller term is
// below 2^-15 of the larger, which is itself a bf16 value, so both
// roundings return the larger. The same holds for res + 0.5 y as __hfma2.

// SiLU of a pair, v / (1 + exp(-v)) op by op in bf16 as silu_t<bf16>
// rounds it. The quotient of two bf16 values (8 significant bits each)
// lies at least 2^-17 of its size from any rounding boundary of bf16, so
// the approximate division (2 ulps of float32, no slow-path branch) rounds
// to the same bf16 value as the exact one, for every denominator below
// 2^126, that is every v above -87.
__device__ __forceinline__ __nv_bfloat162 silu_bf16x2(__nv_bfloat162 v2) {
  const float2 v = __bfloat1622float2(v2);
  const __nv_bfloat162 e = __floats2bfloat162_rn(expf(-v.x), expf(-v.y));
  const float2 den = __bfloat1622float2(__hadd2(__float2bfloat162_rn(1.f), e));
  return __floats2bfloat162_rn(__fdividef(v.x, den.x), __fdividef(v.y, den.y));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// returns once the barrier's phase is no longer `parity`; a wait of
// seconds means a load that never completed, and traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 4000000000ll) __trap();
  }
}
// one box of the tensor map at (c0 innermost, c1) -> shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1 in
// bits 62-63), offsets in 16-byte units. K-major (A): rows of 64 k = 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO unused. MN-major (W):
// rows of 64 n = 128 bytes, one per k; 8-k groups 1024 bytes apart (SBO),
// 64-n boxes WG_BOX_BYTES apart (LBO).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(WG_BOX_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)
#define WG_D64(i) WG_D16(i), WG_D16(i + 16), WG_D16(i + 32), WG_D16(i + 48)

// d (64 x 256 over the warpgroup) = A (64 x 16, K-major) @ B (16 x 256,
// MN-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"   // scale a, scale b, A K-major, B transposed
      : WG_D64(0), WG_D64(64)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// What a product's epilogue reads beside the sums, by value in the kernel's
// parameters: bias is bf16 for a bf16 product, float32 for an int8 one,
// whose sums are rescaled by sx[row] * sw[column] first; res and out are
// bf16, or float32 under EPI_F32.
struct GemmArgs {
  const void* bias;
  const float* sx;
  const float* sw;
  const void* res;
  void* out;
  int M, N, K;
  int epi;  // the float32 epilogue's op and flags (EPI_F32 instantiation only)
};

// The operand type of a product: how a stage of W is loaded, which wgmma
// runs on a stage, and how a pair of sums becomes a pair of bf16 values
// before the bias is behind them. A stage is 128 bytes of k in A and W
// alike, so the rings and strips below serve both types.
struct OpBf16 {
  typedef float Acc;
  static constexpr bool kF32Out = false;  // bf16 outputs only
  static constexpr int BK = WG_BK;  // k per stage
  // W (K, N) row-major, the MN-major operand: four [64 k][64 n] boxes
  __device__ static void load_w(uint32_t dst, const CUtensorMap* map, uint32_t bar, int n0,
                                int k0) {
#pragma unroll
    for (int i = 0; i < WG_BN / 64; ++i)
      tma_load_2d(dst + i * WG_BOX_BYTES, map, bar, n0 + 64 * i, k0);
  }
  __device__ static void mma(float (&d)[128], uint32_t a, uint32_t w, int accumulate) {
    const uint64_t da = desc_k_major(a), db = desc_mn_major(w);
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16)  // 32 bytes along k in A, 16 rows in W
      wgmma_m64n256k16(d, da + 2 * k16, db + (16 * 128 / 16) * k16, accumulate | k16);
  }
  typedef __nv_bfloat162 Col;  // the bias of a column pair
  __device__ static Col col(const GemmArgs& g, int gn) {
    return *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(g.bias) + gn);
  }
  __device__ static float row_scale(const GemmArgs&, int) { return 0.f; }
  // bf16(acc) + bias, both rounding points on the pair (see above)
  __device__ static __nv_bfloat162 pair(float a, float b, Col bias, float, const GemmArgs&) {
    return __hadd2(__floats2bfloat162_rn(a, b), bias);
  }
};

// The epilogue of one warp's 16 x 256 sums: d[4j + 2h + e] is row lane/4
// + 8h, column 8j + 2*(lane%4) + e. row0: the warp's first row in the
// matrix; n0: the tile's first column.
// The float32 epilogue (EPI_F32, the int8 product only): no strip, each
// lane's pairs of sums straight to their float2 (the four lanes of a row
// write 32 contiguous bytes, a whole sector), the residual read likewise.
// y = Op::pair_f32 (the rescaled sum plus the float32 bias, unrounded);
// SiLU in float32 (silu_t<float>); res + w y one rounding of the float32
// sum (w y exact), after y's one rounding to bf16 under EPI_ROUND. One
// instantiation serves the four ops and the flag: g.epi says which, a
// branch uniform over the grid (each instantiation of the product is a
// large kernel to compile).
template <class Op>
__device__ __forceinline__ void epilogue_f32(typename Op::Acc (&d)[128], int row0, int n0,
                                             const GemmArgs& g, int lane) {
  const int OP = g.epi & 3;
  const bool round_y = (g.epi & EPI_ROUND) != 0;
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const float* res = static_cast<const float*>(g.res);
  float* out = static_cast<float*>(g.out);
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rs[h] = Op::row_scale(g, row0 + fr + 8 * h);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int gn = n0 + 8 * j + fc;
    if (gn >= g.N) continue;  // N a multiple of 8: a pair is in or out
    const typename Op::Col c = Op::col(g, gn);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + fr + 8 * h;
      if (gm >= g.M) continue;
      float2 v = Op::pair_f32(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], c, rs[h]);
      if (OP == EPI_SILU) v = make_float2(silu_t<float>(v.x), silu_t<float>(v.y));
      const size_t at = (size_t)gm * g.N + gn;
      if (OP == EPI_RES || OP == EPI_RES_HALF) {
        if (round_y) v = make_float2(bf16r(v.x), bf16r(v.y));
        const float w = OP == EPI_RES ? 1.f : 0.5f;
        const float2 r = *reinterpret_cast<const float2*>(res + at);
        v = make_float2(__fmaf_rn(w, v.x, r.x), __fmaf_rn(w, v.y, r.y));
      }
      *reinterpret_cast<float2*>(out + at) = v;
    }
  }
}

template <class Op, int EPI>
__device__ __forceinline__ void epilogue(typename Op::Acc (&d)[128], bf16* strip, int row0, int n0,
                                         const GemmArgs& g, int lane) {
  if constexpr (EPI == EPI_F32) {
    epilogue_f32<Op>(d, row0, n0, g, lane);
    return;
  }
  const int M = g.M, N = g.N;
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const int chunk = lane & 15, rsub = lane >> 4;  // on the way out: 16 bytes of row 2i + rsub
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rs[h] = Op::row_scale(g, row0 + fr + 8 * h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gn_out = n0 + 128 * half + 8 * chunk;
    // the residual's loads start before the arithmetic that hides them
    uint4 rv[8];
    if (EPI == EPI_RES || EPI == EPI_RES_HALF) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gm = row0 + 2 * i + rsub;
        rv[i] = gm < M && gn_out < N
                    ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.res) +
                                                      (size_t)gm * N + gn_out)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * half + jj;
      const int gn = n0 + 8 * j + fc;
      const typename Op::Col c = Op::col(g, gn < N ? gn : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 v = Op::pair(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], c, rs[h], g);
        if (EPI == EPI_SILU) v = silu_bf16x2(v);
        const int r = fr + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(strip + r * 128 + ((jj ^ (r & 7)) << 3) + fc) = v;
      }
    }
    __syncwarp();
    // out of the strip two rows at a time, 16 bytes a lane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 2 * i + rsub;
      const int gm = row0 + r;
      if (gm >= M || gn_out >= N) continue;
      uint4 yv = *reinterpret_cast<const uint4*>(strip + r * 128 + ((chunk ^ (r & 7)) << 3));
      if (EPI == EPI_RES || EPI == EPI_RES_HALF) {
        // res + w y, one rounding of the exact value (w y is a bf16 value)
        __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&yv);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
        const __nv_bfloat162 w = __float2bfloat162_rn(EPI == EPI_RES ? 1.f : 0.5f);
#pragma unroll
        for (int e = 0; e < 4; ++e) y2[e] = __hfma2(y2[e], w, r2[e]);
      }
      *reinterpret_cast<uint4*>(static_cast<bf16*>(g.out) + (size_t)gm * N + gn_out) = yv;
    }
    __syncwarp();  // the strip is free again
  }
}

// A block's tiles are [first, last) of the tile sequence, in which tile t
// is row tile t % tiles_m of tile column t / tiles_m. Stage `it` of a
// block's run (one per tile and 128 bytes of k) lies in slot it % WG_STAGES
// of every ring, in phase (it / WG_STAGES) & 1 of the slot's barriers.
template <class Op, int EPI>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const GemmArgs g) {
  extern __shared__ unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t a_base = base + WG_STAGES * WG_B_BYTES;  // [warpgroup][stage]
  constexpr int kStrips = WG_STAGES * (WG_B_BYTES + WG_CONSUMERS * WG_A_BYTES);
  bf16* strips = reinterpret_cast<bf16*>(wg_smem + (base - smem_u32(wg_smem)) + kStrips);
  const uint32_t b_full = base + kStrips + WG_STRIP_BYTES;
  const uint32_t b_empty = b_full + 8 * WG_STAGES;
  const uint32_t a_bars = b_empty + 8 * WG_STAGES;  // per warpgroup: full[], empty[]
  const int group = threadIdx.x >> 7;
  const int tiles_m = (g.M + WG_BM - 1) / WG_BM;
  const int n_tiles = tiles_m * ((g.N + WG_BN - 1) / WG_BN);
  const int first = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int KB = (g.K + Op::BK - 1) / Op::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(b_full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(b_empty + 8 * s, WG_CONSUMERS * 4);  // lane 0 of each consumer warp
      for (int c = 0; c < WG_CONSUMERS; ++c) {
        mbar_init(a_bars + 8 * (2 * WG_STAGES * c + s), 1);
        mbar_init(a_bars + 8 * (2 * WG_STAGES * c + WG_STAGES + s), 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == WG_CONSUMERS) {
    // ---- producers: lane 0 of warp c loads consumer warpgroup c's A;
    // that of warp 0 loads W as well
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int c = (threadIdx.x & 127) >> 5;
    if (c < WG_CONSUMERS && (threadIdx.x & 31) == 0) {
      const uint32_t a_full = a_bars + 8 * (2 * WG_STAGES * c), a_empty = a_full + 8 * WG_STAGES;
      int it = 0;
      for (int tile = first; tile < last; ++tile) {
        const int m0 = (tile % tiles_m) * WG_BM + 64 * c, n0 = (tile / tiles_m) * WG_BN;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % WG_STAGES;
          const uint32_t free_parity = ((it / WG_STAGES) & 1) ^ 1;  // passes the first time
          if (c == 0) {
            const uint32_t bar = b_full + 8 * s;
            mbar_wait(b_empty + 8 * s, free_parity);
            mbar_expect_tx(bar, WG_B_BYTES);
            Op::load_w(base + s * WG_B_BYTES, &map_w, bar, n0, kb * Op::BK);
          }
          mbar_wait(a_empty + 8 * s, free_parity);
          mbar_expect_tx(a_full + 8 * s, WG_A_BYTES);
          tma_load_2d(a_base + (c * WG_STAGES + s) * WG_A_BYTES, &map_a, a_full + 8 * s,
                      kb * Op::BK, m0);
        }
      }
    }
  } else {
    // ---- consumers: rows [64 * group, 64 * group + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const uint32_t a_full = a_bars + 8 * (2 * WG_STAGES * group), a_empty = a_full + 8 * WG_STAGES;
    bf16* strip = strips + (group * 4 + warp) * 16 * 128;
    typename Op::Acc d[128];
    int it = 0;
    for (int tile = first; tile < last; ++tile) {
      const int m0 = (tile % tiles_m) * WG_BM + 64 * group, n0 = (tile / tiles_m) * WG_BN;
      for (int kb = 0; kb < KB; ++kb, ++it) {
        const int s = it % WG_STAGES;
        const uint32_t parity = (it / WG_STAGES) & 1;
        mbar_wait(b_full + 8 * s, parity);
        mbar_wait(a_full + 8 * s, parity);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        Op::mma(d, a_base + (group * WG_STAGES + s) * WG_A_BYTES, base + s * WG_B_BYTES, kb != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane == 0) {
          mbar_arrive(a_empty + 8 * s);
          mbar_arrive(b_empty + 8 * s);
        }
      }
      if (m0 + 16 * warp < g.M) epilogue<Op, EPI>(d, strip, m0 + 16 * warp, n0, g, lane);
    }
  }
}

#undef WG_D4
#undef WG_D16
#undef WG_D64

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  uint64_t inner, outer;
  uint32_t box_inner, box_outer, elem_bytes;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && box_inner == o.box_inner &&
           box_outer == o.box_outer && elem_bytes == o.elem_bytes;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr);
    for (uint64_t v : {k.inner, k.outer, (uint64_t)k.box_inner, (uint64_t)k.box_outer,
                       (uint64_t)k.elem_bytes})
      h = h * 0x9E3779B97F4A7C15ull + v;
    return h;
  }
};

// The tensor map of a row-major matrix of bf16 (elem_bytes 2) or int8 (1)
// values, outer rows of inner values, read in boxes of box_outer x
// box_inner, 128-byte swizzle, zeros past the edges. Maps are cached: one
// is a pure function of its key.
static cudaError_t tensor_map(const void* ptr, int elem_bytes, uint64_t inner, uint64_t outer,
                              uint32_t box_inner, uint32_t box_outer, CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, inner, outer, box_inner, box_outer, (uint32_t)elem_bytes};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * elem_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, elem[2] = {1, 1};
  if (encode(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// The SM count of the current device, by device, after `kernel`'s shared
// memory limit is raised there: 0 until then. Each caller keeps its own.
template <class Kernel>
static cudaError_t sm_count(Kernel kernel, int smem, int (&sms_of)[64], int* sms) {
  int dev = 0;
  EET_TRY(cudaGetDevice(&dev));
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    EET_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    EET_TRY(cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev));
  }
  *sms = sms_of[dev];
  return cudaSuccess;
}

// One persistent block per SM, or per tile where there are fewer.
template <class Op, int EPI>
static cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mw, const GemmArgs& g,
                               cudaStream_t s) {
  static int sms_of[64] = {};  // one per instantiation, as the attribute is
  int sms = 0;
  EET_TRY(sm_count(gemm_wgmma_kernel<Op, EPI>, WG_SMEM, sms_of, &sms));
  const int tiles = ((g.M + WG_BM - 1) / WG_BM) * ((g.N + WG_BN - 1) / WG_BN);
  gemm_wgmma_kernel<Op, EPI><<<tiles < sms ? tiles : sms, WG_THREADS, WG_SMEM, s>>>(ma, mw, g);
  return cudaGetLastError();
}

// epi: one of the four, with the float32 flags where Op::kF32Out
template <class Op>
static cudaError_t launch_gemm_epi(int epi, const CUtensorMap& ma, const CUtensorMap& mw,
                                   const GemmArgs& g, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS: return launch_gemm<Op, EPI_BIAS>(ma, mw, g, s);
    case EPI_SILU: return launch_gemm<Op, EPI_SILU>(ma, mw, g, s);
    case EPI_RES: return launch_gemm<Op, EPI_RES>(ma, mw, g, s);
    case EPI_RES_HALF: return launch_gemm<Op, EPI_RES_HALF>(ma, mw, g, s);
    default: break;
  }
  if constexpr (Op::kF32Out) {
    // one instantiation, the op and flags in g.epi; EPI_ROUND with a residual only
    const bool res_op = (epi & 3) == EPI_RES || (epi & 3) == EPI_RES_HALF;
    if ((epi & ~(EPI_F32 | EPI_ROUND | 3)) == 0 && (epi & EPI_F32) &&
        (res_op || !(epi & EPI_ROUND))) {
      GemmArgs gf = g;
      gf.epi = epi;
      return launch_gemm<Op, EPI_F32>(ma, mw, gf, s);
    }
  }
  return cudaErrorInvalidValue;
}

// A: (M, K), W: (K, N), res and out: (M, N), all row-major and 16-byte
// aligned, K and N multiples of 8; res may be out.
static cudaError_t gemm(int epi, const bf16* A, const bf16* W, const bf16* bias,
                        const bf16* res, bf16* out, int M, int N, int K, cudaStream_t s) {
  const bool wants_res = epi == EPI_RES || epi == EPI_RES_HALF;
  if (M <= 0 || N % 8 || K % 8 || (wants_res && res == nullptr) ||
      ((uintptr_t)A | (uintptr_t)W | (uintptr_t)out | (uintptr_t)res) % 16 ||
      (uintptr_t)bias % 4)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  EET_TRY(tensor_map(A, 2, K, M, WG_BK, 64, &ma));
  EET_TRY(tensor_map(W, 2, N, K, 64, WG_BK, &mw));
  return launch_gemm_epi<OpBf16>(epi, ma, mw,
                                 GemmArgs{bias, nullptr, nullptr, res, out, M, N, K, epi}, s);
}
