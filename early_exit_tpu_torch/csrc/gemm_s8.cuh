// The W8A8 Conformer block's matrix product for Hopper (sm_90a):
//   out[M, N] = epilogue(bf16(float(A[M, K] @ Wt[N, K]^T) * (sx[M] * sw[N])
//                             + bias[N]))
// A: the int8 rows of an activation, one float32 scale each (sx); Wt: the
// per-output-channel int8 weight stored transposed, (N, K), the `<name>_t`
// twin that fold_block_params builds, with its float32 scale row sw; bias
// float32; res and out bf16, or float32 in the float32 epilogues (EPI_F32:
// float32 compute, whose product outputs are not rounded, and bf16 compute
// with a float32 residual, whose y is rounded before the add). All ten products of the W8A8 block go through
// it (W1 256->2048 +SiLU, W2 2048->256 x+0.5y, QKV 256->768, Wo, PW1
// 256->512, PW2, each at M = B*T' rows).
//
// Bound: at M = 31,872 the ten products are 162.9 G operations, 0.082 ms
// at 1,979 TOP/s dense int8; only wgmma reaches that rate. As for the bf16
// products (gemm_bf16.cuh), the K = 256 products spend more on a tile's
// epilogue than on its products, and W2 reads the 65 MB int8 FFN
// intermediate. Design: the persistent, warp-specialised kernel of
// gemm_bf16.cuh, instantiated for int8 operands (OpS8 below, in two
// variants by K, which the host picks):
//   - wgmma.mma_async m64n256k32 .s32.s8.s8, the 128 int32 sums of a
//     thread in registers. An 8-bit wgmma takes no transpose, so both
//     operands are K-major in shared memory: A as it is, W as its (N, K)
//     twin, one TMA box of [256 n][128 k] a stage (no second copy of the
//     weights beyond the twin the layout already holds);
//   - a stage is 128 k, 128 bytes a row in A and W as for bf16, so the
//     rings, the 128-byte swizzle and the epilogue strips are the bf16
//     product's byte for byte: 4 stages of 48 KB and 16 KB of strips;
//   - the epilogue keeps the arithmetic of the plain version and of the
//     TPU kernel: float(acc) * (sx * sw) and the float32 bias, each
//     product and sum rounded on its own (no FMA contraction), one rounding
//     to bf16, then SiLU or the residual add on bf16 pairs as the bf16
//     product does them. int8 x int8 -> int32 sums are exact in any order,
//     so the product equals its plain version bit for bit, and a row's
//     result does not depend on the rows beside it.
#pragma once

#include "gemm_bf16.cuh"

#define S8_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define S8_D16(i) S8_D4(i), S8_D4(i + 4), S8_D4(i + 8), S8_D4(i + 12)
#define S8_D64(i) S8_D16(i), S8_D16(i + 16), S8_D16(i + 32), S8_D16(i + 48)

// d (64 x 256 over the warpgroup) = A (64 x 32, K-major) @ B (32 x 256,
// K-major) + (accumulate ? d : 0), int32
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "%128, %129, p;\n}\n"
      : S8_D64(0), S8_D64(64)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef S8_D4
#undef S8_D16
#undef S8_D64

// kSmallK: K <= 256, where float(acc) comes from the bits (to_float).
template <bool kSmallK>
struct OpS8 {
  typedef int Acc;
  static constexpr bool kF32Out = true;  // the float32 epilogues too (EPI_F32)
  static constexpr int BK = 128;  // k per stage: 128 bytes of int8
  // Wt (N, K) row-major, K-major like A: one [256 n][128 k] box
  __device__ static void load_w(uint32_t dst, const CUtensorMap* map, uint32_t bar, int n0,
                                int k0) {
    tma_load_2d(dst, map, bar, k0, n0);
  }
  __device__ static void mma(int (&d)[128], uint32_t a, uint32_t w, int accumulate) {
    const uint64_t da = desc_k_major(a), db = desc_k_major(w);
#pragma unroll
    for (int k32 = 0; k32 < BK / 32; ++k32)  // 32 bytes along k in A and in W
      wgmma_m64n256k32_s8(d, da + 2 * k32, db + 2 * k32, accumulate | k32);
  }
  struct Col {  // the weight scales and the biases of a column pair
    float2 sw, bias;
  };
  __device__ static Col col(const GemmArgs& g, int gn) {
    return Col{*reinterpret_cast<const float2*>(g.sw + gn),
               *reinterpret_cast<const float2*>(static_cast<const float*>(g.bias) + gn)};
  }
  __device__ static float row_scale(const GemmArgs& g, int row) {
    return row < g.M ? g.sx[row] : 0.f;
  }
  // float(acc), exactly. The int -> float conversion runs at a quarter of
  // the float32 rate and would bound a K = 256 tile's epilogue; up to 2^22
  // in magnitude (K <= 256: 256 x 128 x 128 = 2^22) the integer is added
  // to the bits of 1.5 x 2^23, whose ulp is 1 up to 2^24, and the offset
  // subtracted again, both exact.
  __device__ static float to_float(int v) {
    return kSmallK ? __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.f) : (float)v;
  }
  // float(acc) * (sx * sw) + bias, each operation rounded on its own
  __device__ static float2 pair_f32(int a, int b, Col c, float sx) {
    return make_float2(__fadd_rn(__fmul_rn(to_float(a), __fmul_rn(sx, c.sw.x)), c.bias.x),
                       __fadd_rn(__fmul_rn(to_float(b), __fmul_rn(sx, c.sw.y)), c.bias.y));
  }
  __device__ static __nv_bfloat162 pair(int a, int b, Col c, float sx, const GemmArgs&) {
    const float2 v = pair_f32(a, b, c, sx);
    return __floats2bfloat162_rn(v.x, v.y);
  }
};

// A: (M, K) int8, Wt: (N, K) int8, res and out: (M, N) bf16 (float32 with
// EPI_F32), all row-major and 16-byte aligned; sx (M), sw (N) and bias (N)
// float32, sw and bias 8-byte aligned; K a multiple of 16, N of 8; res may
// be out.
static cudaError_t gemm_s8(int epi, const int8_t* A, const float* sx, const int8_t* Wt,
                           const float* sw, const float* bias, const void* res, void* out, int M,
                           int N, int K, cudaStream_t s) {
  const bool wants_res = (epi & 3) == EPI_RES || (epi & 3) == EPI_RES_HALF;
  if (M <= 0 || N % 8 || K % 16 || (wants_res && res == nullptr) ||
      ((uintptr_t)A | (uintptr_t)Wt | (uintptr_t)out | (uintptr_t)res) % 16 ||
      ((uintptr_t)sw | (uintptr_t)bias) % 8 || (uintptr_t)sx % 4)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  EET_TRY(tensor_map(A, 1, K, M, OpS8<true>::BK, 64, &ma));
  EET_TRY(tensor_map(Wt, 1, K, N, OpS8<true>::BK, WG_BN, &mw));
  const GemmArgs g{bias, sx, sw, res, out, M, N, K, epi};
  return K <= 256 ? launch_gemm_epi<OpS8<true>>(epi, ma, mw, g, s)
                  : launch_gemm_epi<OpS8<false>>(epi, ma, mw, g, s);
}
