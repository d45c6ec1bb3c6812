// Float32 self-attention with a key mask, shared by attention.cu (the
// (B, H, T, dh) layout) and the float32 entry of conformer_block.cu (the
// packed (B*T, 3D) q|k|v rows): the layouts differ only in strides.
//
// Arithmetic, all in true float32 FMAs (no TF32):
//   s = (q . k) * scale;  s = valid ? s : -1e9;  p = exp(s - max s);
//   o = (sum_t p[t] v[t]) / sum_t p[t]
// K and V are streamed in tiles of 64 keys with a running maximum: each
// new tile rescales the sums so far by exp(m_old - m_new), so the keys
// are summed tile by tile and the division by the sum comes last. That
// moves the result by a few float32 roundings against the two-pass
// softmax of the plain version (held to 1e-5 of max|v| on the card) and
// takes any T. A row whose keys are all masked has every score at -1e9,
// so it gets uniform p, the mean of v.
//
// Bound at B=128, H=8, T=249, dh=32: 4*T*T*dh FLOP per head, 8.1 GFLOP,
// 0.12 ms at 67 TFLOP/s (float32 outside the tensor cores); q, k, v in
// and o out are 0.13 GB in float32, 0.04 ms. What holds a float32
// attention back on this card is shared-memory bandwidth: an SM starts
// four FMA instructions a cycle but serves one 128-byte shared-memory
// request. So both products are register-tiled. One block takes 64
// queries of one (item, head); a warp owns 16 of them and its lanes form
// a 4 x 8 grid: lane (qg, kg) holds a 4-query x 4-key tile of the scores
// and, for P V, a 4-query x 4-column tile of the output. Every operand
// comes from shared memory as a 16-byte load that a group of lanes
// shares (a broadcast), and serves 16 FMAs: 64 FMAs per eight loads, each
// load one 128-byte request. The tiles are float32 rows of 128 bytes
// whose 16-byte chunks are XOR-swizzled so that the rows a warp reads
// together fall on distinct banks (no padding, so rows stay 16-byte
// aligned). K and V arrive by cp.async into a two-stage ring, so the load
// of the next tile overlaps the products of this one; bf16 inputs land in
// a raw buffer first and are widened to float32 once per tile. The
// probabilities pass from the score layout to the P V layout through a
// per-warp strip of shared memory.
//
// Head widths: the kernel is a template over dh in {16, 32, 48, 64, 128};
// a caller pads a head of another width up to 128 with zero columns to
// the next of them (the scale stays 1/sqrt of the true width), which
// changes no sum. A tile row is DHP = max(dh, 32) floats, 64 at dh = 48,
// so the swizzle always has its 8 chunks to spread over: at dh = 64 and
// 128 a row is 256 and 512 bytes, its chunks swizzled within each 128
// bytes (at dh = 128 the two K|V stages take 128 KB and the block 168 KB
// of shared memory, and a lane holds 64 float32 sums of P V); at dh = 16
// and 48 the row keeps 32 and 64 floats of which the scores read only
// the first dh (the chunks past them are never written or read) and P V
// computes DHP columns, the ones past dh on whatever the tile holds
// there, never stored: a quarter to a half of P V's FMAs are wasted
// there, which keeps one lane layout for every width. At dh = 48 a row
// has 12 chunks of head values, so the chunk loops divide where the
// powers of two shift. A lane owns DHP / 32 groups of 4 output columns.
//
// kLowp (the float32 Conformer block with the bf16 softmax, the JAX
// kernel's compute float32 with attn_softmax_dtype bf16): the scores are
// rounded to bf16, scaled in bf16 and masked to bf16(-30000), and the
// softmax is the TPU kernel's in bf16 -- m the row max, e = bf16(exp(
// bf16(s - m))), z = bf16(sum e), p = bf16(e / z) -- with P V summed in
// float32 and no division after it. An online softmax cannot keep those
// rounding points, so the keys are streamed three times (max, sum, P V),
// as the bf16 block's attention streams them; keys past T drop out.
#pragma once

#include "common.cuh"

constexpr int AF_WARPS = 4;    // 16 queries each
constexpr int AF_QTILE = 16 * AF_WARPS;
constexpr int AF_KT = 64;      // keys per stage

template <typename TIn, int DH>
struct AttF32Smem {
  static_assert(DH == 16 || DH == 32 || DH == 48 || DH == 64 || DH == 128,
                "head widths 16, 32, 48, 64 and 128");
  static constexpr int DHP = DH < 32 ? 32 : DH == 48 ? 64 : DH;  // floats per tile row
  static constexpr bool kRaw = sizeof(TIn) != sizeof(float);
  static constexpr int kStages = kRaw ? 1 : 2;            // float32 K|V tiles
  static constexpr int kTileFloats = 2 * AF_KT * DHP;     // K then V
  static constexpr int kFloats =
      AF_QTILE * DHP + AF_WARPS * 16 * 32 + kStages * kTileFloats;
  static constexpr int kRawBytes = kRaw ? 2 * AF_KT * DH * (int)sizeof(TIn) : 0;
  static constexpr int kBytes = kFloats * (int)sizeof(float) + kRawBytes;
};

// 16 bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// acc[j] += a . b over the four values of a chunk, d in order
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Strides in elements: *_bs between items, *_hs between heads, *_ts
// between frames; a frame's dh values are contiguous and 16-byte aligned.
// Keys t are valid where mask[b*T + t] != 0, or, with mask == nullptr,
// where t < lengths[b].
template <typename TIn, int DH>
__global__ void __launch_bounds__(AF_WARPS * 32)
attention_f32_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                     const TIn* __restrict__ v, const unsigned char* __restrict__ mask,
                     const int* __restrict__ lengths, float* __restrict__ out, int T,
                     long long in_bs, long long in_hs, long long in_ts, long long out_bs,
                     long long out_hs, long long out_ts, float scale) {
  using S = AttF32Smem<TIn, DH>;
  constexpr int DHP = S::DHP;
  constexpr int CHP = DHP / 4;                    // 4-float chunks of a tile row
  constexpr int CHI = DH / 4;                     // of them holding the head's values
  constexpr int CHI_LOG = CHI == 4 ? 2 : CHI == 8 ? 3 : CHI == 16 ? 4 : 5;  // shifts
  constexpr bool kPow2 = (CHI & (CHI - 1)) == 0;  // else (dh 48) divisions
  constexpr int NG = DHP / 32;                    // a lane's groups of 4 output columns
  constexpr int CH = DH * (int)sizeof(TIn) / 16;  // 16-byte chunks of an input row
  extern __shared__ __align__(16) unsigned char af_smem[];
  float* Qs = reinterpret_cast<float*>(af_smem);       // [64][DHP], chunk ^ (row & 7)
  float* Ps = Qs + AF_QTILE * DHP;                      // per warp [16][32], chunk ^ (row & 7)
  float* KVs = Ps + AF_WARPS * 16 * 32;                 // per stage K [64][DHP] with
                                                        // chunk ^ ((row >> 2) & 7), then V
  TIn* raw = reinterpret_cast<TIn*>(KVs + S::kStages * S::kTileFloats);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AF_QTILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = lane >> 3, kg = lane & 7;  // kg is the column group dg in P V
  const long long in0 = b * in_bs + h * in_hs;
  const int len = mask == nullptr ? lengths[b] : 0;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + (size_t)b * T;

  // start the copy of key tile t: float32 straight into its swizzled
  // stage, anything else into the raw buffer
  auto start_copy = [&](int t) {
    for (int idx = tid; idx < 2 * AF_KT * CH; idx += AF_WARPS * 32) {
      const int which = idx / (AF_KT * CH), r = (idx / CH) % AF_KT, c = idx % CH;
      const int key = t * AF_KT + r;
      const TIn* src = (which ? v : k) + in0 + (long long)(key < T ? key : 0) * in_ts +
                       c * (16 / (int)sizeof(TIn));
      uint32_t dst;
      if (S::kRaw) {
        dst = smem_u32(raw) + ((which * AF_KT + r) * CH + c) * 16;
      } else {
        const int pc = which ? c : c ^ ((r >> 2) & 7);
        dst = smem_u32(KVs + (t & 1) * S::kTileFloats) + ((which * AF_KT + r) * CHP + pc) * 16;
      }
      cp_async16(dst, src, key < T ? 16 : 0);
    }
    cp_async_commit();
  };

  start_copy(0);
  for (int idx = tid; idx < AF_QTILE * CHI; idx += AF_WARPS * 32) {
    const int r = kPow2 ? idx >> CHI_LOG : idx / CHI, c = kPow2 ? idx & (CHI - 1) : idx % CHI;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) qv = load4f(q + in0 + (long long)(q0 + r) * in_ts + c * 4);
    *reinterpret_cast<float4*>(Qs + r * DHP + ((c ^ (r & 7)) << 2)) = qv;
  }

  float s[4][4], o[4][4 * NG], m[4], z[4];
  int qoff[4], qsw[4];  // this lane's query rows in Qs: offset and swizzle
  int poff[4];          // and in its warp's strip of Ps (qoff itself at DHP = 32)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    z[i] = 0.f;
    qoff[i] = (qg + 4 * i) * DHP;
    poff[i] = DHP == 32 ? qoff[i] : (qg + 4 * i) * 32;
    qsw[i] = (qg + 4 * i) & 7;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) o[i][j] = 0.f;
  }
  const float* Qw = Qs + warp * 16 * DHP;
  float* Pw = Ps + warp * 16 * 32;
  const bool active = q0 + warp * 16 < T;

  const int n_tiles = (T + AF_KT - 1) / AF_KT;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t-1
    const float* Kt = KVs + (S::kRaw ? 0 : (t & 1) * S::kTileFloats);
    if (S::kRaw) {
      float* dstt = KVs;
      for (int idx = tid; idx < 2 * AF_KT * CHI; idx += AF_WARPS * 32) {
        const int which = idx / (AF_KT * CHI),
                  r = (kPow2 ? idx >> CHI_LOG : idx / CHI) % AF_KT,
                  c = kPow2 ? idx & (CHI - 1) : idx % CHI;
        const int pc = which ? c : c ^ ((r >> 2) & 7);
        *reinterpret_cast<float4*>(dstt + (which * AF_KT + r) * DHP + (pc << 2)) =
            load4f(raw + (which * AF_KT + r) * DH + c * 4);
      }
      __syncthreads();
    }
    if (t + 1 < n_tiles) start_copy(t + 1);
    if (!active) continue;
    const float* Vt = Kt + AF_KT * DHP;

    for (int ks = 0; ks < AF_KT; ks += 32) {
      const int key0 = t * AF_KT + ks + 4 * kg;  // this lane's four keys
      if (t * AF_KT + ks >= T) break;
      // scores: 4 queries x 4 keys, over the dh / 4 chunks of d
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* Kl = Kt + (ks + 4 * kg) * DHP;
#pragma unroll
      for (int c = 0; c < CHI; ++c) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = load4f(Qw + qoff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = load4f(Kl + j * DHP + ((c ^ kg) << 2));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
      }
      // scale, mask; keys past T drop out of the sums altogether
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + j;
        const bool in = key < T;
        const bool ok = in && (mrow != nullptr ? mrow[key] != 0 : key < len);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = ok ? s[i][j] * scale : (in ? -1e9f : -INFINITY);
      }
      // running maximum and sum of each query over the warp's 32 keys
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);  // 0 on the first tile
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        z[i] = z[i] * alpha + rs;
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) o[i][j] *= alpha;
        *reinterpret_cast<float4*>(Pw + poff[i] + ((kg ^ qsw[i]) << 2)) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncwarp();
      // P V: 4 queries x 4 NG columns, over the 8 chunks of 4 keys
      const float* Vl = Vt + ks * DHP + 4 * kg;
      if constexpr (NG == 1) {  // dh 16 and 32: one group of 4 columns a lane
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float4 pv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = load4f(Pw + qoff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = load4f(Vl + (4 * c + j) * DHP);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][0] = fmaf(pv[i].x, vv[0].x, o[i][0]);
            o[i][1] = fmaf(pv[i].x, vv[0].y, o[i][1]);
            o[i][2] = fmaf(pv[i].x, vv[0].z, o[i][2]);
            o[i][3] = fmaf(pv[i].x, vv[0].w, o[i][3]);
            o[i][0] = fmaf(pv[i].y, vv[1].x, o[i][0]);
            o[i][1] = fmaf(pv[i].y, vv[1].y, o[i][1]);
            o[i][2] = fmaf(pv[i].y, vv[1].z, o[i][2]);
            o[i][3] = fmaf(pv[i].y, vv[1].w, o[i][3]);
            o[i][0] = fmaf(pv[i].z, vv[2].x, o[i][0]);
            o[i][1] = fmaf(pv[i].z, vv[2].y, o[i][1]);
            o[i][2] = fmaf(pv[i].z, vv[2].z, o[i][2]);
            o[i][3] = fmaf(pv[i].z, vv[2].w, o[i][3]);
            o[i][0] = fmaf(pv[i].w, vv[3].x, o[i][0]);
            o[i][1] = fmaf(pv[i].w, vv[3].y, o[i][1]);
            o[i][2] = fmaf(pv[i].w, vv[3].z, o[i][2]);
            o[i][3] = fmaf(pv[i].w, vv[3].w, o[i][3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = load4f(Pw + poff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            float4 vv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) vv[j] = load4f(Vl + (4 * c + j) * DHP + 32 * g);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {  // key 4 c + j
                const float p = j == 0 ? pv[i].x : j == 1 ? pv[i].y : j == 2 ? pv[i].z : pv[i].w;
                o[i][4 * g + 0] = fmaf(p, vv[j].x, o[i][4 * g + 0]);
                o[i][4 * g + 1] = fmaf(p, vv[j].y, o[i][4 * g + 1]);
                o[i][4 * g + 2] = fmaf(p, vv[j].z, o[i][4 * g + 2]);
                o[i][4 * g + 3] = fmaf(p, vv[j].w, o[i][4 * g + 3]);
              }
            }
          }
        }
      }
      __syncwarp();  // the strip is free for the next 32 keys
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + warp * 16 + qg + 4 * i;
    if (qi >= T) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 32 * g + 4 * kg;
      if (DH < DHP && col >= DH) continue;  // dh 16, 48: the lanes past its columns
      *reinterpret_cast<float4*>(out + b * out_bs + h * out_hs + qi * out_ts + col) =
          make_float4(o[i][4 * g] / z[i], o[i][4 * g + 1] / z[i], o[i][4 * g + 2] / z[i],
                      o[i][4 * g + 3] / z[i]);
    }
  }
}

// The kLowp variant (see above): the same tiles and lanes, three passes
// over the keys, P normalized before P V.
template <typename TIn, int DH>
__global__ void __launch_bounds__(AF_WARPS * 32)
attention_f32_lowp_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                          const TIn* __restrict__ v, const unsigned char* __restrict__ mask,
                          const int* __restrict__ lengths, float* __restrict__ out, int T,
                          long long in_bs, long long in_hs, long long in_ts, long long out_bs,
                          long long out_hs, long long out_ts, float scale) {
  using S = AttF32Smem<TIn, DH>;
  constexpr int DHP = S::DHP;
  constexpr int CHP = DHP / 4;                    // 4-float chunks of a tile row
  constexpr int CHI = DH / 4;                     // of them holding the head's values
  constexpr int CHI_LOG = CHI == 4 ? 2 : CHI == 8 ? 3 : CHI == 16 ? 4 : 5;  // shifts
  constexpr bool kPow2 = (CHI & (CHI - 1)) == 0;  // else (dh 48) divisions
  constexpr int NG = DHP / 32;                    // a lane's groups of 4 output columns
  constexpr int CH = DH * (int)sizeof(TIn) / 16;  // 16-byte chunks of an input row
  extern __shared__ __align__(16) unsigned char af_smem[];
  float* Qs = reinterpret_cast<float*>(af_smem);       // [64][DHP], chunk ^ (row & 7)
  float* Ps = Qs + AF_QTILE * DHP;                      // per warp [16][32], chunk ^ (row & 7)
  float* KVs = Ps + AF_WARPS * 16 * 32;                 // per stage K [64][DHP] with
                                                        // chunk ^ ((row >> 2) & 7), then V
  TIn* raw = reinterpret_cast<TIn*>(KVs + S::kStages * S::kTileFloats);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AF_QTILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = lane >> 3, kg = lane & 7;  // kg is the column group dg in P V
  const long long in0 = b * in_bs + h * in_hs;
  const int len = mask == nullptr ? lengths[b] : 0;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + (size_t)b * T;

  const int n_tiles = (T + AF_KT - 1) / AF_KT;
  // start the copy of step u's key tile (tile u % n_tiles: the keys are
  // streamed once for each of the three passes) into stage u & 1
  auto start_copy = [&](int u) {
    const int t = u % n_tiles;
    for (int idx = tid; idx < 2 * AF_KT * CH; idx += AF_WARPS * 32) {
      const int which = idx / (AF_KT * CH), r = (idx / CH) % AF_KT, c = idx % CH;
      const int key = t * AF_KT + r;
      const TIn* src = (which ? v : k) + in0 + (long long)(key < T ? key : 0) * in_ts +
                       c * (16 / (int)sizeof(TIn));
      uint32_t dst;
      if (S::kRaw) {
        dst = smem_u32(raw) + ((which * AF_KT + r) * CH + c) * 16;
      } else {
        const int pc = which ? c : c ^ ((r >> 2) & 7);
        dst = smem_u32(KVs + (u & 1) * S::kTileFloats) + ((which * AF_KT + r) * CHP + pc) * 16;
      }
      cp_async16(dst, src, key < T ? 16 : 0);
    }
    cp_async_commit();
  };

  start_copy(0);
  for (int idx = tid; idx < AF_QTILE * CHI; idx += AF_WARPS * 32) {
    const int r = kPow2 ? idx >> CHI_LOG : idx / CHI, c = kPow2 ? idx & (CHI - 1) : idx % CHI;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) qv = load4f(q + in0 + (long long)(q0 + r) * in_ts + c * 4);
    *reinterpret_cast<float4*>(Qs + r * DHP + ((c ^ (r & 7)) << 2)) = qv;
  }

  float s[4][4], o[4][4 * NG], m[4], z[4];
  int qoff[4], qsw[4];  // this lane's query rows in Qs: offset and swizzle
  int poff[4];          // and in its warp's strip of Ps (qoff itself at DHP = 32)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    z[i] = 0.f;
    qoff[i] = (qg + 4 * i) * DHP;
    poff[i] = DHP == 32 ? qoff[i] : (qg + 4 * i) * 32;
    qsw[i] = (qg + 4 * i) & 7;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) o[i][j] = 0.f;
  }
  const float* Qw = Qs + warp * 16 * DHP;
  float* Pw = Ps + warp * 16 * 32;
  const bool active = q0 + warp * 16 < T;

  const float neg = bf16r(-30000.f), scale_r = bf16r(scale);
  const int n_steps = 3 * n_tiles;
  for (int u = 0; u < n_steps; ++u) {
    const int t = u % n_tiles, pass = u / n_tiles;  // 0 max, 1 sum, 2 P V
    cp_async_wait_all();
    __syncthreads();  // tile u has landed; every warp is done with tile u-1
    const float* Kt = KVs + (S::kRaw ? 0 : (u & 1) * S::kTileFloats);
    if (S::kRaw) {
      float* dstt = KVs;
      for (int idx = tid; idx < 2 * AF_KT * CHI; idx += AF_WARPS * 32) {
        const int which = idx / (AF_KT * CHI),
                  r = (kPow2 ? idx >> CHI_LOG : idx / CHI) % AF_KT,
                  c = kPow2 ? idx & (CHI - 1) : idx % CHI;
        const int pc = which ? c : c ^ ((r >> 2) & 7);
        *reinterpret_cast<float4*>(dstt + (which * AF_KT + r) * DHP + (pc << 2)) =
            load4f(raw + (which * AF_KT + r) * DH + c * 4);
      }
      __syncthreads();
    }
    if (u + 1 < n_steps) start_copy(u + 1);
    if (!active) continue;
    if (t == 0 && pass > 0) {  // a pass is over: its row values, over the 8 lanes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pass == 1) {
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 4));
        } else {
          z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
          z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
          z[i] += __shfl_xor_sync(0xffffffffu, z[i], 4);
          z[i] = bf16r(z[i]);
        }
      }
    }
    const float* Vt = Kt + AF_KT * DHP;

    for (int ks = 0; ks < AF_KT; ks += 32) {
      const int key0 = t * AF_KT + ks + 4 * kg;  // this lane's four keys
      if (t * AF_KT + ks >= T) break;
      // scores: 4 queries x 4 keys, over the dh / 4 chunks of d
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* Kl = Kt + (ks + 4 * kg) * DHP;
#pragma unroll
      for (int c = 0; c < CHI; ++c) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = load4f(Qw + qoff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = load4f(Kl + j * DHP + ((c ^ kg) << 2));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
      }
      // scale, mask; keys past T drop out of the sums altogether
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + j;
        const bool in = key < T;
        const bool ok = in && (mrow != nullptr ? mrow[key] != 0 : key < len);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = ok ? bf16r(bf16r(s[i][j]) * scale_r) : (in ? neg : -INFINITY);
      }
      if (pass < 2) {  // the row max, then the sum of the bf16 exponentials
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (pass == 0) m[i] = fmaxf(m[i], s[i][j]);
            else if (s[i][j] != -INFINITY) z[i] += bf16r(expf(bf16r(s[i][j] - m[i])));
          }
        continue;
      }
      // p = bf16(e / z) into the strip
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = s[i][j] == -INFINITY ? 0.f
                                         : bf16r(bf16r(expf(bf16r(s[i][j] - m[i]))) / z[i]);
        *reinterpret_cast<float4*>(Pw + poff[i] + ((kg ^ qsw[i]) << 2)) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncwarp();
      // P V: 4 queries x 4 NG columns, over the 8 chunks of 4 keys
      const float* Vl = Vt + ks * DHP + 4 * kg;
      if constexpr (NG == 1) {  // dh 16 and 32: one group of 4 columns a lane
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float4 pv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = load4f(Pw + qoff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = load4f(Vl + (4 * c + j) * DHP);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][0] = fmaf(pv[i].x, vv[0].x, o[i][0]);
            o[i][1] = fmaf(pv[i].x, vv[0].y, o[i][1]);
            o[i][2] = fmaf(pv[i].x, vv[0].z, o[i][2]);
            o[i][3] = fmaf(pv[i].x, vv[0].w, o[i][3]);
            o[i][0] = fmaf(pv[i].y, vv[1].x, o[i][0]);
            o[i][1] = fmaf(pv[i].y, vv[1].y, o[i][1]);
            o[i][2] = fmaf(pv[i].y, vv[1].z, o[i][2]);
            o[i][3] = fmaf(pv[i].y, vv[1].w, o[i][3]);
            o[i][0] = fmaf(pv[i].z, vv[2].x, o[i][0]);
            o[i][1] = fmaf(pv[i].z, vv[2].y, o[i][1]);
            o[i][2] = fmaf(pv[i].z, vv[2].z, o[i][2]);
            o[i][3] = fmaf(pv[i].z, vv[2].w, o[i][3]);
            o[i][0] = fmaf(pv[i].w, vv[3].x, o[i][0]);
            o[i][1] = fmaf(pv[i].w, vv[3].y, o[i][1]);
            o[i][2] = fmaf(pv[i].w, vv[3].z, o[i][2]);
            o[i][3] = fmaf(pv[i].w, vv[3].w, o[i][3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = load4f(Pw + poff[i] + ((c ^ qsw[i]) << 2));
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            float4 vv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) vv[j] = load4f(Vl + (4 * c + j) * DHP + 32 * g);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {  // key 4 c + j
                const float p = j == 0 ? pv[i].x : j == 1 ? pv[i].y : j == 2 ? pv[i].z : pv[i].w;
                o[i][4 * g + 0] = fmaf(p, vv[j].x, o[i][4 * g + 0]);
                o[i][4 * g + 1] = fmaf(p, vv[j].y, o[i][4 * g + 1]);
                o[i][4 * g + 2] = fmaf(p, vv[j].z, o[i][4 * g + 2]);
                o[i][4 * g + 3] = fmaf(p, vv[j].w, o[i][4 * g + 3]);
              }
            }
          }
        }
      }
      __syncwarp();  // the strip is free for the next 32 keys
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + warp * 16 + qg + 4 * i;
    if (qi >= T) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 32 * g + 4 * kg;
      if (DH < DHP && col >= DH) continue;  // dh 16, 48: the lanes past its columns
      // P is normalized already
      *reinterpret_cast<float4*>(out + b * out_bs + h * out_hs + qi * out_ts + col) =
          make_float4(o[i][4 * g], o[i][4 * g + 1], o[i][4 * g + 2], o[i][4 * g + 3]);
    }
  }
}

template <typename TIn, int DH, bool kLowp>
static cudaError_t attention_f32_dh(const TIn* q, const TIn* k, const TIn* v,
                                    const unsigned char* mask, const int* lengths, float* out,
                                    int B, int H, int T, long long in_bs, long long in_hs,
                                    long long in_ts, long long out_bs, long long out_hs,
                                    long long out_ts, float scale, cudaStream_t s) {
  constexpr int bytes = AttF32Smem<TIn, DH>::kBytes;
  static_assert(bytes <= 232448, "the shared memory a block can opt in to");
  auto launch = [&](auto kernel) -> cudaError_t {
    if (bytes > 48 * 1024)  // above the default: opt in (dh = 48, 64 and 128)
      EET_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    const dim3 grid((T + AF_QTILE - 1) / AF_QTILE, H, B);
    kernel<<<grid, AF_WARPS * 32, bytes, s>>>(q, k, v, mask, lengths, out, T, in_bs, in_hs,
                                               in_ts, out_bs, out_hs, out_ts, scale);
    return cudaGetLastError();
  };
  if constexpr (kLowp) return launch(attention_f32_lowp_kernel<TIn, DH>);
  else return launch(attention_f32_kernel<TIn, DH>);
}

// dh = 16, 32, 48, 64 or 128 (anything else: cudaErrorInvalidValue); any T > 0.
template <typename TIn, bool kLowp = false>
static cudaError_t attention_f32(const TIn* q, const TIn* k, const TIn* v,
                                 const unsigned char* mask, const int* lengths, float* out,
                                 int B, int H, int T, int DH, long long in_bs, long long in_hs,
                                 long long in_ts, long long out_bs, long long out_hs,
                                 long long out_ts, float scale, cudaStream_t s) {
#define EET_ATT_F32_CASE(dh)                                                                  \
  case dh:                                                                                    \
    return attention_f32_dh<TIn, dh, kLowp>(q, k, v, mask, lengths, out, B, H, T, in_bs, in_hs, \
                                            in_ts, out_bs, out_hs, out_ts, scale, s);
  switch (DH) {
    EET_ATT_F32_CASE(16) EET_ATT_F32_CASE(32) EET_ATT_F32_CASE(48) EET_ATT_F32_CASE(64)
    EET_ATT_F32_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef EET_ATT_F32_CASE
}
