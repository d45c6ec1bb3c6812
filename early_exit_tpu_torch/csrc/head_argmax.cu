// Per-exit vocabulary head + frame argmax (the greedy-decode epilogue),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel early_exit_tpu/ops/pallas/head_argmax.py
// (head_argmax -> _kernel): per exit, a bf16 product with float32
// accumulation, rounded to bf16, plus the bf16 bias, then each row's
// argmax with the lowest index winning ties. Only the (E, rows) int32 ids
// are written; the logits never reach device memory.
//
// Bound on an H100 SXM at the main-path shape (E=6, B=128, T'=249, D=V=256):
// 98 MB of hidden states read, 0.0297 ms at 3.35 TB/s, against 25 GFLOP,
// 0.025 ms at 989 TFLOP/s dense bf16: bytes-bound, and each hidden row
// must cross from device memory once. Like the TPU kernel, which keeps all
// E heads resident and reads each hidden row once, the design keeps the
// heads out of the stream:
//   - one persistent block per SM walks a contiguous run of (exit, 64-row
//     tile) work in exit-major order, so a run crosses at most one or two
//     exits: the exit's (D, 256) bf16 head (128 KB at D = 256) is loaded
//     into shared memory by TMA only when the run enters that exit;
//   - one producer warp streams the hidden rows by TMA (128-byte swizzle,
//     completing on mbarriers) into a ring of three 64-row stages (32 KB
//     each), so the next tiles' loads overlap this tile's products;
//   - two consumer warpgroups take alternate tiles and run wgmma
//     m64n256k16 over K = D with A from the stage and the head as the
//     MN-major operand, W as it is stored (D, V) row-major, exactly as
//     gemm_bf16.cuh reads its W;
//   - the epilogue runs in registers with no logits tile: each sum rounded
//     to bf16 and the bf16 bias added with __hadd2 (the rounding of the
//     plain version's bf16 add: gemm_bf16.cuh says why), a thread scans its
//     64 columns of each of its two rows in column order, a quad of lanes
//     reduces by shuffles with the lowest index winning ties, and only the
//     int32 ids are stored.

#include "gemm_bf16.cuh"

constexpr int HA_V = 256, HA_BM = 64, HA_MAX_D = 256, HA_STAGES = 3, HA_CONSUMERS = 2;
constexpr int HA_THREADS = (HA_CONSUMERS + 1) * 128;
constexpr int HA_KB_BYTES = 64 * HA_V * 2;           // 64 k of the head: four [64 k][64 n] boxes
constexpr int HA_W_BYTES = HA_MAX_D / 64 * HA_KB_BYTES;  // the head, 128 KB
constexpr int HA_A_BYTES = HA_BM * HA_MAX_D * 2;     // 64 hidden rows, [64 k] boxes, 32 KB
// mbarriers: head full / empty, and full / empty per stage
constexpr int HA_BARS = 2 + 2 * HA_STAGES;
constexpr int HA_SMEM = HA_W_BYTES + HA_STAGES * HA_A_BYTES + HA_BARS * 8 + 1024;
static_assert(HA_SMEM <= 232448, "the shared memory a block can opt in to");

// Work item i of the sequence is row tile i % tiles of exit i / tiles; a
// block's run is [first, last). Item n of the run lies in stage n %
// HA_STAGES, phase (n / HA_STAGES) & 1, and belongs to consumer n % 2.
// The head's barriers count epochs, one per exit the run enters.
__global__ void __launch_bounds__(HA_THREADS, 1)
head_argmax_kernel(const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ bias,
                   int* __restrict__ out, int E, int rows, int D) {
  extern __shared__ unsigned char ha_smem[];
  const uint32_t w_base = (smem_u32(ha_smem) + 1023u) & ~1023u;
  const uint32_t a_base = w_base + HA_W_BYTES;
  const uint32_t w_full = a_base + HA_STAGES * HA_A_BYTES, w_empty = w_full + 8;
  const uint32_t a_full = w_empty + 8, a_empty = a_full + 8 * HA_STAGES;
  const int group = threadIdx.x >> 7;
  const int tiles = (rows + HA_BM - 1) / HA_BM, work = E * tiles;
  const int first = (int)((long long)blockIdx.x * work / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * work / gridDim.x);
  const int KB = D / 64;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);                  // the producer's expect_tx
    mbar_init(w_empty, HA_CONSUMERS * 4);  // lane 0 of every consumer warp
    for (int s = 0; s < HA_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 4);       // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == HA_CONSUMERS) {
    // ---- producer: lane 0 of the warpgroup's first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 != 0) return;
    int cur = -1, epoch = 0;
    for (int i = first, n = 0; i < last; ++i, ++n) {
      const int e = i / tiles, t = i % tiles, s = n % HA_STAGES;
      mbar_wait(a_empty + 8 * s, ((n / HA_STAGES) & 1) ^ 1);  // passes the first time
      mbar_expect_tx(a_full + 8 * s, HA_BM * D * 2);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(a_base + s * HA_A_BYTES + kb * (HA_BM * 128), &map_h, a_full + 8 * s,
                    64 * kb, e * rows + HA_BM * t);
      if (e != cur) {  // the run enters exit e: its head, once every consumer is done with the last
        if (epoch > 0) mbar_wait(w_empty, (epoch - 1) & 1);
        mbar_expect_tx(w_full, D * HA_V * 2);
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int j = 0; j < HA_V / 64; ++j)
            tma_load_2d(w_base + kb * HA_KB_BYTES + j * WG_BOX_BYTES, &map_w, w_full, 64 * j,
                        e * D + 64 * kb);
        cur = e;
        ++epoch;
      }
    }
  } else {
    // ---- consumers: rows [16 warp, 16 warp + 16) of each of their tiles
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int fr = lane >> 2, fc = 2 * (lane & 3);
    float d[128];
    int cur = -1, epoch = 0;
    for (int i = first, n = 0; i < last; ++i, ++n) {
      const int e = i / tiles, t = i % tiles, s = n % HA_STAGES;
      if (e != cur) {
        if (epoch > 0 && lane == 0) mbar_arrive(w_empty);  // done with the last exit's head
        mbar_wait(w_full, epoch & 1);
        cur = e;
        ++epoch;
      }
      if ((n & 1) != group) continue;
      mbar_wait(a_full + 8 * s, (n / HA_STAGES) & 1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int kb = 0; kb < KB; ++kb) {
        const uint64_t da = desc_k_major(a_base + s * HA_A_BYTES + kb * (HA_BM * 128));
        const uint64_t db = desc_mn_major(w_base + kb * HA_KB_BYTES);
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          wgmma_m64n256k16(d, da + 2 * k16, db + (16 * 128 / 16) * k16, kb | k16);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(a_empty + 8 * s);

      // d[4j + 2h + c]: row fr + 8h of the warp's 16, column 8j + fc + c
      const __nv_bfloat162* be = reinterpret_cast<const __nv_bfloat162*>(bias + (size_t)e * HA_V);
      float best[2] = {-INFINITY, -INFINITY};
      int idx[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < HA_V / 8; ++j) {
        const __nv_bfloat162 bv = be[(8 * j + fc) >> 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = __bfloat1622float2(
              __hadd2(__floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]), bv));
          if (v.x > best[h]) { best[h] = v.x; idx[h] = 8 * j + fc; }
          if (v.y > best[h]) { best[h] = v.y; idx[h] = 8 * j + fc + 1; }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, idx[h], o);
          if (ob > best[h] || (ob == best[h] && oi < idx[h])) { best[h] = ob; idx[h] = oi; }
        }
        const int row = HA_BM * t + 16 * warp + fr + 8 * h;
        if ((lane & 3) == 0 && row < rows) out[(size_t)e * rows + row] = idx[h];
      }
    }
  }
}

// hidden: (E, rows, D) bf16; W: (E, D, 256) bf16; bias: (E, 256) bf16;
// out: (E, rows) int32. D a multiple of 64, at most 256; the three
// tensors 16-byte aligned.
extern "C" int eet_head_argmax_bf16(const void* hidden, const void* w, const void* bias,
                                    void* out, int E, int rows, int D, void* stream) {
  if (E <= 0 || rows <= 0 || D % 64 || D > HA_MAX_D ||
      ((uintptr_t)hidden | (uintptr_t)w | (uintptr_t)bias) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mh, mw;
  EET_TRY(tensor_map(hidden, 2, D, (uint64_t)E * rows, 64, HA_BM, &mh));
  EET_TRY(tensor_map(w, 2, HA_V, (uint64_t)E * D, 64, 64, &mw));
  static int sms_of[64] = {};
  int sms = 0;
  EET_TRY(sm_count(head_argmax_kernel, HA_SMEM, sms_of, &sms));
  const int work = E * ((rows + HA_BM - 1) / HA_BM);
  head_argmax_kernel<<<work < sms ? work : sms, HA_THREADS, HA_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      mh, mw, static_cast<const bf16*>(bias), static_cast<int*>(out), E, rows, D);
  return (int)cudaGetLastError();
}
