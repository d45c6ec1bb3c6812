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
//
// Any vocabulary V >= 1 and any D a multiple of 8. The head is taken in V
// tiles of 256 columns (the wgmma's N); columns past V, in the last tile,
// are zeros or stale shared memory, never read from the bias and never
// candidates. D is taken in boxes of 64 k: where D is not a multiple of
// 64, TMA fills the hidden rows' last box past D with zeros, so the head
// rows that box meets (the next exit's first rows, or zeros past the last
// exit) add exact zeros and the sums are those over D. Three designs, by
// Dk, D rounded up to 64:
//   - resident (V <= 256 and Dk <= 256, the flagship's V = 256 among them):
//     the design above, the one tile of the head in shared memory per
//     exit; boxes of 64 columns wholly past V are not loaded. The kernel is
//     a template over kRagged (V < 256), so V = 256 runs the code it ran
//     before the ragged masks were added;
//   - streaming (V > 256 or Dk > 256, up to Dk 512: the head no longer
//     fits beside the hidden rows, 256 KB at D = 512 for one tile): a work
//     item is 128 rows
//     of one exit, 64 for each consumer warpgroup, in a ring of A stages
//     (two at D <= 256, one of 128 KB at D = 512). The head streams through
//     a ring of three [64 k][256 n] W stages (32 KB each) in the order (V
//     tile, 64 k), both consumers reading every stage; each V tile's sums
//     go through the epilogue into a running (max, lowest index) per row,
//     carried from tile to tile in column order, so a tie across a tile
//     boundary keeps the lower index. Each item reads the head again, from
//     L2 (5 MB at D = 512, V = 5000): at large V the kernel is bound by
//     that L2 traffic and the tensor cores rather than by the hidden rows;
//   - k-tiled (Dk > 512, d 1024: a stage of 128 hidden rows would take 256
//     KB): the streaming design with no A stages. Each stage of a ring of
//     four holds one [128 rows][64 k] box of the item's hidden rows beside
//     the [64 k][256 n] head stage it meets (48 KB), so the rows are read
//     once for each V tile, from L2 after the first.
// V % 8 != 0 is padded to a multiple of 8 by the wrapper (TMA wants 16-byte
// row strides); the padding columns are masked like those past V.

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

// The streaming kernel's geometry: 128-row items, a ring of HS_WSTAGES
// [64 k][256 n] head stages, A stages of 128 rows x D.
constexpr int HS_BM = 128, HS_WSTAGES = 3, HS_MAX_D = 512;
constexpr int HS_SMEM_LIMIT = 232448;
constexpr int HS_W_RING = HS_WSTAGES * HA_KB_BYTES;  // 96 KB
constexpr int HS_BARS = 2 * HS_WSTAGES + 2 * 2;      // W full / empty, A full / empty (<= 2)

// A-stage count of the streaming kernel at width D: two where they fit
__host__ __device__ constexpr int hs_a_stages(int D) {
  return 1024 + HS_W_RING + 2 * HS_BM * D * 2 + HS_BARS * 8 <= HS_SMEM_LIMIT ? 2 : 1;
}
__host__ __device__ constexpr int hs_smem(int D) {
  return 1024 + HS_W_RING + hs_a_stages(D) * HS_BM * D * 2 + HS_BARS * 8;
}
static_assert(hs_smem(HS_MAX_D) <= HS_SMEM_LIMIT, "one A stage fits at the widest D");

// The boxes of 64 columns of V tile vt that hold a column below Vp
__host__ __device__ __forceinline__ int tile_boxes(int Vp, int vt) {
  const int left = Vp - HA_V * vt;
  return left >= HA_V ? HA_V / 64 : (left + 63) / 64;
}

// One V tile's epilogue: d[4j + 2h + c] is row fr + 8h of the warp's 16,
// column col0 + 8j + fc + c; each sum rounded to bf16 plus the bf16 bias,
// then folded into best / idx in column order. kRagged: columns at or past
// V are skipped (the bias row is padded to a multiple of 8, so a pair
// that starts below V is read whole).
template <bool kRagged>
__device__ __forceinline__ void fold_tile(const float (&d)[128], const bf16* __restrict__ be,
                                          int col0, int V, int fc, float (&best)[2],
                                          int (&idx)[2]) {
#pragma unroll
  for (int j = 0; j < HA_V / 8; ++j) {
    const int c = col0 + 8 * j + fc;
    if (kRagged && c >= V) continue;
    const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(be + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = __bfloat1622float2(
          __hadd2(__floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]), bv));
      if (v.x > best[h]) { best[h] = v.x; idx[h] = c; }
      if ((!kRagged || c + 1 < V) && v.y > best[h]) { best[h] = v.y; idx[h] = c + 1; }
    }
  }
}

// The quad's (max, lowest index) of each of a thread's two rows, stored
// by lane 0 of the quad where the row exists. row0: the warp's first row.
__device__ __forceinline__ void store_ids(float (&best)[2], int (&idx)[2], int* out, int e,
                                          int rows, int row0, int lane) {
  const int fr = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[h], o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[h], o);
      if (ob > best[h] || (ob == best[h] && oi < idx[h])) { best[h] = ob; idx[h] = oi; }
    }
    const int row = row0 + fr + 8 * h;
    if ((lane & 3) == 0 && row < rows) out[(size_t)e * rows + row] = idx[h];
  }
}

// Work item i of the sequence is row tile i % tiles of exit i / tiles; a
// block's run is [first, last). Item n of the run lies in stage n %
// HA_STAGES, phase (n / HA_STAGES) & 1, and belongs to consumer n % 2.
// The head's barriers count epochs, one per exit the run enters.
template <bool kRagged>
__global__ void __launch_bounds__(HA_THREADS, 1)
head_argmax_kernel(const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ bias,
                   int* __restrict__ out, int E, int rows, int D, int V, int Vp) {
  extern __shared__ unsigned char ha_smem[];
  const uint32_t w_base = (smem_u32(ha_smem) + 1023u) & ~1023u;
  const uint32_t a_base = w_base + HA_W_BYTES;
  const uint32_t w_full = a_base + HA_STAGES * HA_A_BYTES, w_empty = w_full + 8;
  const uint32_t a_full = w_empty + 8, a_empty = a_full + 8 * HA_STAGES;
  const int group = threadIdx.x >> 7;
  const int tiles = (rows + HA_BM - 1) / HA_BM, work = E * tiles;
  const int first = (int)((long long)blockIdx.x * work / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * work / gridDim.x);
  const int KB = (D + 63) / 64;
  const int nbox = kRagged ? tile_boxes(Vp, 0) : HA_V / 64;

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
      mbar_expect_tx(a_full + 8 * s, HA_BM * 64 * KB * 2);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(a_base + s * HA_A_BYTES + kb * (HA_BM * 128), &map_h, a_full + 8 * s,
                    64 * kb, e * rows + HA_BM * t);
      if (e != cur) {  // the run enters exit e: its head, once every consumer is done with the last
        if (epoch > 0) mbar_wait(w_empty, (epoch - 1) & 1);
        mbar_expect_tx(w_full, 64 * KB * 64 * nbox * 2);
        for (int kb = 0; kb < KB; ++kb)
          for (int j = 0; j < nbox; ++j)
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
    const int fc = 2 * (lane & 3);
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

      float best[2] = {-INFINITY, -INFINITY};
      int idx[2] = {0, 0};
      fold_tile<kRagged>(d, bias + (size_t)e * Vp, 0, V, fc, best, idx);
      store_ids(best, idx, out, e, rows, HA_BM * t + 16 * warp, lane);
    }
  }
}

// The streaming design. Item n of a block's run lies in A stage n % AS;
// the run's W stages are numbered w = 0, 1, ... over its items' (V tile,
// 64 k) pairs, in slot w % HS_WSTAGES, phase (w / HS_WSTAGES) & 1.
__global__ void __launch_bounds__(HA_THREADS, 1)
head_argmax_stream_kernel(const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_w,
                          const bf16* __restrict__ bias, int* __restrict__ out, int E, int rows,
                          int D, int V, int Vp) {
  extern __shared__ unsigned char ha_smem[];
  const int KB = (D + 63) / 64, NV = (Vp + HA_V - 1) / HA_V;
  const int AS = hs_a_stages(64 * KB);
  const int a_bytes = HS_BM * 64 * KB * 2;
  const uint32_t w_base = (smem_u32(ha_smem) + 1023u) & ~1023u;
  const uint32_t a_base = w_base + HS_W_RING;
  const uint32_t w_full = a_base + AS * a_bytes, w_empty = w_full + 8 * HS_WSTAGES;
  const uint32_t a_full = w_empty + 8 * HS_WSTAGES, a_empty = a_full + 8 * 2;
  const int group = threadIdx.x >> 7;
  const int tiles = (rows + HS_BM - 1) / HS_BM, work = E * tiles;
  const int first = (int)((long long)blockIdx.x * work / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * work / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < HS_WSTAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(w_empty + 8 * s, HA_CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < AS; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, HA_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == HA_CONSUMERS) {
    // ---- producer: lane 0 of the warpgroup's first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 != 0) return;
    int w = 0;
    for (int i = first, n = 0; i < last; ++i, ++n) {
      const int e = i / tiles, t = i % tiles, s = n % AS;
      mbar_wait(a_empty + 8 * s, ((n / AS) & 1) ^ 1);  // passes the first time
      mbar_expect_tx(a_full + 8 * s, a_bytes);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(a_base + s * a_bytes + kb * (HS_BM * 128), &map_h, a_full + 8 * s, 64 * kb,
                    e * rows + HS_BM * t);
      for (int vt = 0; vt < NV; ++vt) {
        const int nbox = tile_boxes(Vp, vt);
        for (int kb = 0; kb < KB; ++kb, ++w) {
          const int ws = w % HS_WSTAGES;
          mbar_wait(w_empty + 8 * ws, ((w / HS_WSTAGES) & 1) ^ 1);
          mbar_expect_tx(w_full + 8 * ws, 64 * 64 * 2 * nbox);
          for (int j = 0; j < nbox; ++j)
            tma_load_2d(w_base + ws * HA_KB_BYTES + j * WG_BOX_BYTES, &map_w, w_full + 8 * ws,
                        HA_V * vt + 64 * j, e * D + 64 * kb);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g takes rows [64 g, 64 g + 64) of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int fc = 2 * (lane & 3);
    float d[128];
    int w = 0;
    for (int i = first, n = 0; i < last; ++i, ++n) {
      const int e = i / tiles, t = i % tiles, s = n % AS;
      mbar_wait(a_full + 8 * s, (n / AS) & 1);
      const uint32_t a_rows = a_base + s * a_bytes + group * (64 * 128);
      float best[2] = {-INFINITY, -INFINITY};
      int idx[2] = {0, 0};
      for (int vt = 0; vt < NV; ++vt) {
        for (int kb = 0; kb < KB; ++kb, ++w) {
          const int ws = w % HS_WSTAGES;
          mbar_wait(w_full + 8 * ws, (w / HS_WSTAGES) & 1);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          const uint64_t da = desc_k_major(a_rows + kb * (HS_BM * 128));
          const uint64_t db = desc_mn_major(w_base + ws * HA_KB_BYTES);
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            wgmma_m64n256k16(d, da + 2 * k16, db + (16 * 128 / 16) * k16, kb | k16);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if (lane == 0) mbar_arrive(w_empty + 8 * ws);
        }
        fold_tile<true>(d, bias + (size_t)e * Vp, HA_V * vt, V, fc, best, idx);
      }
      if (lane == 0) mbar_arrive(a_empty + 8 * s);
      store_ids(best, idx, out, e, rows, HS_BM * t + 64 * group + 16 * warp, lane);
    }
  }
}

// The k-tiled design: the run's stages are numbered w = 0, 1, ... over
// its items' (V tile, 64 k) pairs, in slot w % HK_STAGES, phase (w /
// HK_STAGES) & 1; a stage is the A box then the head stage.
constexpr int HK_STAGES = 4;
constexpr int HK_A_BYTES = HS_BM * 128;  // [128 rows][64 k] bf16
constexpr int HK_STAGE_BYTES = HK_A_BYTES + HA_KB_BYTES;
constexpr int HK_SMEM = 1024 + HK_STAGES * HK_STAGE_BYTES + 2 * HK_STAGES * 8;
static_assert(HK_SMEM <= HS_SMEM_LIMIT, "the k-tiled ring fits");

__global__ void __launch_bounds__(HA_THREADS, 1)
head_argmax_ktile_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_w,
                         const bf16* __restrict__ bias, int* __restrict__ out, int E, int rows,
                         int D, int V, int Vp) {
  extern __shared__ unsigned char ha_smem[];
  const uint32_t base = (smem_u32(ha_smem) + 1023u) & ~1023u;
  const uint32_t full = base + HK_STAGES * HK_STAGE_BYTES, empty = full + 8 * HK_STAGES;
  const int group = threadIdx.x >> 7;
  const int tiles = (rows + HS_BM - 1) / HS_BM, work = E * tiles;
  const int first = (int)((long long)blockIdx.x * work / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * work / gridDim.x);
  const int KB = (D + 63) / 64, NV = (Vp + HA_V - 1) / HA_V;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HK_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty + 8 * s, HA_CONSUMERS * 4);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == HA_CONSUMERS) {
    // ---- producer: lane 0 of the warpgroup's first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 != 0) return;
    int w = 0;
    for (int i = first; i < last; ++i) {
      const int e = i / tiles, t = i % tiles;
      for (int vt = 0; vt < NV; ++vt) {
        const int nbox = tile_boxes(Vp, vt);
        for (int kb = 0; kb < KB; ++kb, ++w) {
          const int ws = w % HK_STAGES;
          const uint32_t stage = base + ws * HK_STAGE_BYTES;
          mbar_wait(empty + 8 * ws, ((w / HK_STAGES) & 1) ^ 1);  // passes the first time
          mbar_expect_tx(full + 8 * ws, HK_A_BYTES + 64 * 64 * 2 * nbox);
          tma_load_2d(stage, &map_h, full + 8 * ws, 64 * kb, e * rows + HS_BM * t);
          for (int j = 0; j < nbox; ++j)
            tma_load_2d(stage + HK_A_BYTES + j * WG_BOX_BYTES, &map_w, full + 8 * ws,
                        HA_V * vt + 64 * j, e * D + 64 * kb);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g takes rows [64 g, 64 g + 64) of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int fc = 2 * (lane & 3);
    float d[128];
    int w = 0;
    for (int i = first; i < last; ++i) {
      const int e = i / tiles, t = i % tiles;
      float best[2] = {-INFINITY, -INFINITY};
      int idx[2] = {0, 0};
      for (int vt = 0; vt < NV; ++vt) {
        for (int kb = 0; kb < KB; ++kb, ++w) {
          const int ws = w % HK_STAGES;
          const uint32_t stage = base + ws * HK_STAGE_BYTES;
          mbar_wait(full + 8 * ws, (w / HK_STAGES) & 1);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          const uint64_t da = desc_k_major(stage + group * (64 * 128));
          const uint64_t db = desc_mn_major(stage + HK_A_BYTES);
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            wgmma_m64n256k16(d, da + 2 * k16, db + (16 * 128 / 16) * k16, kb | k16);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if (lane == 0) mbar_arrive(empty + 8 * ws);
        }
        fold_tile<true>(d, bias + (size_t)e * Vp, HA_V * vt, V, fc, best, idx);
      }
      store_ids(best, idx, out, e, rows, HS_BM * t + 64 * group + 16 * warp, lane);
    }
  }
}

template <class Kernel>
static cudaError_t launch_head(Kernel kernel, int smem, int (&sms_of)[64], int work,
                               const CUtensorMap& mh, const CUtensorMap& mw, const bf16* bias,
                               int* out, int E, int rows, int D, int V, int Vp, cudaStream_t s) {
  int sms = 0;
  EET_TRY(sm_count(kernel, smem, sms_of, &sms));
  kernel<<<work < sms ? work : sms, HA_THREADS, smem, s>>>(mh, mw, bias, out, E, rows, D, V,
                                                           Vp);
  return cudaGetLastError();
}

// hidden: (E, rows, D) bf16; W: (E, D, Vp) bf16; bias: (E, Vp) bf16;
// out: (E, rows) int32, the argmax over the first V columns. D a multiple
// of 8; 1 <= V <= Vp, Vp a multiple of 8; the three tensors 16-byte
// aligned.
extern "C" int eet_head_argmax_bf16(const void* hidden, const void* w, const void* bias,
                                    void* out, int E, int rows, int D, int V, int Vp,
                                    void* stream) {
  if (E <= 0 || rows <= 0 || D <= 0 || D % 8 || V <= 0 || V > Vp || Vp % 8 ||
      ((uintptr_t)hidden | (uintptr_t)w | (uintptr_t)bias) % 16)
    return (int)cudaErrorInvalidValue;
  const bf16* b = static_cast<const bf16*>(bias);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Dk = (D + 63) / 64 * 64;
  CUtensorMap mh, mw;
  EET_TRY(tensor_map(w, 2, Vp, (uint64_t)E * D, 64, 64, &mw));
  if (V <= HA_V && Dk <= HA_MAX_D) {  // resident
    EET_TRY(tensor_map(hidden, 2, D, (uint64_t)E * rows, 64, HA_BM, &mh));
    const int work = E * ((rows + HA_BM - 1) / HA_BM);
    if (V == HA_V) {
      static int sms_of[64] = {};
      return (int)launch_head(head_argmax_kernel<false>, HA_SMEM, sms_of, work, mh, mw, b, o,
                              E, rows, D, V, Vp, s);
    }
    static int sms_of[64] = {};
    return (int)launch_head(head_argmax_kernel<true>, HA_SMEM, sms_of, work, mh, mw, b, o, E,
                            rows, D, V, Vp, s);
  }
  EET_TRY(tensor_map(hidden, 2, D, (uint64_t)E * rows, 64, HS_BM, &mh));
  const int work = E * ((rows + HS_BM - 1) / HS_BM);
  if (Dk > HS_MAX_D) {  // k-tiled
    static int sms_of[64] = {};
    return (int)launch_head(head_argmax_ktile_kernel, HK_SMEM, sms_of, work, mh, mw, b, o, E,
                            rows, D, V, Vp, s);
  }
  // the largest opt-in the kernel may ask for, set once; each launch asks
  // for its own D's
  static int sms_of[64] = {};
  int sms = 0;
  EET_TRY(sm_count(head_argmax_stream_kernel, hs_smem(HS_MAX_D), sms_of, &sms));
  head_argmax_stream_kernel<<<work < sms ? work : sms, HA_THREADS, hs_smem(Dk), s>>>(
      mh, mw, b, o, E, rows, D, V, Vp);
  return (int)cudaGetLastError();
}
