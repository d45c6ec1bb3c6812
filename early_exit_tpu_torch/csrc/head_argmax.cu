// Per-exit vocabulary head + frame argmax (the greedy-decode epilogue),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel early_exit_tpu/ops/pallas/head_argmax.py
// (head_argmax -> _kernel). Each block takes 64 rows of one exit's
// hidden states, streams that exit's (D, 256) bf16 head weight through
// shared memory in 32-row chunks, accumulates the logits in float32 on
// the tensor cores (WMMA), rounds them to bf16, adds the bf16 bias, and
// reduces each row to its argmax with the lowest index winning ties.
// Only the (E, rows) int32 ids are written; the logits never reach
// device memory.
//
// Bound on an H100 SXM at the main-path shape (E=6, B=128, T'=249, D=V=256):
// 25 GFLOP (~25 us at 989 TFLOP/s) against 98 MB of hidden states read
// (~29 us at 3.35 TB/s): memory-bound. This simple version loads each
// chunk synchronously (no cp.async/TMA pipeline), so loads and tensor-core
// work do not overlap.

#include "common.cuh"

constexpr int HBM = 64, HBK = 32, HV = 256, HTHREADS = 256;
constexpr int A_LD = HBK + 8;
constexpr int B_LD = HV + 8;
constexpr int L_LD = HV + 8;
constexpr int A_BYTES = HBM * A_LD * 2;           // 5,120
constexpr int B_BYTES = HBK * B_LD * 2;           // 16,896
constexpr int L_BYTES = HBM * L_LD * 2;           // 33,792
constexpr int STAGE_BYTES = (HTHREADS / 32) * 256 * 4;
constexpr int MAIN_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_BYTES = L_BYTES + STAGE_BYTES;
constexpr int SMEM_BYTES = MAIN_BYTES > EPI_BYTES ? MAIN_BYTES : EPI_BYTES;

__global__ void __launch_bounds__(HTHREADS)
head_argmax_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ W,
                   const bf16* __restrict__ bias, int* __restrict__ out, int rows, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  bf16* Ls = reinterpret_cast<bf16*>(smem);
  float* stage = reinterpret_cast<float*>(smem + L_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;  // 16-row slab
  const int wn = warp & 1;   // 128-column half
  const int e = blockIdx.y, m0 = blockIdx.x * HBM;
  const bf16* H = hidden + (size_t)e * rows * D;
  const bf16* We = W + (size_t)e * D * HV;
  const bf16* be = bias + (size_t)e * HV;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < D; k0 += HBK) {
    // A chunk: 64 rows x 4 vectors of 8 bf16, one per thread
    const int r = tid >> 2, cv = tid & 3, gm = m0 + r;
    const uint4 av = gm < rows ? *reinterpret_cast<const uint4*>(H + (size_t)gm * D + k0 + cv * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
    // W chunk: 32 rows x 32 vectors, four per thread
    uint4 bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * HTHREADS;
      bv[i] = *reinterpret_cast<const uint4*>(We + (size_t)(k0 + (idx >> 5)) * HV + (idx & 31) * 8);
    }
    __syncthreads();
    *reinterpret_cast<uint4*>(As + r * A_LD + cv * 8) = av;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * HTHREADS;
      *reinterpret_cast<uint4*>(Bs + (idx >> 5) * B_LD + (idx & 31) * 8) = bv[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + wm * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * B_LD + wn * 128 + j * 16, B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();  // the logits tile reuses the chunk buffers

  float* st = stage + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = wn * 128 + j * 16 + c0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = bf16r(st[r * 16 + c0 + q]) + bf2f(be[col + q]);
      Ls[(wm * 16 + r) * L_LD + col + q] = f2bf(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // argmax: each warp takes 8 rows; each lane scans 8 columns in order
  for (int rr = 0; rr < HBM / (HTHREADS / 32); ++rr) {
    const int row = warp * (HBM / (HTHREADS / 32)) + rr;
    const bf16* lr = Ls + row * L_LD + lane * 8;
    float best = bf2f(lr[0]);
    int idx = lane * 8;
#pragma unroll
    for (int q = 1; q < 8; ++q) {
      const float v = bf2f(lr[q]);
      if (v > best) { best = v; idx = lane * 8 + q; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
    }
    if (lane == 0 && m0 + row < rows) out[(size_t)e * rows + m0 + row] = idx;
  }
}

// hidden: (E, rows, D) bf16; W: (E, D, 256) bf16; bias: (E, 256) bf16;
// out: (E, rows) int32.
extern "C" int eet_head_argmax_bf16(const void* hidden, const void* w, const void* bias,
                                    void* out, int E, int rows, int D, void* stream) {
  const dim3 grid((rows + HBM - 1) / HBM, E);
  head_argmax_kernel<<<grid, HTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<int*>(out), rows, D);
  return (int)cudaGetLastError();
}
