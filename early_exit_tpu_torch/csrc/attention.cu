// Fused multi-head self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel early_exit_tpu/ops/pallas/attention.py
// (fused_attention -> _attn_kernel): q, k, v (B, H, T, dh) in bf16 or
// float32 are upcast to float32; Q K^T * (1/sqrt(dh)) -> key mask to -1e9
// -> softmax -> P V, nothing of the (T, T) scores leaving the chip; the
// output is (B, H, T, dh) float32, for dh = 16, 32, 48, 64, 128 or a
// multiple of 128, and any T (the wrapper pads a head of another width with
// zero columns to the next of them, scale 1/sqrt of the true width). The
// device code (register-tiled float32 products over streamed K and V
// tiles; past 128, in chunks of 128 of the head), its bound and what holds
// it back on this card are in attention_f32.cuh, which the float32
// Conformer block shares.

#include "attention_f32.cuh"

// q, k, v: contiguous (B, H, T, DH), bf16 when in_bf16 else float32;
// mask: (B, T) bytes, nonzero where the key is valid; out: (B, H, T, DH)
// float32.
extern "C" int eet_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int T, int DH, int in_bf16, float scale,
                             void* stream_) {
  if (DH != 16 && DH != 32 && DH != 48 && DH != 64 && DH % 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const long long hs = (long long)T * DH, bs = hs * H;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* o = static_cast<float*>(out);
  if (in_bf16)
    return attention_f32(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), m, nullptr, o, B, H, T, DH, bs, hs, DH,
                         bs, hs, DH, scale, s);
  return attention_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), m, nullptr, o, B, H, T, DH, bs, hs, DH, bs,
                       hs, DH, scale, s);
}
