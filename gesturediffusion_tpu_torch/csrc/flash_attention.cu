// Flash self-attention, float32, non-causal: the standalone entry point of
// the kernel in flash_attention.cuh (which the encoder layer's chain also
// launches, csrc/encoder_layer.cu).
//
// Replaces: gesturediffusion_tpu/ops/pallas_flash.py::_flash_kernel
// (reached through fused_self_attention).  out = softmax(q k^T / sqrt(dh)) v
// per (batch, head), online softmax over key tiles; see the header.
//
// What bounds it on an H100: at the long-chunk encoder shape [82, 4, 1201,
// 64] a call does 4 B H T^2 dh = 121.1 GFLOP against 0.40 GB of q, k, v and
// out: ~300 FLOP per byte, bound by arithmetic.  Its products run in 3xTF32
// on the tensor cores (three TF32 passes keep f32-level error; see the
// header): at 495 / 3 TFLOP/s of f32-equivalent work, ~0.73 ms per call.

#include "flash_attention.cuh"

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out [B, H, T, dh] through their strides (in floats, head width
// contiguous), any head width.  Returns cudaGetLastError() after
// queueing on `stream`.
int gdt_flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                            long long qb, long long qh, long long qt, long long kb,
                            long long kh, long long kt, long long vb, long long vh,
                            long long vt, long long ob, long long oh, long long ot,
                            int B, int H, int T, int dh, float scale, void* stream) {
  const cudaError_t e = flash_attention<false>(
      q, k, v, out, AttnStrides{qb, qh, qt}, AttnStrides{kb, kh, kt},
      AttnStrides{vb, vh, vt}, AttnStrides{ob, oh, ot}, B, H, T, dh, scale, Drop{},
      nullptr, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
