// One post-LN transformer encoder layer, inference path, float32.
//
// Replaces: gesturediffusion_tpu/ops/pallas_encoder.py::_encoder_layer_kernel
// (reached through fused_encoder_layer).  Same function:
//
//   qkv = x @ Wqkv^T + bqkv
//   a   = concat_h softmax(q_h k_h^T / sqrt(dh)) v_h        (f32 softmax)
//   h1  = LN1(x + a @ Wo^T + bo)                            (f32 statistics)
//   out = LN2(h1 + gelu_tanh(h1 @ W1^T + b1) @ W2^T + b2)
//
// Weights arrive in PyTorch's [out, in] layout (nn.Linear / the packed
// nn.MultiheadAttention in_proj), so every product is C = A . W^T with both
// operands contiguous along the reduction axis.
//
// What bounds it on an H100: at the gesture shape [82, 81, 256], ff 1024, a
// call does ~11.0 GFLOP against ~16.7 MB of compulsory traffic (x in, out,
// f32 weights), ~660 FLOP per byte: it is bound by arithmetic.  Without
// tensor cores (this kernel stays in float32, no TF32) the ceiling is the
// 67 TFLOP/s SIMT rate, ~164 us per call.
//
// Design: the TPU kernel kept a whole batch block in VMEM and ran every
// stage in one grid step.  A Hopper SM has 227 KB of shared memory, too
// little for a block's [rows, 1024] feed-forward activations, so the layer
// is a short chain of launches on one stream instead, all from
// common.cuh (shared with the training layer, csrc/encoder_layer_train.cu):
//   1. the SIMT GEMM for the four products: 64 x 128 block tiles, 8 x 8
//      outputs per thread (4 FMAs per float read from shared memory, enough
//      to keep the FMA pipes ahead of the shared-memory port), the next K
//      slice prefetched into registers, and a fused epilogue (bias;
//      optional GELU-tanh; optional residual add);
//   2. attention with one block per (batch, head): K and V of the head in
//      shared memory, a warp per two query rows, scores and softmax in f32.
//      Where a head's K and V do not fit in a block's shared memory (above
//      T = 384 at dh 64), the caller sets `flash` and the stage is the
//      flash kernel of flash_attention.cuh instead (the port of
//      pallas_flash.py::_flash_kernel): key tiles streamed through shared
//      memory, online softmax, reading the packed qkv through its strides;
//   3. a LayerNorm row kernel, one warp per row.
// The intermediates (qkv, attention output, pre-LN sums, ff activations)
// round-trip through device memory (~68 MB written and read back per call
// at the gesture shape, much of it served from the 50 MB L2).  T is taken
// as it is (no tile padding), so no key is padded and none needs masking.
// Tensor cores (wgmma / TMA tiles, which would change the numerics) and a
// fused LN epilogue are later work.

#include "common.cuh"
#include "flash_attention.cuh"

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after queueing the layer on `stream`.
// Scratch buffers (all float32, contiguous): qkv [M, 3D], attn [M, D],
// tmp [M, D], h1 [M, D], ff [M, F], with M = B * T.  `out` [M, D].
// `flash` selects the flash attention stage (dh in {32, 64, 128}).
int gdt_encoder_layer_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, float* qkv, float* attn, float* tmp, float* h1,
    float* ff, float* out, int B, int T, int D, int F, int H, float scale,
    int flash, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const Drop none{nullptr, 0u, 1.0f};
  EpiArgs ep{};
  ep.bias = bqkv;
  gemm_nt<kBias>(x, wqkv, qkv, M, 3 * D, D, ep, s);
  const long long dh = D / H, t = T;
  const AttnStrides packed{t * 3 * D, dh, 3 * D}, rows{t * D, dh, D};
  const cudaError_t e =
      flash ? flash_attention(qkv, qkv + D, qkv + 2 * D, attn, packed, packed, packed, rows,
                              B, H, T, D / H, scale, s)
            : attention(qkv, attn, B, T, D, H, scale, none, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ep = EpiArgs{bo, x, nullptr, nullptr, none, 0};
  gemm_nt<kBiasResid>(attn, wo, tmp, M, D, D, ep, s);
  layernorm(tmp, ln1_w, ln1_b, h1, M, D, s);
  ep = EpiArgs{b1, nullptr, nullptr, nullptr, none, 0};
  gemm_nt<kBiasGelu>(h1, w1, ff, M, F, D, ep, s);
  ep = EpiArgs{b2, h1, nullptr, nullptr, none, 0};
  gemm_nt<kBiasResid>(ff, w2, tmp, M, D, F, ep, s);
  layernorm(tmp, ln2_w, ln2_b, out, M, D, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
