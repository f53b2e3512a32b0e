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
// f32 weights), ~660 FLOP per byte: it is bound by arithmetic.  The products
// run on the tensor cores in 3xTF32 (gemm_tf32x3.cuh): each f32 operand is
// split into a TF32 big and small part and big.big + big.small + small.big
// is accumulated in f32.  Three passes keep f32-level error (~1e-6
// relative) where one TF32 pass (~1e-3) would be another result than the
// f32 reference.  Three passes of the 495 TFLOP/s TF32 rate are 165 TFLOP/s
// of f32-equivalent work: ~0.067 ms per call at 81 rows, ~1.67 ms at 1201.
//
// Design: the TPU kernel kept a whole batch block in VMEM and ran every
// stage in one grid step.  A Hopper SM has 227 KB of shared memory, too
// little for a block's [rows, 1024] feed-forward activations, so the layer
// is a short chain of launches on one stream instead:
//   1. the 3xTF32 GEMM of gemm_tf32x3.cuh for the four products, shared
//      with the training layer (wgmma m64n64k8 TF32 fed by a 3-stage
//      cp.async ring, 128 x 64 block tiles, W split into big and small
//      tiles as it lands, A split in registers), with a fused epilogue:
//      bias; bias and GELU-tanh; bias and residual;
//   2. attention: the flash kernel of flash_attention.cuh (the port of
//      pallas_flash.py::_flash_kernel, 3xTF32 on the tensor cores) reading
//      the packed qkv through its strides, at every length and head width
//      (zero-padded to the next multiple of 16 up to 128, in 128-column
//      slices past it);
//   3. a LayerNorm row kernel, one warp per row (common.cuh).
// The intermediates (qkv, attention output, pre-LN sums, ff activations)
// round-trip through device memory (~68 MB written and read back per call
// at the gesture shape, much of it served from the 50 MB L2).  T is taken
// as it is (no tile padding): the GEMM masks its M edge and the flash
// kernel its last key tile.

#include "common.cuh"
#include "flash_attention.cuh"
#include "gemm_tf32x3.cuh"

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after queueing the layer on `stream`.
// Scratch buffers (all float32, contiguous): qkv [M, 3D], attn [M, D],
// tmp [M, D], h1 [M, D], ff [M, F], with M = B * T.  `out` [M, D].
// Any D, F and head width D / H.
int gdt_encoder_layer_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, float* qkv, float* attn, float* tmp, float* h1,
    float* ff, float* out, int B, int T, int D, int F, int H, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  cudaError_t e = gemm_nt<kBias>(x, wqkv, qkv, M, 3 * D, D, EpiArgs{bqkv}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dh = D / H, t = T;
  const AttnStrides packed{t * 3 * D, dh, 3 * D}, rows{t * D, dh, D};
  e = flash_attention<false>(qkv, qkv + D, qkv + 2 * D, attn, packed, packed, packed, rows, B,
                             H, T, D / H, scale, Drop{}, nullptr, s);
  if (e == cudaSuccess) e = gemm_nt<kBiasResid>(attn, wo, tmp, M, D, D, EpiArgs{bo, x}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  layernorm(tmp, ln1_w, ln1_b, h1, M, D, s);
  e = gemm_nt<kBiasGelu>(h1, w1, ff, M, F, D, EpiArgs{b1}, s);
  if (e == cudaSuccess) e = gemm_nt<kBiasResid>(ff, w2, tmp, M, D, F, EpiArgs{b2, h1}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  layernorm(tmp, ln2_w, ln2_b, out, M, D, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
