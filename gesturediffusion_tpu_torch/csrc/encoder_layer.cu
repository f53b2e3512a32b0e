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
//   1. the four products on gemm_ws.cuh's warp-specialized 3xTF32 GEMM:
//      the weights split into TF32 big and small parts once per weight and
//      version (ops/fused_encoder.py keeps them, with their tensor maps),
//      loaded by the copy engine into a swizzled mbarrier ring by a
//      producer warp, wgmma on two (one) consumer warpgroups with one group
//      in flight, a persistent walk over the output tiles; epilogues: bias;
//      bias and GELU-tanh; bias and residual; at D <= 256 bias, residual
//      and LayerNorm (LN1 after the out-projection, LN2 after ff2);
//   2. attention: the flash kernel of flash_attention.cuh (the port of
//      pallas_flash.py::_flash_kernel, 3xTF32 on the tensor cores) reading
//      the packed qkv through its strides, at every length and head width
//      (zero-padded to the next multiple of 16 up to 128, wide_attention.cuh
//      past it);
//   3. past D 256, a LayerNorm row kernel after the out-projection and
//      after ff2, one warp per row (common.cuh).
// So the gesture layer (D 256) is five launches: qkv, flash, out + LN1,
// ff1, ff2 + LN2; a layer at D 512 seven.  A product outside gemm_ws.cuh's
// rule (rows not 16-byte aligned: D or F not a multiple of 4; K past 1024)
// runs gemm_tf32x3.cuh's GEMM (wgmma m64n64k8 fed by a cp.async ring, W
// split as it lands), with the LayerNorm launch after it; layer_routes
// gives each product's route (ops/fused_encoder.py:layer_routes mirrors
// it).  The intermediates (qkv, attention output, h1, ff activations)
// round-trip through device memory (~60 MB written and read back per call
// at the gesture shape, much of it served from the 50 MB L2).  T is taken
// as it is (no tile padding): the GEMMs mask their M edge and the flash
// kernel its last key tile.

#include "common.cuh"
#include "flash_attention.cuh"
#include "gemm_tf32x3.cuh"
#include "gemm_ws.cuh"

namespace {

// Each product's route by the layer's D and F: bit i set where product i
// (0 qkv [M, 3D] = x Wqkv^T, 1 the out-projection [M, D], 2 ff1 [M, F], 3 ff2
// [M, D] over K = F) takes gemm_ws.cuh's GEMM; bits 4 and 5 where LN1 and
// LN2 run in the epilogue of products 1 and 3 (D <= kWsLnCols).
int layer_routes(int D, int F) {
  const int n[4] = {3 * D, D, F, D}, k[4] = {D, D, D, F};
  int r = 0;
  for (int i = 0; i < 4; ++i)
    if (ws_takes(n[i], k[i])) r |= 1 << i;
  if (D <= kWsLnCols) r |= (r & 2) << 3 | (r & 8) << 2;
  return r;
}

// One product of the layer on its route: gemm_ws on W's split (its map)
// where bit `i` of `routes` is set, else gemm_nt on W itself; then, where
// the LayerNorm is not in the epilogue (ln_w set and bit `ln_bit` clear),
// C is `tmp` and the row kernel writes `out`.
template <int EPI>
cudaError_t product(int routes, int i, int ln_bit, const float* A, const float* W,
                    const void* map, float* C, float* tmp, int M, int N, int K,
                    const float* bias, const float* resid, const float* ln_w,
                    const float* ln_b, cudaStream_t s) {
  const bool ws = routes >> i & 1;
  if (ws && map == nullptr) return cudaErrorInvalidValue;  // the split's map is missing
  const CUtensorMap* tmw = static_cast<const CUtensorMap*>(map);
  if (ln_w != nullptr && (routes >> ln_bit & 1))
    return gemm_ws<kBiasResidLn>(A, *tmw, WsArgs{C, M, N, K, bias, resid, ln_w, ln_b}, s);
  float* dst = ln_w != nullptr ? tmp : C;
  if (dst == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e = ws ? gemm_ws<EPI>(A, *tmw, WsArgs{dst, M, N, K, bias, resid}, s)
                           : gemm_nt<EPI>(A, W, dst, M, N, K, EpiArgs{bias, resid}, s);
  if (e == cudaSuccess && ln_w != nullptr) layernorm(tmp, ln_w, ln_b, C, M, N, s);
  return e;
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gdt_encoder_layer_routes(int D, int F) { return layer_routes(D, F); }

// bytes of a tensor map (the host buffer weight maps are written into)
int gdt_tensor_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// Queues the split of W [N, K] into `split` (float32 [2][N][K rounded up to
// 8], 16-byte aligned) and encodes its tensor map into the host buffer
// `map`.  Returns cudaGetLastError() or the encoder's error.
int gdt_split_weight_f32(const float* w, float* split, int N, int K, void* map, void* stream) {
  const cudaError_t e = split_weight(w, split, N, K, static_cast<CUtensorMap*>(map),
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Returns cudaGetLastError() after queueing the layer on `stream`.
// Scratch buffers (all float32, contiguous): qkv [M, 3D], attn [M, D],
// tmp [M, D] (may be null where both LayerNorms run in an epilogue:
// layer_routes bits 4 and 5), h1 [M, D], ff [M, F], with M = B * T.  `out`
// [M, D].  map_qkv, map_o, map_1, map_2: host buffers holding the tensor maps
// of the weights' splits (gdt_split_weight_f32), needed by the products
// layer_routes sends to gemm_ws (null otherwise).  Any D, F and head width
// D / H.
int gdt_encoder_layer_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, float* qkv, float* attn, float* tmp, float* h1,
    float* ff, float* out, int B, int T, int D, int F, int H, float scale,
    const void* map_qkv, const void* map_o, const void* map_1, const void* map_2,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T, routes = layer_routes(D, F);
  cudaError_t e = product<kBias>(routes, 0, 0, x, wqkv, map_qkv, qkv, nullptr, M, 3 * D, D,
                                 bqkv, nullptr, nullptr, nullptr, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dh = D / H, t = T;
  const AttnStrides packed{t * 3 * D, dh, 3 * D}, rows{t * D, dh, D};
  e = flash_attention<false>(qkv, qkv + D, qkv + 2 * D, attn, packed, packed, packed, rows, B,
                             H, T, D / H, scale, Drop{}, nullptr, s);
  if (e == cudaSuccess)
    e = product<kBiasResid>(routes, 1, 4, attn, wo, map_o, h1, tmp, M, D, D, bo, x, ln1_w,
                            ln1_b, s);
  if (e == cudaSuccess)
    e = product<kBiasGelu>(routes, 2, 0, h1, w1, map_1, ff, nullptr, M, F, D, b1, nullptr,
                           nullptr, nullptr, s);
  if (e == cudaSuccess)
    e = product<kBiasResid>(routes, 3, 5, ff, w2, map_2, out, tmp, M, D, F, b2, h1, ln2_w,
                            ln2_b, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// One product alone, for the card tests and tools/kernel_variants.py:
// C [M, N] = epi(A [M, K] . W^T) by gemm_ws on W's split (`map`), epi 0
// bias, 1 bias and GELU-tanh, 2 bias and residual, 3 bias, residual and
// LayerNorm (N <= 256).  cudaErrorInvalidValue outside the rule.
int gdt_gemm_ws_f32(const float* A, const void* map, float* C, int M, int N, int K, int epi,
                    const float* bias, const float* resid, const float* ln_w, const float* ln_b,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMap& tmw = *static_cast<const CUtensorMap*>(map);
  const WsArgs p{C, M, N, K, bias, resid, ln_w, ln_b};
  const cudaError_t e = epi == 0   ? gemm_ws<kBias>(A, tmw, p, s)
                        : epi == 1 ? gemm_ws<kBiasGelu>(A, tmw, p, s)
                        : epi == 2 ? gemm_ws<kBiasResid>(A, tmw, p, s)
                        : epi == 3 ? gemm_ws<kBiasResidLn>(A, tmw, p, s)
                                   : cudaErrorInvalidValue;
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The same product by gemm_tf32x3.cuh's gemm_nt on W [N, K] (epi 0-2), the
// parent of gemm_ws
int gdt_gemm_parent_f32(const float* A, const float* W, float* C, int M, int N, int K, int epi,
                        const float* bias, const float* resid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiArgs ep{bias, resid};
  const cudaError_t e = epi == 0   ? gemm_nt<kBias>(A, W, C, M, N, K, ep, s)
                        : epi == 1 ? gemm_nt<kBiasGelu>(A, W, C, M, N, K, ep, s)
                        : epi == 2 ? gemm_nt<kBiasResid>(A, W, C, M, N, K, ep, s)
                                   : cudaErrorInvalidValue;
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
