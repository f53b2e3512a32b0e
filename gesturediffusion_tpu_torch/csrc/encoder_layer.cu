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
//      the packed qkv through its strides, at every length for the head
//      widths it is built for (the caller sets `flash`); for other widths
//      the whole-sequence SIMT stage below (one block per (batch, head), K
//      and V in shared memory);
//   3. a LayerNorm row kernel, one warp per row (common.cuh).
// The intermediates (qkv, attention output, pre-LN sums, ff activations)
// round-trip through device memory (~68 MB written and read back per call
// at the gesture shape, much of it served from the 50 MB L2).  T is taken
// as it is (no tile padding): the GEMM masks its M edge and the flash
// kernel its last key tile.

#include "common.cuh"
#include "flash_attention.cuh"
#include "gemm_tf32x3.cuh"

namespace {

constexpr int kAttnThreads = 256;

// The whole-sequence attention stage, for head widths the flash kernel lacks.
//
// qkv [B*T, 3D] -> out [B*T, D]: softmax(q k^T * scale) v per head.  One
// block per (batch, head); dh % 4 == 0.  K rows are padded to dh + 4
// floats: float4 reads by lanes on consecutive keys then fall in distinct
// banks.  Each warp takes two query rows at a time, so every K float4 feeds
// 8 FMAs and every V float2 feeds 4.  The row sum is applied after the
// product.
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                 int T, int D, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dh = D / H, ks = dh + 4, tp = (T + 3) & ~3;
  const int nwarps = blockDim.x >> 5;
  float* Ks = smem;                      // [T][dh + 4]
  float* Vs = Ks + T * ks;               // [tp][dh], rows >= T zero
  float* qbuf = Vs + tp * dh;            // [nwarps][2][dh]
  float* pbuf = qbuf + nwarps * 2 * dh;  // [nwarps][2][tp]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* base = qkv + (size_t)b * T * 3 * D + h * dh;

  const int dh4 = dh / 4;
  for (int idx = threadIdx.x; idx < tp * dh4; idx += blockDim.x) {
    const int j = idx / dh4, d = (idx - j * dh4) * 4;
    if (j < T) {
      const float* row = base + (size_t)j * 3 * D + d;
      *reinterpret_cast<float4*>(Ks + j * ks + d) = ld4(row + D);
      *reinterpret_cast<float4*>(Vs + j * dh + d) = ld4(row + 2 * D);
    } else {
      *reinterpret_cast<float4*>(Vs + j * dh + d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q0 = qbuf + warp * 2 * dh;
  float* q1 = q0 + dh;
  float* p0 = pbuf + warp * 2 * tp;
  float* p1 = p0 + tp;
  for (int i0 = 2 * warp; i0 < T; i0 += 2 * nwarps) {
    const bool two = i0 + 1 < T;
    for (int d = lane; d < dh; d += 32) {
      q0[d] = base[(size_t)i0 * 3 * D + d];
      q1[d] = two ? base[(size_t)(i0 + 1) * 3 * D + d] : 0.0f;
    }
    __syncwarp();
    float m0 = -FLT_MAX, m1 = -FLT_MAX;
    for (int j = lane; j < T; j += 32) {
      const float* kj = Ks + j * ks;
      float s0 = 0.0f, s1 = 0.0f;
      for (int d = 0; d < dh; d += 4) {
        const float4 k4 = ld4(kj + d), a = ld4(q0 + d), c = ld4(q1 + d);
        s0 = fmaf(a.x, k4.x, s0); s0 = fmaf(a.y, k4.y, s0);
        s0 = fmaf(a.z, k4.z, s0); s0 = fmaf(a.w, k4.w, s0);
        s1 = fmaf(c.x, k4.x, s1); s1 = fmaf(c.y, k4.y, s1);
        s1 = fmaf(c.z, k4.z, s1); s1 = fmaf(c.w, k4.w, s1);
      }
      s0 *= scale;
      s1 *= scale;
      p0[j] = s0;
      p1[j] = s1;
      m0 = fmaxf(m0, s0);
      m1 = fmaxf(m1, s1);
    }
    m0 = warp_max(m0);
    m1 = warp_max(m1);
    float l0 = 0.0f, l1 = 0.0f;
    for (int j = lane; j < tp; j += 32) {
      const float e0 = j < T ? expf(p0[j] - m0) : 0.0f;
      const float e1 = j < T ? expf(p1[j] - m1) : 0.0f;
      l0 += e0;
      l1 += e1;
      p0[j] = e0;
      p1[j] = e1;
    }
    const float inv0 = 1.0f / warp_sum(l0), inv1 = 1.0f / warp_sum(l1);
    __syncwarp();
    for (int d = 2 * lane; d < dh; d += 64) {
      float2 o0 = make_float2(0.f, 0.f), o1 = make_float2(0.f, 0.f);
      for (int j = 0; j < tp; j += 4) {
        const float4 pa = ld4(p0 + j), pb = ld4(p1 + j);
        const float wa[4] = {pa.x, pa.y, pa.z, pa.w};
        const float wb[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 v = *reinterpret_cast<const float2*>(Vs + (j + u) * dh + d);
          o0.x = fmaf(wa[u], v.x, o0.x); o0.y = fmaf(wa[u], v.y, o0.y);
          o1.x = fmaf(wb[u], v.x, o1.x); o1.y = fmaf(wb[u], v.y, o1.y);
        }
      }
      float* orow = out + ((size_t)b * T + i0) * D + h * dh + d;
      *reinterpret_cast<float2*>(orow) = make_float2(o0.x * inv0, o0.y * inv0);
      if (two)
        *reinterpret_cast<float2*>(orow + D) = make_float2(o1.x * inv1, o1.y * inv1);
    }
    __syncwarp();
  }
}

// Queues attention_kernel for [B, T] rows of D = H heads on `s`.
cudaError_t attention(const float* qkv, float* out, int B, int T, int D, int H,
                      float scale, cudaStream_t s) {
  const size_t dh = D / H, tp = (T + 3) & ~3, nwarps = kAttnThreads / 32;
  const size_t smem =
      ((size_t)T * (dh + 4) + tp * dh + nwarps * 2 * (dh + tp)) * sizeof(float);
  const cudaError_t e = set_smem(attention_kernel, smem);
  if (e != cudaSuccess) return e;
  attention_kernel<<<B * H, kAttnThreads, smem, s>>>(qkv, out, T, D, H, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after queueing the layer on `stream`.
// Scratch buffers (all float32, contiguous): qkv [M, 3D], attn [M, D],
// tmp [M, D], h1 [M, D], ff [M, F], with M = B * T.  `out` [M, D].
// `flash` selects the flash attention stage (dh in {16, 32, 64, 128}),
// else the whole-sequence stage, whose K and V must fit in shared memory.
int gdt_encoder_layer_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, float* qkv, float* attn, float* tmp, float* h1,
    float* ff, float* out, int B, int T, int D, int F, int H, float scale,
    int flash, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  cudaError_t e = gemm_nt<kBias>(x, wqkv, qkv, M, 3 * D, D, EpiArgs{bqkv}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dh = D / H, t = T;
  const AttnStrides packed{t * 3 * D, dh, 3 * D}, rows{t * D, dh, D};
  e = flash ? flash_attention(qkv, qkv + D, qkv + 2 * D, attn, packed, packed, packed, rows,
                              B, H, T, D / H, scale, Drop{}, nullptr, s)
            : attention(qkv, attn, B, T, D, H, scale, s);
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
