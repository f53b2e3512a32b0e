// Device code shared by the encoder-layer kernels (encoder_layer.cu,
// encoder_layer_train.cu) and the attention kernels (band_attention.cu,
// flash_attention.cuh): warp reductions, GELU in its tanh form, float4
// loads, attention operand strides, the counter-based dropout hash, the
// shared-memory opt-in and the LayerNorm row kernel.  Each .cu that
// includes this file is its own library, so everything here has internal
// linkage.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLnThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100 per-block opt-in maximum
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.nn.gelu(approximate=True), the activation of the reference layer
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

// d/dx of gelu_tanh, as pallas_encoder_train.py:_gelu_tanh_grad
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f;
  const float a = 0.044715f;
  const float th = tanhf(c * (x + a * (x * x * x)));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * (x * x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// (batch, head, position) strides of a [B, H, T, dh] operand of the
// attention kernels, in floats; the head width is contiguous
struct AttnStrides {
  long long b, h, t;
};

// ---- dropout: the hash of pallas_encoder_train.py:64-92 ------------------ //

constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;
enum Site { kSiteAttn = 0, kSitePostAttn = 1, kSiteAct = 2, kSiteFF = 3 };

// Dropout parameters; seed == nullptr means no dropout (rate 0, inference).
struct Drop {
  const int* seed;  // one int32 on the device
  uint32_t thresh;  // keep iff hash < thresh
  float inv_keep;   // f32(1 / keep_prob)
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t salt) {
  uint32_t h = idx * kM1 + salt;
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t site_salt(const int* seed, int site) {
  return (static_cast<uint32_t>(*seed) + static_cast<uint32_t>(site) * kGold) | 1u;
}

// drop(z) for the element with global index idx of the site with `salt`
__device__ __forceinline__ float dropped(float z, uint32_t idx, uint32_t salt,
                                         const Drop& d) {
  return hash_u32(idx, salt) < d.thresh ? z * d.inv_keep : 0.0f;
}

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---- LayerNorm ----------------------------------------------------------- //

// Y[M, D] = LayerNorm(X) * w + b, eps 1e-5, one warp per row.
__global__ void __launch_bounds__(kLnThreads)
layernorm_kernel(const float* __restrict__ X, const float* __restrict__ w,
                 const float* __restrict__ bvec, float* __restrict__ Y, int M,
                 int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* x = X + (size_t)row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += x[d];
  const float mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float c = x[d] - mu;
    v = fmaf(c, c, v);
  }
  const float r = rsqrtf(warp_sum(v) / D + kLnEps);
  float* y = Y + (size_t)row * D;
  for (int d = lane; d < D; d += 32) y[d] = (x[d] - mu) * r * w[d] + bvec[d];
}

void layernorm(const float* X, const float* w, const float* b, float* Y,
               int M, int D, cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0,
                     s>>>(X, w, b, Y, M, D);
}

}  // namespace
