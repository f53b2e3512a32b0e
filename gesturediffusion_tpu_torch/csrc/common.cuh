// Device code shared by the encoder-layer kernels (encoder_layer.cu,
// encoder_layer_train.cu) and the attention kernels (band_attention.cu,
// local_block.cu, flash_attention.cuh): a warp sum, GELU in its tanh form,
// float4 loads, attention operand strides, row alignment and the stores of
// a padded head width, the counter-based dropout hash, the shared-memory
// opt-in, the size of a one-wave grid and the LayerNorm row kernel.  Each .cu that includes this file is
// its own library, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace {

constexpr int kLnThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100 per-block opt-in maximum
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// whether every row of an operand starts 16 bytes aligned, so that it can
// be copied a float4 at a time (with dh % 4 == 0)
inline bool aligned16(const float* p, const AttnStrides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.t % 4 == 0;
}

// Stores the output pair (x, y) at columns col, col + 1 (col even) of a row
// of head width dh, dropping columns >= dh (the padding of a padded head
// width): one float2 where `vec` (dh % 4 == 0, aligned rows), else floats.
__device__ __forceinline__ void store_pair(float* p, float x, float y, bool row_ok, int col,
                                           int dh, bool vec) {
  if (!row_ok || col >= dh) return;
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (col + 1 < dh) p[1] = y;
  }
}

// ---- dropout: the hash of pallas_encoder_train.py:64-92 ------------------ //

constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;
enum Site { kSiteAttn = 0, kSitePostAttn = 1, kSiteAct = 2, kSiteFF = 3 };

// Dropout parameters; seed == nullptr means no dropout (rate 0, inference).
struct Drop {
  const int* seed;     // one int32 on the device
  uint32_t thresh;     // keep iff hash < thresh
  float inv_keep;      // f32(1 / keep_prob)
  // The global index of the call's first element when its batch holds rows
  // [r0, r0 + B) of a larger batch (a rank's share): site 0's r0 H T T, and
  // the token rows' r0 T (times the row width at the other sites).  Zero
  // for a whole batch.
  uint32_t attn_base;
  uint32_t row_base;
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

// The widest padded head width of the attention kernels that hold a head's
// rows in registers and shared memory; wider heads take the sliced kernels
// of wide_attention.cuh.
constexpr int kMaxPaddedWidth = 128;

// f(std::integral_constant<int, DHP>{}) for the padded width DHP of head
// width dh, the next multiple of 16 up to 128: the widths the attention
// kernels are instantiated for.  cudaErrorInvalidValue outside 1 .. 128.
template <typename F>
cudaError_t with_padded_width(int dh, F&& f) {
  switch ((dh + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>{});
    case 2: return f(std::integral_constant<int, 32>{});
    case 3: return f(std::integral_constant<int, 48>{});
    case 4: return f(std::integral_constant<int, 64>{});
    case 5: return f(std::integral_constant<int, 80>{});
    case 6: return f(std::integral_constant<int, 96>{});
    case 7: return f(std::integral_constant<int, 112>{});
    case 8: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) the current card holds at once: the grid of a one-wave persistent
// kernel.  The kernel's shared-memory opt-in is raised to the maximum and the
// answer kept per kernel, device and smem, so the occupancy query and the
// attribute calls are paid once, not on every launch.
template <typename Kernel>
cudaError_t wave_blocks(Kernel* kernel, int threads, size_t smem, int& blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache)
    if (c.kernel == key && c.dev == dev && c.smem == smem) {
      blocks = c.blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  blocks = (per_sm > 0 ? per_sm : 1) * sms;
  cache.push_back({key, dev, smem, blocks});
  return cudaSuccess;
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
