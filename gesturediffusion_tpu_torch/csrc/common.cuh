// Device code shared by the encoder-layer kernels (encoder_layer.cu,
// encoder_layer_train.cu) and the attention kernels (band_attention.cu,
// flash_attention.cuh): warp reductions, GELU in its tanh form, float4
// loads, attention operand strides, the counter-based dropout hash, the
// SIMT GEMM with its fused
// epilogues, the per-(batch, head) attention forward and the LayerNorm row
// kernel.  Each .cu that includes this file is its own library, so
// everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLnThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100 per-block opt-in maximum
constexpr float kLnEps = 1e-5f;
constexpr int kBM = 64;   // GEMM block tile rows
constexpr int kBN = 128;  // GEMM block tile cols
constexpr int kBK = 16;   // GEMM reduction slice per stage
constexpr int kGemmThreads = 128;  // 8 x 16 threads, 8 x 8 outputs each
constexpr int kAttnThreads = 256;

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

// ---- GEMM ---------------------------------------------------------------- //

// The dropout of kBiasResid, kBiasGelu and kDropGeluGrad applies only when
// ep.drop.seed is set; the element's index is its offset in C.
enum Epilogue {
  kPlain,         // C = acc
  kBias,          // C = acc + bias
  kBiasResid,     // C = resid + drop(acc + bias)
  kBiasGelu,      // pre = acc + bias; C = drop(gelu(pre))
  kDropGeluGrad,  // C = drop(acc) * gelu'(aux)
  kResid,         // C = acc + resid
};

struct EpiArgs {
  const float* bias;   // [J]
  const float* resid;  // [I, J]
  const float* aux;    // [I, J] GELU input for kDropGeluGrad
  float* pre;          // [I, J] pre-activation out for kBiasGelu, or null
  Drop drop;
  int site;
};

// C[I, J] = epilogue(sum_k A(i, k) B(k, j)).  A(i, k) is A[i*lda + k] when
// A_KC (contiguous along k) and A[k*lda + i] otherwise; B(k, j) is
// B[j*ldb + k] when B_KC and B[k*ldb + j] otherwise.  The block takes the
// k range [z*k_chunk, (z+1)*k_chunk) of blockIdx.z and writes its slice
// z of C (partial sums when gridDim.z > 1).  Requirements: a contiguous
// axis read as float4 is a multiple of 4 long (K when A_KC or B_KC, I or
// J otherwise), k_chunk % kBK == 0, all pointers and leading dimensions
// 16-byte aligned.  A block computes a 64 x 128 tile; a thread owns rows
// {ty*4 + i, 32 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j} (i, j <
// 4), so each shared-memory float4 it reads feeds 16 FMAs and a warp's
// reads of one row are contiguous.  The next K slice is fetched into
// registers while the current one is multiplied.
template <bool A_KC, bool B_KC, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int I, int J, int K, int lda, int ldb,
            int k_chunk, EpiArgs ep) {
  constexpr int kAVec = kBM * kBK / 4 / kGemmThreads;  // float4s of A per thread
  constexpr int kBVec = kBN * kBK / 4 / kGemmThreads;  // float4s of B per thread
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  C += (size_t)blockIdx.z * I * J;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 ra[kAVec], rb[kBVec];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kAVec; ++s) {
      const int f = tid + s * kGemmThreads;
      if (A_KC) {
        const int r = f >> 2, k = k0 + (f & 3) * 4;
        ra[s] = (row0 + r < I && k < kend) ? ld4(A + (size_t)(row0 + r) * lda + k) : zero;
      } else {
        const int k = k0 + (f >> 4), i = row0 + (f & 15) * 4;
        ra[s] = (k < kend && i < I) ? ld4(A + (size_t)k * lda + i) : zero;
      }
    }
#pragma unroll
    for (int s = 0; s < kBVec; ++s) {
      const int f = tid + s * kGemmThreads;
      if (B_KC) {
        const int r = f >> 2, k = k0 + (f & 3) * 4;
        rb[s] = (col0 + r < J && k < kend) ? ld4(B + (size_t)(col0 + r) * ldb + k) : zero;
      } else {
        const int k = k0 + (f >> 5), j = col0 + (f & 31) * 4;
        rb[s] = (k < kend && j < J) ? ld4(B + (size_t)k * ldb + j) : zero;
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int s = 0; s < kAVec; ++s) {
      const int f = tid + s * kGemmThreads;
      if (A_KC) {
        const int r = f >> 2, k = (f & 3) * 4;
        As[k + 0][r] = ra[s].x; As[k + 1][r] = ra[s].y;
        As[k + 2][r] = ra[s].z; As[k + 3][r] = ra[s].w;
      } else {
        *reinterpret_cast<float4*>(&As[f >> 4][(f & 15) * 4]) = ra[s];
      }
    }
#pragma unroll
    for (int s = 0; s < kBVec; ++s) {
      const int f = tid + s * kGemmThreads;
      if (B_KC) {
        const int r = f >> 2, k = (f & 3) * 4;
        Bs[k + 0][r] = rb[s].x; Bs[k + 1][r] = rb[s].y;
        Bs[k + 2][r] = rb[s].z; Bs[k + 3][r] = rb[s].w;
      } else {
        *reinterpret_cast<float4*>(&Bs[f >> 5][(f & 31) * 4]) = rb[s];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < kend) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(&As[kk][ty * 4]), a1 = ld4(&As[kk][32 + ty * 4]);
      const float4 b0 = ld4(&Bs[kk][tx * 4]), b1 = ld4(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool drop = (EPI == kBiasResid || EPI == kBiasGelu || EPI == kDropGeluGrad) &&
                    ep.drop.seed != nullptr;
  const uint32_t salt = drop ? site_salt(ep.drop.seed, ep.site) : 0u;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = col0 + half * 64 + tx * 4;
    if (c >= J) continue;
    float4 b4 = zero;
    if (EPI == kBias || EPI == kBiasResid || EPI == kBiasGelu) b4 = ld4(ep.bias + c);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
      if (r >= I) continue;
      const size_t off = (size_t)r * J + c;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][half * 4 + j] + bb[j];
      if (EPI == kBiasGelu && ep.pre != nullptr)
        *reinterpret_cast<float4*>(ep.pre + off) = make_float4(v[0], v[1], v[2], v[3]);
      if (EPI == kBiasGelu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = gelu_tanh(v[j]);
      }
      if (drop) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = dropped(v[j], static_cast<uint32_t>(off + j), salt, ep.drop);
      }
      if (EPI == kDropGeluGrad) {
        const float4 h4 = ld4(ep.aux + off);
        v[0] *= gelu_tanh_grad(h4.x); v[1] *= gelu_tanh_grad(h4.y);
        v[2] *= gelu_tanh_grad(h4.z); v[3] *= gelu_tanh_grad(h4.w);
      }
      if (EPI == kBiasResid || EPI == kResid) {
        const float4 r4 = ld4(ep.resid + off);
        v[0] += r4.x; v[1] += r4.y; v[2] += r4.z; v[3] += r4.w;
      }
      *reinterpret_cast<float4*>(C + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool A_KC, bool B_KC, int EPI>
void gemm(const float* A, const float* Bm, float* C, int I, int J, int K,
          int lda, int ldb, int splits, int k_chunk, const EpiArgs& ep,
          cudaStream_t s) {
  dim3 grid((J + kBN - 1) / kBN, (I + kBM - 1) / kBM, splits);
  gemm_kernel<A_KC, B_KC, EPI><<<grid, kGemmThreads, 0, s>>>(
      A, Bm, C, I, J, K, lda, ldb, k_chunk, ep);
}

// C[I, J] = epi(A[I, K] . W[J, K]^T): the forward products, W in PyTorch's
// [out, in] layout
template <int EPI>
void gemm_nt(const float* A, const float* W, float* C, int I, int J, int K,
             const EpiArgs& ep, cudaStream_t s) {
  gemm<true, true, EPI>(A, W, C, I, J, K, K, K, 1, K, ep, s);
}

// ---- attention forward --------------------------------------------------- //

// qkv [B*T, 3D] -> out [B*T, D]: softmax(q k^T * scale) v per head, the
// probabilities dropped at site 0 when drop.seed is set (index ((b*H + h)*T
// + i)*T + j).  One block per (batch, head); dh % 4 == 0.  K rows are
// padded to dh + 4 floats: float4 reads by lanes on consecutive keys then
// fall in distinct banks.  Each warp takes two query rows at a time, so
// every K float4 feeds 8 FMAs and every V float2 feeds 4.  The row sum is
// taken over the undropped exponentials and applied after the product.
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                 int T, int D, int H, float scale, Drop drop) {
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

  const bool has_drop = drop.seed != nullptr;
  const uint32_t salt = has_drop ? site_salt(drop.seed, kSiteAttn) : 0u;
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
    const uint32_t idx0 = (static_cast<uint32_t>(b * H + h) * T + i0) * T;
    float l0 = 0.0f, l1 = 0.0f;
    for (int j = lane; j < tp; j += 32) {
      float e0 = j < T ? expf(p0[j] - m0) : 0.0f;
      float e1 = j < T ? expf(p1[j] - m1) : 0.0f;
      l0 += e0;
      l1 += e1;
      if (has_drop && j < T) {
        e0 = dropped(e0, idx0 + j, salt, drop);
        e1 = dropped(e1, idx0 + T + j, salt, drop);
      }
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

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Queues attention_kernel for [B, T] rows of D = H heads on `s`.
cudaError_t attention(const float* qkv, float* out, int B, int T, int D, int H,
                      float scale, const Drop& drop, cudaStream_t s) {
  const size_t dh = D / H, tp = (T + 3) & ~3, nwarps = kAttnThreads / 32;
  const size_t smem =
      ((size_t)T * (dh + 4) + tp * dh + nwarps * 2 * (dh + tp)) * sizeof(float);
  const cudaError_t e = set_smem(attention_kernel, smem);
  if (e != cudaSuccess) return e;
  attention_kernel<<<B * H, kAttnThreads, smem, s>>>(qkv, out, T, D, H, scale, drop);
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
