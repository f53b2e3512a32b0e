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
// is a short chain of launches on one stream instead:
//   1. a SIMT GEMM for the four products: 64 x 128 block tiles, 8 x 8
//      outputs per thread (4 FMAs per float read from shared memory, enough
//      to keep the FMA pipes ahead of the shared-memory port), the next K
//      slice prefetched into registers, and a fused epilogue (bias;
//      optional GELU-tanh; optional residual add);
//   2. attention with one block per (batch, head): K and V of the head in
//      shared memory, a warp per two query rows, scores and softmax in f32;
//   3. a LayerNorm row kernel, one warp per row.
// The intermediates (qkv, attention output, pre-LN sums, ff activations)
// round-trip through device memory (~68 MB written and read back per call
// at the gesture shape, much of it served from the 50 MB L2).  T is taken
// as it is (no tile padding), so no key is padded and none needs masking.
// Tensor cores (wgmma / TMA tiles, which would change the numerics) and a
// fused LN epilogue are later work.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kBM = 64;   // block tile rows
constexpr int kBN = 128;  // block tile cols
constexpr int kBK = 16;   // reduction slice per stage
constexpr int kGemmThreads = 128;  // 8 x 16 threads, 8 x 8 outputs each
constexpr int kAttnThreads = 256;
constexpr int kLnThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100 per-block opt-in maximum

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// C[M, N] = epilogue(A[M, K] . W[N, K]^T + bias[N]); K % 4 == 0, N % 4 == 0,
// all pointers 16-byte aligned.  A block computes a 64 x 128 tile; a thread
// owns rows {ty*4 + i, 32 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}
// (i, j < 4), so each shared-memory float4 it reads feeds 16 FMAs and a
// warp's reads of one row are contiguous.  The next K slice is fetched into
// registers while the current one is multiplied.
template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(const float* __restrict__ A, const float* __restrict__ W,
               const float* __restrict__ bias, const float* __restrict__ R,
               float* __restrict__ C, int M, int N, int K) {
  constexpr int kAVec = kBM * kBK / 4 / kGemmThreads;  // float4s of A per thread
  constexpr int kWVec = kBN * kBK / 4 / kGemmThreads;  // float4s of W per thread
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float4 ra[kAVec], rw[kWVec];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kAVec; ++s) {
      const int f = tid + s * kGemmThreads, r = f >> 2, k = k0 + (f & 3) * 4;
      ra[s] = (row0 + r < M && k < K) ? ld4(A + (size_t)(row0 + r) * K + k)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int s = 0; s < kWVec; ++s) {
      const int f = tid + s * kGemmThreads, r = f >> 2, k = k0 + (f & 3) * 4;
      rw[s] = (col0 + r < N && k < K) ? ld4(W + (size_t)(col0 + r) * K + k)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kAVec; ++s) {
      const int f = tid + s * kGemmThreads, r = f >> 2, k = (f & 3) * 4;
      As[k + 0][r] = ra[s].x; As[k + 1][r] = ra[s].y;
      As[k + 2][r] = ra[s].z; As[k + 3][r] = ra[s].w;
    }
#pragma unroll
    for (int s = 0; s < kWVec; ++s) {
      const int f = tid + s * kGemmThreads, r = f >> 2, k = (f & 3) * 4;
      Ws[k + 0][r] = rw[s].x; Ws[k + 1][r] = rw[s].y;
      Ws[k + 2][r] = rw[s].z; Ws[k + 3][r] = rw[s].w;
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(&As[kk][ty * 4]), a1 = ld4(&As[kk][32 + ty * 4]);
      const float4 b0 = ld4(&Ws[kk][tx * 4]), b1 = ld4(&Ws[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = col0 + half * 64 + tx * 4;
    if (c >= N) continue;
    const float4 b4 = ld4(bias + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
      if (r >= M) continue;
      float v[4] = {acc[i][half * 4 + 0] + b4.x, acc[i][half * 4 + 1] + b4.y,
                    acc[i][half * 4 + 2] + b4.z, acc[i][half * 4 + 3] + b4.w};
      if (EPI == kBiasGelu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = gelu_tanh(v[j]);
      }
      if (EPI == kBiasResidual) {
        const float4 r4 = ld4(R + (size_t)r * N + c);
        v[0] += r4.x; v[1] += r4.y; v[2] += r4.z; v[3] += r4.w;
      }
      *reinterpret_cast<float4*>(C + (size_t)r * N + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// qkv [B*T, 3D] -> out [B*T, D]; one block per (batch, head); dh % 4 == 0.
// K rows are padded to dh + 4 floats: float4 reads by lanes on consecutive
// keys then fall in distinct banks.  Each warp takes two query rows at a
// time, so every K float4 feeds 8 FMAs and every V float2 feeds 4.
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
      p0[j] = e0;
      p1[j] = e1;
      l0 += e0;
      l1 += e1;
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
  const float r = rsqrtf(warp_sum(v) / D + 1e-5f);
  float* y = Y + (size_t)row * D;
  for (int d = lane; d < D; d += 32) y[d] = (x[d] - mu) * r * w[d] + bvec[d];
}

template <int EPI>
void gemm(const float* A, const float* W, const float* bias, const float* R,
          float* C, int M, int N, int K, cudaStream_t s) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_nt_kernel<EPI><<<grid, kGemmThreads, 0, s>>>(A, W, bias, R, C, M, N, K);
}

void layernorm(const float* X, const float* w, const float* b, float* Y,
               int M, int D, cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0,
                     s>>>(X, w, b, Y, M, D);
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after queueing the layer on `stream`.
// Scratch buffers (all float32, contiguous): qkv [M, 3D], attn [M, D],
// tmp [M, D], h1 [M, D], ff [M, F], with M = B * T.  `out` [M, D].
int gdt_encoder_layer_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, float* qkv, float* attn, float* tmp, float* h1,
    float* ff, float* out, int B, int T, int D, int F, int H, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int dh = D / H;
  const int nwarps = kAttnThreads / 32;
  const size_t tp = (T + 3) & ~3;
  const size_t smem = ((size_t)T * (dh + 4) + tp * dh +
                       (size_t)nwarps * 2 * (dh + tp)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gemm<kBias>(x, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s);
  attention_kernel<<<B * H, kAttnThreads, smem, s>>>(qkv, attn, T, D, H, scale);
  gemm<kBiasResidual>(attn, wo, bo, x, tmp, M, D, D, s);
  layernorm(tmp, ln1_w, ln1_b, h1, M, D, s);
  gemm<kBiasGelu>(h1, w1, b1, nullptr, ff, M, F, D, s);
  gemm<kBiasResidual>(ff, w2, b2, h1, tmp, M, D, F, s);
  layernorm(tmp, ln2_w, ln2_b, out, M, D, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
