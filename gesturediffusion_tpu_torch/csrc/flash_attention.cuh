// Flash self-attention forward, float32, non-causal: the device code of
// csrc/flash_attention.cu (the standalone entry point) and of the encoder
// layer's attention stage beyond what fits in shared memory
// (csrc/encoder_layer.cu, reading its packed qkv buffer).
//
// Replaces: gesturediffusion_tpu/ops/pallas_flash.py::_flash_kernel.  Same
// function, per (batch, head):
//
//   out = softmax(q k^T * scale) v,  scores and softmax in f32,
//
// computed with an online softmax over key tiles: per query row a running
// max m, a normaliser l and an f32 accumulator o; at each tile
//   m' = max(m, rowmax(s)),  p = exp(s - m'),  l = exp(m - m') l + rowsum(p),
//   o = exp(m - m') o + p v,  m = m';
// and o / l is written once at the end.  m starts at the finite -FLT_MAX,
// never -inf.  Keys at positions >= T are masked (p = 0) and their rows
// staged as zeros, so no length needs padding.
//
// Design: the TPU kernel walked the key blocks as the innermost, sequential
// grid axis, carrying m, l and the accumulator in VMEM scratch (m and l as
// lane-broadcast [BQ, 128] tiles), with T padded to the block sizes and D
// to 128 lanes.  None of those layout rules carries over.  Here one block
// owns one (batch * head, tile of kBQ queries) and loops over the key tiles
// itself.  Its 256 threads form a 16 x 16 grid: thread (ty, tx) holds the
// scores of rows ty + 16 i and keys tx + 16 j (i, j < 4) in registers, and
// the accumulator of the same rows over the head-width columns
// [tx * DH / 16, (tx + 1) * DH / 16).  Q and the current K tile sit in
// shared memory in rows padded to DH + 4 floats, so each float4 read of K
// by the 16 threads of a row group falls in distinct banks, and every
// float4 pair feeds 16 FMAs.  A row's max and sum are reduced across its 16
// threads with shuffles; the probabilities go through shared memory to the
// P V product, whose V reads are contiguous across the row group.  Each
// tensor is read through (batch, head, position) strides with the head
// width contiguous: the encoder chain passes its packed [B*T, 3D] qkv and
// its [B*T, D] output, the standalone entry point [B, H, T, D] tensors.
// Tensor cores (wgmma, TMA) would change the numerics and are later work.
#pragma once

#include "common.cuh"

namespace {

constexpr int kFlashThreads = 256;  // 16 x 16
constexpr int kFlashBQ = 64;        // queries per block
constexpr int kFlashBK = 64;        // keys per tile

template <int DH>
constexpr size_t flash_smem_bytes() {
  return ((size_t)2 * kFlashBQ * (DH + 4) + (size_t)kFlashBK * DH +
          (size_t)kFlashBQ * (kFlashBK + 4)) * sizeof(float);
}

// grid (B * H, ceil(T / kFlashBQ)); rows 16-byte aligned
template <int DH>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       AttnStrides sq, AttnStrides sk, AttnStrides sv, AttnStrides so,
                       int H, int T, float scale) {
  constexpr int QS = DH + 4, PS = kFlashBK + 4, CPT = DH / 16, DH4 = DH / 4;
  static_assert(DH % 32 == 0, "the head width must be a multiple of 32");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kFlashBQ][DH + 4]
  float* Ks = Qs + kFlashBQ * QS;    // [kFlashBK][DH + 4]
  float* Vs = Ks + kFlashBK * QS;    // [kFlashBK][DH]
  float* Ps = Vs + kFlashBK * DH;    // [kFlashBQ][kFlashBK + 4]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kFlashBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;

  for (int idx = threadIdx.x; idx < kFlashBQ * DH4; idx += kFlashThreads) {
    const int r = idx / DH4, d = (idx - r * DH4) * 4;
    *reinterpret_cast<float4*>(Qs + r * QS + d) =
        q0 + r < T ? ld4(qb + (q0 + r) * sq.t + d) : zero;
  }

  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < T; k0 += kFlashBK) {
    __syncthreads();  // the previous tile's K, V and P are read
    for (int idx = threadIdx.x; idx < kFlashBK * DH4; idx += kFlashThreads) {
      const int r = idx / DH4, d = (idx - r * DH4) * 4;
      const bool in = k0 + r < T;
      *reinterpret_cast<float4*>(Ks + r * QS + d) =
          in ? ld4(kbase + (k0 + r) * sk.t + d) : zero;
      *reinterpret_cast<float4*>(Vs + r * DH + d) =
          in ? ld4(vbase + (k0 + r) * sv.t + d) : zero;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ld4(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // online softmax: a row's 64 keys are spread over the 16 lanes of
    // its row group (tx), which are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < T ? s[i][j] * scale : -FLT_MAX;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < T ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kFlashBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ld4(Ps + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (kk + u) * DH + tx * CPT;
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; c += 2) {
          const float2 v2 = *reinterpret_cast<const float2*>(vr + c);
          vv[c] = v2.x;
          vv[c + 1] = v2.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = 1.0f / l[i];
    float* orow = ob + row * so.t + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; c += 2)
      *reinterpret_cast<float2*>(orow + c) = make_float2(o[i][c] * inv, o[i][c + 1] * inv);
  }
}

template <int DH>
cudaError_t flash_attention_dh(const float* q, const float* k, const float* v, float* out,
                               const AttnStrides& sq, const AttnStrides& sk,
                               const AttnStrides& sv, const AttnStrides& so, int B, int H,
                               int T, float scale, cudaStream_t s) {
  const size_t smem = flash_smem_bytes<DH>();
  const cudaError_t e = set_smem(flash_attention_kernel<DH>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (T + kFlashBQ - 1) / kFlashBQ);
  flash_attention_kernel<DH><<<grid, kFlashThreads, smem, s>>>(q, k, v, out, sq, sk, sv, so,
                                                               H, T, scale);
  return cudaSuccess;
}

// Queues flash_attention_kernel on `s` for head width dh in {32, 64, 128}.
cudaError_t flash_attention(const float* q, const float* k, const float* v, float* out,
                            const AttnStrides& sq, const AttnStrides& sk,
                            const AttnStrides& sv, const AttnStrides& so, int B, int H,
                            int T, int dh, float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return flash_attention_dh<32>(q, k, v, out, sq, sk, sv, so, B, H, T, scale, s);
    case 64:
      return flash_attention_dh<64>(q, k, v, out, sq, sk, sv, so, B, H, T, scale, s);
    case 128:
      return flash_attention_dh<128>(q, k, v, out, sq, sk, sv, so, B, H, T, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
