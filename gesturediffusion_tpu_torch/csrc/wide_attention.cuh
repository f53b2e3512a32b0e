// Attention at head widths past 128: the forward of the flash kernel
// (flash_attention.cuh) and of the band kernels (band_attention.cu,
// local_block.cu) for heads the narrow kernels' registers and shared memory
// do not hold, and the tile products the training layer's wide attention
// backward shares (encoder_layer_train.cu).
//
// Replaces, for those widths: gesturediffusion_tpu/ops/pallas_flash.py::
// _flash_kernel (which pads any head width to a multiple of 128,
// pallas_flash.py:93-109), pallas_attention.py::_band_kernel and the band
// stage of pallas_local_block.py::_local_block_kernel.  Same functions, f32
// scores and softmax, the same masks (keys >= T, the causal look-back-one
// band) and, for the flash forward in training, the same site-0 dropout and
// log-sum-exp.
//
// Design: the narrow kernels keep a query tile's q fragments and its whole
// output row in registers and stage whole key rows in shared memory, which
// stops at a padded width of 128.  Here the head width is walked in slices:
//   * the scores S = q k^T of a warp's 16 rows against 8 keys accumulate
//     over the whole width in k8 steps, each fragment read from device
//     memory (L1 and L2 serve the re-reads of a block's 4 warps), so no
//     width is too wide;
//   * the output is cut into column slices of kWideSlice (128), one slice a
//     block (grid z): each block recomputes the scores and the softmax of
//     its rows and accumulates only its slice of p v in registers.
// Every product is mma.sync.m16n8k8 TF32 in three passes (mma_tf32x3.cuh),
// with the k permutation of flash_attention.cuh, so P stays in registers.
// The price of the simplicity is work and traffic: the scores are computed
// once per output slice (ceil(dh / 128) times), and every fragment comes
// from L1 or L2; no shipped configuration has heads wider than 128, and
// these kernels are held for correctness, not speed (PERF.md gives their
// times).  Rows past T and columns past dh read as zeros; only real rows
// and columns are stored.
#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kWideSlice = 128;    // output columns a block
constexpr int kWideNO = kWideSlice / 8;  // n8 tiles of a slice
constexpr int kWideThreads = 128;  // 4 warps of 16 rows
constexpr int kWideRows = 64;      // rows a block
constexpr int kWideKeys = 32;      // keys a step of the flash forward and backward

// x[r][c], x[r][c + 1] (c even) of a [T, dh] operand with row stride ld,
// zero past T and dh: one float2 where `vec` (dh % 4 == 0, rows 16-byte
// aligned), else floats
__device__ __forceinline__ float2 wide_pair(const float* x, long long ld, int r, int c, int T,
                                            int dh, bool vec) {
  if (r >= T || c >= dh) return make_float2(0.f, 0.f);
  const float* p = x + r * ld + c;
  if (vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], c + 1 < dh ? p[1] : 0.f);
}

__device__ __forceinline__ float wide_at(const float* x, long long ld, int r, int c, int T,
                                         int dh) {
  return r < T && c < dh ? x[r * ld + c] : 0.0f;
}

// acc[n] += A[ra .. ra + 15] . B[rb + 8n .. rb + 8n + 7]^T over the whole
// head width: rows of A against rows of B (both [T, dh], row strides lda
// and ldb), the calling warp's 16 x 8NS tile in mma.sync's accumulator
// layout (acc[n][0..1]: row ra + g, columns rb + 8n + 2t, + 1; [2..3]: row
// ra + g + 8)
template <int NS>
__device__ __forceinline__ void wide_scores(float (&acc)[NS][4], const float* a, long long lda,
                                            int ra, const float* b, long long ldb, int rb,
                                            int T, int dh, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int c = 0; c < dh; c += 8) {
    const float2 lo = wide_pair(a, lda, ra + g, c + 2 * t, T, dh, vec);
    const float2 hi = wide_pair(a, lda, ra + g + 8, c + 2 * t, T, dh, vec);
    uint32_t a_big[4], a_small[4];
    split_tf32(lo.x, a_big[0], a_small[0]);
    split_tf32(hi.x, a_big[1], a_small[1]);
    split_tf32(lo.y, a_big[2], a_small[2]);
    split_tf32(hi.y, a_big[3], a_small[3]);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 k2 = wide_pair(b, ldb, rb + 8 * n + g, c + 2 * t, T, dh, vec);
      uint32_t b_big[2], b_small[2];
      split_tf32(k2.x, b_big[0], b_small[0]);
      split_tf32(k2.y, b_big[1], b_small[1]);
      mma_tf32x3(acc[n], a_big, a_small, b_big, b_small);
    }
  }
}

// o[d] += P . X[rb .. rb + 8NS - 1][c0 + 8d .. c0 + 8d + 7]: P the 16 x 8NS
// accumulator of wide_scores (its key slices are the A fragments under the
// k permutation), X [T, dh] with row stride ld
template <int NS>
__device__ __forceinline__ void wide_pv(float (&o)[kWideNO][4], const float (&p)[NS][4],
                                        const float* x, long long ld, int rb, int c0, int T,
                                        int dh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    uint32_t p_big[4], p_small[4];
    split_tf32(p[n][0], p_big[0], p_small[0]);
    split_tf32(p[n][2], p_big[1], p_small[1]);
    split_tf32(p[n][1], p_big[2], p_small[2]);
    split_tf32(p[n][3], p_big[3], p_small[3]);
    const int r = rb + 8 * n + 2 * t;
#pragma unroll
    for (int d = 0; d < kWideNO; ++d) {
      uint32_t b_big[2], b_small[2];
      split_tf32(wide_at(x, ld, r, c0 + 8 * d + g, T, dh), b_big[0], b_small[0]);
      split_tf32(wide_at(x, ld, r + 1, c0 + 8 * d + g, T, dh), b_big[1], b_small[1]);
      mma_tf32x3(o[d], p_big, p_small, b_big, b_small);
    }
  }
}

// One online-softmax step in log2 units over a 16 x 8NS score tile whose
// masked entries hold -FLT_MAX: updates the running max m and sum l of rows
// g (lo) and g + 8 (hi), rescales o and leaves p in s (0 where masked).
template <int NS>
__device__ __forceinline__ void wide_softmax_step(float (&s)[NS][4], float (&o)[kWideNO][4],
                                                  float& m_lo, float& m_hi, float& l_lo,
                                                  float& l_hi) {
  float mx_lo = -FLT_MAX, mx_hi = -FLT_MAX;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked key's p is 0, even where every key of the row in this
      // step is masked (mn = -FLT_MAX)
      const float mn = e < 2 ? mn_lo : mn_hi;
      s[n][e] = s[n][e] == -FLT_MAX ? 0.0f : exp2f(s[n][e] - mn);
      if (e < 2)
        sum_lo += s[n][e];
      else
        sum_hi += s[n][e];
    }
  l_lo = al_lo * l_lo + sum_lo;
  l_hi = al_hi * l_hi + sum_hi;
  m_lo = mn_lo;
  m_hi = mn_hi;
#pragma unroll
  for (int d = 0; d < kWideNO; ++d) {
    o[d][0] *= al_lo;
    o[d][1] *= al_lo;
    o[d][2] *= al_hi;
    o[d][3] *= al_hi;
  }
}

// the row sums of the quad, then o scaled by 1 / l (0 for an empty row)
__device__ __forceinline__ void wide_normalise(float (&o)[kWideNO][4], float& l_lo,
                                               float& l_hi) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;
  const float inv_hi = l_hi > 0.0f ? 1.0f / l_hi : 0.0f;
#pragma unroll
  for (int d = 0; d < kWideNO; ++d) {
    o[d][0] *= inv_lo;
    o[d][1] *= inv_lo;
    o[d][2] *= inv_hi;
    o[d][3] *= inv_hi;
  }
}

// rows r0 = q0 + g and r0 + 8 of o, output slice c0, into a row-strided
// [T, dh] output
__device__ __forceinline__ void wide_store(float* ob, long long ld, int q0, int c0,
                                           const float (&o)[kWideNO][4], int T, int dh,
                                           bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
  for (int d = 0; d < kWideNO; ++d) {
    const int col = c0 + 8 * d + 2 * t;
    store_pair(ob + r0 * ld + col, o[d][0], o[d][1], r0 < T, col, dh, vec);
    store_pair(ob + r1 * ld + col, o[d][2], o[d][3], r1 < T, col, dh, vec);
  }
}

// The flash forward (flash_attention.cuh's function) at any head width:
// grid (ceil(T / 64), B * H, ceil(dh / 128)).  With DROP, p is dropped at
// site 0 after the row sums took it; lse (log2 units) is written by the
// blocks of slice 0.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, AttnStrides sq,
                  AttnStrides sk, AttnStrides sv, AttnStrides so, int H, int T, int dh,
                  bool vec, float scale, Drop drop, float* __restrict__ lse) {
  constexpr int NS = kWideKeys / 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, c0 = blockIdx.z * kWideSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kWideRows + warp * 16;
  if (q0 >= T) return;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  const int r0 = q0 + g;
  // the site-0 index of (row r0, key 2t of the first step); r0 + 8 is 8 T on
  const uint32_t idx0 = drop.attn_base + (static_cast<uint32_t>(bh) * T + r0) * T + 2 * t;

  float o[kWideNO][4];
#pragma unroll
  for (int d = 0; d < kWideNO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;

  for (int j0 = 0; j0 < T; j0 += kWideKeys) {
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    wide_scores<NS>(s, qb, sq.t, q0, kb, sk.t, j0, T, dh, vec);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = j0 + 8 * n + 2 * t + (e & 1) < T ? s[n][e] * scale_log2 : -FLT_MAX;
    wide_softmax_step<NS>(s, o, m_lo, m_hi, l_lo, l_hi);
    if constexpr (DROP) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const uint32_t i_lo = idx0 + j0 + 8 * n, i_hi = i_lo + 8u * T;
        s[n][0] = dropped(s[n][0], i_lo, salt, drop);
        s[n][1] = dropped(s[n][1], i_lo + 1, salt, drop);
        s[n][2] = dropped(s[n][2], i_hi, salt, drop);
        s[n][3] = dropped(s[n][3], i_hi + 1, salt, drop);
      }
    }
    wide_pv<NS>(o, s, vb, sv.t, j0, c0, T, dh);
  }
  const float m_row[2] = {m_lo, m_hi};
  float l_row[2] = {l_lo, l_hi};
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_row[0] += __shfl_xor_sync(0xffffffffu, l_row[0], off);
    l_row[1] += __shfl_xor_sync(0xffffffffu, l_row[1], off);
  }
  if (lse != nullptr && blockIdx.z == 0 && t == 0)
    for (int hf = 0; hf < 2; ++hf)
      if (r0 + 8 * hf < T) lse[(size_t)bh * T + r0 + 8 * hf] = m_row[hf] + log2f(l_row[hf]);
  wide_normalise(o, l_lo, l_hi);
  wide_store(out + b * so.b + h * so.h, so.t, q0, c0, o, T, dh, vec);
}

template <bool DROP>
cudaError_t flash_wide_launch(const float* q, const float* k, const float* v, float* out,
                              const AttnStrides& sq, const AttnStrides& sk,
                              const AttnStrides& sv, const AttnStrides& so, int B, int H,
                              int T, int dh, bool vec, float scale, const Drop& drop,
                              float* lse, cudaStream_t s) {
  if (B * H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((T + kWideRows - 1) / kWideRows, B * H, (dh + kWideSlice - 1) / kWideSlice);
  flash_wide_kernel<DROP><<<grid, kWideThreads, 0, s>>>(q, k, v, out, sq, sk, sv, so, H, T, dh,
                                                        vec, scale, drop, lse);
  return cudaSuccess;
}

// The causal look-back-one band (band_tile.cuh's function) at any head
// width and window: grid (ceil(T / 64), B * H, ceil(dh / 128)); a warp's 16
// queries walk the keys of their band, 40 a step.
template <int NT = 5>
__global__ void __launch_bounds__(kWideThreads)
band_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, AttnStrides sq,
                 AttnStrides sk, AttnStrides sv, AttnStrides so, int H, int T, int dh,
                 int window, bool vec, float scale_log2) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, c0 = blockIdx.z * kWideSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kWideRows + warp * 16;
  if (q0 >= T) return;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int i_lo = q0 + g, i_hi = i_lo + 8;
  const int lo_lo = max(0, (i_lo / window - 1) * window);
  const int lo_hi = max(0, (i_hi / window - 1) * window);
  const int k_first = max(0, (q0 / window - 1) * window), k_last = min(q0 + 15, T - 1);

  float o[kWideNO][4];
#pragma unroll
  for (int d = 0; d < kWideNO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;

  for (int j0 = k_first; j0 <= k_last; j0 += 8 * NT) {
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    wide_scores<NT>(s, qb, sq.t, q0, kb, sk.t, j0, T, dh, vec);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * n + 2 * t + (e & 1);
        const int i = e < 2 ? i_lo : i_hi, lo = e < 2 ? lo_lo : lo_hi;
        s[n][e] = j >= lo && j <= i && j <= k_last ? s[n][e] * scale_log2 : -FLT_MAX;
      }
    wide_softmax_step<NT>(s, o, m_lo, m_hi, l_lo, l_hi);
    wide_pv<NT>(o, s, vb, sv.t, j0, c0, T, dh);
  }
  wide_normalise(o, l_lo, l_hi);
  wide_store(out + b * so.b + h * so.h, so.t, q0, c0, o, T, dh, vec);
}

template <int NT = 5>
cudaError_t band_wide_launch(const float* q, const float* k, const float* v, float* out,
                             const AttnStrides& sq, const AttnStrides& sk, const AttnStrides& sv,
                             const AttnStrides& so, int B, int H, int T, int dh, int window,
                             bool vec, float scale_log2, cudaStream_t s) {
  if (B * H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((T + kWideRows - 1) / kWideRows, B * H, (dh + kWideSlice - 1) / kWideSlice);
  band_wide_kernel<NT><<<grid, kWideThreads, 0, s>>>(q, k, v, out, sq, sk, sv, so, H, T, dh, window,
                                                 vec, scale_log2);
  return cudaSuccess;
}

}  // namespace
