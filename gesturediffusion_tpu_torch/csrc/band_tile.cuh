// The banded softmax of one 16-query tile on the tensor cores in 3xTF32:
// the device routine the two band kernels share (band_attention.cu, the
// port of pallas_attention.py::_band_kernel; local_block.cu, of
// pallas_local_block.py::_local_block_kernel).  For the queries i of the
// tile and window w,
//
//   o[i] = softmax_j(q[i] . k[j] * scale) v[j]   over j in [band_lo(i), i],
//   band_lo(i) = max(0, (i / w - 1) * w),
//
// the keys j <= i of the query's own window and of the previous one, f32
// scores and softmax.  One warp owns the tile: rows g and g + 8 of
// mma.sync's m16n8k8 layout (g = lane / 4, t = lane % 4).
//
// Design.  The tile's band reaches the keys [band_lo(q0), q0 + 15]: at most
// 15 + 2w keys (35 at w 10), taken in chunks of kBandKeyTiles n8 tiles (40
// keys: one chunk up to w 12), with an online softmax across chunks for
// wider windows.  S = Q K^T is 5 n8 tiles of 3xTF32 mma.sync over the
// head width; the band mask is applied in registers with the finite
// -FLT_MAX and p of a masked key is set to 0 (never -inf); the row max and
// sum are reduced over the 4 threads of a quad.  P stays in registers:
// under the k permutation of flash_attention.cuh (fragment elements k = t
// and t + 4 are keys 2t and 2t + 1), the S accumulator of a key tile is the
// A fragment of o += P V.  Q and K are read without that permutation, as
// scalars at columns t and t + 4: with shared rows of DHP + 4 floats (DHP a
// multiple of 8) those reads, and V's scalar reads at rows 2t and 2t + 1,
// are all free of bank conflicts, so one row stride serves Q, K and V when
// they are one tensor (the local block's q = k = v).  Each operand element
// is split into its TF32 big and small parts as it is used, Q's too
// (staging the parts once in shared memory measured slower: twice the
// shared memory, so fewer blocks an SM; holding Q's parts in registers for
// the whole tile measured no faster, PERF.md section 6).  The caller stages the
// rows with the columns dh .. DHP - 1 zero-filled and keeps the up to 7
// rows past the band's last key finite (zeros, or rows staged earlier):
// they are read with the band's last key tile, scored and masked, and their
// p of 0 multiplies their finite values.
#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kBandKeyTiles = 5;  // n8 key tiles a chunk: 40 keys

// the first key of query i's band: the start of the previous window
__device__ __forceinline__ int band_lo(int i, int window) {
  return max(0, (i / window - 1) * window);
}

// The band attention of queries [q0, q0 + 16) of a sequence of T rows, for
// the calling warp.  qrow(i), krow(j) and vrow(j) return the shared-memory
// row of query i, key j and value j (DHP columns, zero past the real head
// width, finite up to 7 keys past the last); query rows >= T are never
// read.  Leaves in o the normalised output: o[d][0..1] at row q0 + g,
// columns 8d + 2t and 8d + 2t + 1, o[d][2..3] at row q0 + g + 8; rows >= T
// hold finite garbage.
template <int DHP, typename QRow, typename KRow, typename VRow>
__device__ __forceinline__ void band_tile(int q0, int T, int window, float scale_log2,
                                          QRow qrow, KRow krow, VRow vrow,
                                          float (&o)[DHP / 8][4]) {
  constexpr int KC = DHP / 8;  // k slices of S = Q K^T
  constexpr int NO = DHP / 8;  // n8 tiles of o
  constexpr int NT = kBandKeyTiles;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i_lo = q0 + g, i_hi = i_lo + 8;  // this thread's query rows
  const int lo_lo = band_lo(i_lo, window), lo_hi = band_lo(i_hi, window);
  const int k_first = band_lo(q0, window), k_last = min(q0 + 15, T - 1);

  // Q's A fragments: a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4); rows >= T read as zeros
  float qf[KC][4];
  {
    const float* ql = qrow(min(i_lo, T - 1));
    const float* qh = qrow(min(i_hi, T - 1));
    const bool in_lo = i_lo < T, in_hi = i_hi < T;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      qf[c][0] = in_lo ? ql[8 * c + t] : 0.0f;
      qf[c][1] = in_hi ? qh[8 * c + t] : 0.0f;
      qf[c][2] = in_lo ? ql[8 * c + t + 4] : 0.0f;
      qf[c][3] = in_hi ? qh[8 * c + t + 4] : 0.0f;
    }
  }

#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;

  for (int kb = k_first; kb <= k_last; kb += 8 * NT) {
    // S = Q K^T over the chunk's key tiles; tiles past the band are skipped
    // (a warp-uniform test)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      if (kb + 8 * n > k_last) continue;
      const float* kr = krow(kb + 8 * n + g);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qf[c][e], a_big[e], a_small[e]);
        split_tf32(kr[8 * c + t], b_big[0], b_small[0]);
        split_tf32(kr[8 * c + t + 4], b_big[1], b_small[1]);
        mma_tf32x3(s[n], a_big, a_small, b_big, b_small);
      }
    }

    // the band mask and the online softmax in log2 units; element e of
    // tile n is row (e < 2 ? i_lo : i_hi), key kb + 8n + 2t + (e & 1)
    float mx_lo = -FLT_MAX, mx_hi = -FLT_MAX;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb + 8 * n + 2 * t + (e & 1);
        const int i = e < 2 ? i_lo : i_hi, lo = e < 2 ? lo_lo : lo_hi;
        s[n][e] = (j >= lo && j <= i && j <= k_last) ? s[n][e] * scale_log2 : -FLT_MAX;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s[n][e]);
        else
          mx_hi = fmaxf(mx_hi, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked key scores -FLT_MAX; its p is 0 even where every key of
        // the row in this chunk is masked (mn = -FLT_MAX)
        const float mn = e < 2 ? mn_lo : mn_hi;
        s[n][e] = s[n][e] == -FLT_MAX ? 0.0f : exp2f(s[n][e] - mn);
      }
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      o[d][0] *= al_lo;
      o[d][1] *= al_lo;
      o[d][2] *= al_hi;
      o[d][3] *= al_hi;
    }

    // o += P V: the S accumulator of key tile n is P's A fragment (a0 = row
    // g key 2t, a1 = row g + 8 key 2t, a2, a3 the keys 2t + 1); V is read at
    // keys 2t and 2t + 1 of the tile, column 8d + g
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (kb + 8 * n > k_last) continue;
      uint32_t p_big[4], p_small[4];
      split_tf32(s[n][0], p_big[0], p_small[0]);
      split_tf32(s[n][2], p_big[1], p_small[1]);
      split_tf32(s[n][1], p_big[2], p_small[2]);
      split_tf32(s[n][3], p_big[3], p_small[3]);
      const float* v0 = vrow(kb + 8 * n + 2 * t);
      const float* v1 = vrow(kb + 8 * n + 2 * t + 1);
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        uint32_t b_big[2], b_small[2];
        split_tf32(v0[8 * d + g], b_big[0], b_small[0]);
        split_tf32(v1[8 * d + g], b_big[1], b_small[1]);
        mma_tf32x3(o[d], p_big, p_small, b_big, b_small);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;
  const float inv_hi = l_hi > 0.0f ? 1.0f / l_hi : 0.0f;
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    o[d][0] *= inv_lo;
    o[d][1] *= inv_lo;
    o[d][2] *= inv_hi;
    o[d][3] *= inv_hi;
  }
}

}  // namespace
