// Flash self-attention forward, float32 numerics, non-causal: the device
// code of csrc/flash_attention.cu (the standalone entry point) and of the
// encoder layers' attention stage (csrc/encoder_layer.cu and
// csrc/encoder_layer_train.cu, reading their packed qkv buffer).
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
// The training layer (pallas_encoder_train.py::_fwd_kernel) drops the
// probabilities at site 0 (drop.seed set; the DROP instantiation): l sums
// the undropped p and o = sum_j drop(p_ij) v_j / l, each mask drawn from the
// hash of ((b*H + h)*T + i)*T + j at the physical key j (common.cuh), the
// masks of pallas_encoder_train.py.  With `lse` it also writes each row's
// log-sum-exp in log2 units, m + log2(l), for the attention backward.  The
// inference instantiation (DROP false, no lse) computes what it did.
//
// What bounds it on an H100: both products, S = q k^T and o += p v, run on
// the tensor cores in 3xTF32 (gemm_tf32x3.cuh: each f32 operand split into
// a TF32 big and small part, big.big + big.small + small.big accumulated in
// f32), which keeps f32-level error (~1e-6 relative) where one TF32 pass
// would be off by ~1e-3 and break the 2e-4 tolerance against the f32
// reference.  At [82, 4, 1201, 64] a call is 121 GFLOP of products against
// 0.40 GB of q, k, v and out: at three passes of the 495 TFLOP/s TF32 rate,
// 0.73 ms, plus ~0.13 ms for its 473M exponentials on the SFUs.
//
// Design (FlashAttention-2 on mma.sync.m16n8k8 TF32): a block of 4 warps
// owns 64 queries of one (batch, head), a warp 16 query rows, and walks the
// key tiles (64 keys; 16 above DHP 64, for registers) through a 3-stage
// cp.async ring.  A warp's q rows are read from device memory once, as A
// fragments in registers (split into big and small once at DHP <= 64,
// above it kept whole and split as used).  K and V fragments are split as they
// are read from shared memory.  Within each slice of 8 along a product's
// reduction axis, k is permuted: fragment elements k = t and t + 4 come
// from the adjacent physical positions 2t and 2t + 1 of both operands.
// That makes each q and K fragment pair one float2, and it makes the S
// accumulator of a key slice (row g: keys 2t, 2t + 1; row g + 8: the same)
// exactly the A fragment that o += p v needs for those keys, so p stays in
// registers: no shuffle and no pass through shared memory.  V is then read
// at rows 2t and 2t + 1 of the slice.  Scores are kept in log2 units
// (scale * log2(e) folded into one multiply, exp2 on the SFU); only the
// last, ragged tile is masked.  Row max and row sum are reduced over the 4
// threads of a quad with shuffles; the sum is kept per thread and reduced
// once at the end.  Shared rows are padded (K to DHP + 8, V to DHP + 4
// floats) so every fragment read is free of bank conflicts.  The kernel
// issues about five instructions per mma, near the issue limit of the
// mma.sync rate.  Measured slower at dh 64 and not done: splitting each K
// and V tile once per block into big and small tiles (fewer ALU
// operations, a second barrier a tile), and two query tiles a warp (K and
// V fragments feed twice the mmas, but the registers spill).
// Each tensor is read through (batch, head, position) strides with the head
// width contiguous: the encoder chain passes its packed [B*T, 3D] qkv and
// its [B*T, D] output, the standalone entry point [B, H, T, D] tensors.
//
// Any head width: up to 128 the kernel is built for the padded widths DHP,
// every multiple of 16 up to 128, and takes the real dh at run time; wider
// heads run wide_attention.cuh's flash_fwd_wide_kernel (same function, same
// dropout and log-sum-exp; a block of two warpgroups over the whole width,
// a cluster of two past 272 columns).  K and
// V rows are staged with columns dh .. DHP - 1 zero-filled (cp.async's
// zero fill), q's fragments read those columns as zeros, and only the
// columns below dh are stored: zero columns add nothing to q . k and give
// zero output columns, so the result is that of the real width, with the
// scale dh^-0.5 the caller passes.  Rows are copied 16 bytes at a time
// where dh and every stride are multiples of 4 floats and the pointers
// 16-byte aligned (`vec`), else one float at a time.
#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kFlashThreads = 128;  // 4 warps of 16 query rows
constexpr int kFlashBQ = 64;        // queries per block

template <int DHP>
struct FlashTile {
  static constexpr int BK = DHP <= 64 ? 64 : 16;  // keys per tile
  static constexpr int KLD = DHP + 8;             // K row stride (floats)
  static constexpr int VLD = DHP + 4;             // V row stride (floats)
  static constexpr int kStages = 3;              // ring of key tiles
  static constexpr size_t smem = (size_t)kStages * BK * (KLD + VLD) * sizeof(float);
};

// grid (ceil(T / kFlashBQ), B * H); head width dh <= DHP
template <int DHP, bool DROP>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       AttnStrides sq, AttnStrides sk, AttnStrides sv, AttnStrides so,
                       int H, int T, int dh, bool vec, float scale, Drop drop,
                       float* __restrict__ lse) {
  using Tile = FlashTile<DHP>;
  constexpr int BK = Tile::BK, KLD = Tile::KLD, VLD = Tile::VLD, kStages = Tile::kStages;
  constexpr int KC = DHP / 8;  // reduction slices of q k^T
  constexpr int NS = BK / 8;   // key slices of a tile: n8 tiles of S, k slices of p v
  constexpr int NO = DHP / 8;  // n8 tiles of o
  constexpr int C4 = DHP / 4;  // float4s in a row
  constexpr bool kSplitQOnce = DHP <= 64;
  static_assert(DHP % 16 == 0, "the padded head width is a multiple of 16");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // [kStages][BK][KLD]
  float* Vs = Ks + kStages * BK * KLD;   // [kStages][BK][VLD]
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (T + BK - 1) / BK;
  // scores in log2 units: exp(x * scale - m) = exp2(x * scale * log2(e) - m')
  const float scale_log2 = scale * 1.4426950408889634f;

  // rows j0 .. j0 + BK - 1; rows past T and columns past dh zero-filled
  auto load_tile = [&](int buf, int j0) {
    float* ks = Ks + buf * BK * KLD;
    float* vs = Vs + buf * BK * VLD;
    if (vec) {
      constexpr int kIters = (BK * C4 + kFlashThreads - 1) / kFlashThreads;
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int f = threadIdx.x + i * kFlashThreads, r = f / C4, c = (f % C4) * 4;
        if (BK * C4 % kFlashThreads != 0 && f >= BK * C4) break;
        const bool in = j0 + r < T && c < dh;
        cp_async16(ks + r * KLD + c, in ? kb + (j0 + r) * sk.t + c : kb, in);
        cp_async16(vs + r * VLD + c, in ? vb + (j0 + r) * sv.t + c : vb, in);
      }
    } else {
      copy_rows_scalar<DHP, KLD>(ks, kb, sk.t, j0, BK, T, dh);
      copy_rows_scalar<DHP, VLD>(vs, vb, sv.t, j0, BK, T, dh);
    }
  };
  load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, BK);
  cp_async_commit();

  // this warp's query rows r0 (fragment rows g) and r1 = r0 + 8 (rows g + 8)
  const int r0 = blockIdx.x * kFlashBQ + warp * 16 + g, r1 = r0 + 8;
  float qf[kSplitQOnce ? 1 : KC][4];        // whole q fragments (DHP > 64)
  uint32_t qbig[kSplitQOnce ? KC : 1][4];   // split once (DHP <= 64)
  uint32_t qsmall[kSplitQOnce ? KC : 1][4];
  // q[r][col, col + 1] (col even), zero past T and past the real head width
  auto qpair = [&](int r, int col) {
    if (r >= T || col >= dh) return make_float2(0.f, 0.f);
    const float* p = qb + r * sq.t + col;
    if (vec) return *reinterpret_cast<const float2*>(p);
    return make_float2(p[0], col + 1 < dh ? p[1] : 0.f);
  };
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int col = 8 * c + 2 * t;
    const float2 lo = qpair(r0, col), hi = qpair(r1, col);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};  // a0 .. a3 under the k permutation
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kSplitQOnce)
        split_tf32(a[e], qbig[c][e], qsmall[c][e]);
      else
        qf[c][e] = a[e];
    }
  }

  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  // the site-0 index of (row r0, key 2t of the first tile); r1 is 8 T on
  const uint32_t idx0 = drop.attn_base + (static_cast<uint32_t>(blockIdx.y) * T + r0) * T + 2 * t;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();     // ... for every thread; tile it - 1 is read
    if (it + 2 < ntiles) load_tile((it + 2) % kStages, (it + 2) * BK);
    cp_async_commit();
    const float* ks = Ks + (it % kStages) * BK * KLD;
    const float* vs = Vs + (it % kStages) * BK * VLD;

    // S = q k^T, 16 x BK for this warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const int kfrag = g * KLD + 2 * t;  // key g, head-width columns 2t, 2t + 1
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kSplitQOnce) {
          a_big[e] = qbig[c][e];
          a_small[e] = qsmall[c][e];
        } else {
          split_tf32(qf[c][e], a_big[e], a_small[e]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 k2 = *reinterpret_cast<const float2*>(ks + kfrag + n * 8 * KLD + 8 * c);
        uint32_t b_big[2], b_small[2];
        split_tf32(k2.x, b_big[0], b_small[0]);
        split_tf32(k2.y, b_big[1], b_small[1]);
        mma_tf32x3(s[n], a_big, a_small, b_big, b_small);
      }
    }

    // online softmax in log2 units; this thread holds keys 8n + 2t + {0, 1}
    // of rows r0 (s[n][0..1]) and r1 (s[n][2..3])
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    const int j0 = it * BK;
    if (j0 + BK > T) {  // the last tile is ragged: keys >= T score -FLT_MAX
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j0 + n * 8 + 2 * t + e >= T) s[n][e] = s[n][2 + e] = -FLT_MAX;
    }
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
      for (int e = 0; e < 2; ++e) {
        // a masked key: exp2(-FLT_MAX - m) = 0
        s[n][e] = exp2f(s[n][e] - mn_lo);
        s[n][2 + e] = exp2f(s[n][2 + e] - mn_hi);
        sum_lo += s[n][e];
        sum_hi += s[n][2 + e];
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

    // o += p v: the S accumulator of key slice n is p's A fragment
    // (a0 = row g key 2t, a1 = row g + 8 key 2t, a2, a3 the keys 2t + 1),
    // dropped at site 0 after the row sums took it
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if constexpr (DROP) {
        const uint32_t i_lo = idx0 + j0 + 8 * n, i_hi = i_lo + 8u * T;
        s[n][0] = dropped(s[n][0], i_lo, salt, drop);
        s[n][1] = dropped(s[n][1], i_lo + 1, salt, drop);
        s[n][2] = dropped(s[n][2], i_hi, salt, drop);
        s[n][3] = dropped(s[n][3], i_hi + 1, salt, drop);
      }
      uint32_t p_big[4], p_small[4];
      split_tf32(s[n][0], p_big[0], p_small[0]);
      split_tf32(s[n][2], p_big[1], p_small[1]);
      split_tf32(s[n][1], p_big[2], p_small[2]);
      split_tf32(s[n][3], p_big[3], p_small[3]);
      const float* v0 = vs + (n * 8 + 2 * t) * VLD + g;  // keys 2t, 2t + 1 of the slice
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        uint32_t b_big[2], b_small[2];
        split_tf32(v0[d * 8], b_big[0], b_small[0]);
        split_tf32(v0[VLD + d * 8], b_big[1], b_small[1]);
        mma_tf32x3(o[d], p_big, p_small, b_big, b_small);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < T) lse[(size_t)blockIdx.y * T + r0] = m_lo + log2f(l_lo);
    if (r1 < T) lse[(size_t)blockIdx.y * T + r1] = m_hi + log2f(l_hi);
  }
  float* ob = out + b * so.b + h * so.h;
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    const int col = d * 8 + 2 * t;
    store_pair(ob + r0 * so.t + col, o[d][0] * inv_lo, o[d][1] * inv_lo, r0 < T, col, dh, vec);
    store_pair(ob + r1 * so.t + col, o[d][2] * inv_hi, o[d][3] * inv_hi, r1 < T, col, dh, vec);
  }
}

struct FlashArgs {
  const float *q, *k, *v;
  float* out;
  AttnStrides sq, sk, sv, so;
  int B, H, T, dh;
  bool vec;
  float scale;
  Drop drop;
  float* lse;
};

template <int DHP, bool DROP>
cudaError_t flash_launch(const FlashArgs& a, cudaStream_t s) {
  const size_t smem = FlashTile<DHP>::smem;
  const cudaError_t e = set_smem(flash_attention_kernel<DHP, DROP>, smem);
  if (e != cudaSuccess) return e;
  if (a.B * a.H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((a.T + kFlashBQ - 1) / kFlashBQ, a.B * a.H);
  flash_attention_kernel<DHP, DROP><<<grid, kFlashThreads, smem, s>>>(
      a.q, a.k, a.v, a.out, a.sq, a.sk, a.sv, a.so, a.H, a.T, a.dh, a.vec, a.scale, a.drop,
      a.lse);
  return cudaSuccess;
}

template <int DHP, bool TRAIN>
cudaError_t flash_dhp(const FlashArgs& a, cudaStream_t s) {
  if constexpr (TRAIN)
    if (a.drop.seed != nullptr) return flash_launch<DHP, true>(a, s);
  return flash_launch<DHP, false>(a, s);
}

// Queues flash_attention_kernel on `s` for any head width dh <= 128 (the
// kernel of the next multiple of 16), wide_attention.cuh's flash_wide_launch
// for wider heads, with site-0 dropout when drop.seed is set (TRAIN: the
// training layer's instantiation; the inference ones build no dropout
// kernel) and the rows' log-sum-exp (log2 units, [B*H, T]) when lse is not
// null.
template <bool TRAIN>
cudaError_t flash_attention(const float* q, const float* k, const float* v, float* out,
                            const AttnStrides& sq, const AttnStrides& sk,
                            const AttnStrides& sv, const AttnStrides& so, int B, int H,
                            int T, int dh, float scale, const Drop& drop, float* lse,
                            cudaStream_t s) {
  const bool vec = dh % 4 == 0 && aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
                   aligned16(out, so);
  if (dh > kMaxPaddedWidth) {
    if constexpr (TRAIN)
      if (drop.seed != nullptr)
        return flash_wide_launch<true>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec, scale,
                                       drop, lse, s);
    return flash_wide_launch<false>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec, scale, drop,
                                    lse, s);
  }
  const FlashArgs a{q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec, scale, drop, lse};
  return with_padded_width(dh,
                           [&](auto w) { return flash_dhp<decltype(w)::value, TRAIN>(a, s); });
}

}  // namespace
