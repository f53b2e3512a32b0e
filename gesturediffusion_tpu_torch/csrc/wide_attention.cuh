// Attention at head widths past 128: the flash forward (flash_attention.cuh's
// function), the band (band_attention.cu's) and the local block
// (local_block.cu's) for heads the narrow kernels' registers and shared
// memory do not hold, and the primitives the training layer's wide
// attention backward shares (encoder_layer_train.cu).
//
// Replaces, for those widths: gesturediffusion_tpu/ops/pallas_flash.py::
// _flash_kernel (which pads any head width to a multiple of 128,
// pallas_flash.py:93-109), pallas_attention.py::_band_kernel and
// pallas_local_block.py::_local_block_kernel.  Same functions, f32 scores
// and softmax, the same masks (keys >= T, the causal look-back-one band)
// and, for the flash forward in training, the same site-0 dropout and
// log-sum-exp.
//
// The wide forward (wide_fwd: flash_fwd_wide_kernel, band_wide_kernel,
// local_block_wide_kernel), heads of 129 to 544.  What bounds it on an
// H100: the flash forward at [82, 4, 1201, 256] is 484 GFLOP of products
// against 0.5 GB of q, k, v and out, so the tensor cores: 2.94 ms at three
// passes of the 495 TFLOP/s TF32 rate; the band at [82, 8, 1200, 136]
// (window 10, q = k = v) is 0.86 GB of input and output against 6.6
// GFLOP of band products, so memory: 0.26 ms at 3.35 TB/s.  Its design:
//   * a block is 64 query rows of one (batch, head), two warpgroups of 4
//     warps (16 rows a warp), and the whole width up to 272 columns; past
//     that a cluster of two blocks, each taking a share of 272 columns
//     (registers hold q's rows and the output over a warpgroup's half of a
//     share: 64 + 64 floats a thread at dh 256, 68 + 68 at 520);
//   * the scores are computed once: each warp takes S = q k^T for its 16
//     rows over its warpgroup's half of the share; the partial sums meet in
//     shared memory, each warpgroup adding its block's two in the same
//     order, and in a cluster warpgroup 0 publishes its block's sum, which
//     the peer reads through distributed shared memory (mapa,
//     ld.shared::cluster) and adds in rank order: every warpgroup holds the
//     same bits of S and runs the same online softmax;
//   * o += p v is wgmma m64nNk8 TF32, N the warpgroup's 72, 128 or 136
//     output columns, A = P from registers (the S accumulator of a key
//     slice is its A fragment under flash_attention.cuh's k permutation), B
//     from shared memory; S = q k^T is mma.sync.m16n8k8, a warp's 16 rows
//     against 8-key slices, q's A fragments split a k8 step at a time from
//     registers: with a 32-key tile (all that shared memory holds at 272
//     columns) S as m64n32k8 wgmma measured slower on the card than the
//     four warps' mma.sync;
//   * K and V rows of a 32-key tile land by cp.async (16 bytes a copy where
//     rows are aligned, `vec`, else one float a copy), the next tile in
//     flight while one is used; the block splits each landed element into
//     big and small once (mma_tf32x3.cuh's split), into wgmma's K-major
//     core matrices without swizzle: K as it lies along the width (the
//     mma.sync B fragment is two floats of them), V transposed along the
//     keys and k permuted.  Every product is three TF32 passes, big . small
//     + small . big + big . big.  Shared memory at dh 256: raw K and V 2 x
//     32 x 260 floats, split K and V 4 x 32 x 256, partial scores 16 KB, 209
//     KB of the 227 KB a block may use; at dh 520 each block of the cluster
//     the same at 272 columns, 221 KB;
//   * the block index runs over (batch * head, query tile) in one grid
//     dimension, so B * H is not bounded by the grid's second dimension.
// The band (band_wide_kernel) is the same loop over the key tiles from the
// block's first band key, (q0 / w - 1) w, to its last row, under the band
// mask; a warp skips the score products of the 8-key slices that none of
// its 16 rows sees, and the block the p v of the slices past its last row.
// It bounds by bytes (the band at window 10 is ~15 keys a query), and its
// blocks are short (six 16-key tiles at window 10), so what it pays for
// is each block's latency: its tiles are 16 keys, q's 64 rows sit in
// shared memory (no q fragments held in registers: 113 registers at 144
// columns, so two blocks share an SM, 102 KB each) and, where q = k = v
// (the model's path) and the band's rows up to the block's last fit 96
// rows (windows up to 16), those rows land once, resident, and each tile
// is split where it lies.  The local block (local_block_wide_kernel) is
// that band over x's head rows, roped in shared memory once as they land
// (the rotate-half partner of column k is column k + dh / 2 of the same
// row, both resident), the output tile staged in shared memory for the
// second rotary pass (position i + 1) and written with the conditioning
// token's row: one launch and no workspace up to local heads of 272.
// Tried and not kept (PERF.md section 6; an H100 80GB HBM3 at 700 W): the
// flash forward's 32-key tiles with q in registers (one block an SM; 1.49
// ms at [82, 8, 1200, 136] against 1.03-1.08), p v on mma.sync over a
// warp's live slices instead of wgmma (slower).  The shared body costs the
// flash forward at heads of 136 ~9% against its own kernel before the band
// modes (7.54-7.62 ms against 6.90-6.98 at [82, 4, 1201, 136]; at 272
// 11.75 against 11.78-11.86): ptxas now issues all of a tile's
// exponentials before its first p v wgmma, where it used to interleave
// them.  Taking the arguments one by one or as this struct, and computing
// a slice's exponentials inside the p v loop, left that time unchanged.
// Rows past T and columns past dh read as zeros; only real rows and
// columns are stored.
//
// Heads wider than 544 (no configuration comes near them; the training
// layer's attention backward too) walk the head width in 128-column
// slices, each block of 4 warps recomputing the scores of its slice from
// fragments read from device memory (L1 and L2 serve the re-reads):
// flash_sliced_kernel, band_sliced_kernel and the helpers below.
// encoder_layer_train.cu's wide backward passes (heads of 129 to 544) reuse
// the forward's wgmma widths, splits and cluster exchange.  Their products are
// mma.sync.m16n8k8 TF32 in three passes, with the k permutation of
// flash_attention.cuh, so P stays in registers.
#pragma once

#include <limits.h>

#include <algorithm>

#include "common.cuh"
#include "gemm_tf32x3.cuh"
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

// ---- the flash forward, heads of 129 to 544 ------------------------------- //

constexpr int kWgThreads = 256;  // 2 warpgroups
constexpr int kWgRows = 64;      // query rows a block: wgmma's M, shared by both warpgroups
constexpr int kWgKeys = 32;      // keys a tile

// d += a . b for a warpgroup, m64n72k8 TF32: a from registers (mma.sync's
// m16n8k8 A fragment, each warp its 16 rows), b 72 x 8 from shared memory
// through `desc`, d 36 floats a thread (mma.sync's accumulator, per n8 tile)
__device__ __forceinline__ void wgmma_n72(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . b for a warpgroup, m64n128k8 TF32: a from registers (mma.sync's
// m16n8k8 A fragment, each warp its 16 rows), b 128 x 8 from shared memory
// through `desc`, d 64 floats a thread (mma.sync's accumulator, per n8 tile)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . b for a warpgroup, m64n136k8 TF32: a from registers (mma.sync's
// m16n8k8 A fragment, each warp its 16 rows), b 136 x 8 from shared memory
// through `desc`, d 68 floats a thread (mma.sync's accumulator, per n8 tile)
__device__ __forceinline__ void wgmma_n136(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0 .. 3] += a . b on one m16n8k8 tile (mma_tf32x3.cuh's mma_tf32 on four
// floats of a larger accumulator)
__device__ __forceinline__ void mma_tf32_at(float* d, const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at N = 72, 128 or 136
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4], uint64_t desc) {
  static_assert(N == 72 || N == 128 || N == 136, "an instantiated wgmma width");
  if constexpr (N == 72)
    wgmma_n72(d, a, desc);
  else if constexpr (N == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n136(d, a, desc);
}

// wait until at most N committed groups of this warp's wgmma are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// big and small of x[0 .. 3] at big + off, small + off (16-byte aligned)
__device__ __forceinline__ void store_split4(float* big, float* small, int off, float4 x) {
  uint32_t bg[4], sm[4];
  split_tf32(x.x, bg[0], sm[0]);
  split_tf32(x.y, bg[1], sm[1]);
  split_tf32(x.z, bg[2], sm[2]);
  split_tf32(x.w, bg[3], sm[3]);
  *reinterpret_cast<uint4*>(big + off) = make_uint4(bg[0], bg[1], bg[2], bg[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
}

// Rows [r0, r0 + n) of a [T, dh] operand (row stride ld floats) into n
// shared rows of ldd floats, w columns: one float a copy, rows past T and
// columns past dh zero-filled (rows that are not 16-byte aligned)
__device__ __noinline__ void wide_copy_scalar(float* dst, int ldd, const float* src, long long ld,
                                              int r0, int n, int T, int dh, int w) {
  for (int f = threadIdx.x; f < n * w; f += blockDim.x) {
    const int r = f / w, c = f % w;
    const bool in = r0 + r < T && c < dh;
    cp_async4(dst + r * ldd + c, in ? src + (r0 + r) * ld + c : src, in);
  }
}

// a float4 of block `rank`'s shared memory in the cluster, at the offset of
// this block's p
__device__ __forceinline__ float4 ld_cluster(const float4* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// every thread of the cluster's blocks waits for the others; shared-memory
// writes before it are visible to the peers' reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the same wait without ordering memory: every thread has reached it
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// rope of the pair (x1, x2) = (column k, column k + dh / 2) with cos c and
// sin s: x * cos + rotate_half(x) * sin, each product rounded on its own (no
// fused multiply-add), as PyTorch rounds the plain version's
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, float& y1,
                                         float& y2) {
  y1 = __fadd_rn(__fmul_rn(x1, c), __fmul_rn(-x2, s));
  y2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

__device__ __forceinline__ void rope4(const float4& x1, const float4& x2, const float4& c,
                                      const float4& s, float4& y1, float4& y2) {
  rope_pair(x1.x, x2.x, c.x, s.x, y1.x, y2.x);
  rope_pair(x1.y, x2.y, c.y, s.y, y1.y, y2.y);
  rope_pair(x1.z, x2.z, c.z, s.z, y1.z, y2.z);
  rope_pair(x1.w, x2.w, c.w, s.w, y1.w, y2.w);
}

// Rows [0, n) of a [.][ld] shared tile, positions p0 .. p0 + n - 1 of a head
// of width dh, roped in place (rows at positions >= T are left as they are:
// zeros); cos_t and sin_t [T + 1, dh / 2].  `vec`: dh % 8 == 0 and aligned
// tables, a float4 of each half a thread.
__device__ __forceinline__ void rope_rows(float* x, int ld, int n, int p0, int T, int dh,
                                          const float* cos_t, const float* sin_t, bool vec) {
  const int half = dh / 2;
  if (vec) {
    const int h4 = half / 4;
    for (int f = threadIdx.x; f < n * h4; f += blockDim.x) {
      const int r = f / h4, k = (f - r * h4) * 4, pos = p0 + r;
      if (pos >= T) continue;
      float* row = x + r * ld;
      float4 y1, y2;
      rope4(ld4(row + k), ld4(row + k + half), ld4(cos_t + pos * half + k),
            ld4(sin_t + pos * half + k), y1, y2);
      *reinterpret_cast<float4*>(row + k) = y1;
      *reinterpret_cast<float4*>(row + k + half) = y2;
    }
  } else {
    for (int f = threadIdx.x; f < n * half; f += blockDim.x) {
      const int r = f / half, k = f - r * half, pos = p0 + r;
      if (pos >= T) continue;
      float* row = x + r * ld;
      rope_pair(row[k], row[k + half], cos_t[pos * half + k], sin_t[pos * half + k], row[k],
                row[k + half]);
    }
  }
}

// The three functions of the wide forward: the flash forward (all keys
// below T), the causal look-back-one band (band_tile.cuh's function,
// kernel 3) and the local block (local_block.cu's function, kernel 2: the
// band over the roped rows, then the token and the second rotary pass)
enum WideMode { kWideFlash, kWideBand, kWideLocal };

// The wide forward's arguments: q, k, v and out [B, H, T, dh] through their
// strides.  The local block reads x [B, T, D] as q = k = v (strides {T D,
// dh, D}) and writes [B, T + 1, D] (strides {(T + 1) D, dh, D}): row i's
// output at row i + 1, the token at row 0.
struct WideFwdArgs {
  const float *q, *k, *v;
  float* out;
  AttnStrides sq, sk, sv, so;
  int H, T, dh;
  bool vec;      // 16-byte copies, float2 stores (float4 in the local block's epilogue)
  float scale;
  Drop drop;     // the flash forward in training: site-0 dropout ...
  float* lse;    // ... and the rows' log-sum-exp (log2 units), where not null
  int window;    // the band and the local block
  bool kv_same;  // k and v one operand: its rows land once (the local block's always)
  bool qkv_same; // q, k and v one operand (the local block's always)
  const float *coa, *cos_t, *sin_t;  // the local block: the token [B, D], tables [T + 1, dh / 2]
};

// The shared memory of the wide forward at a block's share w <= 16 KS of
// the padded head width, in floats, key tiles of BK keys: `raws` raw tiles
// (K and V, or their one operand) [BK][w + 4] as cp.async lands them; K big
// and small [w / 8][BK * 8] and V big and small [2][BK / 8][8 KS * 8] in
// wgmma's K-major core matrices; the partial scores [8 warps][BK / 8][32
// lanes][4].  In the band the raw tiles and q's 64 rows share one area of
// kResRows rows: 2 BK raw rows and 64 of q, or, where q = k = v and the
// block's band is at most kResRows keys, the band's rows resident.
constexpr int kResRows = 96;
template <int KS, int BK, bool BAND>
size_t wide_fwd_floats(int w, int raws) {
  static_assert(!BAND || 2 * BK + kWgRows <= kResRows, "the raw tiles and q share the area");
  return (BAND ? kResRows : (size_t)raws * BK) * (w + 4) + 2 * w * BK + 32 * KS * BK + 128 * BK;
}

// The wide forward of one block, grid (B * H * ceil(T / 64), CL), 256
// threads, clusters of the CL blocks of a query tile: 64 query rows of one
// (batch, head).  The padded width is cut into CL shares of w = 16 ks
// columns (ks <= KS); block `rank` takes the share [rank w, (rank + 1) w),
// warpgroup c its half [8 ks c, 8 ks (c + 1)) of it, for both the scores
// and the output.  The flash forward walks every key tile; with DROP, p is
// dropped at site 0 after the row sums took it; lse (log2 units) is written
// by warpgroup 0 of block 0.  The band walks the key tiles from the
// block's first band key on, (q0 / w - 1) w, to its last row, masks each
// row's band and skips a warp's key slices that none of its rows sees; the
// local block does the same over x's rows roped as they land, then stages
// the output tile in shared memory for the second rotary pass, a row on,
// and the token.  Tiles of BK keys; the band reads q's rows from shared
// memory, the flash forward holds them in registers.
template <int MODE, bool DROP, int KS, int CL, int BK>
__device__ __forceinline__ void wide_fwd(const WideFwdArgs& a) {
  constexpr int WO = 8 * KS;  // a warpgroup's accumulator columns
  constexpr int NSL = BK / 8;               // 8-key slices of a tile
  constexpr bool BAND = MODE != kWideFlash, LOCAL = MODE == kWideLocal;
  extern __shared__ __align__(16) float smem[];
  const float *__restrict__ q = a.q, *__restrict__ k = a.k, *__restrict__ v = a.v;
  const AttnStrides sq = a.sq, sk = a.sk, sv = a.sv, so = a.so;
  const int H = a.H, T = a.T, dh = a.dh;
  const bool vec = a.vec;
  const int w = (dh + 16 * CL - 1) / (16 * CL) * 16, ks = w / 16;
  const int ld = w + 4;  // raw rows: = 4 mod 16, conflict-free float4 reads down the keys
  const uint32_t rank = CL > 1 ? blockIdx.y : 0;
  const int col0 = rank * w;  // the block's first column
  const bool one_raw = LOCAL || (BAND && a.kv_same);  // k and v land once
  float* kraw = smem;
  float* vraw = kraw + (one_raw ? 0 : BK * ld);
  float* kbig = BAND ? smem + kResRows * ld : vraw + BK * ld;
  float* ksmall = kbig + w * BK;
  float* vbig = ksmall + w * BK;
  float* vsmall = vbig + 2 * WO * BK;
  float4* xch = reinterpret_cast<float4*>(vsmall + 2 * WO * BK);
  float* qs = smem + 2 * BK * ld;  // the band's q rows, beside the raw tiles
  const int qtiles = (T + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / qtiles, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int c = warp >> 2, wi = warp & 3;  // warpgroup, warp in it
  const int q0 = (blockIdx.x % qtiles) * kWgRows, r0 = q0 + 16 * wi + g, r1 = r0 + 8;
  const int dw = dh - col0;  // real columns from the block's first on
  const float* qb = q + b * sq.b + h * sq.h + col0;
  const float* kb = k + b * sk.b + h * sk.h + col0;
  const float* vb = v + b * sv.b + h * sv.h + col0;
  // the keys [jbeg, jend) the block's rows see: all of them, or the band of
  // rows q0 .. q0 + 63 (window `window`, look-back one)
  const int win = BAND ? a.window : 1;
  const int jbeg = BAND ? max(0, (q0 / win - 1) * win) : 0;
  const int jend = BAND ? min(q0 + kWgRows, T) : T;
  const int ntiles = (jend - jbeg + BK - 1) / BK;
  // where q = k = v and the band's rows up to the block's last (window <=
  // 16) fit the area, they land once, resident, and every tile is read
  // where it lies (no copy, and in the local block no rotary pass, a tile)
  const bool res = BAND && (LOCAL || a.qkv_same) && q0 + kWgRows - jbeg <= kResRows;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  // rows r0 and r1 see the keys [lo, row]; the warp's rows the keys
  // [lo_w, hi_w]
  const int lo0 = max(0, (r0 / win - 1) * win), lo1 = max(0, (r1 / win - 1) * win);
  const int lo_w = max(0, ((q0 + 16 * wi) / win - 1) * win), hi_w = min(q0 + 16 * wi + 15, T - 1);

  // K and V rows j0 .. j0 + BK - 1 over the block's share of the width (one
  // operand's rows, into kraw, where they alias)
  auto load_tile = [&](int j0) {
    const bool two = !one_raw;
    if (vec) {
      const int w4 = w / 4;
      for (int f = threadIdx.x; f < BK * w4; f += kWgThreads) {
        const int rr = f / w4, cc = (f % w4) * 4;
        const bool in = j0 + rr < T && cc < dw;
        cp_async16(kraw + rr * ld + cc, in ? kb + (j0 + rr) * sk.t + cc : kb, in);
        if (two) cp_async16(vraw + rr * ld + cc, in ? vb + (j0 + rr) * sv.t + cc : vb, in);
      }
    } else {
      wide_copy_scalar(kraw, ld, kb, sk.t, j0, BK, T, dw, w);
      if (two) wide_copy_scalar(vraw, ld, vb, sv.t, j0, BK, T, dw, w);
    }
  };
  // the landed tile into the big and small tiles: K as it lies (K-major
  // along the head width, core matrix 0 of a k8 step its columns 0 .. 3), V
  // transposed (K-major along the keys, k permuted: core 0 the keys 0, 2, 4,
  // 6 of the step, core 1 keys 1, 3, 5, 7, so that p's accumulator is its A
  // fragment); warpgroup c's V columns are 8 ks c .. 8 ks c + WO - 1, zero
  // past the share
  auto split_tile = [&]() {
    for (int f = threadIdx.x; f < BK * (w / 4); f += kWgThreads) {
      const int key = f % BK, c4 = f / BK;  // columns 4 c4 .. 4 c4 + 3
      const int off = (c4 >> 1) * BK * 8 + (key >> 3) * 64 + (c4 & 1) * 32 + (key & 7) * 4;
      store_split4(kbig, ksmall, off, ld4(kraw + key * ld + 4 * c4));
    }
    for (int f = threadIdx.x; f < 2 * WO * NSL * 2; f += kWgThreads) {
      const int n = f % (2 * WO), j = f / (2 * WO) >> 1, core = (f / (2 * WO)) & 1;
      const int wg = n / WO, nn = n % WO, src = 8 * ks * wg + nn;
      const float* vs = vraw + (8 * j + core) * ld + src;
      const bool in = src < w;
      const float4 x = in ? make_float4(vs[0], vs[2 * ld], vs[4 * ld], vs[6 * ld])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const int off = wg * WO * BK + j * WO * 8 + (nn >> 3) * 64 + core * 32 + (nn & 7) * 4;
      store_split4(vbig, vsmall, off, x);
    }
  };
  // the band stages q's 64 rows (or, resident, the band's rows) in shared
  // memory (the local block ropes them there); the flash forward reads its
  // fragments from device memory
  if constexpr (BAND) {
    const int r_first = res ? jbeg : q0, n = res ? kResRows : kWgRows;
    float* dst = res ? smem : qs;
    if (vec) {
      const int w4 = w / 4;
      for (int f = threadIdx.x; f < n * w4; f += kWgThreads) {
        const int rr = f / w4, cc = (f % w4) * 4;
        const bool in = r_first + rr < T && cc < dw;
        cp_async16(dst + rr * ld + cc, in ? qb + (r_first + rr) * sq.t + cc : qb, in);
      }
    } else {
      wide_copy_scalar(dst, ld, qb, sq.t, r_first, n, T, dw, w);
    }
    cp_async_commit();
    if (res) qs = smem + (q0 - jbeg) * ld;
  }
  if (!res) load_tile(jbeg);
  cp_async_commit();

  // q[r0 | r1][this warpgroup's half of the block's share] as A fragments
  // (a0, a1 at column t of a k8 step, a2, a3 at t + 4), zero past T and dh,
  // split as they are used: the flash forward's in registers, the band's
  // read from q's rows in shared memory
  float qf[BAND ? 1 : KS][4];
  const float* q_lo = qs + (16 * wi + g) * ld + 8 * ks * c + t;
  if constexpr (BAND) {
    cp_async_wait<1>();
    __syncthreads();  // q's rows (the band's rows) have landed
    if constexpr (LOCAL) {
      rope_rows(res ? smem : qs, ld, res ? kResRows : kWgRows, res ? jbeg : q0, T, dh, a.cos_t,
                a.sin_t, vec);
      __syncthreads();
    }
  }
  if constexpr (!BAND) {
    auto q_at = [&](int r, int col) -> float {
      return r < T && col < dw ? qb[r * sq.t + col] : 0.0f;
    };
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int col = 8 * (ks * c + i) + t;
      const bool in = i < ks;
      qf[i][0] = in ? q_at(r0, col) : 0.0f;
      qf[i][1] = in ? q_at(r1, col) : 0.0f;
      qf[i][2] = in ? q_at(r0, col + 4) : 0.0f;
      qf[i][3] = in ? q_at(r1, col + 4) : 0.0f;
    }
  }
  float o[4 * KS];
#pragma unroll
  for (int i = 0; i < 4 * KS; ++i) o[i] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;
  const uint32_t salt = DROP ? site_salt(a.drop.seed, kSiteAttn) : 0u;
  // the site-0 index of (row r0, key 2t of the first tile); r1 is 8 T on
  const uint32_t idx0 = a.drop.attn_base + (static_cast<uint32_t>(bh) * T + r0) * T + 2 * t;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = jbeg + it * BK;
    if (res) kraw = vraw = smem + (j0 - jbeg) * ld;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; the last tile's split tiles and partials are read
    // ... and in a cluster the peer has read this block's sums of the last
    // tile: it used the values before it arrived, so no release is needed
    if constexpr (CL > 1) cluster_sync_relaxed();
    if (LOCAL && !res) {
      rope_rows(kraw, ld, BK, j0, T, dh, a.cos_t, a.sin_t, vec);
      __syncthreads();
    }
    split_tile();
    fence_proxy_async();
    __syncthreads();  // the split tiles are visible to wgmma; the raw tiles are free
    if (!res && it + 1 < ntiles) load_tile(j0 + BK);
    cp_async_commit();

    // the key slices a row of this warp sees (the band: keys [lo_w, hi_w])
    uint32_t live = (1u << NSL) - 1;
    if constexpr (BAND) {
      live = 0;
#pragma unroll
      for (int n = 0; n < NSL; ++n)
        if (j0 + 8 * n <= hi_w && j0 + 8 * n + 7 >= lo_w) live |= 1u << n;
    }

    // this warp's part of S = q k^T: its 16 rows, BK keys, its warpgroup's
    // half of the block's share of the width, on mma.sync (at N = BK a
    // wgmma is dearer than the four warps' mma.sync), the B fragments read
    // from the split K tiles: b0 at row g, position t of a key group's core
    // 0, b1 of core 1
    float s[4 * NSL];
#pragma unroll
    for (int i = 0; i < 4 * NSL; ++i) s[i] = 0.0f;
    const float* kbg = kbig + ks * c * BK * 8 + 4 * g + t;
    const float* ksm = ksmall + ks * c * BK * 8 + 4 * g + t;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (i >= ks || live == 0) break;
      uint32_t a_big[4], a_small[4], b_big[NSL][2], b_small[NSL][2];
      if constexpr (BAND) {
        split_tf32(q_lo[8 * i], a_big[0], a_small[0]);
        split_tf32(q_lo[8 * ld + 8 * i], a_big[1], a_small[1]);
        split_tf32(q_lo[8 * i + 4], a_big[2], a_small[2]);
        split_tf32(q_lo[8 * ld + 8 * i + 4], a_big[3], a_small[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qf[i][e], a_big[e], a_small[e]);
      }
#pragma unroll
      for (int n = 0; n < NSL; ++n) {
        const int off = i * BK * 8 + n * 64;
        b_big[n][0] = __float_as_uint(kbg[off]);
        b_big[n][1] = __float_as_uint(kbg[off + 32]);
        b_small[n][0] = __float_as_uint(ksm[off]);
        b_small[n][1] = __float_as_uint(ksm[off + 32]);
      }
#pragma unroll
      for (int n = 0; n < NSL; ++n)
        if (live >> n & 1) mma_tf32_at(s + 4 * n, a_big, b_small[n]);
#pragma unroll
      for (int n = 0; n < NSL; ++n)
        if (live >> n & 1) mma_tf32_at(s + 4 * n, a_small, b_big[n]);
#pragma unroll
      for (int n = 0; n < NSL; ++n)
        if (live >> n & 1) mma_tf32_at(s + 4 * n, a_big, b_big[n]);
    }

    // the partial sums, added in the same order by every warpgroup of the
    // cluster: the same S in each.  A block's two first (local reads), then,
    // in a cluster, the blocks' sums in rank order (the peer's read from its
    // shared memory, where its warpgroup 0 put it)
#pragma unroll
    for (int n = 0; n < NSL; ++n)
      xch[(warp * NSL + n) * 32 + lane] =
          make_float4(s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3]);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NSL; ++n) {
      const float4 x0 = xch[(wi * NSL + n) * 32 + lane];
      const float4 x1 = xch[((4 + wi) * NSL + n) * 32 + lane];
      s[4 * n] = x0.x + x1.x;
      s[4 * n + 1] = x0.y + x1.y;
      s[4 * n + 2] = x0.z + x1.z;
      s[4 * n + 3] = x0.w + x1.w;
    }
    if constexpr (CL > 1) {
      __syncthreads();  // both warpgroups have read the partials
      if (c == 0)
#pragma unroll
        for (int n = 0; n < NSL; ++n)
          xch[(wi * NSL + n) * 32 + lane] =
              make_float4(s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3]);
      cluster_sync();
#pragma unroll
      for (int n = 0; n < NSL; ++n) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < CL; ++r) {
          const float4 x = r == static_cast<int>(rank)
                               ? make_float4(s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3])
                               : ld_cluster(xch + (wi * NSL + n) * 32 + lane, r);
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        s[4 * n] = acc.x;
        s[4 * n + 1] = acc.y;
        s[4 * n + 2] = acc.z;
        s[4 * n + 3] = acc.w;
      }
    }

    // online softmax in log2 units; keys past T, and in the band keys
    // outside a row's band, score -FLT_MAX (p = 0)
#pragma unroll
    for (int i = 0; i < 4 * NSL; ++i) {
      const int j = j0 + 8 * (i / 4) + 2 * t + (i & 1);
      bool in = j < T;
      if constexpr (BAND) in = in && j <= (i & 2 ? r1 : r0) && j >= (i & 2 ? lo1 : lo0);
      s[i] = in ? s[i] * scale_log2 : -FLT_MAX;
    }
    float mx_lo = -FLT_MAX, mx_hi = -FLT_MAX;
#pragma unroll
    for (int n = 0; n < NSL; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
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
    for (int n = 0; n < NSL; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked key: exp2(-FLT_MAX - m) = 0; in the band a row may have
        // seen no key yet (m = -FLT_MAX), so its masked keys are set to 0
        float& x_lo = s[4 * n + e];
        float& x_hi = s[4 * n + 2 + e];
        if constexpr (BAND) {
          x_lo = x_lo == -FLT_MAX ? 0.0f : exp2f(x_lo - mn_lo);
          x_hi = x_hi == -FLT_MAX ? 0.0f : exp2f(x_hi - mn_hi);
        } else {
          x_lo = exp2f(x_lo - mn_lo);
          x_hi = exp2f(x_hi - mn_hi);
        }
        sum_lo += x_lo;
        sum_hi += x_hi;
      }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      o[4 * i] *= al_lo;
      o[4 * i + 1] *= al_lo;
      o[4 * i + 2] *= al_hi;
      o[4 * i + 3] *= al_hi;
    }

    // o += p v over this warpgroup's columns: the S accumulator of key slice
    // n is p's A fragment, dropped at site 0 after the row sums took it; a
    // slice's split while the last one runs.  The band's slices past the
    // block's last row are p = 0 for every row: skipped
    uint32_t p_big[2][4], p_small[2][4];
    reg_fence(o);
#pragma unroll
    for (int n = 0; n < NSL; ++n) {
      if (BAND && j0 + 8 * n >= jend) break;
      if constexpr (DROP) {
        const uint32_t i_lo = idx0 + j0 + 8 * n, i_hi = i_lo + 8u * T;
        s[4 * n] = dropped(s[4 * n], i_lo, salt, a.drop);
        s[4 * n + 1] = dropped(s[4 * n + 1], i_lo + 1, salt, a.drop);
        s[4 * n + 2] = dropped(s[4 * n + 2], i_hi, salt, a.drop);
        s[4 * n + 3] = dropped(s[4 * n + 3], i_hi + 1, salt, a.drop);
      }
      const int set = n & 1;
      split_tf32(s[4 * n], p_big[set][0], p_small[set][0]);
      split_tf32(s[4 * n + 2], p_big[set][1], p_small[set][1]);
      split_tf32(s[4 * n + 1], p_big[set][2], p_small[set][2]);
      split_tf32(s[4 * n + 3], p_big[set][3], p_small[set][3]);
      wgmma_fence();
      const int off = c * WO * BK + n * WO * 8;
      const uint64_t db = wgmma_desc(vbig + off, 128, 256);
      const uint64_t ds = wgmma_desc(vsmall + off, 128, 256);
      wgmma_tf32<WO>(o, p_big[set], ds);
      wgmma_tf32<WO>(o, p_small[set], db);
      wgmma_tf32<WO>(o, p_big[set], db);
      wgmma_commit();
      wgmma_wait<1>();  // the slice before is read: its registers are free
    }
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      reg_fence(p_big[i]);
      reg_fence(p_small[i]);
    }
  }

  if constexpr (CL > 1) cluster_sync();  // the peers have read this block's partials
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if (!BAND && a.lse != nullptr && c == 0 && rank == 0 && t == 0) {
    if (r0 < T) a.lse[(size_t)bh * T + r0] = m_lo + log2f(l_lo);
    if (r1 < T) a.lse[(size_t)bh * T + r1] = m_hi + log2f(l_hi);
  }
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
  if constexpr (LOCAL) {
    // the output tile [64][ld] in the tiles' place (the token's row after
    // it), then the second rotary pass of its real rows, a row on, and (the
    // first tile) of the token at position 0
    __syncthreads();
    float* os = smem;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (i >= ks) break;
      const int col = 8 * (ks * c + i) + 2 * t, rr = 16 * wi + g;
      *reinterpret_cast<float2*>(os + rr * ld + col) =
          make_float2(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
      *reinterpret_cast<float2*>(os + (rr + 8) * ld + col) =
          make_float2(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
    }
    if (q0 == 0)  // coa[b, h dh ..] (D = H dh)
      for (int f = threadIdx.x; f < dh; f += kWgThreads)
        os[kWgRows * ld + f] = a.coa[(size_t)bh * dh + f];
    __syncthreads();
    const int n = min(kWgRows, T - q0);
    rope_rows(os, ld, n, q0 + 1, T + 1, dh, a.cos_t, a.sin_t, vec);
    if (q0 == 0) rope_rows(os + kWgRows * ld, ld, 1, 0, T + 1, dh, a.cos_t, a.sin_t, false);
    __syncthreads();
    float* ob = a.out + b * so.b + h * so.h;
    // rows q0 .. q0 + n - 1 to output rows q0 + 1 .., the token to row 0
    const int first = q0 == 0 ? -1 : 0;
    if (vec) {
      const int d4 = dh / 4;
      for (int f = threadIdx.x; f < (n - first) * d4; f += kWgThreads) {
        const int rr = f / d4 + first, cc = (f % d4) * 4;
        const float* src = os + (rr < 0 ? kWgRows : rr) * ld;
        *reinterpret_cast<float4*>(ob + (q0 + rr + 1) * so.t + cc) = ld4(src + cc);
      }
    } else {
      for (int f = threadIdx.x; f < (n - first) * dh; f += kWgThreads) {
        const int rr = f / dh + first, cc = f % dh;
        const float* src = os + (rr < 0 ? kWgRows : rr) * ld;
        ob[(q0 + rr + 1) * so.t + cc] = src[cc];
      }
    }
  } else {
    float* ob = a.out + b * so.b + h * so.h + col0;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (i >= ks) break;
      const int col = 8 * (ks * c + i) + 2 * t;
      store_pair(ob + r0 * so.t + col, o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo, r0 < T, col, dw,
                 vec);
      store_pair(ob + r1 * so.t + col, o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi, r1 < T, col,
                 dw, vec);
    }
  }
}

// The flash forward past a head width of 128 (flash_attention.cuh's
// function), heads of 129 to 544
template <bool DROP, int KS, int CL>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wide_kernel(const WideFwdArgs a) {
  wide_fwd<kWideFlash, DROP, KS, CL, kWgKeys>(a);
}

// The band's blocks: 16-key tiles, q's rows in shared memory (no q
// fragments held in registers) beside the raw tiles, or the band's rows
// resident where q = k = v; to 144 columns (102 KB of shared memory)
// registers capped for two blocks an SM, wider one block an SM
constexpr int kBandKeys = 16;
template <int KS>
constexpr int kBandBlocks = KS <= 9 ? 2 : 1;

// The band (kernel 3) at heads of 129 to 544, and where the narrow ring of
// band_attention.cu does not fit a block's shared memory
template <int KS, int CL>
__global__ void __launch_bounds__(kWgThreads, kBandBlocks<KS>)
    band_wide_kernel(const WideFwdArgs a) {
  wide_fwd<kWideBand, false, KS, CL, kBandKeys>(a);
}

// The local block (kernel 2) at local heads of 129 to 272, and of up to 128
// where local_block.cu's one-block kernel does not fit shared memory
template <int KS>
__global__ void __launch_bounds__(kWgThreads, kBandBlocks<KS>)
    local_block_wide_kernel(const WideFwdArgs a) {
  wide_fwd<kWideLocal, false, KS, 1, kBandKeys>(a);
}

// Queues `kernel` (a wide forward at KS and CL, BK-key tiles, the band's
// layout with BAND) on `a` over B * H * ceil(T / 64) query tiles in grid.x,
// the CL blocks of a cluster in grid.y.
template <int KS, int CL, int BK, bool BAND>
cudaError_t wide_fwd_launch(void (*kernel)(WideFwdArgs), const WideFwdArgs& a, int B,
                            cudaStream_t s) {
  const int w = (a.dh + 16 * CL - 1) / (16 * CL) * 16;
  const size_t smem = wide_fwd_floats<KS, BK, BAND>(w, a.kv_same ? 1 : 2) * sizeof(float);
  cudaError_t e = set_smem(kernel, smem);
  // two blocks an SM (the band's) want all of its 228 KB as shared memory
  if (e == cudaSuccess && BAND)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * a.H * ((a.T + kWgRows - 1) / kWgRows);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;  // grid.x
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), CL);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = CL;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The arguments of a forward over q, k, v and out [B, H, T, dh]
inline WideFwdArgs wide_args(const float* q, const float* k, const float* v, float* out,
                             const AttnStrides& sq, const AttnStrides& sk, const AttnStrides& sv,
                             const AttnStrides& so, int H, int T, int dh, bool vec, float scale) {
  WideFwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.sq = sq;
  a.sk = sk;
  a.sv = sv;
  a.so = so;
  a.H = H;
  a.T = T;
  a.dh = dh;
  a.vec = vec;
  a.scale = scale;
  return a;
}

// The flash forward past 544 columns (flash_attention.cuh's function at any
// head width): grid (ceil(T / 64), B * H, ceil(dh / 128)).  With DROP, p is dropped at
// site 0 after the row sums took it; lse (log2 units) is written by the
// blocks of slice 0.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
flash_sliced_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
cudaError_t flash_sliced_launch(const float* q, const float* k, const float* v, float* out,
                                const AttnStrides& sq, const AttnStrides& sk,
                                const AttnStrides& sv, const AttnStrides& so, int B, int H,
                                int T, int dh, bool vec, float scale, const Drop& drop,
                                float* lse, cudaStream_t s) {
  if (B * H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((T + kWideRows - 1) / kWideRows, B * H, (dh + kWideSlice - 1) / kWideSlice);
  flash_sliced_kernel<DROP><<<grid, kWideThreads, 0, s>>>(q, k, v, out, sq, sk, sv, so, H, T,
                                                          dh, vec, scale, drop, lse);
  return cudaSuccess;
}

template <bool DROP, int KS, int CL>
cudaError_t flash_fwd_wide_launch(const float* q, const float* k, const float* v, float* out,
                                  const AttnStrides& sq, const AttnStrides& sk,
                                  const AttnStrides& sv, const AttnStrides& so, int B, int H,
                                  int T, int dh, bool vec, float scale, const Drop& drop,
                                  float* lse, cudaStream_t s) {
  WideFwdArgs a = wide_args(q, k, v, out, sq, sk, sv, so, H, T, dh, vec, scale);
  a.drop = drop;
  a.lse = lse;
  return wide_fwd_launch<KS, CL, kWgKeys, false>(flash_fwd_wide_kernel<DROP, KS, CL>, a, B, s);
}

// Queues the flash forward at head width dh > 128: flash_fwd_wide_kernel up
// to 544, one block to 272 columns (a warpgroup's half of them 72, 128 or
// 136 wide), a cluster of two past it (shares of 272); flash_sliced_kernel
// past 544.
template <bool DROP>
cudaError_t flash_wide_launch(const float* q, const float* k, const float* v, float* out,
                              const AttnStrides& sq, const AttnStrides& sk,
                              const AttnStrides& sv, const AttnStrides& so, int B, int H,
                              int T, int dh, bool vec, float scale, const Drop& drop,
                              float* lse, cudaStream_t s) {
  if (dh <= 144)
    return flash_fwd_wide_launch<DROP, 9, 1>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec,
                                             scale, drop, lse, s);
  if (dh <= 256)
    return flash_fwd_wide_launch<DROP, 16, 1>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec,
                                              scale, drop, lse, s);
  if (dh <= 272)
    return flash_fwd_wide_launch<DROP, 17, 1>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec,
                                              scale, drop, lse, s);
  if (dh <= 544)
    return flash_fwd_wide_launch<DROP, 17, 2>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec,
                                              scale, drop, lse, s);
  return flash_sliced_launch<DROP>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, vec, scale, drop,
                                   lse, s);
}

// The causal look-back-one band (band_tile.cuh's function) at head widths
// past 544 (no configuration comes near them): grid (ceil(T / 64), B * H,
// ceil(dh / 128)); a warp's 16 queries walk the keys of their band, 40 a
// step, each block recomputing the scores of its 128-column output slice
// from fragments read from device memory.
template <int NT = 5>
__global__ void __launch_bounds__(kWideThreads)
band_sliced_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
cudaError_t band_sliced_launch(const float* q, const float* k, const float* v, float* out,
                               const AttnStrides& sq, const AttnStrides& sk,
                               const AttnStrides& sv, const AttnStrides& so, int B, int H, int T,
                               int dh, int window, bool vec, float scale, cudaStream_t s) {
  if (B * H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((T + kWideRows - 1) / kWideRows, B * H, (dh + kWideSlice - 1) / kWideSlice);
  band_sliced_kernel<NT><<<grid, kWideThreads, 0, s>>>(q, k, v, out, sq, sk, sv, so, H, T, dh,
                                                       window, vec, scale * 1.4426950408889634f);
  return cudaSuccess;
}

// Queues the band at any head width and window: band_wide_kernel up to 544
// columns (one block to 272, a cluster of two past it; k and v landed once
// where they are one operand), band_sliced_kernel past 544.
template <int NT = 5>
cudaError_t band_wide_launch(const float* q, const float* k, const float* v, float* out,
                             const AttnStrides& sq, const AttnStrides& sk, const AttnStrides& sv,
                             const AttnStrides& so, int B, int H, int T, int dh, int window,
                             bool vec, float scale, cudaStream_t s) {
  if (dh > 544)
    return band_sliced_launch<NT>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, window, vec, scale,
                                  s);
  WideFwdArgs a = wide_args(q, k, v, out, sq, sk, sv, so, H, T, dh, vec, scale);
  a.window = window;
  a.kv_same = k == v && sk.b == sv.b && sk.h == sv.h && sk.t == sv.t;
  a.qkv_same = a.kv_same && q == k && sq.b == sk.b && sq.h == sk.h && sq.t == sk.t;
  if (dh <= 144)
    return wide_fwd_launch<9, 1, kBandKeys, true>(band_wide_kernel<9, 1>, a, B, s);
  if (dh <= 256)
    return wide_fwd_launch<16, 1, kBandKeys, true>(band_wide_kernel<16, 1>, a, B, s);
  if (dh <= 272)
    return wide_fwd_launch<17, 1, kBandKeys, true>(band_wide_kernel<17, 1>, a, B, s);
  return wide_fwd_launch<17, 2, kBandKeys, true>(band_wide_kernel<17, 2>, a, B, s);
}

}  // namespace
