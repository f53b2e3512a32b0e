// One post-LN transformer encoder layer for training, float32: a forward
// with dropout at four sites and a backward that recomputes the layer from
// its input and returns dx and the 12 parameter gradients.
//
// Replaces: gesturediffusion_tpu/ops/pallas_encoder_train.py::_fwd_kernel
// and ::_bwd_kernel (with their shared _forward_core).  Same function:
//
//   qkv = x @ Wqkv^T + bqkv
//   o   = concat_h drop_0(softmax(q_h k_h^T / sqrt(dh))) v_h   (f32 softmax)
//   u   = x + drop_1(o @ Wo^T + bo);                y1 = LN1(u)
//   hd  = drop_2(gelu_tanh(y1 @ W1^T + b1))
//   v2  = y1 + drop_3(hd @ W2^T + b2);              out = LN2(v2)
//
// drop_s(z) = keep ? z * f32(1 / keep_prob) : 0, where keep compares the
// murmur3 fmix32 hash of the element's global index (uint32 wraparound),
// salted with (seed + site * 0x9E3779B9) | 1, against a threshold the
// caller computes in double precision.  The indices are those of the TPU
// kernels: ((b*H + h)*T + i)*T + j for the attention probabilities and
// row*width + col for the three [B*T, width] sites.  The masks are never
// stored: the backward redraws them.  The seed is read from device memory,
// so drawing it needs no host round trip.
//
// Weights arrive in PyTorch's [out, in] layout and their gradients leave in
// it.  What bounds it on an H100: at the training shape [64, 81, 256], ff
// 1024, the forward does ~8.58 GFLOP against ~13.8 MB of compulsory
// traffic and the backward ~25.7 GFLOP against ~22.2 MB: both are bound by
// arithmetic.  Every product runs on the tensor cores in 3xTF32
// (gemm_tf32x3.cuh: each f32 operand split into a TF32 big and small part,
// big.big + big.small + small.big accumulated in f32, f32-level error), so
// the bound is three TF32 passes at 495 TFLOP/s: ~0.052 and ~0.156 ms.
//
// Design: the TPU kernels kept a batch block in VMEM and accumulated the
// weight gradients in VMEM scratch across a sequential grid.  Here each
// entry point is a chain of launches on one stream:
//   * the products on gemm_ws.cuh's warp-specialized 3xTF32 GEMM (shared
//     with the inference layer): the forward products (A . W^T, also
//     recomputed in the backward) and the data gradients (dY . W) read each
//     weight's TF32 big and small parts, split once per weight and version
//     (W and, for the data gradients, W^T; ops/fused_encoder.py keeps both
//     with their tensor maps), landed by the copy engine into a swizzled
//     mbarrier ring by a producer warp and multiplied on wgmma by two
//     consumer warpgroups; the weight gradients (dY^T . X, a reduction over
//     all B*T rows) land both operands raw and a producer warpgroup splits
//     X's slices, transposed, into the consumers' layout.  A product whose
//     rows are not 16-byte aligned (train_routes) runs gemm_tf32x3.cuh's
//     GEMM, which takes either operand along K or transposed.  Both GEMMs
//     do the same arithmetic in the same order, so a product is the same bit
//     for bit on either route (gdt_encoder_layer_train_parent_* run the
//     chain with every product on gemm_tf32x3.cuh, for the comparison).
//     Every product here flushes its accumulator into an f32 sum every 128
//     of K (kFwdFlush, kDataGradFlush, kWeightGradFlush): unflushed, the
//     action-to-motion step's gradients stood ~8x further from the exact
//     ones than plain f32's, and the rot6d losses amplify that past the
//     step tolerance (tools/a2m_f64_check.py).  The
//     weight gradients split the row reduction into chunks that fill the
//     card and add the partial sums in a second pass, in a fixed order:
//     deterministic, no atomics.  Fused epilogues apply bias, GELU-tanh,
//     dropout, the GELU derivative and residuals;
//   * the flash attention forward of flash_attention.cuh with its site-0
//     dropout (and, in the backward's recompute, the rows' log-sum-exp),
//     and here a flash-style attention backward (FlashAttention-2 with
//     dropout) on mma.sync 3xTF32 (past a head width of 128 its outputs on
//     wgmma): neither holds a head's whole sequence, so T is bounded by
//     device memory only;
//   * LayerNorm forward (common.cuh) and backward row kernels (a warp per
//     row) and a column-sum kernel for the bias and LayerNorm-parameter
//     gradients: memory-bound passes.
// The backward's recomputed intermediates live in one workspace that the
// caller allocates for the call and frees after it; nothing but x, the
// weights and the seed is kept between forward and backward.  Two backward
// calls on the same inputs give bit-equal results.

#include <algorithm>

#include "common.cuh"
#include "flash_attention.cuh"
#include "gemm_tf32x3.cuh"
#include "gemm_ws.cuh"

namespace {

constexpr int kColX = 32, kColY = 16;  // column-sum block: 32 columns
constexpr int kColSplits = 16;         // row chunks of a column sum, at most
constexpr int kTargetBlocks = 264;     // two GEMM blocks per H100 SM
constexpr int kSumThreads = 256;

// ---- attention backward -------------------------------------------------- //
//
// With P the softmax of S = scale q k^T, Z the scaled site-0 keep mask
// (inv_keep or 0) and O = (Z o P) V the dropped output of the recompute,
// the FlashAttention-2 identities with dropout:
//   dP = Z o (dO V^T),  D_i = rowsum(dO_i o O_i) = sum_j P_ij dP_ij,
//   dS = P o (dP - D) * scale,  dV = (Z o P)^T dO,  dK = dS^T Q,  dQ = dS K.
// P is recomputed tile by tile from S and the forward's log-sum-exp (log2
// units): P = exp2(S log2(e) - lse).  Two passes, both deterministic (no
// atomics), both with a block of 4 warps keeping 64 rows of one (batch,
// head) resident, a warp 16 of them, and streaming tiles of the other side
// through a 3-stage cp.async ring:
//   * the dK/dV pass keeps 64 keys and walks the query tiles.  It computes
//     S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out as
//     accumulator fragments whose columns are queries; under the k
//     permutation of gemm_tf32x3.cuh those are exactly the A fragments of
//     dV += (Z o P)^T dO and dK += dS^T Q (the trick that keeps P in
//     registers for P V in the forward);
//   * the dQ pass keeps 64 queries and walks the key tiles: S = Q K^T,
//     dP = dO V^T, then dQ += dS K from the dS accumulator.
// The dQ pass recomputes S and dP: 7 tile products instead of FA-2's 5,
// the price of summing dQ without atomics or [T, T] partials.  Every
// product is mma.sync.m16n8k8 TF32 in three passes.  The mask index is
// ((b*H + h)*T + i)*T + j at the physical query i and key j of each
// accumulator element (the S accumulator of row g holds keys 2t, 2t + 1).
// Rows are padded to DHP + 4 floats: the float2 reads along the head width
// (row g, columns 2t, 2t + 1) and the scalar reads down it (rows 2t, 2t +
// 1, column g) are then both free of bank conflicts for DHP >= 32.  A warp
// whose 16 resident rows all lie past T skips the arithmetic; the ragged
// tile of the other side is masked (p = 0).  Any head width dh <= 128 runs
// at the padded width DHP (the next multiple of 16), as the flash forward
// does: staged columns dh .. DHP - 1 are zero, so the padded columns of dQ,
// dK and dV are zero, and they are never stored.  Wider heads take the
// wide passes below (two warpgroups over the whole width, a cluster of two
// past 272 columns), and past 544 the sliced ones (the products over the
// whole width from device memory, one 128-column slice of dQ, dK and dV a
// block).

constexpr int kBwdThreads = 128;  // 4 warps of 16 resident rows
constexpr int kBwdRows = 64;      // resident rows a block

template <int DHP>
struct BwdTile {
  static constexpr int LD = DHP + 4;              // row stride (floats)
  static constexpr int BN = DHP <= 64 ? 32 : 16;  // streamed rows a tile
  static constexpr int kStages = 3;
  // resident [64][LD] x 2, the ring [kStages][BN][LD] x 2, lse and D of the
  // dK/dV pass's query tiles [kStages][BN] x 2
  static constexpr size_t smem =
      ((size_t)2 * kBwdRows * LD + (size_t)2 * kStages * BN * LD + 2 * kStages * BN) *
      sizeof(float);
};

// A fragment of rows r, r + 8 and k slice c of a [rows][LD] tile, split
template <int LD>
__device__ __forceinline__ void frag_a(const float* x, int r, int c, int t,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(x + r * LD + 8 * c + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(x + (r + 8) * LD + 8 * c + 2 * t);
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

// B fragment of X^T (k along X's rows' width): b0 = X[8n + g][8c + 2t],
// b1 = X[8n + g][8c + 2t + 1]
template <int LD>
__device__ __forceinline__ void frag_bt(const float* x, int n, int c, int g, int t,
                                        uint32_t (&big)[2], uint32_t (&small)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(x + (8 * n + g) * LD + 8 * c + 2 * t);
  split_tf32(v.x, big[0], small[0]);
  split_tf32(v.y, big[1], small[1]);
}

// B fragment of X (k along X's rows): b0 = X[8n + 2t][8d + g],
// b1 = X[8n + 2t + 1][8d + g]
template <int LD>
__device__ __forceinline__ void frag_b(const float* x, int n, int d, int g, int t,
                                       uint32_t (&big)[2], uint32_t (&small)[2]) {
  const float* p = x + (8 * n + 2 * t) * LD + 8 * d + g;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[LD], big[1], small[1]);
}

// the accumulator of an n8 tile as the A fragment of a product whose k runs
// along its columns (a0 = row g col 2t, a1 = row g + 8 col 2t, a2, a3 the
// columns 2t + 1)
__device__ __forceinline__ void acc_a(const float (&d)[4], uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
  split_tf32(d[0], big[0], small[0]);
  split_tf32(d[2], big[1], small[1]);
  split_tf32(d[1], big[2], small[2]);
  split_tf32(d[3], big[3], small[3]);
}

// rows [r0, r0 + n) of a head's [T, dh] operand (row stride ld floats) into
// a [n][LD] tile, rows past T and columns past dh zero-filled; 16 bytes a
// copy where `vec` (dh, ld and the head offsets multiples of 4)
template <int DHP>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t ld, int r0,
                                          int n, int T, int dh, bool vec) {
  constexpr int C4 = DHP / 4, LD = BwdTile<DHP>::LD;
  if (vec) {
    for (int f = threadIdx.x; f < n * C4; f += kBwdThreads) {
      const int r = f / C4, c = (f % C4) * 4;
      const bool in = r0 + r < T && c < dh;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * ld + c : src, in);
    }
  } else {
    copy_rows_scalar<DHP, LD>(dst, src, ld, r0, n, T, dh);
  }
}

// dK and dV of 64 keys of one (batch, head): grid (ceil(T / 64), B * H).
// qkv, dqkv [B*T, 3D]; dout [B*T, D]; lse, dvec [B*H, T].
template <int DHP, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                     float scale, Drop drop) {
  using Tile = BwdTile<DHP>;
  constexpr int LD = Tile::LD, BN = Tile::BN, kStages = Tile::kStages;
  constexpr int KC = DHP / 8;  // k slices of S^T and dP^T
  constexpr int NS = BN / 8;   // query slices of a tile
  constexpr int NO = DHP / 8;  // n8 tiles of dK and dV
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [64][LD]
  float* Vs = Ks + kBwdRows * LD;         // [64][LD]
  float* Qs = Vs + kBwdRows * LD;         // [kStages][BN][LD]
  float* Os = Qs + kStages * BN * LD;     // dO: [kStages][BN][LD]
  float* Ls = Os + kStages * BN * LD;     // lse: [kStages][BN]
  float* Ds = Ls + kStages * BN;          // D: [kStages][BN]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t ld3 = 3 * (size_t)D;
  const float* qb = qkv + (size_t)b * T * ld3 + h * dh;
  const float* ob = dout + (size_t)b * T * D + h * dh;
  const float* lb = lse + (size_t)bh * T;
  const float* db = dvec + (size_t)bh * T;
  const int k0 = blockIdx.x * kBwdRows;
  const int ntiles = (T + BN - 1) / BN;

  auto load_tile = [&](int buf, int j0) {
    load_rows<DHP>(Qs + buf * BN * LD, qb, ld3, j0, BN, T, dh, vec);
    load_rows<DHP>(Os + buf * BN * LD, ob, D, j0, BN, T, dh, vec);
    if (threadIdx.x < BN) {
      const int j = j0 + threadIdx.x;
      Ls[buf * BN + threadIdx.x] = j < T ? lb[j] : 0.0f;
      Ds[buf * BN + threadIdx.x] = j < T ? db[j] : 0.0f;
    }
  };
  load_rows<DHP>(Ks, qb + D, ld3, k0, kBwdRows, T, dh, vec);
  load_rows<DHP>(Vs, qb + 2 * D, ld3, k0, kBwdRows, T, dh, vec);
  load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, BN);
  cp_async_commit();

  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  const int kr = warp * 16 + g;  // this thread's keys k0 + kr, k0 + kr + 8
  const bool active = k0 + warp * 16 < T;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();     // ... for every thread; tile it - 1 is read
    if (it + 2 < ntiles) load_tile((it + 2) % kStages, (it + 2) * BN);
    cp_async_commit();
    if (!active) continue;
    const int buf = it % kStages, j0 = it * BN;
    const float* qs = Qs + buf * BN * LD;
    const float* os = Os + buf * BN * LD;
    const float* ls = Ls + buf * BN;
    const float* ds = Ds + buf * BN;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BN queries for this warp
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t kbig[4], ksmall[4], vbig[4], vsmall[4];
      frag_a<LD>(Ks, kr, c, t, kbig, ksmall);
      frag_a<LD>(Vs, kr, c, t, vbig, vsmall);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bbig[2], bsmall[2];
        frag_bt<LD>(qs, n, c, g, t, bbig, bsmall);
        mma_tf32x3(st[n], kbig, ksmall, bbig, bsmall);
        frag_bt<LD>(os, n, c, g, t, bbig, bsmall);
        mma_tf32x3(dpt[n], vbig, vsmall, bbig, bsmall);
      }
    }

    // element e of slice n: key k0 + kr + 8 (e >> 1), query j0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 8 * n + 2 * t + (e & 1);
        const float p = j0 + jl < T ? exp2f(st[n][e] * scale_log2 - ls[jl]) : 0.0f;
        float pd = p, dp = dpt[n][e];
        if constexpr (DROP) {
          const uint32_t key = k0 + kr + 8 * (e >> 1);
          const uint32_t idx = drop.attn_base + (static_cast<uint32_t>(bh) * T + j0 + jl) * T + key;
          const bool keep = hash_u32(idx, salt) < drop.thresh;
          pd = keep ? p * drop.inv_keep : 0.0f;
          dp = keep ? dp * drop.inv_keep : 0.0f;
        }
        st[n][e] = pd;                        // (Z o P)^T
        dpt[n][e] = p * (dp - ds[jl]) * scale;  // dS^T
      }

    // dV += (Z o P)^T dO, dK += dS^T Q
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t pbig[4], psmall[4], sbig[4], ssmall[4];
      acc_a(st[n], pbig, psmall);
      acc_a(dpt[n], sbig, ssmall);
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        uint32_t bbig[2], bsmall[2];
        frag_b<LD>(os, n, d, g, t, bbig, bsmall);
        mma_tf32x3(dv[d], pbig, psmall, bbig, bsmall);
        frag_b<LD>(qs, n, d, g, t, bbig, bsmall);
        mma_tf32x3(dk[d], sbig, ssmall, bbig, bsmall);
      }
    }
  }

  const int r0 = k0 + kr, r1 = r0 + 8;
  float* dkb = dqkv + (size_t)b * T * ld3 + D + h * dh + 2 * t;
  float* dvb = dkb + D;
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    const int col = 8 * d + 2 * t;
    store_pair(dkb + r0 * ld3 + 8 * d, dk[d][0], dk[d][1], r0 < T, col, dh, vec);
    store_pair(dvb + r0 * ld3 + 8 * d, dv[d][0], dv[d][1], r0 < T, col, dh, vec);
    store_pair(dkb + r1 * ld3 + 8 * d, dk[d][2], dk[d][3], r1 < T, col, dh, vec);
    store_pair(dvb + r1 * ld3 + 8 * d, dv[d][2], dv[d][3], r1 < T, col, dh, vec);
  }
}

// dQ of 64 queries of one (batch, head): grid (ceil(T / 64), B * H).
template <int DHP, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dvec,
                   float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                   float scale, Drop drop) {
  using Tile = BwdTile<DHP>;
  constexpr int LD = Tile::LD, BN = Tile::BN, kStages = Tile::kStages;
  constexpr int KC = DHP / 8;  // k slices of S and dP
  constexpr int NS = BN / 8;   // key slices of a tile
  constexpr int NO = DHP / 8;  // n8 tiles of dQ
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [64][LD]
  float* Os = Qs + kBwdRows * LD;         // dO: [64][LD]
  float* Ks = Os + kBwdRows * LD;         // [kStages][BN][LD]
  float* Vs = Ks + kStages * BN * LD;     // [kStages][BN][LD]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t ld3 = 3 * (size_t)D;
  const float* qb = qkv + (size_t)b * T * ld3 + h * dh;
  const int q0 = blockIdx.x * kBwdRows;
  const int ntiles = (T + BN - 1) / BN;

  auto load_tile = [&](int buf, int j0) {
    load_rows<DHP>(Ks + buf * BN * LD, qb + D, ld3, j0, BN, T, dh, vec);
    load_rows<DHP>(Vs + buf * BN * LD, qb + 2 * D, ld3, j0, BN, T, dh, vec);
  };
  load_rows<DHP>(Qs, qb, ld3, q0, kBwdRows, T, dh, vec);
  load_rows<DHP>(Os, dout + (size_t)b * T * D + h * dh, D, q0, kBwdRows, T, dh, vec);
  load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, BN);
  cp_async_commit();

  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  const int qr = warp * 16 + g;  // this thread's queries q0 + qr, q0 + qr + 8
  const int r0 = q0 + qr, r1 = r0 + 8;
  const bool active = q0 + warp * 16 < T;
  const float lse_r[2] = {r0 < T ? lse[(size_t)bh * T + r0] : 0.0f,
                          r1 < T ? lse[(size_t)bh * T + r1] : 0.0f};
  const float d_r[2] = {r0 < T ? dvec[(size_t)bh * T + r0] : 0.0f,
                        r1 < T ? dvec[(size_t)bh * T + r1] : 0.0f};
  float dq[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();     // ... for every thread; tile it - 1 is read
    if (it + 2 < ntiles) load_tile((it + 2) % kStages, (it + 2) * BN);
    cp_async_commit();
    if (!active) continue;
    const int j0 = it * BN;
    const float* ks = Ks + (it % kStages) * BN * LD;
    const float* vs = Vs + (it % kStages) * BN * LD;

    // S = Q K^T and dP = dO V^T: 16 queries x BN keys for this warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t qbig[4], qsmall[4], obig[4], osmall[4];
      frag_a<LD>(Qs, qr, c, t, qbig, qsmall);
      frag_a<LD>(Os, qr, c, t, obig, osmall);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bbig[2], bsmall[2];
        frag_bt<LD>(ks, n, c, g, t, bbig, bsmall);
        mma_tf32x3(s[n], qbig, qsmall, bbig, bsmall);
        frag_bt<LD>(vs, n, c, g, t, bbig, bsmall);
        mma_tf32x3(dp[n], obig, osmall, bbig, bsmall);
      }
    }

    // element e of slice n: query r0 + 8 (e >> 1), key j0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * n + 2 * t + (e & 1), hi = e >> 1;
        const float p = key < T ? exp2f(s[n][e] * scale_log2 - lse_r[hi]) : 0.0f;
        float dpz = dp[n][e];
        if constexpr (DROP) {
          const uint32_t idx =
              drop.attn_base + (static_cast<uint32_t>(bh) * T + r0 + 8 * hi) * T + key;
          dpz = dropped(dpz, idx, salt, drop);
        }
        s[n][e] = p * (dpz - d_r[hi]) * scale;  // dS
      }

    // dQ += dS K
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t sbig[4], ssmall[4];
      acc_a(s[n], sbig, ssmall);
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        uint32_t bbig[2], bsmall[2];
        frag_b<LD>(ks, n, d, g, t, bbig, bsmall);
        mma_tf32x3(dq[d], sbig, ssmall, bbig, bsmall);
      }
    }
  }

  float* dqb = dqkv + (size_t)b * T * ld3 + h * dh + 2 * t;
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    const int col = 8 * d + 2 * t;
    store_pair(dqb + r0 * ld3 + 8 * d, dq[d][0], dq[d][1], r0 < T, col, dh, vec);
    store_pair(dqb + r1 * ld3 + 8 * d, dq[d][2], dq[d][3], r1 < T, col, dh, vec);
  }
}

// ---- the attention backward past a head width of 128 ---------------------- //
//
// The same function as the passes above (P from the forward's log2-unit
// LSE, D = rowsum(dO o O), the site-0 mask at each element's physical
// (query, key) index counted from drop.attn_base, keys >= T masked, 3xTF32
// products with f32 sums) for heads of 129 to 544: attn_bwd_dq_wide_kernel
// and attn_bwd_dkdv_wide_kernel, one body, after D's warp-per-row
// attn_bwd_rowdot_wide_kernel.  What bounds them on an H100: at [64, 4, 81,
// 256] the five products are 4.3 GFLOP, 0.026 ms in three TF32 passes,
// against 170 MB of q, k, v, o, dO and the LSE read and dq, dk, dv written,
// 0.051 ms at 3.35 TB/s: bytes.  In practice one block an SM (8 warps)
// leaves each tile's steps latency-bound.  The design, wide_attention.cuh's
// forward turned round:
//   * a block is 64 resident rows of one (batch, head) (queries for dQ,
//     keys for dK and dV), two warpgroups of 4 warps (16 rows a warp), and
//     the whole width up to 272 columns; past that a cluster of two blocks,
//     each a share of 272 columns.  The block index runs over (batch *
//     head, row tile) in grid.x, so B * H is not bounded by grid.y;
//   * the other side streams in tiles of 8 rows (keys for dQ, queries for
//     dK and dV) landed by cp.async, the next tile in flight while one is
//     used, and split into big and small once a block, into wgmma's K-major
//     core matrices along the tile's rows, k permuted (as the forward's V);
//   * the score tiles (S and dP for dQ, S^T and dP^T for dK and dV) are
//     computed once a block: each warp takes its 16 rows over its
//     warpgroup's half of the share on mma.sync (B fragments read from the
//     split tiles, two accumulators a product, even and odd k8 steps), and
//     the partial sums meet in shared memory, each block's two warpgroups
//     added first, then in a cluster the blocks' sums in rank order through
//     distributed shared memory: every warpgroup holds the same bits.  A
//     warp whose 16 rows all lie past T skips its products;
//   * the outputs (dQ += dS K; dV += (Z o P)^T dO and dK += dS^T Q) run on
//     wgmma m64nNk8, N the warpgroup's 72, 128 or 136 columns, A the score
//     accumulator (its A fragment under the k permutation), B the split
//     tile; no atomics, and the sums are taken in a fixed order: two calls
//     give the same bits.
// The budget: 64 resident rows of two operands held split as big and small
// at 256 columns would take 256 KB, past the 227 KB a block may use.  They
// are held raw (rows of w + 8 floats, = 8 mod 16: conflict-free float2
// fragment reads) and split a k8 step at a time as the forward splits q;
// with them the tiles of 8 rows fit: 193 KB at dh 256, 204 KB a block at
// 272 and 520.  Rows past T and columns past dh read as zeros; only real
// rows and columns are stored.  Past 544 the sliced passes below run.
// Tried on an H100 and not kept (tools/kernel_variants.py's wbwd_*
// ablations locate the time: at [64, 81, 1024] the score products are ~35%
// of the passes, the split and the loads ~12% each, the output wgmmas ~6%):
// the dQ pass with Q in registers (as the forward's q) and 16-key tiles,
// both passes with two staged tiles in flight and the dK/dV tile's LSE and
// D landed by cp.async: 3-5% slower (the dQ pass spilled at 255 registers).

constexpr int kWbKeys = 8;  // streamed rows a tile

// The shared memory of the wide passes at a block's share w <= 16 KS, in
// floats: the two resident operands' rows [64][w + 8] and the streamed
// tile's [BK][w + 8] raw; the streamed tile of both operands split, big and
// small [2 WO][BK] each (WO = 8 KS, a warpgroup's columns); the partial
// sums of the two score products [2][8 warps][32 lanes][4].
template <int KS>
size_t wide_bwd_floats(int w) {
  constexpr size_t BK = kWbKeys;
  return 2 * (kWgRows + BK) * (w + 8) + 4 * 16 * KS * BK + 2 * 8 * 32 * 4;
}

// Rows [r0, r0 + n) of a head's share (row stride ld floats, dw real
// columns of w) into n shared rows of ldd floats: 16 bytes a copy where
// `vec`, else one float; rows past T and columns past dw zero-filled
__device__ __forceinline__ void wide_rows_async(float* dst, int ldd, const float* src,
                                                long long ld, int r0, int n, int T, int dw,
                                                int w, bool vec) {
  if (vec) {
    const int w4 = w / 4;
    for (int f = threadIdx.x; f < n * w4; f += blockDim.x) {
      const int rr = f / w4, cc = (f % w4) * 4;
      const bool in = r0 + rr < T && cc < dw;
      cp_async16(dst + rr * ldd + cc, in ? src + (r0 + rr) * ld + cc : src, in);
    }
  } else {
    wide_copy_scalar(dst, ldd, src, ld, r0, n, T, dw, w);
  }
}

// The landed tile x [kWbKeys][ld] into big and small tiles, K-major along
// its rows: warpgroup c's columns 8 ks c + nn (nn < WO, zero past its half
// of the share) at c WO BK, core 0 of the k8 step rows 0, 2, 4, 6, core 1
// rows 1, 3, 5, 7
template <int WO>
__device__ __forceinline__ void wide_split_rows(float* big, float* small, const float* x, int ld,
                                                int ks) {
  for (int f = threadIdx.x; f < 2 * WO * 2; f += kWgThreads) {
    const int n = f % (2 * WO), core = f / (2 * WO);
    const int wg = n / WO, nn = n % WO;
    const float* xs = x + core * ld + 8 * ks * wg + nn;
    const float4 v = nn < 8 * ks ? make_float4(xs[0], xs[2 * ld], xs[4 * ld], xs[6 * ld])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split4(big, small, wg * WO * kWbKeys + (nn >> 3) * 64 + core * 32 + (nn & 7) * 4, v);
  }
}

// the split A fragment of rows r, r + 8 (row stride ld) at columns 2t, 2t
// + 1 of p (k permuted: a0, a1 column 2t, a2, a3 column 2t + 1)
__device__ __forceinline__ void wide_frag_a(const float* p, int ld, uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ld);
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

// d += a . b in 3xTF32 on the four floats of an m16n8k8 tile: b's
// fragments from a split tile of wide_split_rows (b0 at p, b1 at p + 4)
__device__ __forceinline__ void wide_mma_x3(float* d, const uint32_t (&a_big)[4],
                                            const uint32_t (&a_small)[4], const float* big,
                                            const float* small) {
  const uint32_t bb[2] = {__float_as_uint(big[0]), __float_as_uint(big[4])};
  const uint32_t bs[2] = {__float_as_uint(small[0]), __float_as_uint(small[4])};
  mma_tf32_at(d, a_big, bs);
  mma_tf32_at(d, a_small, bb);
  mma_tf32_at(d, a_big, bb);
}

// d += a . b over a warpgroup's WO columns, three passes: a the split score
// accumulator (its A fragment), b the split tile of a warpgroup at big,
// small
template <int WO>
__device__ __forceinline__ void wide_out_x3(float* d, const uint32_t (&a_big)[4],
                                            const uint32_t (&a_small)[4], const float* big,
                                            const float* small) {
  const uint64_t db = wgmma_desc(big, 128, 256), ds = wgmma_desc(small, 128, 256);
  wgmma_tf32<WO>(d, a_big, ds);
  wgmma_tf32<WO>(d, a_small, db);
  wgmma_tf32<WO>(d, a_big, db);
}

// One wide pass: DQ, dQ of 64 queries (resident Q and dO, streamed K and
// V); else dK and dV of 64 keys (resident K and V, streamed Q and dO).
// grid (B * H * ceil(T / 64), CL), 256 threads, clusters of the CL blocks
// of a row tile; block `rank` takes the share [rank w, (rank + 1) w) of the
// padded width, warpgroup c its half [8 ks c, 8 ks (c + 1)) for the scores
// and the outputs.  qkv, dqkv [B*T, 3D]; dout [B*T, D]; lse, dvec [B*H, T].
template <bool DQ, bool DROP, int KS, int CL>
__device__ __forceinline__ void attn_bwd_wide(const float* __restrict__ qkv,
                                              const float* __restrict__ dout,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ dvec,
                                              float* __restrict__ dqkv, int T, int D, int H,
                                              int dh, bool vec, float scale, Drop drop) {
  constexpr int BK = kWbKeys, WO = 8 * KS;
  extern __shared__ __align__(16) float smem[];
  const int w = (dh + 16 * CL - 1) / (16 * CL) * 16, ks = w / 16;
  const int ld = w + 8;
  const uint32_t rank = CL > 1 ? blockIdx.y : 0;
  const int col0 = rank * w, dw = dh - col0;  // the share's first column, its real columns
  float* res1 = smem;               // resident Q (dQ) or K: [64][ld]
  float* res2 = res1 + kWgRows * ld;  // resident dO or V
  float* raw1 = res2 + kWgRows * ld;  // streamed K or Q as it lands: [BK][ld]
  float* raw2 = raw1 + BK * ld;       // streamed V or dO
  float* big1 = raw2 + BK * ld;       // streamed K or Q split: [2 WO][BK]
  float* small1 = big1 + 2 * WO * BK;
  float* big2 = small1 + 2 * WO * BK;  // streamed V or dO split
  float* small2 = big2 + 2 * WO * BK;
  float4* xch = reinterpret_cast<float4*>(small2 + 2 * WO * BK);  // [2][8][32]
  const int rtiles = (T + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / rtiles, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int c = warp >> 2, wi = warp & 3;  // warpgroup, warp in it
  const int row0 = (blockIdx.x % rtiles) * kWgRows;
  const int r0 = row0 + 16 * wi + g, r1 = r0 + 8;  // this thread's resident rows
  const long long ld3 = 3 * (long long)D;
  const float* qb = qkv + b * T * ld3 + h * dh + col0;
  const float* ob = dout + (long long)b * T * D + h * dh + col0;
  const float* s1 = DQ ? qb + D : qb;           // streamed K or Q
  const float* s2 = DQ ? qb + 2 * D : ob;       // streamed V or dO
  const long long ls2 = DQ ? ld3 : D;
  wide_rows_async(res1, ld, DQ ? qb : qb + D, ld3, row0, kWgRows, T, dw, w, vec);
  wide_rows_async(res2, ld, DQ ? ob : qb + 2 * D, DQ ? D : ld3, row0, kWgRows, T, dw, w, vec);
  auto load_tile = [&](int j0) {
    wide_rows_async(raw1, ld, s1, ld3, j0, BK, T, dw, w, vec);
    wide_rows_async(raw2, ld, s2, ls2, j0, BK, T, dw, w, vec);
  };
  load_tile(0);
  cp_async_commit();

  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  const float* lb = lse + (size_t)bh * T;
  const float* db = dvec + (size_t)bh * T;
  // dQ: the LSE and D of the resident rows
  float lse_r[2] = {0.0f, 0.0f}, d_r[2] = {0.0f, 0.0f};
  if constexpr (DQ) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r0 + 8 * hi;
      lse_r[hi] = r < T ? lb[r] : 0.0f;
      d_r[hi] = r < T ? db[r] : 0.0f;
    }
  }
  // dQ, or dV and dK, over this warpgroup's columns
  float acc1[4 * KS], acc2[DQ ? 1 : 4 * KS];
#pragma unroll
  for (int i = 0; i < 4 * KS; ++i) acc1[i] = 0.0f;
  if constexpr (!DQ)
#pragma unroll
    for (int i = 0; i < 4 * KS; ++i) acc2[i] = 0.0f;
  // this warp's fragments of the resident rows (16 wi + g, + 8) and of the
  // split tiles (row g of the tile), at its warpgroup's half
  const float* fa1 = res1 + (16 * wi + g) * ld + 8 * ks * c + 2 * t;
  const float* fa2 = res2 + (16 * wi + g) * ld + 8 * ks * c + 2 * t;
  const int fb = c * WO * BK + (g & 1) * 32 + 8 * t + (g >> 1);
  const bool live = row0 + 16 * wi < T;  // the warp holds a real row

  const int ntiles = (T + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();  // the tile (and the resident rows) have landed; the last tile is read
    // ... and in a cluster the peer has read this block's sums of the last
    // tile: it used the values before it arrived, so no release is needed
    if constexpr (CL > 1) cluster_sync_relaxed();
    wide_split_rows<WO>(big1, small1, raw1, ld, ks);
    wide_split_rows<WO>(big2, small2, raw2, ld, ks);
    fence_proxy_async();
    __syncthreads();  // the split tiles are visible to wgmma; the raw tiles are free
    if (it + 1 < ntiles) load_tile(j0 + BK);
    cp_async_commit();
    // dK/dV: the LSE and D of this thread's streamed queries j0 + 2t, + 1
    float lse_j[2] = {0.0f, 0.0f}, d_j[2] = {0.0f, 0.0f};
    if constexpr (!DQ) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 2 * t + e;
        lse_j[e] = j < T ? lb[j] : 0.0f;
        d_j[e] = j < T ? db[j] : 0.0f;
      }
    }

    // this warp's part of the two score tiles (S and dP, or S^T and dP^T):
    // its 16 rows, the tile's 8, its warpgroup's half of the share; even
    // and odd k8 steps in two accumulators.  A warp whose rows all lie past
    // T skips it (those rows are never stored and reach no other row); the
    // loop without a bound check where the half is KS steps wide (every
    // width but those between the instantiations), so that its shared
    // loads run ahead of the products
    float s[2][4], p2[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = p2[0][e] = p2[1][e] = 0.0f;
    auto scores = [&](auto whole) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        if (!decltype(whole)::value && i >= ks) break;
        uint32_t x_big[4], x_small[4], y_big[4], y_small[4];
        wide_frag_a(fa1 + 8 * i, ld, x_big, x_small);
        wide_frag_a(fa2 + 8 * i, ld, y_big, y_small);
        const int off = fb + 64 * i;
        wide_mma_x3(s[i & 1], x_big, x_small, big1 + off, small1 + off);
        wide_mma_x3(p2[i & 1], y_big, y_small, big2 + off, small2 + off);
      }
    };
    if (live) {
      if (ks == KS)
        scores(std::true_type{});
      else
        scores(std::false_type{});
    }

    // the partial sums, added in the same order by every warpgroup of the
    // cluster: a block's two first, then the blocks' sums in rank order
    xch[warp * 32 + lane] =
        make_float4(s[0][0] + s[1][0], s[0][1] + s[1][1], s[0][2] + s[1][2], s[0][3] + s[1][3]);
    xch[(8 + warp) * 32 + lane] = make_float4(p2[0][0] + p2[1][0], p2[0][1] + p2[1][1],
                                              p2[0][2] + p2[1][2], p2[0][3] + p2[1][3]);
    __syncthreads();
    float sc[4], dp[4];
    {
      const float4 x0 = xch[wi * 32 + lane], x1 = xch[(4 + wi) * 32 + lane];
      const float4 y0 = xch[(8 + wi) * 32 + lane], y1 = xch[(12 + wi) * 32 + lane];
      sc[0] = x0.x + x1.x, sc[1] = x0.y + x1.y, sc[2] = x0.z + x1.z, sc[3] = x0.w + x1.w;
      dp[0] = y0.x + y1.x, dp[1] = y0.y + y1.y, dp[2] = y0.z + y1.z, dp[3] = y0.w + y1.w;
    }
    if constexpr (CL > 1) {
      __syncthreads();  // both warpgroups have read the partials
      if (c == 0) {
        xch[wi * 32 + lane] = make_float4(sc[0], sc[1], sc[2], sc[3]);
        xch[(8 + wi) * 32 + lane] = make_float4(dp[0], dp[1], dp[2], dp[3]);
      }
      cluster_sync();
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), y = a;
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        const bool own = r == static_cast<int>(rank);
        const float4 x = own ? make_float4(sc[0], sc[1], sc[2], sc[3])
                             : ld_cluster(xch + wi * 32 + lane, r);
        const float4 z = own ? make_float4(dp[0], dp[1], dp[2], dp[3])
                             : ld_cluster(xch + (8 + wi) * 32 + lane, r);
        a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
        y.x += z.x, y.y += z.y, y.z += z.z, y.w += z.w;
      }
      sc[0] = a.x, sc[1] = a.y, sc[2] = a.z, sc[3] = a.w;
      dp[0] = y.x, dp[1] = y.y, dp[2] = y.z, dp[3] = y.w;
    }

    // element e: resident row r0 + 8 (e >> 1), streamed row j0 + 2t + (e & 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e >> 1, j = j0 + 2 * t + (e & 1), r = r0 + 8 * hi;
      if constexpr (DQ) {  // key j: dS
        const float p = j < T ? exp2f(sc[e] * scale_log2 - lse_r[hi]) : 0.0f;
        float dpz = dp[e];
        if constexpr (DROP)
          dpz = dropped(dpz, drop.attn_base + (static_cast<uint32_t>(bh) * T + r) * T + j, salt,
                        drop);
        sc[e] = p * (dpz - d_r[hi]) * scale;
      } else {  // query j, key r: (Z o P)^T and dS^T
        const float p = j < T ? exp2f(sc[e] * scale_log2 - lse_j[e & 1]) : 0.0f;
        float pd = p, dpz = dp[e];
        if constexpr (DROP) {
          const uint32_t idx = drop.attn_base + (static_cast<uint32_t>(bh) * T + j) * T + r;
          const bool keep = hash_u32(idx, salt) < drop.thresh;
          pd = keep ? p * drop.inv_keep : 0.0f;
          dpz = keep ? dpz * drop.inv_keep : 0.0f;
        }
        sc[e] = pd;
        dp[e] = j < T ? p * (dpz - d_j[e & 1]) * scale : 0.0f;
      }
    }

    // the outputs on wgmma: dQ += dS K; dV += (Z o P)^T dO, dK += dS^T Q
    uint32_t a_big[4], a_small[4];
    acc_a(sc, a_big, a_small);
    const int wg_off = c * WO * BK;
    reg_fence(acc1);
    if constexpr (!DQ) reg_fence(acc2);
    wgmma_fence();
    if constexpr (DQ) {
      wide_out_x3<WO>(acc1, a_big, a_small, big1 + wg_off, small1 + wg_off);
    } else {
      uint32_t b_big[4], b_small[4];
      acc_a(dp, b_big, b_small);
      wide_out_x3<WO>(acc1, a_big, a_small, big2 + wg_off, small2 + wg_off);
      wide_out_x3<WO>(acc2, b_big, b_small, big1 + wg_off, small1 + wg_off);
      reg_fence(b_big);
      reg_fence(b_small);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc1);
    if constexpr (!DQ) reg_fence(acc2);
    reg_fence(a_big);
    reg_fence(a_small);
  }

  if constexpr (CL > 1) cluster_sync();  // the peers have read this block's partials
  float* out1 = dqkv + b * T * ld3 + h * dh + col0 + (DQ ? 0 : 2 * D);  // dQ or dV
  float* out2 = out1 - D;                                                // dK
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    if (i >= ks) break;
    const int col = 8 * (ks * c + i) + 2 * t;
    store_pair(out1 + r0 * ld3 + col, acc1[4 * i], acc1[4 * i + 1], r0 < T, col, dw, vec);
    store_pair(out1 + r1 * ld3 + col, acc1[4 * i + 2], acc1[4 * i + 3], r1 < T, col, dw, vec);
    if constexpr (!DQ) {
      store_pair(out2 + r0 * ld3 + col, acc2[4 * i], acc2[4 * i + 1], r0 < T, col, dw, vec);
      store_pair(out2 + r1 * ld3 + col, acc2[4 * i + 2], acc2[4 * i + 3], r1 < T, col, dw, vec);
    }
  }
}

template <bool DROP, int KS, int CL>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dq_wide_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                        float scale, Drop drop) {
  attn_bwd_wide<true, DROP, KS, CL>(qkv, dout, lse, dvec, dqkv, T, D, H, dh, vec, scale, drop);
}

template <bool DROP, int KS, int CL>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dkdv_wide_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                          float scale, Drop drop) {
  attn_bwd_wide<false, DROP, KS, CL>(qkv, dout, lse, dvec, dqkv, T, D, H, dh, vec, scale, drop);
}

// The dQ pass past a head width of 544: grid (ceil(T / 64), B * H,
// ceil(dh / 128)), each block one 128-column slice of dQ.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
attn_bwd_dq_sliced_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                        float scale, Drop drop) {
  constexpr int NS = kWideKeys / 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, c0 = blockIdx.z * kWideSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int q0 = blockIdx.x * kWideRows + warp * 16;
  if (q0 >= T) return;
  const int r0 = q0 + (lane >> 2);
  const long long ld3 = 3 * (long long)D;
  const float* qb = qkv + b * T * ld3 + h * dh;
  const float* ob = dout + (long long)b * T * D + h * dh;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = r0 + 8 * hi;
    lse_r[hi] = r < T ? lse[(size_t)bh * T + r] : 0.0f;
    d_r[hi] = r < T ? dvec[(size_t)bh * T + r] : 0.0f;
  }
  float dq[kWideNO][4];
#pragma unroll
  for (int d = 0; d < kWideNO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.0f;

  for (int j0 = 0; j0 < T; j0 += kWideKeys) {
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    wide_scores<NS>(s, qb, ld3, q0, qb + D, ld3, j0, T, dh, vec);     // S = Q K^T
    wide_scores<NS>(dp, ob, D, q0, qb + 2 * D, ld3, j0, T, dh, vec);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * n + 2 * t + (e & 1), hi = e >> 1;
        const float p = key < T ? exp2f(s[n][e] * scale_log2 - lse_r[hi]) : 0.0f;
        float dpz = dp[n][e];
        if constexpr (DROP) {
          const uint32_t idx =
              drop.attn_base + (static_cast<uint32_t>(bh) * T + r0 + 8 * hi) * T + key;
          dpz = dropped(dpz, idx, salt, drop);
        }
        s[n][e] = p * (dpz - d_r[hi]) * scale;  // dS
      }
    wide_pv<NS>(dq, s, qb + D, ld3, j0, c0, T, dh);  // dQ += dS K
  }
  wide_store(dqkv + b * T * ld3 + h * dh, ld3, q0, c0, dq, T, dh, vec);
}

// The dK/dV pass past a head width of 544, as the dQ pass.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
attn_bwd_dkdv_sliced_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dqkv, int T, int D, int H, int dh, bool vec,
                          float scale, Drop drop) {
  constexpr int NS = kWideKeys / 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, c0 = blockIdx.z * kWideSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kWideRows + warp * 16;  // this warp's keys k0 .. k0 + 15
  if (k0 >= T) return;
  const long long ld3 = 3 * (long long)D;
  const float* qb = qkv + b * T * ld3 + h * dh;
  const float* ob = dout + (long long)b * T * D + h * dh;
  const float* lb = lse + (size_t)bh * T;
  const float* db = dvec + (size_t)bh * T;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t salt = DROP ? site_salt(drop.seed, kSiteAttn) : 0u;
  float dk[kWideNO][4], dv[kWideNO][4];
#pragma unroll
  for (int d = 0; d < kWideNO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  for (int j0 = 0; j0 < T; j0 += kWideKeys) {
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
    wide_scores<NS>(st, qb + D, ld3, k0, qb, ld3, j0, T, dh, vec);      // S^T = K Q^T
    wide_scores<NS>(dpt, qb + 2 * D, ld3, k0, ob, D, j0, T, dh, vec);   // dP^T = V dO^T
    // element e of slice n: key k0 + g + 8 (e >> 1), query j0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * n + 2 * t + (e & 1);
        const float p = j < T ? exp2f(st[n][e] * scale_log2 - lb[j]) : 0.0f;
        float pd = p, dp = dpt[n][e];
        if constexpr (DROP) {
          const uint32_t key = k0 + g + 8 * (e >> 1);
          const uint32_t idx = drop.attn_base + (static_cast<uint32_t>(bh) * T + j) * T + key;
          const bool keep = hash_u32(idx, salt) < drop.thresh;
          pd = keep ? p * drop.inv_keep : 0.0f;
          dp = keep ? dp * drop.inv_keep : 0.0f;
        }
        st[n][e] = pd;                                       // (Z o P)^T
        dpt[n][e] = j < T ? p * (dp - db[j]) * scale : 0.0f;  // dS^T
      }
    wide_pv<NS>(dv, st, ob, D, j0, c0, T, dh);    // dV += (Z o P)^T dO
    wide_pv<NS>(dk, dpt, qb, ld3, j0, c0, T, dh);  // dK += dS^T Q
  }
  float* dkb = dqkv + b * T * ld3 + D + h * dh;
  wide_store(dkb, ld3, k0, c0, dk, T, dh, vec);
  wide_store(dkb + D, ld3, k0, c0, dv, T, dh, vec);
}

// dvec[(b*H + h)*T + i] = sum_d dout[m, h*dh + d] o[m, h*dh + d] for m = b*T
// + i: D of the attention backward, one thread per (row, head)
__global__ void __launch_bounds__(kSumThreads)
attn_bwd_rowdot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ dvec, int M, int T, int D, int H) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * H) return;
  const int m = e / H, h = e - m * H, dh = D / H;
  const float* a = o + (size_t)m * D + h * dh;
  const float* c = dout + (size_t)m * D + h * dh;
  float s = 0.0f;
  for (int d = 0; d < dh; ++d) s = fmaf(a[d], c[d], s);
  const int b = m / T;
  dvec[((size_t)b * H + h) * T + (m - b * T)] = s;
}

// D past a head width of 128: a warp per (row, head), its lanes along the
// head width (a float4 a load where `vec`), their sums added in a fixed
// order; dvec as attn_bwd_rowdot_kernel's
__global__ void __launch_bounds__(kSumThreads)
attn_bwd_rowdot_wide_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                            float* __restrict__ dvec, int M, int T, int D, int H, bool vec) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (e >= M * H) return;
  const int m = e / H, h = e - m * H, dh = D / H;
  const float* a = o + (size_t)m * D + h * dh;
  const float* c = dout + (size_t)m * D + h * dh;
  float s = 0.0f;
  if (vec) {
    for (int d = 4 * lane; d < dh; d += 128) {
      const float4 x = ld4(a + d), y = ld4(c + d);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
  } else {
    for (int d = lane; d < dh; d += 32) s = fmaf(a[d], c[d], s);
  }
  s = warp_sum(s);
  const int b = m / T;
  if (lane == 0) dvec[((size_t)b * H + h) * T + (m - b * T)] = s;
}

struct BwdArgs {
  const float *qkv, *dout, *lse, *dvec;
  float* dqkv;
  int B, T, D, H, dh;
  bool vec;
  float scale;
  Drop drop;
};

template <int DHP, bool DROP>
cudaError_t attention_backward_launch(const BwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = BwdTile<DHP>::smem;
  cudaError_t e = set_smem(attn_bwd_dq_kernel<DHP, DROP>, smem);
  if (e == cudaSuccess) e = set_smem(attn_bwd_dkdv_kernel<DHP, DROP>, smem);
  if (e != cudaSuccess) return e;
  if (a.B * a.H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((a.T + kBwdRows - 1) / kBwdRows, a.B * a.H);
  attn_bwd_dq_kernel<DHP, DROP><<<grid, kBwdThreads, smem, s>>>(
      a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh, a.vec, a.scale, a.drop);
  attn_bwd_dkdv_kernel<DHP, DROP><<<grid, kBwdThreads, smem, s>>>(
      a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh, a.vec, a.scale, a.drop);
  return cudaSuccess;
}

template <int DHP>
cudaError_t attention_backward_dhp(const BwdArgs& a, cudaStream_t s) {
  return a.drop.seed != nullptr ? attention_backward_launch<DHP, true>(a, s)
                                : attention_backward_launch<DHP, false>(a, s);
}

// The wide passes of one block shape: the dQ pass, then the dK/dV pass
template <bool DROP, int KS, int CL>
cudaError_t attn_bwd_wide_launch(const BwdArgs& a, cudaStream_t s) {
  auto* dq = attn_bwd_dq_wide_kernel<DROP, KS, CL>;
  auto* dkdv = attn_bwd_dkdv_wide_kernel<DROP, KS, CL>;
  const int w = (a.dh + 16 * CL - 1) / (16 * CL) * 16;
  const size_t smem = wide_bwd_floats<KS>(w) * sizeof(float);
  cudaError_t e = set_smem(dq, smem);
  if (e == cudaSuccess) e = set_smem(dkdv, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)a.B * a.H * ((a.T + kWgRows - 1) / kWgRows);
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
  e = cudaLaunchKernelEx(&cfg, dq, a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh,
                         a.vec, a.scale, a.drop);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, dkdv, a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh,
                           a.vec, a.scale, a.drop);
  return e;
}

// The sliced passes: grid (ceil(T / 64), B * H, ceil(dh / 128))
template <bool DROP>
cudaError_t attn_bwd_sliced_launch(const BwdArgs& a, cudaStream_t s) {
  if (a.B * a.H > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((a.T + kWideRows - 1) / kWideRows, a.B * a.H,
                  (a.dh + kWideSlice - 1) / kWideSlice);
  attn_bwd_dq_sliced_kernel<DROP><<<grid, kWideThreads, 0, s>>>(
      a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh, a.vec, a.scale, a.drop);
  attn_bwd_dkdv_sliced_kernel<DROP><<<grid, kWideThreads, 0, s>>>(
      a.qkv, a.dout, a.lse, a.dvec, a.dqkv, a.T, a.D, a.H, a.dh, a.vec, a.scale, a.drop);
  return cudaSuccess;
}

// Both passes at head width dh > 128: the wide passes up to 544, one block
// to 272 columns (a warpgroup's half of them 72, 128 or 136 wide), a
// cluster of two past it (shares of 272); the sliced passes past 544.
template <bool DROP>
cudaError_t attention_backward_wide(const BwdArgs& a, cudaStream_t s) {
  if (a.dh <= 144) return attn_bwd_wide_launch<DROP, 9, 1>(a, s);
  if (a.dh <= 256) return attn_bwd_wide_launch<DROP, 16, 1>(a, s);
  if (a.dh <= 272) return attn_bwd_wide_launch<DROP, 17, 1>(a, s);
  if (a.dh <= 544) return attn_bwd_wide_launch<DROP, 17, 2>(a, s);
  return attn_bwd_sliced_launch<DROP>(a, s);
}

// Queues D (into dvec) and both passes of the attention backward: qkv [B*T,
// 3D] and the forward's lse [B*H, T], o and dout [B*T, D] -> dqkv [B*T, 3D].
cudaError_t attention_backward(const float* qkv, const float* o, const float* dout,
                               const float* lse, float* dvec, float* dqkv, int B, int T,
                               int D, int H, float scale, const Drop& drop, cudaStream_t s) {
  const int rows = B * T * H;
  // 16-byte copies where every row of qkv, dout and dqkv and every head's
  // slice of it starts 16-byte aligned
  const int dh = D / H;
  const bool vec = dh % 4 == 0 && D % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dqkv) % 16 == 0;
  const BwdArgs a{qkv, dout, lse, dvec, dqkv, B, T, D, H, dh, vec, scale, drop};
  if (dh > kMaxPaddedWidth) {
    const unsigned blocks = static_cast<unsigned>(((long long)rows * 32 + kSumThreads - 1) /
                                                  kSumThreads);
    attn_bwd_rowdot_wide_kernel<<<blocks, kSumThreads, 0, s>>>(
        o, dout, dvec, B * T, T, D, H, vec && reinterpret_cast<uintptr_t>(o) % 16 == 0);
    return drop.seed != nullptr ? attention_backward_wide<true>(a, s)
                                : attention_backward_wide<false>(a, s);
  }
  attn_bwd_rowdot_kernel<<<(rows + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      o, dout, dvec, B * T, T, D, H);
  return with_padded_width(
      dh, [&](auto w) { return attention_backward_dhp<decltype(w)::value>(a, s); });
}

// ---- row and column kernels ---------------------------------------------- //

// LayerNorm backward, a warp per row.  X is the LayerNorm input [M, D], G
// the gradient of its output.  Writes dX (the input gradient), dXd =
// drop(dX) at `site` (the gradient that reaches the dropped branch) and
// P = G * xhat (summed over rows into the scale gradient).
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_kernel(const float* __restrict__ X, const float* __restrict__ G,
              const float* __restrict__ w, float* __restrict__ dX,
              float* __restrict__ dXd, float* __restrict__ P, int M, int D,
              Drop drop, int site) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  const float* x = X + off;
  const float* g = G + off;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += x[d];
  const float mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float c = x[d] - mu;
    v = fmaf(c, c, v);
  }
  const float rs = rsqrtf(warp_sum(v) / D + kLnEps);
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float gy = g[d] * w[d];
    s1 += gy;
    s2 = fmaf(gy, (x[d] - mu) * rs, s2);
  }
  const float mean_gy = warp_sum(s1) / D, mean_gyx = warp_sum(s2) / D;
  const bool has_drop = drop.seed != nullptr;
  const uint32_t salt = has_drop ? site_salt(drop.seed, site) : 0u;
  const uint32_t base = drop.row_base * static_cast<uint32_t>(D);
  for (int d = lane; d < D; d += 32) {
    const float xhat = (x[d] - mu) * rs;
    const float dx = rs * (g[d] * w[d] - mean_gy - xhat * mean_gyx);
    dX[off + d] = dx;
    dXd[off + d] = has_drop ? dropped(dx, base + static_cast<uint32_t>(off + d), salt, drop) : dx;
    P[off + d] = g[d] * xhat;
  }
}

// out[z * N + c] = sum_r X[r, c] over the rows [z * rows, (z + 1) * rows)
// of chunk z = blockIdx.y, X [M, N]: a block of 32 x 16 threads per 32
// columns and row chunk, rows summed in a fixed order.
__global__ void __launch_bounds__(kColX * kColY)
colsum_kernel(const float* __restrict__ X, float* __restrict__ out, int M, int N, int rows) {
  __shared__ float part[kColY][kColX + 1];
  const int tx = threadIdx.x & (kColX - 1), ty = threadIdx.x / kColX;
  const int c = blockIdx.x * kColX + tx, z = blockIdx.y;
  const int r_end = min(M, (z + 1) * rows);
  out += (size_t)z * N;
  float s = 0.0f;
  if (c < N)
    for (int r = z * rows + ty; r < r_end; r += kColY) s += X[(size_t)r * N + c];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < N) {
    float t = 0.0f;
    for (int y = 0; y < kColY; ++y) t += part[y][tx];
    out[c] = t;
  }
}

// out[e] = sum_z part[z * n + e], the split-K partial sums in split order.
__global__ void __launch_bounds__(kSumThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int n, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + e];
  out[e] = s;
}

struct Dims {
  int B, T, D, F, H, M;
};

// K slices of kTcBK between the GEMM accumulator's flushes into its f32
// sum (gemm_tf32x3.cuh), for the forward products (also recomputed in the
// backward), the data gradients and the weight gradients.  Measured on an
// H100 by tools/flush_ab.py: every 256 of K saves ~1% and doubles the a2m
// gradients' distance from float64; every 64 halves it for 1-3% more time;
// every 32 brings the model output to plain f32's error for 12-28% more;
// flushing only the gradients' products leaves them where the unflushed
// GEMM had them (the forward's error is the one the rot6d losses amplify).
// gemm_ws.cuh flushes every one of these at any K; gemm_tf32x3.cuh's
// GENERAL route (K past kTcFlushK, unaligned rows) every kTcFlushSlices,
// equal to them, so a product is the same on either route.
constexpr int kFwdFlush = 4, kDataGradFlush = 4, kWeightGradFlush = 4;

// The products' routes by the layer's D and F: bit i set where weight i's
// products take gemm_ws.cuh (0 wqkv [3D, D], 1 wo [D, D], 2 w1 [F, D], 3 w2
// [D, F], each [out, in]): its forward product [M, out] over in (recomputed
// in the backward), its data gradient [M, in] over out and its weight
// gradient [out, in] over M.  The rule (ws_aligned) asks the same of the
// three: out and in multiples of 4.  The others take gemm_tf32x3.cuh.
int train_routes(int D, int F) {
  const int out[4] = {3 * D, D, F, D}, in[4] = {D, D, D, F};
  int r = 0;
  for (int i = 0; i < 4; ++i)
    if (ws_aligned(out[i], in[i])) r |= 1 << i;
  return r;
}

// The tensor maps of the weights' splits (ops/fused_encoder.py), by weight
// as train_routes numbers them: W's (the forward products) and W^T's (the
// data gradients); null where the route is gemm_tf32x3.cuh's
struct Maps {
  const CUtensorMap* w[4];
  const CUtensorMap* t[4];
};

WsArgs ws_args(float* C, int M, int N, int K, const EpiArgs& ep) {
  return WsArgs{C, M, N, K, ep.bias, ep.resid, nullptr, nullptr, ep.aux, ep.pre, ep.drop,
                ep.site};
}

// C[M, N] = epi(A[M, K] . W[N, K]^T): a forward product, on gemm_ws.cuh by
// W's split where `map` is set (its route), else gemm_tf32x3.cuh
template <int EPI>
cudaError_t fwd_product(bool ws, const CUtensorMap* map, const float* A, const float* W,
                        float* C, int M, int N, int K, const EpiArgs& ep, cudaStream_t s) {
  if (!ws) return gemm_nt<EPI, kFwdFlush>(A, W, C, M, N, K, ep, s);
  if (map == nullptr) return cudaErrorInvalidValue;  // the split's map is missing
  return gemm_ws<EPI, kFwdFlush>(A, *map, ws_args(C, M, N, K, ep), s);
}

// C[M, N] = epi(A[M, K] . W[K, N]): a data gradient (W in [out, in]), on
// gemm_ws.cuh by W^T's split where its route says so
template <int EPI>
cudaError_t gemm_nn(bool ws, const CUtensorMap* map, const float* A, const float* W, float* C,
                    int M, int N, int K, const EpiArgs& ep, cudaStream_t s) {
  if (!ws)
    return gemm_tf32x3<true, false, EPI, kDataGradFlush>(A, W, C, M, N, K, K, N, 1, K, ep, s);
  if (map == nullptr) return cudaErrorInvalidValue;
  return gemm_ws<EPI, kDataGradFlush>(A, *map, ws_args(C, M, N, K, ep), s);
}

// How many row chunks a weight gradient [I, J] over M rows is split into,
// and the chunk length (a multiple of kTcBK): enough of gemm_tf32x3.cuh's
// 128 x 64 blocks to fill the card.  Both routes take these chunks.
int weight_grad_splits(int I, int J, int M, int* chunk) {
  const int tiles = ((I + kTcBM - 1) / kTcBM) * ((J + kTcBN - 1) / kTcBN);
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, M / 128));
  int c = (M + splits - 1) / splits;
  c = (c + kTcBK - 1) / kTcBK * kTcBK;
  *chunk = c;
  return (M + c - 1) / c;
}

// dW[I, J] = sum_m dY[m, i] X[m, j] (dY [M, I], X [M, J]), on gemm_ws.cuh
// where `ws`; `part` holds the chunks' partial sums, added in chunk order.
cudaError_t weight_grad(bool ws, const float* dY, const float* X, float* dW, float* part, int M,
                        int I, int J, cudaStream_t s) {
  int chunk;
  const int splits = weight_grad_splits(I, J, M, &chunk);
  const EpiArgs ep{};
  float* C = splits == 1 ? dW : part;
  const cudaError_t e =
      ws ? gemm_ws_tn<kWeightGradFlush>(dY, X, C, I, J, M, chunk, splits, s)
         : gemm_tf32x3<false, false, kPlain, kWeightGradFlush>(dY, X, C, I, J, M, I, J, splits,
                                                               chunk, ep, s);
  if (e != cudaSuccess || splits == 1) return e;
  const int n = I * J;
  sum_splits_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      part, dW, n, splits);
  return e;
}

// out[c] = sum_r X[r, c]: the rows split into chunks that spread over the
// card (N / 32 column blocks alone leave most SMs idle), the chunks' sums
// in `part` added in chunk order
void colsum(const float* X, float* out, float* part, int M, int N, cudaStream_t s) {
  const int splits = std::max(1, std::min(kColSplits, M / 256));
  const int rows = (M + splits - 1) / splits;
  colsum_kernel<<<dim3((N + kColX - 1) / kColX, splits), kColX * kColY, 0, s>>>(
      X, splits > 1 ? part : out, M, N, rows);
  if (splits > 1)
    sum_splits_kernel<<<(N + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(part, out, N,
                                                                                  splits);
}

void ln_bwd(const float* X, const float* G, const float* w, float* dX,
            float* dXd, float* P, int M, int D, const Drop& drop, int site,
            cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  ln_bwd_kernel<<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0, s>>>(
      X, G, w, dX, dXd, P, M, D, drop, site);
}

// ---- the two chains ------------------------------------------------------ //

struct Weights {
  const float *wqkv, *bqkv, *wo, *bo, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2,
      *ln2_w, *ln2_b;
};

// The forward chain.  qkv [M, 3D], o, u, y1, v2 [M, D] and hd [M, F] are
// written; h1 [M, F] and lse [B*H, T] when not null; the layer output goes
// to `out` unless it is null (the backward's recompute stops at v2).  Bit i
// of `routes` sends weight i's product to gemm_ws.cuh on its split's map.
cudaError_t forward_chain(const float* x, const Weights& w, const Drop& drop,
                          const Dims& n, float scale, int routes, const Maps& maps, float* qkv,
                          float* o, float* lse, float* u, float* y1, float* h1, float* hd,
                          float* v2, float* out, cudaStream_t s) {
  const int M = n.M, D = n.D, F = n.F;
  const long long dh = D / n.H, t = n.T;
  const AttnStrides packed{t * 3 * D, dh, 3 * D}, rows{t * D, dh, D};
  cudaError_t e = fwd_product<kBias>(routes & 1, maps.w[0], x, w.wqkv, qkv, M, 3 * D, D,
                                     EpiArgs{w.bqkv}, s);
  if (e == cudaSuccess)
    e = flash_attention<true>(qkv, qkv + D, qkv + 2 * D, o, packed, packed, packed, rows, n.B,
                              n.H, n.T, D / n.H, scale, drop, lse, s);
  if (e == cudaSuccess)
    e = fwd_product<kBiasResid>(routes & 2, maps.w[1], o, w.wo, u, M, D, D,
                                EpiArgs{w.bo, x, nullptr, nullptr, drop, kSitePostAttn}, s);
  if (e != cudaSuccess) return e;
  layernorm(u, w.ln1_w, w.ln1_b, y1, M, D, s);
  e = fwd_product<kBiasGelu>(routes & 4, maps.w[2], y1, w.w1, hd, M, F, D,
                             EpiArgs{w.b1, nullptr, nullptr, h1, drop, kSiteAct}, s);
  if (e == cudaSuccess)
    e = fwd_product<kBiasResid>(routes & 8, maps.w[3], hd, w.w2, v2, M, D, F,
                                EpiArgs{w.b2, y1, nullptr, nullptr, drop, kSiteFF}, s);
  if (e == cudaSuccess && out != nullptr) layernorm(v2, w.ln2_w, w.ln2_b, out, M, D, s);
  return e;
}

// rows [row0, row0 + B) of a larger batch: the sites' global indices start
// at row0's (uint32 arithmetic wraps as the indices do)
Drop make_drop(const int* seed, unsigned thresh, float inv_keep, int use_dropout, int row0,
               const Dims& n) {
  const uint32_t r0 = static_cast<uint32_t>(row0), t = static_cast<uint32_t>(n.T);
  return Drop{use_dropout ? seed : nullptr, thresh, inv_keep,
              r0 * static_cast<uint32_t>(n.H) * t * t, r0 * t};
}

// floats of the partial sums of a weight gradient or a column sum
size_t split_floats(const Dims& n) {
  size_t most = (size_t)kColSplits * std::max(3 * n.D, n.F);
  const int shapes[4][2] = {{3 * n.D, n.D}, {n.D, n.D}, {n.F, n.D}, {n.D, n.F}};
  for (const auto& ij : shapes) {
    int chunk;
    const int splits = weight_grad_splits(ij[0], ij[1], n.M, &chunk);
    if (splits > 1) most = std::max(most, (size_t)splits * ij[0] * ij[1]);
  }
  return most;
}

// The backward chain: the forward recomputed from x, then from g = dL/dout
// dx and the 12 gradients (each in its parameter's layout); `routes` and
// `maps` as forward_chain's (maps.t: the data gradients').
cudaError_t backward_chain(const float* x, const Weights& w, const Drop& drop, const Dims& n,
                           float scale, int routes, const Maps& maps, const float* g, float* dx,
                           float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* dln1_w,
                           float* dln1_b, float* dw1, float* db1, float* dw2, float* db2,
                           float* dln2_w, float* dln2_b, float* ws, cudaStream_t s) {
  const int M = n.M, D = n.D, F = n.F;
  const size_t m = M;
  float* qkv = ws;
  float* dqkv = qkv + m * 3 * D;
  float* h1 = dqkv + m * 3 * D;
  float* hd = h1 + m * F;      // then dh1
  float* o = hd + m * F;
  float* u = o + m * D;
  float* y1 = u + m * D;
  float* v2 = y1 + m * D;
  float* dv = v2 + m * D;
  float* dff = dv + m * D;
  float* P = dff + m * D;
  float* dy1 = P + m * D;
  float* du = dy1 + m * D;
  float* da = du + m * D;
  float* dout = da + m * D;
  float* part = dout + m * D;
  float* lse = part + split_floats(n);  // [B*H, T]
  float* dvec = lse + m * n.H;          // [B*H, T]

  cudaError_t e = forward_chain(x, w, drop, n, scale, routes, maps, qkv, o, lse, u, y1, h1, hd,
                                v2, nullptr, s);
  if (e != cudaSuccess) return e;
  // LN2 and the feed-forward branch
  ln_bwd(v2, g, w.ln2_w, dv, dff, P, M, D, drop, kSiteFF, s);
  colsum(P, dln2_w, part, M, D, s);
  colsum(g, dln2_b, part, M, D, s);
  e = weight_grad(routes & 8, dff, hd, dw2, part, M, D, F, s);
  colsum(dff, db2, part, M, D, s);
  if (e == cudaSuccess)  // hd <- dh1
    e = gemm_nn<kDropGeluGrad>(routes & 8, maps.t[3], dff, w.w2, hd, M, F, D,
                               EpiArgs{nullptr, nullptr, h1, nullptr, drop, kSiteAct}, s);
  if (e == cudaSuccess) e = weight_grad(routes & 4, hd, y1, dw1, part, M, F, D, s);
  colsum(hd, db1, part, M, F, s);
  if (e == cudaSuccess)
    e = gemm_nn<kResid>(routes & 4, maps.t[2], hd, w.w1, dy1, M, D, F, EpiArgs{nullptr, dv}, s);
  if (e != cudaSuccess) return e;
  // LN1 and the attention branch
  ln_bwd(u, dy1, w.ln1_w, du, da, P, M, D, drop, kSitePostAttn, s);
  colsum(P, dln1_w, part, M, D, s);
  colsum(dy1, dln1_b, part, M, D, s);
  e = weight_grad(routes & 2, da, o, dwo, part, M, D, D, s);
  colsum(da, dbo, part, M, D, s);
  if (e == cudaSuccess)
    e = gemm_nn<kPlain>(routes & 2, maps.t[1], da, w.wo, dout, M, D, D, EpiArgs{}, s);
  if (e == cudaSuccess)
    e = attention_backward(qkv, o, dout, lse, dvec, dqkv, n.B, n.T, D, n.H, scale, drop, s);
  if (e == cudaSuccess) e = weight_grad(routes & 1, dqkv, x, dwqkv, part, M, 3 * D, D, s);
  colsum(dqkv, dbqkv, part, M, 3 * D, s);
  if (e == cudaSuccess)
    e = gemm_nn<kResid>(routes & 1, maps.t[0], dqkv, w.wqkv, dx, M, D, 3 * D,
                        EpiArgs{nullptr, du}, s);
  return e;
}

Maps maps_of(const void* const* w, const void* const* t) {
  Maps m{};
  for (int i = 0; i < 4; ++i) {
    m.w[i] = static_cast<const CUtensorMap*>(w[i]);
    m.t[i] = t == nullptr ? nullptr : static_cast<const CUtensorMap*>(t[i]);
  }
  return m;
}

cudaError_t fwd_entry(const float* x, const Weights& w, const int* seed, float* out, float* ws,
                      const Dims& n, float scale, unsigned thresh, float inv_keep,
                      int use_dropout, int row0, int routes, const Maps& maps, cudaStream_t s) {
  const size_t M = n.M;
  float* qkv = ws;
  float* o = qkv + M * 3 * n.D;
  float* u = o + M * n.D;
  float* y1 = u + M * n.D;
  float* v2 = y1 + M * n.D;
  float* hd = v2 + M * n.D;
  const Drop drop = make_drop(seed, thresh, inv_keep, use_dropout, row0, n);
  const cudaError_t e = forward_chain(x, w, drop, n, scale, routes, maps, qkv, o, nullptr, u, y1,
                                      nullptr, hd, v2, out, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Float32 elements of the workspace that the forward (backward = 0) or the
// backward (backward = 1) entry point needs.
size_t gdt_encoder_layer_train_workspace(int B, int T, int D, int F, int H,
                                         int backward) {
  const Dims n{B, T, D, F, H, B * T};
  const size_t M = n.M;
  if (!backward) return M * (3 * (size_t)D + 4 * (size_t)D + F);
  return M * (17 * (size_t)D + 2 * (size_t)F + 2 * (size_t)H) + split_floats(n);
}

// The products' routes of a layer (train_routes; the Python mirror:
// ops/fused_encoder_train.py:train_routes)
int gdt_encoder_layer_train_routes(int D, int F) { return train_routes(D, F); }

// bytes of a tensor map (the host buffer weight maps are written into)
int gdt_tensor_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// Queues the split of W [N, K] into `split` (float32 [2][N][K rounded up to
// 8], 16-byte aligned) and encodes its tensor map into the host buffer
// `map` (as encoder_layer.cu's).  Returns cudaGetLastError() or the
// encoder's error.
int gdt_split_weight_f32(const float* w, float* split, int N, int K, void* map, void* stream) {
  const cudaError_t e = split_weight(w, split, N, K, static_cast<CUtensorMap*>(map),
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The same for a data gradient's weight W [K, N] ([out, in], N = in): the
// split of W^T, [2][N][K rounded up to 8]
int gdt_split_weight_t_f32(const float* w, float* split, int N, int K, void* map, void* stream) {
  const cudaError_t e = split_weight(w, split, N, K, static_cast<CUtensorMap*>(map),
                                     static_cast<cudaStream_t>(stream), true);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Forward: x [B, T, D] -> out [B, T, D].  `seed` points at one int32 on the
// device; thresh and inv_keep come from the caller (rate 0: use_dropout 0);
// x holds rows [row0, row0 + B) of the batch the dropout indices count.
// Any D and F, any head width D / H.  map_qkv, map_o, map_1, map_2: host
// buffers holding the tensor maps of the weights' splits
// (gdt_split_weight_f32), needed by the products train_routes sends to
// gemm_ws.cuh (null otherwise).  Returns cudaGetLastError() after queueing
// the chain on `stream`.
int gdt_encoder_layer_train_fwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, float* out, float* ws, int B, int T,
    int D, int F, int H, float scale, unsigned thresh, float inv_keep,
    int use_dropout, int row0, const void* map_qkv, const void* map_o, const void* map_1,
    const void* map_2, void* stream) {
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const void* maps[4] = {map_qkv, map_o, map_1, map_2};
  return static_cast<int>(fwd_entry(x, w, seed, out, ws, n, scale, thresh, inv_keep,
                                    use_dropout, row0, train_routes(D, F),
                                    maps_of(maps, nullptr), static_cast<cudaStream_t>(stream)));
}

// Backward: recompute the forward from x, then from g = dL/dout produce dx
// and the 12 gradients (each in its parameter's layout).  map_*: the
// forward's (W's splits), then mapt_*: the data gradients' (W^T's splits).
int gdt_encoder_layer_train_bwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, const float* g, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* dln1_w,
    float* dln1_b, float* dw1, float* db1, float* dw2, float* db2,
    float* dln2_w, float* dln2_b, float* ws, int B, int T, int D, int F, int H,
    float scale, unsigned thresh, float inv_keep, int use_dropout, int row0,
    const void* map_qkv, const void* map_o, const void* map_1, const void* map_2,
    const void* mapt_qkv, const void* mapt_o, const void* mapt_1, const void* mapt_2,
    void* stream) {
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const void* fwd[4] = {map_qkv, map_o, map_1, map_2};
  const void* t[4] = {mapt_qkv, mapt_o, mapt_1, mapt_2};
  const cudaError_t e = backward_chain(
      x, w, make_drop(seed, thresh, inv_keep, use_dropout, row0, n), n, scale,
      train_routes(D, F), maps_of(fwd, t), g, dx, dwqkv, dbqkv, dwo, dbo, dln1_w, dln1_b, dw1,
      db1, dw2, db2, dln2_w, dln2_b, ws, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The parent chain, every product on gemm_tf32x3.cuh (the layer as it was
// before gemm_ws.cuh took its products), with the forward entry's and the
// backward entry's arguments less the maps: the card tests and
// chip_smoke.py hold the shipped chain against it bit for bit.  The main
// path never calls it.
int gdt_encoder_layer_train_parent_fwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, float* out, float* ws, int B, int T,
    int D, int F, int H, float scale, unsigned thresh, float inv_keep,
    int use_dropout, int row0, void* stream) {
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  return static_cast<int>(fwd_entry(x, w, seed, out, ws, n, scale, thresh, inv_keep,
                                    use_dropout, row0, 0, Maps{},
                                    static_cast<cudaStream_t>(stream)));
}

int gdt_encoder_layer_train_parent_bwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, const float* g, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* dln1_w,
    float* dln1_b, float* dw1, float* db1, float* dw2, float* db2,
    float* dln2_w, float* dln2_b, float* ws, int B, int T, int D, int F, int H,
    float scale, unsigned thresh, float inv_keep, int use_dropout, int row0,
    void* stream) {
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const cudaError_t e = backward_chain(
      x, w, make_drop(seed, thresh, inv_keep, use_dropout, row0, n), n, scale, 0, Maps{}, g,
      dx, dwqkv, dbqkv, dwo, dbo, dln1_w, dln1_b, dw1, db1, dw2, db2, dln2_w, dln2_b, ws,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One product family alone, for the card tests, chip_smoke.py and
// tools/kernel_variants.py, on gemm_ws.cuh (ws 1: `map` the split's map)
// or on gemm_tf32x3.cuh (ws 0), no dropout.  family 0, a forward product:
// C [M, N] = epi(A [M, K] . W[N, K]^T), epi 1 bias, 2 bias and residual, 3
// bias and GELU (pre: h1 or null); family 1, a data gradient: C [M, N] =
// epi(A [M, K] . W[K, N]) (map: W^T's split), epi 0 plain, 4 GELU'(aux), 5
// residual; family 2, a weight gradient: C [M, N] = A[K, M]^T . W[K, N] in
// weight_grad's chunks (part: their sums, train_workspace's size for the
// layer is enough).  cudaErrorInvalidValue outside the rule (ws 1).
int gdt_train_product_f32(int family, int ws, const float* A, const float* W, const void* map,
                          float* C, float* part, int M, int N, int K, int epi, const float* bias,
                          const float* resid, const float* aux, float* pre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CUtensorMap* tm = static_cast<const CUtensorMap*>(map);
  const EpiArgs ep{bias, resid, aux, pre};
  cudaError_t e = cudaErrorInvalidValue;
  if (family == 0)
    e = epi == kBias       ? fwd_product<kBias>(ws, tm, A, W, C, M, N, K, ep, s)
        : epi == kBiasResid ? fwd_product<kBiasResid>(ws, tm, A, W, C, M, N, K, ep, s)
        : epi == kBiasGelu  ? fwd_product<kBiasGelu>(ws, tm, A, W, C, M, N, K, ep, s)
                            : cudaErrorInvalidValue;
  else if (family == 1)
    e = epi == kPlain          ? gemm_nn<kPlain>(ws, tm, A, W, C, M, N, K, ep, s)
        : epi == kDropGeluGrad ? gemm_nn<kDropGeluGrad>(ws, tm, A, W, C, M, N, K, ep, s)
        : epi == kResid        ? gemm_nn<kResid>(ws, tm, A, W, C, M, N, K, ep, s)
                               : cudaErrorInvalidValue;
  else if (family == 2 && (ws == 0 || ws_aligned(N, M)))
    e = weight_grad(ws, A, W, C, part, K, M, N, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
