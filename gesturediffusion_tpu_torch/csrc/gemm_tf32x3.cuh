// 3xTF32 tensor-core GEMM of the encoder layers' products outside
// gemm_ws.cuh's rules (encoder_layer.cu: rows not 16-byte aligned, or K past
// 1024; encoder_layer_train.cu: rows not 16-byte aligned), the parent chain
// the training layer's products are held against bit for bit, and the
// 3xTF32 primitives the attention kernels share (flash_attention.cuh, the
// training layer's attention backward).
//
// Replaces: the products of pallas_encoder_train.py::_fwd_kernel and
// ::_bwd_kernel: the four forward products of
// gesturediffusion_tpu/ops/pallas_encoder.py::_encoder_layer_kernel (qkv,
// out-projection, ff1 with GELU, ff2, each a jnp.dot with
// preferred_element_type=float32 at full f32 precision) with dropout, the
// data gradients dX = dY . W and the weight gradients dW = dY^T . X; and the
// products where gemm_ws.cuh (the redesign for Hopper: weights split once,
// TMA, a producer warp, a persistent walk) does not take them.
//
// Why three passes.  A TF32 operand keeps 10 of f32's 23 mantissa bits, so a
// single-pass TF32 product is off by ~1e-3 relative: another result than the
// f32 reference, not a faster one.  3xTF32 splits each f32 operand x into
// big = tf32_rn(x) and small = tf32_rn(x - big), so x = big + small to
// ~2^-22 relative, and accumulates big.big + big.small + small.big in f32 on
// the tensor cores; the dropped small.small term is ~2^-22 relative.  The
// result keeps f32-level error (~1e-6 relative), and every tolerance of the
// f32 kernels stands.  tests/test_torch_tf32x3.py emulates this arithmetic on
// the CPU against the JAX package and pins single-pass TF32's larger error.
//
// What bounds it on an H100: three TF32 passes at 495 TFLOP/s are 165 TFLOP/s
// of f32-equivalent work, ~2.5x the 67 TFLOP/s SIMT f32 peak.  At the gesture
// layer [82, 81, 256], ff 1024, the products are 10.4 GFLOP against ~17 MB of
// compulsory traffic, ~600 FLOP per byte: bound by the tensor cores.
//
// Design: wgmma (warpgroup MMA) m64n64k8 TF32, A from registers, B from
// shared memory, fed by a 3-stage cp.async ring of 32-wide K slices.  A
// block of 2 warpgroups owns a 128 x 64 tile of C = A . B^T (A [M, K], B
// [N, K] as PyTorch's [out, in] weights), a warpgroup 64 rows.  TF32 wgmma
// requires both operands K-major; an operand that is not K-contiguous in
// device memory (A_KC, B_KC false: the data gradients' W, both operands of
// the weight gradients) is transposed on its way from the raw ring, at no
// extra pass.  Raw slices land in shared memory as they lie in device
// memory: K-contiguous ones as rows of K padded to 40 floats, the others as
// rows of M (N) padded to 132 (68) floats.  Once a slice has landed, the
// block splits its B part into a big and a small tile in wgmma's K-major
// layout without swizzle (core matrices of 8 rows x 16 bytes: 128 bytes
// between the two along K, 256 between 8-row groups): a thread reads 8
// values along K of one row of B, two float4s from a K-contiguous slice or
// 8 scalars down a column of a transposed one (a warp's 32 lanes read 32
// consecutive floats of a row: no bank conflict).  Each warp reads its A
// fragments (mma.sync's m16n8k8 layout, the rows of its 16) and splits them
// in registers: one float2 per pair from a K-contiguous slice, two scalars
// from a transposed one (the 132-float rows put the 32 lanes in 32 banks).
// Within each slice of 8, k is permuted: fragment elements k = t and t + 4
// are the adjacent physical columns 2t and 2t + 1 of A, and the split pass
// writes B's columns in that order.  Each k8 step is three wgmmas (big .
// small, small . big, big . big) into one f32 accumulator; the block waits
// for them before the next slice.  No pre-split or pre-transposed copy of
// an operand exists anywhere.  Two blocks fit an SM (108.5 KB).  M and N
// edges are masked (copies past them are zero-filled, stores skipped): T is
// taken as it is.  blockIdx.z takes one chunk of K and writes its own slice
// of C (the weight gradients' deterministic split-K; the caller sums the
// slices in a fixed order).  The epilogue adds the bias, then GELU (tanh
// form), the dropout of a training site, the GELU derivative or the
// residual, and stores float2 pairs.  Overlapping the next slice's split
// with the running wgmmas (two B buffers) measured no faster with a 2-stage
// ring and slower with 3 (one block an SM).  gemm_ws.cuh keeps this file's
// arithmetic, k order, flush and epilogues on a Hopper pipeline for both
// encoder layers.
//
// The 3xTF32 split and the mma.sync primitives the attention kernels use
// live in mma_tf32x3.cuh; tools/tf32_ceiling.py measures both instructions'
// rates.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

// ---- wgmma ---------------------------------------------------------------- //

// Shared-memory matrix descriptor of wgmma, no swizzle: a K-major operand
// stored as core matrices of 8 rows x 16 bytes (rows 16 bytes apart); `lbo`
// bytes between core matrices adjacent along K, `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// st.shared writes become visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of v across this point
template <int N>
__device__ __forceinline__ void reg_fence(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

// d += a . b for a warpgroup: a 64 x 8 TF32 tile from registers (each warp
// its 16 rows, laid out as mma.sync's m16n8k8 A fragment), b 8 x 64 from
// shared memory through `desc`, d 64 x 64 in f32 (each warp its 16 rows,
// per n8 tile as mma.sync's accumulator)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ---- the GEMM ------------------------------------------------------------ //

constexpr int kTcBM = 128;            // block rows: 2 warpgroups of 64
constexpr int kTcBN = 64;             // block columns: one wgmma n64 tile
constexpr int kTcBK = 32;             // K slice per stage: 4 wgmma k8 steps
constexpr int kTcLd = kTcBK + 8;      // K-contiguous raw rows: conflict-free float2 reads
constexpr int kTcLdAT = kTcBM + 4;    // transposed raw A rows [k][m]: 32 banks for a warp
constexpr int kTcLdBT = kTcBN + 4;    // transposed raw B rows [k][n]
constexpr int kTcAStage = kTcBM * kTcLd;  // floats of a raw A slice (either layout fits)
constexpr int kTcBStage = kTcBN * kTcLd;  // floats of a raw B slice (either layout fits)
static_assert(kTcBK * kTcLdAT <= kTcAStage && kTcBK * kTcLdBT <= kTcBStage,
              "a transposed raw slice fits the stage");
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;
constexpr int kTcSlice = kTcBN * 8;   // floats of one k8 step of the B tiles
constexpr uint32_t kTcLbo = 128, kTcSbo = 256;  // core-matrix strides (bytes)
// B big and small tiles of one stage, then the ring of raw A and B slices
constexpr size_t kTcSmem =
    ((size_t)2 * kTcBK * kTcBN + (size_t)kTcStages * (kTcAStage + kTcBStage)) * sizeof(float);

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a row-major operand
// (row stride ld) into shared rows of ldd floats, one float a copy, zeros
// past r_end and c_end: the copy of slices whose rows are not 16-byte
// aligned (a row length or stride not divisible by 4), kept out of line so
// that the main loop holds only its float4 copies.
__device__ __noinline__ void gemm_copy_scalar(float* dst, int ldd, const float* base,
                                              long long ld, int r0, int c0, int rows, int cols,
                                              int r_end, int c_end) {
  for (int f = threadIdx.x; f < rows * cols; f += blockDim.x) {
    const int r = f / cols, c = f % cols;
    const bool in = r0 + r < r_end && c0 + c < c_end;
    cp_async4(dst + r * ldd + c, in ? base + (r0 + r) * ld + c0 + c : base, in);
  }
}

// The dropout of kBiasResid, kBiasGelu and kDropGeluGrad applies only when
// ep.drop.seed is set; the element's index is its offset r * N + c in C.
enum Epilogue {
  kPlain,         // C = acc
  kBias,          // C = acc + bias
  kBiasResid,     // C = resid + drop(acc + bias)
  kBiasGelu,      // pre = acc + bias; C = drop(gelu(pre))
  kDropGeluGrad,  // C = drop(acc) * gelu'(aux)
  kResid,         // C = acc + resid
};

struct EpiArgs {
  const float* bias;   // [N]
  const float* resid;  // [M, N]
  const float* aux;    // [M, N] GELU input for kDropGeluGrad
  float* pre;          // [M, N] pre-activation out for kBiasGelu, or null
  Drop drop;
  int site;
};

// The tensor cores add each product into the f32 accumulator without
// rounding to nearest (the sum is truncated), so the accumulator's error
// grows with the number of wgmma steps: ~2.3e-5 at the gesture layer's K
// of 1024 (PERF.md section 6).  FLUSH > 0 adds the accumulator into an
// f32 sum every FLUSH slices of kTcBK, bounding the error at that of
// FLUSH * 32 terms.  The training layer flushes its products: its
// gradients, which the rot6d training losses amplify where a predicted 6D
// half is short, otherwise sit ~8x further from the exact ones than plain f32's
// (tools/a2m_f64_check.py).  The GENERAL instantiation, which always
// flushes every kTcFlushSlices, serves every call the main path's shapes do not: a reduction
// longer than kTcFlushK (wide layers, unsplit weight gradients) and
// operands or outputs that are not aligned for the 16-byte copies and
// float2 stores.  The main path's instantiation is the kernel without the
// alignment branches, and the inference layer's without the flush.
constexpr int kTcFlushK = 1024;
constexpr int kTcFlushSlices = 4;

// C[M, N] = epi(sum_k A(m, k) B(n, k)).  A(m, k) is A[m*lda + k] when A_KC
// and A[k*lda + m] otherwise; B(n, k) is B[n*ldb + k] when B_KC and
// B[k*ldb + n] otherwise.  The block takes the k range [z*k_chunk,
// (z+1)*k_chunk) of z = blockIdx.z and writes slice z of C (partial sums
// when gridDim.z > 1).  Slices are copied 16 bytes at a time where `vec`
// (every row of both operands 16-byte aligned and the contiguous axes
// multiples of 4 long: K and k_chunk when A_KC or B_KC, M or N otherwise),
// else a float at a time; the epilogue reads and writes float2 pairs where
// `pair` (N even, its pointers 8-byte aligned), else floats.  Both flags
// are read by the GENERAL instantiation only; the other takes them true.
// grid (ceil(N / kTcBN), ceil(M / kTcBM), splits).
template <bool A_KC, bool B_KC, int EPI, bool GENERAL, int FLUSH>
__global__ void __launch_bounds__(kTcThreads)
gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int lda, int ldb,
                   int k_chunk, bool vec_arg, bool pair_arg, EpiArgs ep) {
  const bool vec = !GENERAL || vec_arg, pair = !GENERAL || pair_arg;
  extern __shared__ __align__(16) float smem[];
  float* Bbig = smem;                          // [4 k8 steps][kTcSlice]
  float* Bsmall = Bbig + kTcBK * kTcBN;        // [4 k8 steps][kTcSlice]
  float* As = Bsmall + kTcBK * kTcBN;          // [stages][kTcAStage]
  float* Bs = As + kTcStages * kTcAStage;      // [stages][kTcBStage]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int kbeg = blockIdx.z * k_chunk, kend = min(K, kbeg + k_chunk);
  const int ktiles = (kend - kbeg + kTcBK - 1) / kTcBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kbeg + kt * kTcBK;
    float* as = As + stage * kTcAStage;
    float* bs = Bs + stage * kTcBStage;
    if (!vec) {
      if constexpr (A_KC)
        gemm_copy_scalar(as, kTcLd, A, lda, m0, k0, kTcBM, kTcBK, M, kend);
      else
        gemm_copy_scalar(as, kTcLdAT, A, lda, k0, m0, kTcBK, kTcBM, kend, M);
      if constexpr (B_KC)
        gemm_copy_scalar(bs, kTcLd, B, ldb, n0, k0, kTcBN, kTcBK, N, kend);
      else
        gemm_copy_scalar(bs, kTcLdBT, B, ldb, k0, n0, kTcBK, kTcBN, kend, N);
      return;
    }
#pragma unroll
    for (int i = 0; i < kTcBM * (kTcBK / 4) / kTcThreads; ++i) {
      const int f = tid + i * kTcThreads;
      if constexpr (A_KC) {
        const int r = f >> 3, c = (f & 7) * 4;
        const bool in = m0 + r < M && k0 + c < kend;
        cp_async16(as + r * kTcLd + c, in ? A + (size_t)(m0 + r) * lda + k0 + c : A, in);
      } else {  // row r of the slice is k, c is m
        const int r = f >> 5, c = (f & 31) * 4;
        const bool in = k0 + r < kend && m0 + c < M;
        cp_async16(as + r * kTcLdAT + c, in ? A + (size_t)(k0 + r) * lda + m0 + c : A, in);
      }
    }
#pragma unroll
    for (int i = 0; i < kTcBN * (kTcBK / 4) / kTcThreads; ++i) {
      const int f = tid + i * kTcThreads;
      if constexpr (B_KC) {
        const int r = f >> 3, c = (f & 7) * 4;
        const bool in = n0 + r < N && k0 + c < kend;
        cp_async16(bs + r * kTcLd + c, in ? B + (size_t)(n0 + r) * ldb + k0 + c : B, in);
      } else {  // row r of the slice is k, c is n
        const int r = f >> 4, c = (f & 15) * 4;
        const bool in = k0 + r < kend && n0 + c < N;
        cp_async16(bs + r * kTcLdBT + c, in ? B + (size_t)(k0 + r) * ldb + n0 + c : B, in);
      }
    }
  };

  float acc[32];
  float sum[FLUSH ? 32 : 1];  // the flushed sum
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (FLUSH ? 32 : 1); ++i) sum[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  // the split pass: thread -> B row sp_n of k8 step sp_s; its 8 values go
  // to row sp_n of the two core matrices of that step, k permuted so that
  // logical k = t, t + 4 hold the physical columns 2t, 2t + 1
  const int sp_s = tid >> 6, sp_n = tid & 63;
  const int sp_dst = sp_s * kTcSlice + (sp_n >> 3) * 64 + (sp_n & 7) * 4;
  const uint64_t desc_big = wgmma_desc(Bbig, kTcLbo, kTcSbo);
  const uint64_t desc_small = wgmma_desc(Bsmall, kTcLbo, kTcSbo);
  const int arow = warp * 16 + g;  // this warp's A rows arow, arow + 8

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kTcStages - 2>();  // slice kt has landed
    __syncthreads();                 // ... for every thread; the B tiles are free
    const int next = kt + kTcStages - 1;
    if (next < ktiles) load_stage(next % kTcStages, next);
    cp_async_commit();

    const int stage = kt % kTcStages;
    {
      float x[8];
      if constexpr (B_KC) {
        const float* bs = Bs + stage * kTcBStage + sp_n * kTcLd + 8 * sp_s;
        const float4 lo = ld4(bs), hi = ld4(bs + 4);
        x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
        x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
      } else {
        const float* bs = Bs + stage * kTcBStage + 8 * sp_s * kTcLdBT + sp_n;
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = bs[i * kTcLdBT];
      }
      uint32_t bg[8], sm[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // core 0: x0, x2, x4, x6; core 1: x1, x3, x5, x7
        split_tf32(x[2 * i], bg[i], sm[i]);
        split_tf32(x[2 * i + 1], bg[4 + i], sm[4 + i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint4*>(Bbig + sp_dst + 32 * h) =
            make_uint4(bg[4 * h], bg[4 * h + 1], bg[4 * h + 2], bg[4 * h + 3]);
        *reinterpret_cast<uint4*>(Bsmall + sp_dst + 32 * h) =
            make_uint4(sm[4 * h], sm[4 * h + 1], sm[4 * h + 2], sm[4 * h + 3]);
      }
    }
    fence_proxy_async();
    __syncthreads();

    const float* as = As + stage * kTcAStage;
    uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float2 lo, hi;  // rows arow, arow + 8 at the physical columns 8s + 2t, 8s + 2t + 1
      if constexpr (A_KC) {
        lo = *reinterpret_cast<const float2*>(as + arow * kTcLd + 8 * s + 2 * t);
        hi = *reinterpret_cast<const float2*>(as + (arow + 8) * kTcLd + 8 * s + 2 * t);
      } else {
        const float* p = as + (8 * s + 2 * t) * kTcLdAT + arow;
        lo = make_float2(p[0], p[kTcLdAT]);
        hi = make_float2(p[8], p[kTcLdAT + 8]);
      }
      split_tf32(lo.x, a_big[s][0], a_small[s][0]);
      split_tf32(hi.x, a_big[s][1], a_small[s][1]);
      split_tf32(lo.y, a_big[s][2], a_small[s][2]);
      split_tf32(hi.y, a_big[s][3], a_small[s][3]);
    }
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t step = (uint64_t)(s * kTcSlice * sizeof(float)) >> 4;
      wgmma_m64n64k8_tf32(acc, a_big[s], desc_small + step);
      wgmma_m64n64k8_tf32(acc, a_small[s], desc_big + step);
      wgmma_m64n64k8_tf32(acc, a_big[s], desc_big + step);
    }
    wgmma_commit();
    wgmma_wait_all();  // the B tiles and A fragments are read
    reg_fence(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      reg_fence(a_big[s]);
      reg_fence(a_small[s]);
    }
    if constexpr (FLUSH > 0) {
      if (kt % FLUSH == FLUSH - 1 || kt == ktiles - 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
      }
    }
  }
  if constexpr (FLUSH > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = sum[i];
  }

  C += (size_t)blockIdx.z * M * N;
  constexpr bool kHasBias = EPI == kBias || EPI == kBiasResid || EPI == kBiasGelu;
  const bool drop = (EPI == kBiasResid || EPI == kBiasGelu || EPI == kDropGeluGrad) &&
                    ep.drop.seed != nullptr;
  const uint32_t salt = drop ? site_salt(ep.drop.seed, ep.site) : 0u;
  const uint32_t base = ep.drop.row_base * static_cast<uint32_t>(N);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    auto ld2 = [&](const float* p) {
      return pair ? *reinterpret_cast<const float2*>(p) : make_float2(p[0], two ? p[1] : 0.f);
    };
    float2 b2 = make_float2(0.f, 0.f);
    if (kHasBias) b2 = ld2(ep.bias + c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + arow + 8 * hf;
      if (r >= M) continue;
      const size_t off = (size_t)r * N + c;
      float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
      if (kHasBias) {
        v0 += b2.x;
        v1 += b2.y;
      }
      auto st2 = [&](float* p, float x0, float x1) {
        if (pair) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          p[0] = x0;
          if (two) p[1] = x1;
        }
      };
      if (EPI == kBiasGelu) {
        if (ep.pre != nullptr) st2(ep.pre + off, v0, v1);
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      if (drop) {
        v0 = dropped(v0, base + static_cast<uint32_t>(off), salt, ep.drop);
        v1 = dropped(v1, base + static_cast<uint32_t>(off + 1), salt, ep.drop);
      }
      if (EPI == kDropGeluGrad) {
        const float2 h2 = ld2(ep.aux + off);
        v0 *= gelu_tanh_grad(h2.x);
        v1 *= gelu_tanh_grad(h2.y);
      }
      if (EPI == kBiasResid || EPI == kResid) {
        const float2 r2 = ld2(ep.resid + off);
        v0 += r2.x;
        v1 += r2.y;
      }
      st2(C + off, v0, v1);
    }
  }
}

template <bool A_KC, bool B_KC, int EPI, bool GENERAL, int FLUSH>
cudaError_t gemm_tf32x3_launch(const float* A, const float* B, float* C, int M, int N, int K,
                               int lda, int ldb, int splits, int k_chunk, bool vec, bool pair,
                               const EpiArgs& ep, cudaStream_t s) {
  const cudaError_t e = set_smem(gemm_tf32x3_kernel<A_KC, B_KC, EPI, GENERAL, FLUSH>, kTcSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, splits);
  gemm_tf32x3_kernel<A_KC, B_KC, EPI, GENERAL, FLUSH><<<grid, kTcThreads, kTcSmem, s>>>(
      A, B, C, M, N, K, lda, ldb, k_chunk, vec, pair, ep);
  return cudaSuccess;
}

// Queues C = epi(A . B^T) on `s` (operand layouts as gemm_tf32x3_kernel),
// the GENERAL instantiation where a block's K range passes kTcFlushK or an
// operand or output is not aligned for the vector copies and stores, else
// the main path's, flushing every FLUSH slices where FLUSH > 0.
template <bool A_KC, bool B_KC, int EPI, int FLUSH = 0>
cudaError_t gemm_tf32x3(const float* A, const float* B, float* C, int M, int N, int K,
                        int lda, int ldb, int splits, int k_chunk, const EpiArgs& ep,
                        cudaStream_t s) {
  auto at = [](const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; };
  const bool k4 = K % 4 == 0 && k_chunk % 4 == 0;
  const bool vec = at(A, 16) && at(B, 16) && lda % 4 == 0 && ldb % 4 == 0 &&
                   (A_KC ? k4 : M % 4 == 0) && (B_KC ? k4 : N % 4 == 0);
  const bool pair = N % 2 == 0 && at(C, 8) && at(ep.bias, 8) && at(ep.resid, 8) &&
                    at(ep.aux, 8) && at(ep.pre, 8);
  if (!vec || !pair || std::min(K, k_chunk) > kTcFlushK)
    return gemm_tf32x3_launch<A_KC, B_KC, EPI, true, kTcFlushSlices>(
        A, B, C, M, N, K, lda, ldb, splits, k_chunk, vec, pair, ep, s);
  return gemm_tf32x3_launch<A_KC, B_KC, EPI, false, FLUSH>(A, B, C, M, N, K, lda, ldb, splits,
                                                           k_chunk, true, true, ep, s);
}

// C[M, N] = epi(A[M, K] . W[N, K]^T): the forward products, W in PyTorch's
// [out, in] layout
template <int EPI, int FLUSH = 0>
cudaError_t gemm_nt(const float* A, const float* W, float* C, int M, int N, int K,
                    const EpiArgs& ep, cudaStream_t s) {
  return gemm_tf32x3<true, true, EPI, FLUSH>(A, W, C, M, N, K, K, K, 1, K, ep, s);
}

}  // namespace
