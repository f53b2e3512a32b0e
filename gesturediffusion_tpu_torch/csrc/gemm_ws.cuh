// The encoder layers' products, designed for Hopper: a warp-specialized
// 3xTF32 GEMM on weights split once, for the inference layer
// (encoder_layer.cu) and the training layer (encoder_layer_train.cu).
//
// Replaces: the four products of
// gesturediffusion_tpu/ops/pallas_encoder.py::_encoder_layer_kernel, the
// jnp.dots at :109 (qkv), :143 (out-projection), :151 (ff1) and :157 (ff2),
// each at full f32 precision, and with them the LayerNorms _layer_norm_f32
// at :147 and :161 where a block owns whole rows (D <= 256); and the
// products of gesturediffusion_tpu/ops/pallas_encoder_train.py::_fwd_kernel
// and ::_bwd_kernel: the same four forward products with their dropout
// sites, the data gradients dX = dY . W and the weight gradients dW = dY^T
// . X.
//
// The arithmetic is gemm_tf32x3.cuh's 3xTF32 (why three passes: there):
// big.small + small.big + big.big per k8 step, in that order, into one f32
// accumulator, over K in order, and the same k permutation within each
// slice of 8 (fragment elements k = t and t + 4 are A's physical columns 2t
// and 2t + 1).  The inference instantiations (FLUSH 0) do not flush their
// accumulator (K <= kTcFlushK, as the parent's inference instantiation);
// the training ones (FLUSH 4) add it into a second register sum after
// slices 4, 8, ... and the last, as gemm_tf32x3_kernel's flush does, and
// the weight gradients keep the parent's row chunks (the caller's
// weight_grad_splits) and their sum.  So every product before its epilogue
// is the parent GEMM's bit for bit, and after it too where the epilogue is
// the parent's (every training one); the LayerNorm epilogue sums a row's
// statistics in another order than common.cuh's row kernel.
//
// What bounds it on an H100: three TF32 passes at 495 TFLOP/s, 165 TFLOP/s
// of f32-equivalent work (the gesture layer's four products at [82, 81, 256],
// ff 1024: 0.0633 ms).  With W's big and small parts both streamed, a 128 x
// 128 tile needs ~59 bytes from L2 a ns an SM at that rate (7.7 TB/s over
// 132 SMs): L2 is the next wall.
//
// Design:
//   * W split once.  split_weight_kernel writes a weight [N, K] as
//     [2][N][Kp] (big, small; Kp = K rounded up to 8, zeros past K), each
//     slice of 8 columns in the permuted order (0, 2, 4, 6, 1, 3, 5, 7), the
//     big part rounded (tf32_rn) as wgmma reads it; split_weight_t_kernel
//     writes W^T so, for the data gradients (B(n, k) = W[k][n]).  The
//     wrapper (ops/fused_encoder.py:weight_split, weight_split_t) keeps
//     each per weight and version with its tensor map (ws_weight_map),
//     encoded once.
//   * Loads by the copy engine: one producer thread lands each 32-column K
//     slice of A (box 32 x BM) and of both W parts (boxes 32 x 128) with the
//     128-byte swizzle into a ring of STAGES stages (4 at 128 x 128 and 64 x
//     128 tiles, 3 at 64 x 256), on full and empty mbarriers; rows past M or
//     N and columns past K land as zeros.  Its warpgroup keeps the block's
//     register count (168 a thread) where the inference consumers need
//     it; in the training instantiations it gives 128 of them to the
//     consumers (setmaxnreg: 40 and 232), whose flushed sum beside the
//     accumulator would spill in 168.
//   * Consumers on the tensor cores: two warpgroups, each 64 rows of a
//     128 x 128 tile or half the columns of a 64-row one, wgmma m64nNk8
//     TF32 (N 128 or 64) with A from registers (its fragments read from
//     the swizzled A tile, mma.sync's m16n8k8 layout, and split in
//     registers) and both W parts from shared memory through swizzled
//     K-major descriptors (128-byte swizzle, 1024 bytes between 8-row
//     groups, a k8 step 32 bytes along the row).  A k8 step is one group of
//     three wgmmas; wgmma.wait_group 1 keeps one group in flight while the
//     next step's fragments are read and split into the other of two
//     register buffers.
//   * A persistent walk: a one-wave grid (wave_blocks) takes output tiles
//     blockIdx.x, + gridDim.x, ...; tile i is (row block i % m_tiles,
//     column block i / m_tiles), so a wave's blocks share W's tiles in L2.
//     The producer runs ahead into the next tile while the consumers are in
//     their epilogue.
//   * Epilogues: gemm_tf32x3_kernel's, in its order (bias; bias and the
//     residual; bias and GELU-tanh with the pre-activation stored; the
//     dropout of a training site; the GELU derivative; the residual), and
//     where N = D <= 256 (kWsLnCols), bias, residual and LayerNorm: a 64 x
//     256 tile holds its rows whole, a row's sums are taken in the thread,
//     across its quad and over the two consumers' column halves (a few
//     floats of shared memory between two named barriers), columns past N
//     left out, and h1 or out written directly (the inference layer's two
//     layernorm launches and its tmp round trip go).
//   * The weight gradients (gemm_ws_tn_kernel): neither operand is
//     K-contiguous (K is the rows), and TF32 wgmma reads shared-memory
//     operands K-major only.  Tiles of 128 x 64 over (I, J), a walk over
//     (row chunk, tile) items; a producer warpgroup: one thread lands dY's
//     slice (32 rows x 128 columns, four 32 x 32 boxes with the 128-byte
//     swizzle) and X's (32 rows x 64 columns, no swizzle) by tensor maps
//     into the stage's raw part, and two warps split X's slice, transposed,
//     into the stage's big and small tiles in the consumers' swizzled
//     K-major layout (a thread a row of X^T, its 32 values read down a
//     column of the raw slice: 32 lanes, 32 banks), then hand it on; the
//     consumers read dY's fragments from the raw boxes (the swizzle puts a
//     warp's 32 reads in 32 banks) and split them in registers.  Each item
//     writes its chunk's partial sums; the caller adds them in chunk order
//     (encoder_layer_train.cu:sum_splits_kernel).
// Tiles: 128 x 128 for bias, GELU and residual (64 x 128, two consumers of
// 64 columns, where those fit one wave: a short M such as the a2m take's
// 732 rows gets twice the blocks); 64 x 256 for the LayerNorm epilogue, so
// that the gesture layer's out-projection and ff2 ([6642, 256]) spread
// over 104 blocks, not 52.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py ws, the
// inference layer at [82, 81, 256] by CUDA events in turns; PERF.md section
// 6): 0.196-0.205 ms against the parent GEMM's 0.232-0.233.  Tried and not
// kept: the LayerNorm route on one consumer warpgroup of n256 (0.212), the
// residual epilogue and the row kernel in its place (0.208), clusters of
// two blocks sharing each W slice by multicast (0.241), the other routes on
// 64 x 256 tiles (0.193, but slower at D 512).  Without the tensor copies
// the layer takes 0.190-0.192 ms and without A's split 0.191-0.194: neither
// bounds it; the consumers' own instruction stream, the epilogues and the
// last wave do.  The training layer's times: PERF.md section 6 (row "5-6,
// products").
//
// Dispatch: a product takes this GEMM where every operand row is 16-byte
// aligned for the tensor maps (ws_aligned: N and K multiples of 4, for the
// weight gradients I and J; the wrapper checks the pointers), and in the
// inference layer K <= kTcFlushK (ws_takes: its accumulator is not
// flushed); every other product takes gemm_tf32x3.cuh's GEMM unchanged.
// ops/fused_encoder.py:layer_routes and
// ops/fused_encoder_train.py:train_routes are the rule's Python mirrors.
// No fallback: a failed split, map or launch is the layer's error.
#pragma once

#include <cuda.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm_tf32x3.cuh"
#include "mma_tf32x3.cuh"
#include "tma.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kWsBK = 32;             // columns of a K slice: one 128-byte swizzled row
constexpr int kWsBoxRows = 128;       // rows of a W box
constexpr int kWsLnCols = 256;        // the widest D whose LayerNorm runs in the epilogue
constexpr int kBiasResidLn = 16;      // epilogue: C = LN(resid + acc + bias) * ln_w + ln_b

// d += a . b for a warpgroup, m64n256k8 TF32: a from registers (mma.sync's
// m16n8k8 A fragment, each warp its 16 rows), b 256 x 8 from shared memory
// through `desc`, d 128 floats a thread (mma.sync's accumulator, per n8 tile)
__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n"
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
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ws(float* d, const uint32_t (&a)[4], uint64_t desc) {
  static_assert(N == 64 || N == 128 || N == 256, "an instantiated tile width");
  if constexpr (N == 64)
    wgmma_m64n64k8_tf32(*reinterpret_cast<float(*)[32]>(d), a, desc);
  else if constexpr (N == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n256(d, a, desc);
}

// Shared-memory descriptor of a K-major tile with the 128-byte swizzle: rows
// of 128 bytes (32 TF32 values), 8-row groups 1024 bytes apart (the stride
// byte offset), the leading byte offset unused (1), layout type 1 (128-byte
// swizzle) in bits 62-63.  The tile is 1024-byte aligned; a k8 step starts
// 32 bytes further along the row, and the card applies the swizzle to the
// address it forms.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const float* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ float2 ld2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// NC consumer warpgroups (threads 0 .. 128 NC - 1) and the producer
// warpgroup after them; tiles of BM x BN: the consumers
// take 64 rows each (BM = 64 NC), or, where they share the columns of 64
// rows (the LayerNorm route, COLS), BN / NC columns each; a ring stage
// holds A's slice [BM][32], then W's big and small slices [BN][32] each,
// all 1024-byte aligned
template <int NC, int BN, bool COLS>
struct WsTile {
  static constexpr int BM = COLS ? 64 : 64 * NC;
  static constexpr int WN = COLS ? BN / NC : BN;  // a consumer's columns
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kAFloats = BM * kWsBK;
  static constexpr int kBFloats = BN * kWsBK;  // one part of W
  static constexpr int kStageFloats = kAFloats + 2 * kBFloats;
  static constexpr uint32_t kStageBytes = kStageFloats * sizeof(float);
  static constexpr int kStages = std::min<int>(4, (int)((kMaxSmem - 2048) / kStageBytes));
  // the ring, the slack that aligns it to 1024 bytes, the full and empty
  // mbarriers, the LayerNorm's row sums of each consumer (two passes)
  static constexpr size_t smem = (size_t)kStages * kStageBytes + 1024 +
                                 2 * kStages * sizeof(uint64_t) + 2 * NC * 64 * sizeof(float);
  static_assert(kStages >= 2 && smem <= kMaxSmem, "the ring fits shared memory");
};

struct WsArgs {
  float* C;            // [M, N]
  int M, N, K;
  const float* bias;   // [N]
  const float* resid;  // [M, N]: kBiasResid, kResid, kBiasResidLn
  const float* ln_w;   // [N]: kBiasResidLn
  const float* ln_b;   // [N]: kBiasResidLn
  const float* aux;    // [M, N]: the GELU input of kDropGeluGrad
  float* pre;          // [M, N]: kBiasGelu's pre-activation, or null
  Drop drop;           // a training site's dropout (drop.seed null: none)
  int site;
};

// the consumer warpgroups wait for each other (named barrier `id`, not 0)
template <int NC>
__device__ __forceinline__ void consumers_sync_n(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(128 * NC) : "memory");
}

// a stage's reads are done: each warp frees it for the producer
__device__ __forceinline__ void ws_release(uint64_t* bar, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// sum += acc, acc = 0 once the warpgroup's wgmmas are done: the flush of
// gemm_tf32x3_kernel, after slices FLUSH, 2 FLUSH, ... and the last
template <int N>
__device__ __forceinline__ void ws_flush(float (&acc)[N], float (&sum)[N]) {
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sum[i] += acc[i];
    acc[i] = 0.0f;
  }
}

// gemm_tf32x3_kernel's epilogues, in its order, on this thread's pairs:
// columns c0 + 8j + 2t, + 1 (j < NJ) of rows r0 (acc[4j], acc[4j + 1]) and
// r0 + 8 (acc[4j + 2], acc[4j + 3]); N % 4 == 0, so a pair is inside N or
// outside it whole.  The dropout index of element (r, c) is row_base N + r
// N + c, as there.
template <int EPI, int NJ>
__device__ __forceinline__ void ws_epilogue(const float* acc, const WsArgs& p, int r0, int c0,
                                            int t) {
  constexpr bool kHasBias = EPI == kBias || EPI == kBiasResid || EPI == kBiasGelu;
  const bool drop = (EPI == kBiasResid || EPI == kBiasGelu || EPI == kDropGeluGrad) &&
                    p.drop.seed != nullptr;
  const uint32_t salt = drop ? site_salt(p.drop.seed, p.site) : 0u;
  const uint32_t base = p.drop.row_base * static_cast<uint32_t>(p.N);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (c >= p.N) continue;
    float2 b2 = make_float2(0.f, 0.f);
    if (kHasBias) b2 = ld2f(p.bias + c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r >= p.M) continue;
      const size_t off = (size_t)r * p.N + c;
      float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
      if (kHasBias) {
        v0 += b2.x;
        v1 += b2.y;
      }
      if (EPI == kBiasGelu) {
        if (p.pre != nullptr) *reinterpret_cast<float2*>(p.pre + off) = make_float2(v0, v1);
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      if (drop) {
        v0 = dropped(v0, base + static_cast<uint32_t>(off), salt, p.drop);
        v1 = dropped(v1, base + static_cast<uint32_t>(off + 1), salt, p.drop);
      }
      if (EPI == kDropGeluGrad) {
        const float2 h2 = ld2f(p.aux + off);
        v0 *= gelu_tanh_grad(h2.x);
        v1 *= gelu_tanh_grad(h2.y);
      }
      if (EPI == kBiasResid || EPI == kResid) {
        const float2 x2 = ld2f(p.resid + off);
        v0 += x2.x;
        v1 += x2.y;
      }
      *reinterpret_cast<float2*>(p.C + off) = make_float2(v0, v1);
    }
  }
}

// A consumer warpgroup of gemm_ws_kernel: rows 64 cw .. 64 cw + 63 of each
// of its block's tiles, every column; the epilogue writes C
template <int NC, int BN, bool COLS, int EPI, int FLUSH>
__device__ __forceinline__ void gemm_ws_consumer(const float* ring, uint64_t* full,
                                                 uint64_t* empty, float* red, const WsArgs& p,
                                                 int m_tiles, int tiles, int slices) {
  using Tile = WsTile<NC, BN, COLS>;
  constexpr int BM = Tile::BM, WN = Tile::WN, STAGES = Tile::kStages;
  const int ct = threadIdx.x, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int col0 = COLS ? WN * cw : 0;       // this warpgroup's first column of a tile
  const int arow = (COLS ? 0 : 64 * cw) + 16 * warp + g;  // its rows arow, arow + 8
  const int rsw = arow & 7;                  // their swizzle (8 rows apart: the same)
  auto release = [&](uint64_t* bar) { ws_release(bar, lane); };
  float acc[WN / 2];
  float sum[FLUSH ? WN / 2 : 1];             // the flushed sum
  uint32_t a_big[2][4], a_small[2][4];       // the fragments of two k8 steps
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
    if constexpr (FLUSH > 0) {
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) sum[i] = 0.0f;
    }
    for (int ks = 0; ks < slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const float* a = ring + s * Tile::kStageFloats;
      const float* wbig = a + Tile::kAFloats + col0 * kWsBK;  // this warpgroup's W rows
      const float* wsmall = wbig + Tile::kBFloats;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const int buf = st & 1;
        // rows arow, arow + 8 at the physical columns 8 st + 2t, 8 st + 2t + 1:
        // fragment elements k = t and t + 4 (W's split holds that order)
        const int col = ((((2 * st + (t >> 1)) ^ rsw) & 7) << 2) + 2 * (t & 1);
        const float2 lo = ld2f(a + arow * kWsBK + col);
        const float2 hi = ld2f(a + (arow + 8) * kWsBK + col);
        split_tf32(lo.x, a_big[buf][0], a_small[buf][0]);
        split_tf32(hi.x, a_big[buf][1], a_small[buf][1]);
        split_tf32(lo.y, a_big[buf][2], a_small[buf][2]);
        split_tf32(hi.y, a_big[buf][3], a_small[buf][3]);
        wgmma_fence();
        const uint64_t db = wgmma_desc_sw128(wbig + 8 * st);
        const uint64_t ds = wgmma_desc_sw128(wsmall + 8 * st);
        wgmma_ws<WN>(acc, a_big[buf], ds);
        wgmma_ws<WN>(acc, a_small[buf], db);
        wgmma_ws<WN>(acc, a_big[buf], db);
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its fragment buffer is free
        // ... and at st 0 it was slice ks - 1's last: that stage is free
        if (st == 0 && ks > 0) release(&empty[(it - 1) % STAGES]);
      }
      if constexpr (FLUSH > 0) {
        if (ks % FLUSH == FLUSH - 1 || ks == slices - 1) ws_flush(acc, sum);
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      reg_fence(a_big[b]);
      reg_fence(a_small[b]);
    }
    release(&empty[(it - 1) % STAGES]);  // the tile's last slice
    if constexpr (FLUSH > 0) {
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = sum[i];
    }

    // the epilogue: this thread holds columns n0 + 8j + 2t, + 1 of rows r0
    // (acc[4j], acc[4j + 1]) and r1 (acc[4j + 2], acc[4j + 3]); N % 4 == 0,
    // so a pair is inside N or outside it whole
    const int r0 = m0 + arow, r1 = r0 + 8;
    if constexpr (EPI == kBiasResidLn) {
      // v = resid + (acc + bias) over the row's N columns, then
      // (v - mean) * rsqrt(var + eps) * ln_w + ln_b, the statistics summed
      // in the thread, across its quad and then over the consumers' column
      // shares in their order (shared memory: the same sum in each);
      // columns past N and rows past M are left out
      auto row_sums = [&](float& lo, float& hi, float* buf, int bar) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          lo += __shfl_xor_sync(0xffffffffu, lo, o);
          hi += __shfl_xor_sync(0xffffffffu, hi, o);
        }
        if constexpr (NC > 1) {
          if (t == 0) {
            buf[64 * cw + 16 * warp + g] = lo;
            buf[64 * cw + 16 * warp + g + 8] = hi;
          }
          consumers_sync_n<NC>(bar);
          lo = hi = 0.0f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            lo += buf[64 * c + 16 * warp + g];
            hi += buf[64 * c + 16 * warp + g + 8];
          }
        }
      };
      float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c >= p.N) {
          acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.0f;
          continue;
        }
        const float2 b2 = ld2f(p.bias + c);
        const float2 x0 = r0 < p.M ? ld2f(p.resid + (size_t)r0 * p.N + c) : make_float2(0.f, 0.f);
        const float2 x1 = r1 < p.M ? ld2f(p.resid + (size_t)r1 * p.N + c) : make_float2(0.f, 0.f);
        acc[4 * j] = (acc[4 * j] + b2.x) + x0.x;
        acc[4 * j + 1] = (acc[4 * j + 1] + b2.y) + x0.y;
        acc[4 * j + 2] = (acc[4 * j + 2] + b2.x) + x1.x;
        acc[4 * j + 3] = (acc[4 * j + 3] + b2.y) + x1.y;
        s_lo += acc[4 * j] + acc[4 * j + 1];
        s_hi += acc[4 * j + 2] + acc[4 * j + 3];
      }
      row_sums(s_lo, s_hi, red, 1);
      const float mu_lo = s_lo / p.N, mu_hi = s_hi / p.N;
      float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        if (col0 + 8 * j + 2 * t >= p.N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d_lo = acc[4 * j + e] - mu_lo, d_hi = acc[4 * j + 2 + e] - mu_hi;
          q_lo = fmaf(d_lo, d_lo, q_lo);
          q_hi = fmaf(d_hi, d_hi, q_hi);
        }
      }
      row_sums(q_lo, q_hi, red + 64 * NC, 2);
      const float rs_lo = rsqrtf(q_lo / p.N + kLnEps), rs_hi = rsqrtf(q_hi / p.N + kLnEps);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c >= p.N) continue;
        const float2 w2 = ld2f(p.ln_w + c), b2 = ld2f(p.ln_b + c);
        if (r0 < p.M)
          *reinterpret_cast<float2*>(p.C + (size_t)r0 * p.N + c) =
              make_float2((acc[4 * j] - mu_lo) * rs_lo * w2.x + b2.x,
                          (acc[4 * j + 1] - mu_lo) * rs_lo * w2.y + b2.y);
        if (r1 < p.M)
          *reinterpret_cast<float2*>(p.C + (size_t)r1 * p.N + c) =
              make_float2((acc[4 * j + 2] - mu_hi) * rs_hi * w2.x + b2.x,
                          (acc[4 * j + 3] - mu_hi) * rs_hi * w2.y + b2.y);
      }
    } else {
      ws_epilogue<EPI, WN / 8>(acc, p, r0, n0 + col0, t);
    }
  }
}

// C[M, N] = epi(A[M, K] . W[N, K]^T), A by the tensor map `tma` (boxes of 32
// x BM), W by its split's map `tmw` (ws_weight_map).  Grid: a wave, walking
// the tiles; 128 NC threads of consumers, then the producer's.
template <int NC, int BN, bool COLS, int EPI, int FLUSH>
__global__ void __launch_bounds__(WsTile<NC, BN, COLS>::kThreads, 1)
gemm_ws_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmw,
               WsArgs p) {
  using Tile = WsTile<NC, BN, COLS>;
  constexpr int BM = Tile::BM, STAGES = Tile::kStages;
  static_assert(EPI != kBiasResidLn || (BN == kWsLnCols && (COLS || NC == 1)),
                "the LayerNorm epilogue: a tile holds whole rows");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Tile::kStageFloats);
  uint64_t* empty = full + STAGES;
  float* red = reinterpret_cast<float*>(empty + STAGES);  // [2][NC][64] row sums
  const int m_tiles = (p.M + BM - 1) / BM;
  const int tiles = m_tiles * ((p.N + BN - 1) / BN);
  const int slices = (p.K + kWsBK - 1) / kWsBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the roles part here

  if (threadIdx.x >= 128 * NC) {
    // the flushed instantiations: the producer warpgroup hands the
    // consumers its registers (ptxas gives the block 168 a thread; the
    // consumers hold the flushed sum beside the accumulator in 232)
    if constexpr (FLUSH > 0) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // the producer: one thread lands slice `it` of the walk (its tiles' K
    // slices in order) in stage it % STAGES once the consumers have freed it
    if (threadIdx.x == 128 * NC) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
        for (int ks = 0; ks < slices; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          float* stage = ring + s * Tile::kStageFloats;
          mbar_arrive_expect_tx(&full[s], Tile::kStageBytes);
          tma_load_2d(stage, &tma, ks * kWsBK, m0, &full[s]);
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            float* w = stage + Tile::kAFloats + part * Tile::kBFloats;
#pragma unroll
            for (int h = 0; h < BN / kWsBoxRows; ++h)
              tma_load_3d(w + h * kWsBoxRows * kWsBK, &tmw, ks * kWsBK, n0 + h * kWsBoxRows, part,
                          &full[s]);
          }
        }
      }
    }
  } else {
    if constexpr (FLUSH > 0) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    gemm_ws_consumer<NC, BN, COLS, EPI, FLUSH>(ring, full, empty, red, p, m_tiles, tiles, slices);
  }
}

// ---- the weight gradients ------------------------------------------------ //

constexpr int kTnBM = 128;  // rows of dW (dY's columns) a tile: two consumers of 64
constexpr int kTnBN = 64;   // columns of dW (X's columns) a tile
constexpr int kTnSplitters = 2;  // warps of the producer warpgroup that split X's slices

// a stage: dY's raw slice (four 32 x 32 boxes, 128-byte swizzle), X's raw
// slice [32][64], then X^T's big and small tiles [64][32] (swizzled K-major)
struct TnTile {
  static constexpr int kThreads = 384;  // two consumer warpgroups, the producer warpgroup
  static constexpr int kAFloats = kTnBM * kWsBK;
  static constexpr int kRawBFloats = kWsBK * kTnBN;
  static constexpr int kBFloats = kTnBN * kWsBK;  // one part of X^T
  static constexpr int kStageFloats = kAFloats + kRawBFloats + 2 * kBFloats;
  static constexpr uint32_t kTxBytes = (kAFloats + kRawBFloats) * sizeof(float);
  static constexpr int kStages = 4;
  // the ring, its alignment slack, the raw, full and empty mbarriers
  static constexpr size_t smem =
      (size_t)kStages * kStageFloats * sizeof(float) + 1024 + 3 * kStages * sizeof(uint64_t);
  static_assert(smem <= kMaxSmem && kStageFloats % 256 == 0, "the ring fits, 1024-byte stages");
};

struct WsTnArgs {
  float* C;   // [splits][I][J]: chunk z's sums in slice z
  int I, J;   // dW's shape
  int K;      // the rows summed over
  int chunk;  // rows a chunk (a multiple of kWsBK)
  int splits;
};

// The walk of gemm_ws_tn_kernel: item i is row chunk i / tiles and tile i
// % tiles, (row block tile % m_tiles, column block tile / m_tiles); f(m0,
// n0, z, kbeg, slices) for each item of this block in order
template <typename F>
__device__ __forceinline__ void tn_walk(const WsTnArgs& p, F&& f) {
  const int m_tiles = (p.I + kTnBM - 1) / kTnBM;
  const int tiles = m_tiles * ((p.J + kTnBN - 1) / kTnBN);
  for (int item = blockIdx.x; item < tiles * p.splits; item += gridDim.x) {
    const int z = item / tiles, tile = item % tiles;
    const int kbeg = z * p.chunk, kend = min(p.K, kbeg + p.chunk);
    f((tile % m_tiles) * kTnBM, (tile / m_tiles) * kTnBN, z, kbeg,
      (kend - kbeg + kWsBK - 1) / kWsBK);
  }
}

// dW[I, J] = sum_k dY[k, i] X[k, j] over each row chunk (gemm_tf32x3_kernel
// <false, false, kPlain, ..., FLUSH>'s arithmetic): dY by the tensor map
// `tma` (boxes of 32 columns x 32 rows, 128-byte swizzle), X by `tmb` (64 x
// 32, no swizzle).  Grid: a wave, walking (chunk, tile) items.
template <int FLUSH>
__global__ void __launch_bounds__(TnTile::kThreads, 1)
gemm_ws_tn_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                  WsTnArgs p) {
  constexpr int STAGES = TnTile::kStages;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023) / 4;
  uint64_t* raw = reinterpret_cast<uint64_t*>(ring + STAGES * TnTile::kStageFloats);
  uint64_t* full = raw + STAGES;
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&raw[s], 1);
      mbar_init(&full[s], kTnSplitters);
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // the copies: slice `it` of the walk into stage it % STAGES once the
    // consumers have freed it
    if (lane == 0) {
      int it = 0;
      tn_walk(p, [&](int m0, int n0, int, int kbeg, int slices) {
        for (int ks = 0; ks < slices; ++ks, ++it) {
          const int s = it % STAGES, k0 = kbeg + ks * kWsBK;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          float* stage = ring + s * TnTile::kStageFloats;
          mbar_arrive_expect_tx(&raw[s], TnTile::kTxBytes);
#pragma unroll
          for (int h = 0; h < kTnBM / 32; ++h)
            tma_load_2d(stage + h * 32 * kWsBK, &tma, m0 + 32 * h, k0, &raw[s]);
          tma_load_2d(stage + TnTile::kAFloats, &tmb, n0, k0, &raw[s]);
        }
      });
    }
  } else if (warp > 8 && warp <= 8 + kTnSplitters) {
    // the split: thread j takes row j of X^T's slice (column j of the raw
    // slice), its 8 values of a k8 step in the order 0, 2, 4, 6 | 1, 3, 5,
    // 7, as split_weight_kernel orders a weight's, into 16-byte chunks 2 st
    // and 2 st + 1 of its 128-byte row, swizzled by the row (chunk c at c ^
    // (j & 7)), as the copy engine lands W's split
    const int j = 32 * (warp - 9) + lane;
    int it = 0;
    tn_walk(p, [&](int, int, int, int, int slices) {
      for (int ks = 0; ks < slices; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(&raw[s], (it / STAGES) & 1);
        const float* rb = ring + s * TnTile::kStageFloats + TnTile::kAFloats;
        float* big = ring + s * TnTile::kStageFloats + TnTile::kAFloats + TnTile::kRawBFloats;
        float* small = big + TnTile::kBFloats;
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          uint32_t bg[8], sm[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(rb[(8 * st + 2 * i) * kTnBN + j], bg[i], sm[i]);
            split_tf32(rb[(8 * st + 2 * i + 1) * kTnBN + j], bg[4 + i], sm[4 + i]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = j * kWsBK + (((2 * st + h) ^ (j & 7)) << 2);
            *reinterpret_cast<uint4*>(big + off) =
                make_uint4(bg[4 * h], bg[4 * h + 1], bg[4 * h + 2], bg[4 * h + 3]);
            *reinterpret_cast<uint4*>(small + off) =
                make_uint4(sm[4 * h], sm[4 * h + 1], sm[4 * h + 2], sm[4 * h + 3]);
          }
        }
        fence_proxy_async();  // the async proxy (wgmma) reads what was stored
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    });
  } else if (warp < 8) {
    // the consumers: rows 64 cw + 16 warp + g and + 8 of each item's tile,
    // dY's fragments read from the swizzled boxes: element (i, k) of the
    // slice lies at box i / 32, row k, 16-byte chunk ((i % 32) / 4) ^ (k % 8)
    const int cw = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
    const int arow = 64 * cw + 16 * (warp & 3) + g;
    auto a_at = [&](int i, int k) {
      return (i >> 5) * (32 * kWsBK) + k * kWsBK + ((((i & 31) >> 2) ^ (k & 7)) << 2) + (i & 3);
    };
    float acc[32], sum[32];
    uint32_t a_big[2][4], a_small[2][4];
    int it = 0;
    tn_walk(p, [&](int m0, int n0, int z, int, int slices) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = sum[i] = 0.0f;
      for (int ks = 0; ks < slices; ++ks, ++it) {
        const int s = it % STAGES, ph = (it / STAGES) & 1;
        mbar_wait(&raw[s], ph);   // dY's slice has landed
        mbar_wait(&full[s], ph);  // ... and X^T's is split
        const float* a = ring + s * TnTile::kStageFloats;
        const float* bbig = a + TnTile::kAFloats + TnTile::kRawBFloats;
        const float* bsmall = bbig + TnTile::kBFloats;
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const int buf = st & 1, k = 8 * st + 2 * t;
          split_tf32(a[a_at(arow, k)], a_big[buf][0], a_small[buf][0]);
          split_tf32(a[a_at(arow + 8, k)], a_big[buf][1], a_small[buf][1]);
          split_tf32(a[a_at(arow, k + 1)], a_big[buf][2], a_small[buf][2]);
          split_tf32(a[a_at(arow + 8, k + 1)], a_big[buf][3], a_small[buf][3]);
          wgmma_fence();
          const uint64_t db = wgmma_desc_sw128(bbig + 8 * st);
          const uint64_t ds = wgmma_desc_sw128(bsmall + 8 * st);
          wgmma_m64n64k8_tf32(acc, a_big[buf], ds);
          wgmma_m64n64k8_tf32(acc, a_small[buf], db);
          wgmma_m64n64k8_tf32(acc, a_big[buf], db);
          wgmma_commit();
          wgmma_wait<1>();
          if (st == 0 && ks > 0) ws_release(&empty[(it - 1) % STAGES], lane);
        }
        bool flush = ks == slices - 1;  // FLUSH 0: once, at the end
        if constexpr (FLUSH > 0) flush = flush || ks % FLUSH == FLUSH - 1;
        if (flush) ws_flush(acc, sum);
      }
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        reg_fence(a_big[b]);
        reg_fence(a_small[b]);
      }
      ws_release(&empty[(it - 1) % STAGES], lane);  // the item's last slice
      const WsArgs out{p.C + (size_t)z * p.I * p.J, p.I, p.J, p.K};
      ws_epilogue<kPlain, kTnBN / 8>(sum, out, m0 + arow, n0, t);
    });
  }
}

// ---- the splits ---------------------------------------------------------- //

// the column of a weight that column c of its split holds: each slice of 8
// in the order 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ int split_source(int c) {
  const int q = c & 7;
  return (c & ~7) + (q < 4 ? 2 * q : 2 * (q - 4) + 1);
}

// W [N, K] -> [2][N][Kp] (big, small; Kp = ws_split_cols(K)): column 8j + i
// of a part holds W's column 8j + 2i (i < 4) or 8j + 2(i - 4) + 1 (i >= 4),
// zero past K; big = tf32_rn(w), small = tf32_rn(w - big), as split_tf32
__global__ void split_weight_kernel(const float* __restrict__ w, float* __restrict__ out, int N,
                                    int K, int kp) {
  const long long total = (long long)N * kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = static_cast<int>(i / kp), c = static_cast<int>(i % kp);
    const int src = split_source(c);
    const float x = src < K ? w[(size_t)n * K + src] : 0.0f;
    uint32_t big, small;
    split_tf32(x, big, small);
    out[i] = __uint_as_float(big);
    out[total + i] = __uint_as_float(small);
  }
}

// W [K, N] -> the split of W^T [N, K] ([2][N][Kp], as split_weight_kernel):
// the B operand of the data gradients dX = dY . W, B(n, k) = W[k][n]
__global__ void split_weight_t_kernel(const float* __restrict__ w, float* __restrict__ out,
                                      int K, int N, int kp) {
  const long long total = (long long)N * kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = static_cast<int>(i / N), n = static_cast<int>(i % N);  // reads along W's rows
    const int src = split_source(c);
    const float x = src < K ? w[(size_t)src * N + n] : 0.0f;
    uint32_t big, small;
    split_tf32(x, big, small);
    const size_t o = (size_t)n * kp + c;
    out[o] = __uint_as_float(big);
    out[total + o] = __uint_as_float(small);
  }
}

// ---- host ----------------------------------------------------------------- //

// the columns of a weight's split: K rounded up to a whole slice of 8
inline int ws_split_cols(int K) { return (K + 7) / 8 * 8; }

// Every row of A, W and C 16-byte aligned for the tensor maps and the
// float2 stores: N and K multiples of 4 (for the weight gradients, I and J)
inline bool ws_aligned(int N, int K) { return N % 4 == 0 && K % 4 == 0; }

// The inference rule: the warp-specialized GEMM takes C[M, N] = A[M, K] .
// W[N, K]^T where the rows are aligned and K <= kTcFlushK (its accumulator
// is not flushed).  The training layer's products flush: ws_aligned alone.
inline bool ws_takes(int N, int K) { return ws_aligned(N, K) && K <= kTcFlushK; }

// The tensor map of a row-major [rows, cols] f32 operand, its rows 16-byte
// aligned: boxes of box_cols columns x box_rows rows, the 128-byte swizzle
// (or none), zeros past either edge
inline cudaError_t ws_map_2d(CUtensorMap* map, const float* x, int rows, int cols, int box_cols,
                             int box_rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A's map: boxes of 32 columns x box_rows rows, the 128-byte swizzle
inline cudaError_t ws_operand_map(CUtensorMap* map, const float* x, int rows, int cols,
                                  int box_rows) {
  return ws_map_2d(map, x, rows, cols, kWsBK, box_rows, true);
}

// The tensor map of a split weight [2][N][kp]: 3-d (column, row, part),
// boxes of 32 columns x 128 rows of one part, the 128-byte swizzle
inline cudaError_t ws_weight_map(CUtensorMap* map, const float* split, int N, int kp) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(N), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kp) * sizeof(float),
                                 static_cast<cuuint64_t>(N) * kp * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kWsBK), static_cast<cuuint32_t>(kWsBoxRows),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(split),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Queues the split of W [N, K] into `split` ([2][N][ws_split_cols(K)],
// 16-byte aligned) on `s` and encodes its tensor map into `map`; with
// `transposed`, W is [K, N] and the split is W^T's (the data gradients')
inline cudaError_t split_weight(const float* w, float* split, int N, int K, CUtensorMap* map,
                                cudaStream_t s, bool transposed = false) {
  if (N < 1 || K < 1 || reinterpret_cast<uintptr_t>(split) % 16 != 0)
    return cudaErrorInvalidValue;
  const int kp = ws_split_cols(K);
  const long long total = (long long)N * kp;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  if (transposed)
    split_weight_t_kernel<<<blocks, 256, 0, s>>>(w, split, K, N, kp);
  else
    split_weight_kernel<<<blocks, 256, 0, s>>>(w, split, N, K, kp);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : ws_weight_map(map, split, N, kp);
}

template <int NC, int BN, bool COLS, int EPI, int FLUSH>
cudaError_t gemm_ws_launch(const float* A, const CUtensorMap& tmw, const WsArgs& p,
                           cudaStream_t s) {
  using Tile = WsTile<NC, BN, COLS>;
  if constexpr (FLUSH > 0) {
    // setmaxnreg moves registers within the block: the consumers' 232 come
    // from the producer's 168 - 40, so the block must hold 168 a thread
    // (else the consumers would wait for registers forever)
    static const int regs = [] {
      cudaFuncAttributes a{};
      return cudaFuncGetAttributes(&a, gemm_ws_kernel<NC, BN, COLS, EPI, FLUSH>) == cudaSuccess
                 ? a.numRegs : 0;
    }();
    if (regs * (NC + 1) < 40 + 232 * NC) return cudaErrorInvalidConfiguration;
  }
  CUtensorMap tma;
  cudaError_t e = ws_operand_map(&tma, A, p.M, p.K, Tile::BM);
  int blocks = 0;
  if (e == cudaSuccess)
    e = wave_blocks(gemm_ws_kernel<NC, BN, COLS, EPI, FLUSH>, Tile::kThreads, Tile::smem, blocks);
  if (e != cudaSuccess) return e;
  const long long tiles =
      (long long)((p.M + Tile::BM - 1) / Tile::BM) * ((p.N + BN - 1) / BN);
  if (tiles < 1 || tiles > INT_MAX) return cudaErrorInvalidValue;
  gemm_ws_kernel<NC, BN, COLS, EPI, FLUSH>
      <<<static_cast<int>(std::min<long long>(tiles, blocks)), Tile::kThreads, Tile::smem, s>>>(
          tma, tmw, p);
  return cudaSuccess;
}

// Queues C = epi(A . W^T) on `s`, W by its split's map (split_weight): 64 x
// 256 tiles, two consumer warpgroups of 128 columns each, for the LayerNorm
// epilogue (N <= kWsLnCols); else 128 x 128 tiles of two 64-row consumers,
// or 64 x 128 tiles of two 64-column consumers where those still fit one
// wave of the card (a short M: twice the blocks, no more waves).  FLUSH > 0
// flushes the accumulator every FLUSH slices (the training layer's
// products).  cudaErrorInvalidValue where the rule (ws_takes; ws_aligned
// where FLUSH > 0) sends the product to gemm_tf32x3.cuh.
template <int EPI, int FLUSH = 0>
cudaError_t gemm_ws(const float* A, const CUtensorMap& tmw, const WsArgs& p, cudaStream_t s) {
  if (!(FLUSH > 0 ? ws_aligned(p.N, p.K) : ws_takes(p.N, p.K)) || p.M < 1)
    return cudaErrorInvalidValue;
  if constexpr (EPI == kBiasResidLn) {
    static_assert(FLUSH == 0, "the LayerNorm epilogue is the inference layer's");
    if (p.N > kWsLnCols) return cudaErrorInvalidValue;
    return gemm_ws_launch<2, kWsLnCols, true, EPI, FLUSH>(A, tmw, p, s);
  } else {
    using Big = WsTile<2, 128, false>;
    int wave = 0;
    const cudaError_t e =
        wave_blocks(gemm_ws_kernel<2, 128, false, EPI, FLUSH>, Big::kThreads, Big::smem, wave);
    if (e != cudaSuccess) return e;
    const long long short_tiles = (long long)((p.M + 63) / 64) * ((p.N + 127) / 128);
    if (short_tiles <= wave) return gemm_ws_launch<2, 128, true, EPI, FLUSH>(A, tmw, p, s);
    return gemm_ws_launch<2, 128, false, EPI, FLUSH>(A, tmw, p, s);
  }
}

// Queues the weight gradient's chunk sums C[z] = dY[rows of chunk z]^T .
// X[rows of chunk z] (dY [K, I], X [K, J], C [splits][I][J]) on `s`,
// flushing every FLUSH slices: the chunks (`chunk` rows, a multiple of
// kWsBK; `splits` of them cover K) are the caller's, who adds the slices
// (or takes C as dW where splits is 1).  cudaErrorInvalidValue outside the
// rule (ws_aligned(J, I)).
template <int FLUSH>
cudaError_t gemm_ws_tn(const float* dY, const float* X, float* C, int I, int J, int K, int chunk,
                       int splits, cudaStream_t s) {
  const auto at16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (!ws_aligned(J, I) || K < 1 || chunk < 1 || chunk % kWsBK != 0 || splits < 1 ||
      (long long)(splits - 1) * chunk >= K || (long long)splits * chunk < K || !at16(C))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t e = ws_map_2d(&ta, dY, K, I, 32, 32, true);
  if (e == cudaSuccess) e = ws_map_2d(&tb, X, K, J, kTnBN, kWsBK, false);
  int blocks = 0;
  if (e == cudaSuccess)
    e = wave_blocks(gemm_ws_tn_kernel<FLUSH>, TnTile::kThreads, TnTile::smem, blocks);
  if (e != cudaSuccess) return e;
  const long long items =
      (long long)((I + kTnBM - 1) / kTnBM) * ((J + kTnBN - 1) / kTnBN) * splits;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  gemm_ws_tn_kernel<FLUSH>
      <<<static_cast<int>(std::min<long long>(items, blocks)), TnTile::kThreads, TnTile::smem,
         s>>>(ta, tb, WsTnArgs{C, I, J, K, chunk, splits});
  return cudaSuccess;
}

}  // namespace
